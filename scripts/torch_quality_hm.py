"""The port's main path, its headline recipe, or the stage-1 A/B of the text
encoders, at the H&M scale on one GPU, held against the JAX package's
committed runs of the same worlds.

    python3 scripts/torch_quality_hm.py [--recipe main|hybrid|stage1] [--out DIR]
        [--device cuda] [--budget-s 3350]
        [--reserve-s 1200] [--user-epochs 25] [--item-epochs 3] [--requests 20]
        [--set key=value ...]
    python3 scripts/torch_quality_hm.py --compare DIR

The world of ``scripts/quality_hm_v4_data.sh`` (105,000 items, 1,370,000
users, 365 days, ``data.repeat_prob=0.10``, ``data.name_style_words=2``) and
the stages of ``quality_hm_v4_stage1.sh`` (arm A, the hash encoder) and
``quality_hm_v4_phase3.sh``, through the port's CLI (``pipeline.cli.main``):

  gen-data -> etl -> train-item (simcse.epochs=3) -> vectorize -> kNN purity
  -> train-user (user_train.epochs=25, ckpt_every=5) -> eval -> serve

The kNN purity is ``scripts/knn_purity.py``'s at k = 10 over 8,192 sampled
queries (the same rows), with the products and the top-k on ``--device``.
``serve`` is ``serve --model-backed --set serve.user_backend=stage2`` behind
the HTTP server: the catalog ingested, a few products through
``process-pending``, the whole catalog through ``refresh-item-vectors``,
``--requests`` evaluation users' training histories through
``users/process-pending``, then ``--requests`` recommendations in cosine and
in blend mode each. A served user vector is held within 2e-2 of the tower's
eval forward on the same history (built here, apart from the server's code),
and the same tower on these users' stage-2 rows (rebuilt here from the ETL's
sequences and user features) within 2e-2 of their ``eval_uvecs`` rows. The
served vector's own distance to ``eval_uvecs`` is reported, not gated: the
server knows neither the user's static features (zeros) nor the final
training event that the stage-2 row's time buckets are counted from.

``--recipe hybrid`` runs the headline chain of ``quality_hm_v4_stage2.sh``
(lines 45-57) on the same world, after the same first four stages:

  gen-data -> etl -> train-item -> vectorize -> train-gnn (gnn.epochs=1,
  gnn.steps_per_epoch_max=1500) -> gnn-eval -> distill -> gnn-eval (the
  distilled rows present) -> train-hybrid (user_train.epochs=2, ckpt_every=1)
  -> rerank-eval --vectors hybrid -> serve --model-backed --vectors hybrid

(the recipe's overrides come before ``--set``'s, which may cut them for a
test). ``serve`` there: the catalog ingested, ``--requests`` evaluation users'
training histories through ``users/process-pending``, each served vector held
within 2e-2 of the hybrid tower's forward on the same history and GNN row,
then ``--requests`` recommendations in each of rerank, blend and cosine mode,
the HTTP rerank list equal to ``rerank_serve_topk``'s offline list for the same
user. Gates: exact (exit 1) for the world, the ETL, the item steps, the
matrix, the GNN check, the distilled shape, n_eval, the rerank pools' sizes and
split, the GNN arm, and on the card every step of train-gnn, distill,
train-hybrid and rerank-eval's DCN arm after the warm-up a graph replay, with
K2 four times and each K1 kernel twice (the users' and the items' SSL
losses) a train-gnn step; bands (``HYBRID_BANDS``, ``"ok": false`` in
the summary) for the recalls, the GNN check's delta and the AUCs.

``--recipe stage1`` runs both arms of the stage-1 A/B (arm A the hash text
encoder, arm B the frozen corpus-pretrained one, ``item_tower.text_encoder=
pretrained``, each with ``simcse.epochs=3``) in two worlds, each held against
its committed JAX run:

  (a) the 5,000-item world of ``scripts/quality_text_pretrain_ab.sh`` with
      ``data.name_style_words=2`` (``artifacts/text_pretrain_ab_v4/``): gen-data,
      then for each arm in its own data root over the same world (linked):
      etl -> [pretrain-text] -> train-item -> vectorize -> kNN purity over
      every item; JSONs under ``--out``/ab;
  (b) the world of ``--recipe main`` (``scripts/quality_hm_v4_stage1.sh``,
      ``artifacts/quality_hm_v4/``): gen-data -> etl -> train-item ->
      vectorize -> kNN purity (8,192 queries), then arm B in ``world_pt``, a
      data root that links arm A's world and ETL outputs: pretrain-text ->
      train-item -> vectorize -> kNN purity -> serve --model-backed with arm
      B's item encoder: the catalog ingested, a few products through
      ``process-pending``, the whole catalog through ``refresh-item-vectors``
      (every served vector within SERVE_TOL of vectorize's row), then
      ``--requests`` similarity requests (the scores within SERVE_TOL of the
      matrix's; where the exact best hit leads the next by more than
      SERVE_TOL, the answer's first hit is it).

Gates: exact (exit 1) for the worlds, the ETLs, the tables' shape and
nonzero rows, their input (the PPMI matrix) bit for bit against the JAX
package's (TABLE_REF; the table's own bits follow the LAPACK build its SVD
runs on, so its sha256 and abs-sum are reported beside the JAX ones), the
frozen table unchanged by train-item, the item
steps, the matrices' shape, the served vectors and answers, and on the card
each train-item step after the warm-up a graph replay with K1 twice a step;
bands (``"ok": false`` in the summary) for each purity (BANDS["knn_purity"])
and arm B's within / cross cosine at 105,000 items, and for the sign of
each A/B (pretrained above hash at 5,000 items, below it at 105,000).

``train-user`` gets ``--deadline``: no epoch starts that would end later than
``--budget-s`` less ``--reserve-s`` (for eval and serve) after this script
started; the curve is compared over the epochs that ran. Every stage runs on
``--device`` (``cuda`` by default; ``cpu`` where the caller asks), and a
failure stops the run.

Printed: each stage's JSON as it ends, each epoch's eval row from the
trainer's ``metrics.jsonl`` as it lands, each stage's seconds, peak host RSS,
peak device memory of the trainers, K1's and K2's launches in each stage,
the GNN graph's size, step medians and graph replays, recommendation
latencies, the card's name and power limit, and last one JSON summary that
sets every number beside the committed one in ``artifacts/quality_hm_v4/`` (and
``artifacts/text_pretrain_ab_v4/``). The stage
JSONs go to ``--out`` under the committed files' names. Exit code 1 when an
exact gate fails (the world, the ETL, the item steps, the matrix shape, the
training-free baselines, n_eval, the served vectors, and the hybrid recipe's
exact rows); a statistical comparison outside its band is ``"ok": false`` in
the summary and leaves the exit code 0. ``--compare DIR`` runs nothing: it
sets the stage JSONs of a ``--recipe hybrid`` run cut before its serve stage
(by a call's time limit) beside the committed run, as the summary would,
and writes ``DIR/summary.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from recsys_tpu_torch.ops import contrastive_kernel as K  # noqa: E402
from recsys_tpu_torch.ops import spmm as S  # noqa: E402
from recsys_tpu_torch.ops.topk import stable_topk  # noqa: E402
from recsys_tpu_torch.pipeline import cli  # noqa: E402
from recsys_tpu_torch.train.step_graph import WARMUP_STEPS  # noqa: E402

WORLD = ["--set", "data.num_items=105000", "--set", "data.num_users=1370000",
         "--set", "data.days=365", "--set", "data.repeat_prob=0.10",
         "--set", "data.name_style_words=2"]
REFERENCE = os.path.join(REPO, "artifacts", "quality_hm_v4")
# relative bands of the statistical comparisons: the random streams differ
BANDS = {"knn_purity": 0.15, "recall@100": 0.10, "blend_best": 0.05, "content_profile": 0.15}
CURVE_FROM_EPOCH = 3
BASELINE_TOL = 1e-12      # the training-free baselines depend on the world only
SERVE_TOL = 2e-2          # served vs the tower's forward, as tests/test_serve.py
KS = (20, 100, 500)
GEN_KEYS = ("items", "users", "transactions", "oracle.oracle_recall", "oracle.popularity_recall",
            "oracle.k", "oracle.target_rows")
MAIN_REFERENCE = ("gen", "etl", "item", "vectorize", "knn_purity", "user", "user_curve", "eval")
HYBRID_REFERENCE = ("gen", "etl", "item", "vectorize", "gnn", "gnn_eval", "distill",
                    "gnn_eval_distilled", "hybrid", "rerank_hybrid")
# the hybrid recipe's bands, fixed before its first run on the card: relative, but
# the AUCs' absolute. BPR sampling, initialisation and dropout draw from other streams.
HYBRID_BANDS = {"gnn_recall@100": 0.15, "mean_abs_delta": 0.15, "hybrid_recall@100": 0.10,
                "rerank_recall": 0.05, "auc_abs": 0.02}
# --recipe stage1: the 5,000-item A/B world (scripts/quality_text_pretrain_ab.sh, v4 names)
AB_WORLD = ["--set", "data.num_items=5000", "--set", "data.num_users=3000",
            "--set", "data.days=240", "--set", "data.name_style_words=2"]
AB_REFERENCE = os.path.join(REPO, "artifacts", "text_pretrain_ab_v4")
AB_NAMES = ("gen", "etl_hash", "etl_pretrained", "pretrain", "item_hash", "item_pretrained",
            "purity_hash", "purity_pretrained")
STAGE1_REFERENCE = ("gen", "etl", "item", "vectorize", "knn_purity", "pretrain", "item_pt",
                    "vectorize_pt", "knn_purity_pt")
ARMS = ("hash", "pretrained")
WORLD_FILES = ("items.parquet", "users.parquet", "transactions.parquet")
ETL_FILES = ("features_item.parquet", "features_sequence.parquet", "features_user.parquet",
             "targets_val.json")
TABLE_KEY = "encoder.text_encoder.pretrained_embedding"
# the JAX package's pretrain-text tables and their input, printed by
# scripts/jax_hm_cut_reference.py (--world ab: the 5,000-item world, two BLAS threads;
# the cut world: the H&M catalog, four; the items do not depend on the users). The input
# (``ppmi``) is held bit for bit; the table's bits follow the LAPACK build its SVD runs on
# (data/text_pretrain.pretrain_embeddings), so they are reported beside the JAX ones
TABLE_REF = {
    "ab": {"shape": [8192, 128], "nonzero_rows": 220, "abs_sum": 1583.742240030337,
           "sha256": "e900c6851256dae46aecb02ac93b3eef41197e8ad9bc685880d847229e4bb4a2",
           "ppmi": {"nnz": 16214, "sha256":
                    "22b9e1a2fb60c404bb8219b11d102337195d9863c04fff51503dd9e2834d56bd"}},
    "hm": {"shape": [8192, 128], "nonzero_rows": 223, "abs_sum": 1536.597757333248,
           "sha256": "6e4679f44ff6933cbb39f0af28d00db8aa9f884b3efb2f677c708688ba23a595",
           "ppmi": {"nnz": 21758, "sha256":
                    "5adf47e0a1cf00d4c6bd5569623a8b77f8e4b99c1cb799f539f5305196918d1d"}}}


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi failed"


def peak_rss_gib() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


# -- kNN purity (scripts/knn_purity.py's statistic, the products on a device) --

def knn_purity(vecs: np.ndarray, labels: np.ndarray, k: int = 10, sample: int = 0,
               seed: int = 0, device: str = "cpu") -> dict:
    """Fraction of each sampled item's k nearest neighbours (cosine, itself
    left out) in its latent cluster, with the query rows, chunks and pair
    sample of ``scripts/knn_purity.py``; neighbours searched over the whole
    catalog on ``device``."""
    v = vecs / np.maximum(np.linalg.norm(vecs, axis=1, keepdims=True), 1e-8)
    n = len(v)
    if sample and sample < n:
        q_rows = np.random.default_rng(seed).choice(n, sample, replace=False)
    else:
        q_rows = np.arange(n)
    vd = torch.as_tensor(v.astype(np.float32), device=device)
    same_frac = []
    for s0 in range(0, len(q_rows), 2048):
        rows = q_rows[s0:s0 + 2048]
        sims = vd[torch.as_tensor(rows, device=device)] @ vd.T
        sims[torch.arange(len(rows), device=device), torch.as_tensor(rows, device=device)] = \
            -torch.inf
        nn = stable_topk(sims, k)[1].cpu().numpy()
        same_frac.append((labels[nn] == labels[rows, None]).mean(1))
    purity = float(np.concatenate(same_frac).mean())
    rng = np.random.default_rng(0)
    a = rng.integers(0, n, 20000)
    b = rng.integers(0, n, 20000)
    keep = a != b
    pair_sims = np.sum(v[a[keep]] * v[b[keep]], axis=1)
    same_pair = labels[a[keep]] == labels[b[keep]]
    return {"knn_purity": purity, "k": k, "query_sample": int(len(q_rows)),
            "within_cos": float(pair_sims[same_pair].mean()) if same_pair.any() else None,
            "cross_cos": float(pair_sims[~same_pair].mean()),
            "n_items": int(n), "n_clusters": int(len(np.unique(labels)))}


def purity_stage(root: str, device: str, sample: int = 8192) -> dict:
    """``knn_purity`` of ``root``'s item matrix at k = 10 over ``sample``
    queries (0: every item), as ``scripts/knn_purity.py`` runs it."""
    import pandas as pd

    from recsys_tpu_torch.train.checkpoint import load_array_with_ids

    mat, ids, _ = load_array_with_ids(f"{root}/item_matrix")
    ids = ids[1:]                                         # the "<pad>" row 0
    items = pd.read_parquet(f"{root}/items.parquet")
    lab = items.set_index(items["item_id"].astype(str))["latent_cluster"]
    labels = lab.reindex([str(i) for i in ids]).to_numpy()
    return knn_purity(mat[1:], labels, 10, sample=sample, device=device)


# -- the comparison with the committed run (host code) ------------------------

def load_reference(ref_dir: str = REFERENCE, names=MAIN_REFERENCE) -> dict:
    """The committed JAX run's stage JSONs, by stage."""
    out = {}
    for name in names:
        with open(os.path.join(ref_dir, f"{name}.json")) as f:
            out[name] = json.load(f)
    return out


def _get(tree: dict | None, path: str):
    node = tree
    for part in path.split("."):
        if not isinstance(node, dict) or part not in node:
            return None
        node = node[part]
    return node


def _leaves(tree: dict, prefix: str = "") -> list[str]:
    keys = []
    for key, value in tree.items():
        if isinstance(value, dict):
            keys += _leaves(value, f"{prefix}{key}.")
        else:
            keys.append(prefix + key)
    return keys


def _row(name: str, got, ref, kind: str, ok: bool | None, **extra) -> dict:
    return {"name": name, "torch": got, "jax": ref, "kind": kind, "ok": ok, **extra}


def exact_row(name: str, got, ref, tol: float = 0.0) -> dict:
    if tol and got is not None and ref is not None:
        ok = abs(got - ref) <= tol
    else:
        ok = got == ref
    return _row(name, got, ref, "exact", bool(ok), **({"tol": tol} if tol else {}))


def band_row(name: str, got, ref, rel: float) -> dict:
    ok = got is not None and ref is not None and abs(got - ref) <= rel * abs(ref)
    gap = None if got is None or ref is None else (got - ref) / ref
    return _row(name, got, ref, "band", bool(ok), rel_band=rel, rel_gap=gap)


def abs_band_row(name: str, got, ref, tol: float) -> dict:
    ok = got is not None and ref is not None and abs(got - ref) <= tol
    gap = None if got is None or ref is None else got - ref
    return _row(name, got, ref, "band", bool(ok), abs_band=tol, abs_gap=gap)


def verdict(rows: list[dict]) -> dict:
    exact = [r for r in rows if r["kind"] == "exact"]
    bands = [r for r in rows if r["kind"] == "band"]
    return {"comparisons": rows, "exact_ok": all(r["ok"] for r in exact),
            "bands_ok": all(r["ok"] for r in bands),
            "misses": [r["name"] for r in exact + bands if not r["ok"]]}


def world_rows(got: dict, ref: dict) -> list[dict]:
    """The exact rows both recipes share: the world, the ETL, the item
    steps, the matrix."""
    rows = [exact_row(f"gen.{key}", _get(got.get("gen"), key), _get(ref["gen"], key))
            for key in GEN_KEYS]
    for key in _leaves(ref["etl"]):
        if key != "command":
            rows.append(exact_row(f"etl.{key}", _get(got.get("etl"), key),
                                  _get(ref["etl"], key)))
    rows.append(exact_row("item.steps", _get(got.get("item"), "steps"), ref["item"]["steps"]))
    rows.append(exact_row("vectorize.shape", _get(got.get("vectorize"), "shape"),
                          ref["vectorize"]["shape"]))
    return rows


def compare(got: dict, ref: dict) -> dict:
    """Every number of this run beside the committed one. ``got`` holds the
    stage JSONs of this run under the reference's names plus ``curve`` (one
    eval row an epoch) and ``eval_epoch`` (the epoch eval loaded); ``ref`` is
    ``load_reference()``. Rows: ``exact`` (equal, or within ``tol``), ``band``
    (within ``rel_band`` of the JAX number), ``info`` (no gate)."""
    rows = world_rows(got, ref)
    for name in ("popularity", "repurchase"):
        for k in KS:
            key = f"baselines.{name}.recall@{k}"
            rows.append(exact_row(f"eval.{key}", _get(got.get("eval"), key),
                                  _get(ref["eval"], key), BASELINE_TOL))
        key = f"baselines.{name}.n_eval"
        rows.append(exact_row(f"eval.{key}", _get(got.get("eval"), key), _get(ref["eval"], key)))
    curve, ref_curve = got.get("curve") or [], ref["user_curve"]["curve"]
    rows.append(exact_row("train-user.n_eval", curve[0].get("n_eval") if curve else None,
                          ref_curve[0]["n_eval"]))
    rows.append(band_row("knn_purity", _get(got.get("knn_purity"), "knn_purity"),
                         ref["knn_purity"]["knn_purity"], BANDS["knn_purity"]))
    for key in ("within_cos", "cross_cos", "n_clusters"):
        rows.append(_row(f"knn_purity.{key}", _get(got.get("knn_purity"), key),
                         ref["knn_purity"][key], "info", None))
    for epoch, ref_row in enumerate(ref_curve, start=1):
        got_row = curve[epoch - 1] if epoch <= len(curve) else None
        for k in KS:
            key = f"recall@{k}"
            value = None if got_row is None else got_row.get(key)
            if k == 100 and epoch >= CURVE_FROM_EPOCH and got_row is not None:
                rows.append(band_row(f"curve.epoch{epoch}.{key}", value, ref_row[key],
                                     BANDS["recall@100"]))
            else:
                rows.append(_row(f"curve.epoch{epoch}.{key}", value, ref_row[key], "info",
                                 None))
    epoch = got.get("eval_epoch")
    full = len(curve) == len(ref_curve)
    for k in KS:    # the checkpoint eval loaded, beside the JAX curve at its epoch
        name, value = f"eval.model_only.recall@{k}", _get(got.get("eval"), f"recall@{k}")
        ref_value = ref_curve[epoch - 1][f"recall@{k}"] if epoch else None
        if k == 100 and epoch and epoch >= CURVE_FROM_EPOCH:
            rows.append(band_row(name, value, ref_value, BANDS["recall@100"]) | {
                "jax_epoch": epoch})
        else:
            rows.append(_row(name, value, ref_value, "info", None, jax_epoch=epoch))
    blend = _get(got.get("eval"), "blend.best_metrics.recall@100")
    ref_blend = _get(ref["eval"], "blend.best_metrics.recall@100")
    if full:
        rows.append(band_row("eval.blend.best.recall@100", blend, ref_blend,
                             BANDS["blend_best"]))
    else:  # the committed blend is epoch 25's: no JAX blend at an earlier epoch
        rows.append(_row("eval.blend.best.recall@100", blend, ref_blend, "info", None,
                         note=f"{len(curve)} of {len(ref_curve)} epochs ran"))
    rows.append(_row("eval.blend.best", _get(got.get("eval"), "blend.best"),
                     ref["eval"]["blend"]["best"], "info", None))
    rows.append(_row("eval.blend_seasonal.best", _get(got.get("eval"), "blend_seasonal.best"),
                     _get(ref["eval"], "blend_seasonal.best"), "info", None))
    rows.append(band_row("eval.baselines.content_profile.recall@100",
                         _get(got.get("eval"), "baselines.content_profile.recall@100"),
                         ref["eval"]["baselines"]["content_profile"]["recall@100"],
                         BANDS["content_profile"]))
    for key in ("baselines.content_profile_recency.recall@100", "significance.blend_best.mean",
                "significance.model_only.mean", "significance.blend_vs_repurchase.delta",
                "significance.model_vs_repurchase.delta"):
        rows.append(_row(f"eval.{key}", _get(got.get("eval"), key), _get(ref["eval"], key),
                         "info", None))
    return verdict(rows)


def compare_hybrid(got: dict, ref: dict) -> dict:
    """The hybrid recipe's numbers beside the committed ones: ``got`` and
    ``ref`` hold the stage JSONs under HYBRID_REFERENCE's names. Exact: the
    world rows, the GNN check, the distilled shape, n_eval, the rerank
    pools' sizes and split, the GNN arm; bands: HYBRID_BANDS."""
    rows = world_rows(got, ref)

    def pair(stage: str, key: str):
        return _get(got.get(stage), key), _get(ref[stage], key)

    rows.append(exact_row("gnn.check.ok", *pair("gnn", "check.ok")))
    rows.append(band_row("gnn.check.mean_abs_delta", *pair("gnn", "check.mean_abs_delta"),
                         HYBRID_BANDS["mean_abs_delta"]))
    rows.append(exact_row("distill.shape", *pair("distill", "shape")))
    rows.append(_row("distill.fidelity.fidelity", *pair("distill", "fidelity.fidelity"),
                     "info", None))
    for stage, arms in (("gnn_eval", ("gnn_cos", "gnn_dot")),
                        ("gnn_eval_distilled", ("gnn_cos", "gnn_dot", "distill_cos"))):
        rows.append(exact_row(f"{stage}.n_eval_users", *pair(stage, "n_eval_users")))
        for arm in arms:
            for k in KS:
                key = f"{arm}.recall@{k}"
                gated = k == 100 and (stage == "gnn_eval") == (arm != "distill_cos")
                rows.append(band_row(f"{stage}.{key}", *pair(stage, key),
                                     HYBRID_BANDS["gnn_recall@100"]) if gated
                            else _row(f"{stage}.{key}", *pair(stage, key), "info", None))
    rows.append(exact_row("hybrid.hybrid_best.n_eval", *pair("hybrid", "hybrid_best.n_eval")))
    rows.append(band_row("hybrid.hybrid_best.recall@100", *pair("hybrid", "hybrid_best.recall@100"),
                         HYBRID_BANDS["hybrid_recall@100"]))
    history = _get(got.get("hybrid"), "hybrid_history") or []
    for epoch, ref_row in enumerate(ref["hybrid"]["hybrid_history"], start=1):
        got_row = history[epoch - 1] if epoch <= len(history) else {}
        rows.append(band_row(f"hybrid.hybrid_history.epoch{epoch}.recall@100",
                             got_row.get("recall@100"), ref_row["recall@100"],
                             HYBRID_BANDS["hybrid_recall@100"]))
    rows.append(exact_row("hybrid.gnn_arm", *pair("hybrid", "gnn_arm")))
    rows.append(band_row("hybrid.blend.best.recall@100",
                         *pair("hybrid", "blend.best_metrics.recall@100"),
                         HYBRID_BANDS["rerank_recall"]))
    rows.append(_row("hybrid.blend.best", *pair("hybrid", "blend.best"), "info", None))
    for key in ("pool_size", "train_users", "holdout_users", "pool_arms", "inner_split_day",
                "reranked.n_eval"):
        rows.append(exact_row(f"rerank_hybrid.{key}", *pair("rerank_hybrid", key)))
    pool = _get(ref["rerank_hybrid"], "pool_size")
    for key in ("reranked.recall@100", "reranked_dcn.recall@100",
                f"pool_ceiling.recall@{pool}"):
        rows.append(band_row(f"rerank_hybrid.{key}", *pair("rerank_hybrid", key),
                             HYBRID_BANDS["rerank_recall"]))
    for key in ("gbdt_auc", "dcn_auc"):
        rows.append(abs_band_row(f"rerank_hybrid.{key}", *pair("rerank_hybrid", key),
                                 HYBRID_BANDS["auc_abs"]))
    for key in ("reranked.recall@20", "reranked.recall@500", "significance.reranked.mean",
                "significance.reranked_vs_repurchase.delta"):
        rows.append(_row(f"rerank_hybrid.{key}", *pair("rerank_hybrid", key), "info", None))
    return verdict(rows)


def table_rows(name: str, got: dict | None, ref: dict) -> list[dict]:
    """The frozen table of one world against the JAX package's (TABLE_REF):
    its input bit for bit, its bits and abs-sum reported, its largest change
    in train-item."""
    got = got or {}
    abs_sum = got.get("abs_sum")
    return [exact_row(f"{name}.ppmi", got.get("ppmi"), ref["ppmi"]),
            _row(f"{name}.abs_sum", abs_sum, ref["abs_sum"], "info", None,
                 rel_gap=None if abs_sum is None else abs_sum / ref["abs_sum"] - 1),
            _row(f"{name}.sha256", got.get("sha256"), ref["sha256"], "info", None,
                 bits_equal=got.get("sha256") == ref["sha256"]),
            exact_row(f"{name}.max_change_after_train_item",
                      got.get("max_change_after_train_item"), 0.0)]


def sign_row(name: str, got, ref) -> dict:
    """An A/B's difference beside the JAX run's: ok when both have one sign."""
    ok = got is not None and ref is not None and got * ref > 0
    return _row(name, got, ref, "band", bool(ok))


def compare_stage1(got_ab: dict, ref_ab: dict, got: dict, ref: dict) -> dict:
    """Both worlds of ``--recipe stage1`` beside the committed runs. ``got_ab``
    and ``ref_ab`` hold the 5,000-item world's stage JSONs under AB_NAMES,
    ``got`` and ``ref`` the H&M world's under STAGE1_REFERENCE; ``got_ab`` and
    ``got`` also hold ``table`` (``frozen_table_check``) and, on the card,
    ``train_item`` (each arm's steps, graph replays and K1 launches)."""
    rows = [exact_row(f"ab.gen.{key}", _get(got_ab.get("gen"), key), _get(ref_ab["gen"], key))
            for key in GEN_KEYS]
    for arm in ARMS:
        etl = f"etl_{arm}"
        rows += [exact_row(f"ab.{etl}.{key}", _get(got_ab.get(etl), key), _get(ref_ab[etl], key))
                 for key in _leaves(ref_ab[etl]) if key != "command"]
    rows += [exact_row(f"ab.pretrain.{key}", _get(got_ab.get("pretrain"), key),
                       ref_ab["pretrain"][key]) for key in ("shape", "nonzero_rows")]
    rows += table_rows("ab.table", got_ab.get("table"), TABLE_REF["ab"])
    for arm in ARMS:
        rows.append(exact_row(f"ab.item_{arm}.steps", _get(got_ab.get(f"item_{arm}"), "steps"),
                              ref_ab[f"item_{arm}"]["steps"]))
    purity = {}
    for arm in ARMS:
        name = f"purity_{arm}"
        purity[arm] = (_get(got_ab.get(name), "knn_purity"), ref_ab[name]["knn_purity"])
        rows.append(band_row(f"ab.{name}", *purity[arm], BANDS["knn_purity"]))
        for key in ("within_cos", "cross_cos", "n_clusters"):
            rows.append(_row(f"ab.{name}.{key}", _get(got_ab.get(name), key), ref_ab[name][key],
                             "info", None))

    def diff(a, b):
        return None if a is None or b is None else a - b

    rows.append(sign_row("ab.purity_pretrained_minus_hash",
                         diff(purity["pretrained"][0], purity["hash"][0]),
                         diff(purity["pretrained"][1], purity["hash"][1])))

    rows += world_rows(got, ref)
    rows += [exact_row(f"pretrain.{key}", _get(got.get("pretrain"), key), ref["pretrain"][key])
             for key in ("shape", "nonzero_rows")]
    rows += table_rows("table", got.get("table"), TABLE_REF["hm"])
    rows.append(exact_row("item_pt.steps", _get(got.get("item_pt"), "steps"),
                          ref["item_pt"]["steps"]))
    rows.append(exact_row("vectorize_pt.shape", _get(got.get("vectorize_pt"), "shape"),
                          ref["vectorize_pt"]["shape"]))
    for name in ("knn_purity", "knn_purity_pt"):
        rows.append(band_row(name, _get(got.get(name), "knn_purity"), ref[name]["knn_purity"],
                             BANDS["knn_purity"]))
        for key in ("within_cos", "cross_cos"):
            pair = (_get(got.get(name), key), ref[name][key])
            rows.append(band_row(f"{name}.{key}", *pair, BANDS["knn_purity"])
                        if name == "knn_purity_pt" else
                        _row(f"{name}.{key}", *pair, "info", None))
        rows.append(_row(f"{name}.n_clusters", _get(got.get(name), "n_clusters"),
                         ref[name]["n_clusters"], "info", None))
    rows.append(sign_row("purity_pretrained_minus_hash",
                         diff(_get(got.get("knn_purity_pt"), "knn_purity"),
                              _get(got.get("knn_purity"), "knn_purity")),
                         ref["knn_purity_pt"]["knn_purity"] - ref["knn_purity"]["knn_purity"]))
    # on the card: every step after the warm-up a replay, each K1 kernel twice a step
    for world, runs in (("ab", got_ab.get("train_item") or {}), ("hm", got.get("train_item") or {})):
        for arm, run in runs.items():
            rows.append(exact_row(f"{world}.train_item_{arm}.graph_replays",
                                  run["graph_replays"], run["steps"] - WARMUP_STEPS))
            rows.append(exact_row(f"{world}.train_item_{arm}.k1_launches", run["k1_launches"],
                                  {k: 2 * run["steps"] for k in run["k1_launches"]}))
    return verdict(rows)


# -- the run ------------------------------------------------------------------

class CurveTail(threading.Thread):
    """Prints each eval row the trainer appends to ``metrics.jsonl``."""

    def __init__(self, path: str):
        super().__init__(daemon=True)
        self.path, self.rows, self.done = path, [], threading.Event()

    def poll(self) -> None:
        try:
            with open(self.path) as f:
                lines = [json.loads(ln) for ln in f if ln.strip()]
        except (OSError, json.JSONDecodeError):
            return
        evals = [r for r in lines if r.get("kind") == "eval"]
        for r in evals[len(self.rows):]:
            print(json.dumps({"epoch_eval": {k: r[k] for k in ("step", *[f"recall@{k}" for k in KS],
                                                                "n_eval") if k in r},
                              "t": r["t"]}), flush=True)
        self.rows = evals

    def run(self) -> None:
        while not self.done.wait(5.0):
            self.poll()


def http(base: str, method: str, path: str, payload=None):
    req = urllib.request.Request(
        base + path, method=method,
        data=None if payload is None else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return json.loads(resp.read())


def product_json(row: dict) -> dict:
    std = ("product_type_name", "graphical_appearance_name", "colour_group_name",
           "department_name", "section_name", "perceived_colour_value_name")
    rf = row.get("reinforced_feature") or {}
    return {"product_id": str(row["item_id"]), "product_name": row["product_name"],
            "feature_data": {
                "reinforced_feature": {key: [str(v) for v in vals]
                                       for key, vals in rf.items() if vals is not None},
                **{f: row.get(f) for f in std}}}


def history_batch(cfg, id_of: dict, events: list[tuple[str, float]]) -> dict:
    """One user's stage-2 batch from (item id, ts) events, newest last: ids,
    time buckets by days before the newest event, static features zero."""
    from recsys_tpu_torch.data.dataset import TIME_BUCKET_EDGES

    utc = cfg.user_tower
    L = utc.max_len
    events = events[-L:]
    k = len(events)
    b = {key: np.zeros((1, L), np.int64)
         for key in ("input_ids", "target_ids", "time_buckets", "seq_mask")}
    b["user_buckets"] = np.zeros((1, utc.static_bucket_fields), np.int64)
    b["user_cats"] = np.zeros((1, utc.static_cat_fields), np.int64)
    b["user_cont"] = np.zeros((1, utc.static_cont_fields), np.float32)
    b["input_ids"][0, L - k:] = [id_of[pid] for pid, _ in events]
    days = np.array([(events[-1][1] - ts) / 86400.0 for _, ts in events])
    b["time_buckets"][0, L - k:] = np.digitize(days, TIME_BUCKET_EDGES[1:])
    b["seq_mask"][0, L - k:] = 1
    return b


def ingest_catalog(base: str, root: str) -> dict:
    """The whole catalog into the server: ingest, process-pending (a few
    products), refresh-item-vectors (the rest); each step's seconds."""
    import pandas as pd

    out = {}
    items = pd.read_parquet(f"{root}/items.parquet").sort_values("item_id")
    records = items.to_dict("records")
    t0 = time.perf_counter()
    created = 0
    for s in range(0, len(records), 5000):
        created += http(base, "POST", "/api/controller/products/ingest",
                        {"products": [product_json(r) for r in records[s:s + 5000]]}
                        )["created"]
    out["ingest"] = {"products": created, "seconds": time.perf_counter() - t0}
    t0 = time.perf_counter()
    processed = sum(http(base, "POST", "/ai-api/serving/vectors/process-pending",
                         {})["processed_count"] for _ in range(2))
    out["process_pending"] = {"products": processed, "seconds": time.perf_counter() - t0}
    t0 = time.perf_counter()
    refreshed = http(base, "POST", "/ai-api/serving/bg/inference/refresh-item-vectors", {})
    out["refresh_item_vectors"] = {**refreshed, "seconds": time.perf_counter() - t0}
    if created != len(records) or refreshed.get("count") != len(records):
        raise RuntimeError(f"serve: catalog {len(records)}, ingested {created}, "
                           f"refreshed {refreshed}")
    return out


def post_histories(base: str, seqs, users: list[str], id_of: dict) -> dict:
    """Each user's training sequence but its last item as store events
    (``insert-manual-data``): events at (day 400 - days before the last
    event), a second apart. Returns the (item id, ts) events by user."""
    histories = {}
    for uid in users:
        rec = seqs.loc[uid]
        seq, deltas = list(rec["sequence"])[:-1], list(rec["sequence_deltas"])[:-1]
        histories[uid] = [(str(i), 86400.0 * (400 - d) + j)
                          for j, (i, d) in enumerate(zip(seq, deltas)) if str(i) in id_of]
        http(base, "POST", "/api/v1/debug/insert-manual-data", {
            "users": [{"user_id": uid}],
            "sessions": [{"user_id": uid, "events": [
                {"product_id": pid, "action_type": 3, "ts": ts}
                for pid, ts in histories[uid]]}]})
    return histories


def latency_row(ms: list[float]) -> dict:
    return {"p50_ms": float(np.percentile(ms, 50)), "p95_ms": float(np.percentile(ms, 95)),
            "requests": len(ms)}


def serve_stage(sets: list[str], root: str, n_users: int, device: str) -> dict:
    """``serve --model-backed`` with the stage-2 tower behind the HTTP server."""
    import pandas as pd

    from recsys_tpu_torch.data.dataset import IdMap, build_sasrec_tensors
    from recsys_tpu_torch.serve.server import make_server, serve_forever_in_thread
    from recsys_tpu_torch.train.checkpoint import load_array_with_ids
    from recsys_tpu_torch.train.sasrec import restore_stage2, tensors_to

    t_start = time.perf_counter()
    args = cli.parse_args(["serve", *sets, "--model-backed"])
    cfg = cli.config_from_args(args)
    ctx = cli.build_app(cfg, args)
    if ctx.user_backend != "stage-2 tower (best checkpoint)" or ctx.rec_assets is None:
        raise RuntimeError(f"serve: user backend {ctx.user_backend!r}, "
                           f"assets {ctx.rec_assets is not None}")
    build_s = time.perf_counter() - t_start
    uvecs, uv_ids, _ = load_array_with_ids(f"{root}/eval_uvecs")
    mat, mat_ids, _ = load_array_with_ids(f"{root}/eval_item_matrix")
    item_ids = mat_ids[1:]
    id_of = {str(p): r for r, p in enumerate(mat_ids)}
    _, user_vectors, _ = restore_stage2(cfg, {"item_map": item_ids}, f"{root}/ckpt_user", device)
    users = [str(u) for u in np.random.default_rng(0).choice(
        np.asarray(uv_ids, dtype=object), min(n_users, len(uv_ids)), replace=False)]
    row_of_user = {str(u): r for r, u in enumerate(uv_ids)}
    seqs = pd.read_parquet(f"{root}/features_sequence.parquet")
    seqs["user_id"] = seqs["user_id"].astype(str)
    seqs = seqs[seqs["user_id"].isin(set(users))].set_index("user_id")
    L = cfg.user_tower.max_len   # stage 2's sequences: the last L events of the ETL's
    seqs["sequence"] = [list(q)[-L:] for q in seqs["sequence"]]
    seqs["sequence_deltas"] = [list(q)[-L:] for q in seqs["sequence_deltas"]]
    server = make_server(ctx, host="127.0.0.1", port=0)
    thread = serve_forever_in_thread(server)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    out: dict = {"build_s": build_s}
    try:
        out.update(ingest_catalog(base, root))
        histories = post_histories(base, seqs, users, id_of)
        t0 = time.perf_counter()
        done = http(base, "POST", "/ai-api/serving/users/process-pending", {})
        out["users_process_pending"] = {**done, "seconds": time.perf_counter() - t0}
        if done["processed_count"] != len(users):
            raise RuntimeError(f"serve: users process-pending {done}")
        tower_err, eval_err = [], []
        for uid in users:
            served = ctx.store.get_user_vector(uid)
            want = user_vectors(tensors_to(history_batch(cfg, id_of, histories[uid]), device))
            tower_err.append(float(np.abs(served - want.float().cpu().numpy()[0]).max()))
            eval_err.append(float(np.abs(served - uvecs[row_of_user[uid]]).max()))
        # the same tower on these users' stage-2 rows, rebuilt here from the ETL's
        # sequences and user features: eval_uvecs again
        rows = build_sasrec_tensors(seqs.reset_index(),
                                    pd.read_parquet(f"{root}/features_user.parquet"),
                                    IdMap(item_ids), cfg.user_tower)
        again = user_vectors(tensors_to(rows, device)).float().cpu().numpy()
        rows_err = max(float(np.abs(again[r] - uvecs[row_of_user[str(u)]]).max())
                       for r, u in enumerate(rows["user_ids"]))
        for key in ("user_buckets", "user_cats", "user_cont"):   # what the server lacks
            rows[key] = np.zeros_like(rows[key])
        bare = user_vectors(tensors_to(rows, device)).float().cpu().numpy()
        bare_err = max(float(np.abs(bare[r] - ctx.store.get_user_vector(str(u))).max())
                       for r, u in enumerate(rows["user_ids"]))
        if len(rows["user_ids"]) != len(users):
            raise RuntimeError(f"serve: {len(rows['user_ids'])} stage-2 rows for {len(users)}")
        latency = {}
        for mode in ("cosine", "blend"):
            ms = []
            for uid in users:
                t0 = time.perf_counter()
                rec = http(base, "GET", f"/api/controller/recommendations/{uid}"
                                        f"?top_k=20&mode={mode}")
                ms.append(1e3 * (time.perf_counter() - t0))
                res = rec.get("results", [])
                if not (0 < len(res) <= 20) or any(r["product_id"] in (None, "<pad>")
                                                    for r in res):
                    raise RuntimeError(f"serve: {mode} recommendations for {uid}: {rec}")
                if mode == "blend" and rec.get("mode") != "blend":
                    raise RuntimeError(f"serve: blend answered as {rec}")
            latency[mode] = latency_row(ms)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    out.update({"users": len(users), "catalog_rows": int(mat.shape[0]),
                "served_vs_tower_err": max(tower_err), "stage2_rows_vs_eval_uvecs_err": rows_err,
                "served_vs_eval_uvecs_err": max(eval_err),
                "served_vs_stage2_rows_without_statics_err": bare_err,
                "served_vs_eval_uvecs_err_median": float(np.median(eval_err)),
                "latency": latency, "seconds": time.perf_counter() - t_start})
    return out


def serve_hybrid_stage(sets: list[str], root: str, n_users: int, device: str) -> dict:
    """``serve --model-backed --vectors hybrid`` behind the HTTP server: the
    hybrid tower as the user vectorizer, the hybrid matrix and the rerank GBDT
    as the serving assets."""
    import pandas as pd

    from recsys_tpu_torch.data.dataset import IdMap
    from recsys_tpu_torch.serve import recommend as RC
    from recsys_tpu_torch.serve.server import make_server, serve_forever_in_thread
    from recsys_tpu_torch.train import hybrid as H
    from recsys_tpu_torch.train.sasrec import tensors_to

    t_start = time.perf_counter()
    args = cli.parse_args(["serve", *sets, "--model-backed", "--vectors", "hybrid"])
    cfg = cli.config_from_args(args)
    ctx = cli.build_app(cfg, args)
    assets = ctx.rec_assets
    if (ctx.user_backend != "hybrid tower (best checkpoint)" or assets is None
            or assets.ranker is None or assets.vectors != "hybrid"):
        raise RuntimeError(f"serve: user backend {ctx.user_backend!r}, assets "
                           f"{None if assets is None else (assets.vectors, assets.ranker)}")
    build_s = time.perf_counter() - t_start
    # the tower and the GNN rows, restored here apart from the server's code
    item_map = IdMap(assets.item_ids)
    stub = {"item_map": item_map, "logq": np.zeros(len(item_map) + 1, np.float32)}
    content, gnn_items, gu, gu_ids = cli._hybrid_inputs(cfg, stub)
    _, user_vectors, _ = H.restore_hybrid(cfg, stub, content, gnn_items,
                                          f"{root}/ckpt_hybrid", device)
    gnn_of = {str(u): gu[r] for r, u in enumerate(gu_ids)}
    id_of = {p: r for r, p in enumerate(["<pad>", *assets.item_ids])}
    with open(f"{root}/targets_val.json") as f:
        targets = json.load(f)
    seqs = pd.read_parquet(f"{root}/features_sequence.parquet")
    seqs["user_id"] = seqs["user_id"].astype(str)
    pool = sorted(set(targets) & set(gnn_of) & set(seqs["user_id"]))
    users = [str(u) for u in np.random.default_rng(0).choice(
        np.asarray(pool, dtype=object), min(n_users, len(pool)), replace=False)]
    seqs = seqs[seqs["user_id"].isin(set(users))].set_index("user_id")
    L = cfg.user_tower.max_len
    seqs["sequence"] = [list(q)[-L:] for q in seqs["sequence"]]
    seqs["sequence_deltas"] = [list(q)[-L:] for q in seqs["sequence_deltas"]]
    server = make_server(ctx, host="127.0.0.1", port=0)
    thread = serve_forever_in_thread(server)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    out: dict = {"build_s": build_s}
    try:
        out.update(ingest_catalog(base, root))
        histories = post_histories(base, seqs, users, id_of)
        t0 = time.perf_counter()
        done = http(base, "POST", "/ai-api/serving/users/process-pending", {})
        out["users_process_pending"] = {**done, "seconds": time.perf_counter() - t0}
        if done["processed_count"] != len(users):
            raise RuntimeError(f"serve: users process-pending {done}")
        tower_err, rerank_equal = [], 0
        for uid in users:
            served = ctx.store.get_user_vector(uid)
            want = user_vectors(tensors_to(history_batch(cfg, id_of, histories[uid]), device),
                                torch.as_tensor(gnn_of[uid][None], device=device))
            tower_err.append(float(np.abs(served - want.float().cpu().numpy()[0]).max()))
        latency, lists = {}, {}
        for mode in ("rerank", "blend", "cosine"):
            ms = []
            for uid in users:
                t0 = time.perf_counter()
                rec = http(base, "GET", f"/api/controller/recommendations/{uid}"
                                        f"?top_k=20&mode={mode}")
                ms.append(1e3 * (time.perf_counter() - t0))
                res = rec.get("results", [])
                if (not (0 < len(res) <= 20) or rec.get("mode", "cosine") != mode
                        or any(r["product_id"] in (None, "<pad>") for r in res)):
                    raise RuntimeError(f"serve: {mode} recommendations for {uid}: {rec}")
                lists[mode, uid] = [r["product_id"] for r in res]
            latency[mode] = latency_row(ms)
        for uid in users:   # the HTTP rerank list against the offline recipe's
            events = ctx.store.user_histories([uid])[uid]
            iidx, days = RC.store_events_arrays(assets, events)
            offline = RC.rerank_serve_topk(
                assets, ctx.store.get_user_vector(uid)[None], [(iidx, days)],
                int(days.max()) + 1, 20, pool_size=cfg.serve.rerank_pool,
                m_cos=cfg.serve.rerank_m_cos, m_pop=cfg.serve.rerank_m_pop)
            rerank_equal += lists["rerank", uid] == [assets.pid_of(int(r)) for r in offline[0]
                                                     if int(r) != 0]
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    out.update({"users": len(users), "catalog_rows": len(assets.item_ids) + 1,
                "served_vs_tower_err": max(tower_err),
                "rerank_equal_offline": rerank_equal, "latency": latency,
                "seconds": time.perf_counter() - t_start})
    return out


def link_world(src: str, dst: str, names: tuple) -> None:
    """A second data root over the same world: ``names`` of ``src`` linked
    into ``dst`` (``scripts/quality_hm_v4_stage1.sh:46-51``)."""
    os.makedirs(dst, exist_ok=True)
    for name in names:
        if not os.path.lexists(f"{dst}/{name}"):
            os.symlink(os.path.abspath(f"{src}/{name}"), f"{dst}/{name}")


def frozen_table_check(root: str, sets: list[str]) -> dict:
    """The pretrain-text table of ``root`` (``sets``: its stage's overrides):
    its checksums and its input's, and its largest change in train-item's
    best and latest checkpoints (0.0: frozen)."""
    from recsys_tpu_torch.data.text_pretrain import (load_text_pretrain, ppmi_checksum,
                                                     ppmi_matrix, table_checksum)
    from recsys_tpu_torch.train.checkpoint import CheckpointStore

    cfg = cli.config_from_args(cli.parse_args(["pretrain-text", *sets]))
    m = ppmi_matrix(cli._item_tensors(cfg), cfg.vocab.text_vocab_size)
    art = load_text_pretrain(f"{root}/text_pretrain.npz")
    store = CheckpointStore(f"{root}/ckpt_item", maximize=False)
    change = max(float(np.abs(payload["model"][TABLE_KEY].float().numpy() - art).max())
                 for payload, _ in (store.restore_best("cpu"), store.restore_latest("cpu")))
    return {**table_checksum(art), "ppmi": ppmi_checksum(m),
            "max_change_after_train_item": change}


def serve_items_stage(sets: list[str], root: str, n_requests: int, device: str) -> dict:
    """``serve --model-backed`` with ``root``'s item encoder behind the HTTP
    server: the catalog in (``ingest_catalog``), every served vector against
    vectorize's matrix, then ``n_requests`` similarity requests against the
    exact top hits of that matrix."""
    from recsys_tpu_torch.serve.server import make_server, serve_forever_in_thread
    from recsys_tpu_torch.train.checkpoint import load_array_with_ids

    t_start = time.perf_counter()
    args = cli.parse_args(["serve", *sets, "--model-backed"])
    ctx = cli.build_app(cli.config_from_args(args), args)
    build_s = time.perf_counter() - t_start
    mat, ids, _ = load_array_with_ids(f"{root}/item_matrix")
    row_of = {str(p): r for r, p in enumerate(ids)}
    queries = [str(p) for p in np.random.default_rng(0).choice(
        np.asarray(ids[1:], dtype=object), min(n_requests, len(ids) - 1), replace=False)]
    server = make_server(ctx, host="127.0.0.1", port=0)
    thread = serve_forever_in_thread(server)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    out: dict = {"build_s": build_s}
    try:
        out.update(ingest_catalog(base, root))
        served_ids, served = ctx.store.all_vectors()
        served_err = float(np.abs(served - mat[[row_of[p] for p in served_ids]]).max())
        ms, score_err, leading, best_hit = [], 0.0, 0, 0
        for pid in queries:
            t0 = time.perf_counter()
            res = http(base, "GET", f"/api/controller/similarity/{pid}?top_k=10")["results"]
            ms.append(1e3 * (time.perf_counter() - t0))
            if not (0 < len(res) <= 10) or any(r["product_id"] == pid for r in res):
                raise RuntimeError(f"serve: similarity for {pid}: {res}")
            row = row_of[pid]
            for r in res:
                score_err = max(score_err, abs(r["score"] - float(mat[row] @ mat[row_of[
                    r["product_id"]]])))
            scores = mat[1:] @ mat[row]
            scores[row - 1] = -np.inf
            top2 = np.argsort(-scores, kind="stable")[:2]
            if scores[top2[0]] - scores[top2[1]] > SERVE_TOL:
                leading += 1
                best_hit += res[0]["product_id"] == str(ids[top2[0] + 1])
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    out.update({"catalog_rows": int(mat.shape[0]), "served_vs_vectorize_err": served_err,
                "similarity_requests": len(queries), "similarity_score_err": score_err,
                "similarity_leading_best": leading, "similarity_best_hit_first": best_hit,
                "latency": {"similarity": latency_row(ms)},
                "seconds": time.perf_counter() - t_start})
    return out


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--recipe", choices=("main", "hybrid", "stage1"), default="main")
    parser.add_argument("--out", default=os.path.join(REPO, "chiprun_out", "torch_quality_hm"))
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--root", default=None, help="data root (default: a fresh temp dir)")
    parser.add_argument("--budget-s", type=float, default=3350.0, dest="budget_s")
    parser.add_argument("--reserve-s", type=float, default=1200.0, dest="reserve_s",
                        help="seconds kept for eval and serve after train-user "
                             "(905 s at the H&M scale on an H100)")
    parser.add_argument("--user-epochs", type=int, default=25, dest="user_epochs")
    parser.add_argument("--item-epochs", type=int, default=3, dest="item_epochs")
    parser.add_argument("--requests", type=int, default=20)
    parser.add_argument("--set", action="append", default=[], dest="sets",
                        help="more overrides after the world's (a smaller world for a test)")
    parser.add_argument("--compare", default=None, metavar="DIR",
                        help="no run: a cut --recipe hybrid run's stage JSONs in DIR against "
                             "the committed JAX run")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.compare:
        return compare_cut_hybrid(args.compare)
    start = time.time()
    os.makedirs(args.out, exist_ok=True)
    on_card = args.device.startswith("cuda")
    card = card_line() if on_card else "cpu"
    print(card, flush=True)
    root = args.root or tempfile.mkdtemp(prefix="torch_quality_hm_")
    world = ["--set", f"data.root={root}", *WORLD]
    extra = [*[a for kv in args.sets for a in ("--set", kv)], "--device", args.device]
    sets = [*world, *extra]
    got: dict = {}
    stages: dict = {}

    def stage(name: str, argv_: list[str], device_memory: bool = False) -> dict:
        if on_card and device_memory:
            torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        S.reset_launch_counts()
        t0 = time.perf_counter()
        out = cli.main(argv_)
        seconds = time.perf_counter() - t0
        rec = {"seconds": seconds, "peak_rss_gib": peak_rss_gib(),
               "k1_launches": dict(K.LAUNCHES), "k2_launches": dict(S.LAUNCHES),
               **{k: out[k] for k in ("steps", "graph_replays", "step_ms_median") if k in out}}
        if on_card and device_memory:
            rec["peak_device_gib"] = torch.cuda.max_memory_allocated() / 2**30
        stages[name] = rec
        print(json.dumps({"stage": name, **rec}), flush=True)
        got[name] = {k: v for k, v in out.items() if k != "losses"} | {"command": argv_[0]}
        path = os.path.join(args.out, f"{name}.json")     # "ab/gen": a subdirectory
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump({"command": argv_[0], **out}, f, default=str)
        return out

    if args.recipe == "stage1":
        return stage1_recipe(args, stage, stages, got, root, extra, card, start)
    stage("gen", ["gen-data", *sets])
    stage("etl", ["etl", *sets])
    item = stage("item", ["train-item", *sets, "--set", f"simcse.epochs={args.item_epochs}"],
                 device_memory=True)
    stage("vectorize", ["vectorize", *sets])
    if args.recipe == "hybrid":
        return hybrid_recipe(args, stage, stages, got, root, (world, extra), card, start, item)
    t0 = time.perf_counter()
    got["knn_purity"] = purity_stage(root, args.device)
    stages["knn_purity"] = {"seconds": time.perf_counter() - t0}
    print(json.dumps(got["knn_purity"]), flush=True)
    with open(os.path.join(args.out, "knn_purity.json"), "w") as f:
        json.dump(got["knn_purity"], f)

    deadline = start + args.budget_s - args.reserve_s
    tail = CurveTail(os.path.join(root, "ckpt_user", "metrics.jsonl"))
    tail.start()
    try:
        user = stage("user", ["train-user", *sets, "--set", f"user_train.epochs={args.user_epochs}",
                              "--set", "user_train.ckpt_every=5", "--deadline", str(deadline)],
                     device_memory=True)
    finally:
        tail.done.set()
        tail.join()
        tail.poll()
    got["curve"] = [{"step": r["step"], **{f"recall@{k}": r.get(f"recall@{k}") for k in KS},
                     "n_eval": r.get("n_eval")} for r in tail.rows]
    with open(os.path.join(args.out, "user_curve.json"), "w") as f:
        json.dump({"world": "torch_quality_hm_v4", "epochs_target": args.user_epochs,
                   "completed": len(got["curve"]) == args.user_epochs,
                   "curve": got["curve"]}, f, indent=1)
    best = user["best"]
    got["eval_epoch"] = next((r["step"] for r in got["curve"]
                              if r.get("recall@100") == best.get("recall@100")), None)
    ev = stage("eval", ["eval", *sets])
    serve = serve_stage([*sets, "--set", "serve.db_path=:memory:",
                         "--set", "serve.user_backend=stage2"], root, args.requests, args.device)
    stages["serve"] = {"seconds": serve["seconds"], "peak_rss_gib": peak_rss_gib()}
    print(json.dumps({"stage": "serve", **serve}), flush=True)
    with open(os.path.join(args.out, "serve.json"), "w") as f:
        json.dump(serve, f)

    result = compare(got, load_reference())
    for key in ("served_vs_tower_err", "stage2_rows_vs_eval_uvecs_err"):
        ok = serve[key] <= SERVE_TOL
        result["comparisons"].append(_row(f"serve.{key}", serve[key], None, "exact", ok,
                                          tol=SERVE_TOL))
        result["exact_ok"] = result["exact_ok"] and ok
        if not ok:
            result["misses"].append(f"serve.{key}")
    result["comparisons"].append(_row("serve.served_vs_eval_uvecs_err",
                                      serve["served_vs_eval_uvecs_err"], None, "info", None,
                                      bound=SERVE_TOL))
    steady = (lambda ms, b: {"step_ms_median": ms, "examples_per_s": b / ms * 1e3 if ms else None})
    cfg = cli.config_from_args(cli.parse_args(["eval", *sets]))
    summary = {
        "card": card, "device": args.device, "epochs_run": len(got["curve"]),
        "epochs_target": args.user_epochs, "stages": stages,
        "train_item": {"steps": item["steps"], **steady(item["step_ms_median"],
                                                        cfg.simcse.batch_size)},
        "train_user": {"steps": user["steps"], "epoch_losses": user["epoch_losses"],
                       **steady(user["step_ms_median"], cfg.user_train.batch_size)},
        "eval_seconds": ev.get("seconds"), "eval_step_ms_median": ev.get("step_ms_median"),
        "serve_latency": serve["latency"], "peak_rss_gib": peak_rss_gib(),
        "seconds": time.time() - start, **result}
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(card, flush=True)
    print(json.dumps(summary), flush=True)
    return 0 if result["exact_ok"] else 1


def k1_gnn_launches(steps: int) -> dict:
    """K1's launches in ``steps`` LightGCL steps on the card: each kernel
    twice a step, once for the users' SSL loss and once for the items'."""
    return {name: 2 * steps for name in K.LAUNCHES}


def hybrid_replay_rows(got: dict) -> list[dict]:
    """On the card every step after the warm-up is a graph replay: LightGCL,
    distill, the hybrid tower and rerank-eval's DCN arm."""
    rr = got["rerank_hybrid"]
    return [exact_row(name, replays, steps - WARMUP_STEPS) for name, replays, steps in (
        *((f"{k}.graph_replays", got[k]["graph_replays"], got[k]["steps"])
          for k in ("gnn", "distill", "hybrid")),
        ("rerank_hybrid.dcn_graph_replays", rr.get("dcn_graph_replays"),
         rr.get("dcn_steps", WARMUP_STEPS)))]


def compare_cut_hybrid(run_dir: str) -> int:
    """``--compare DIR``: the hybrid recipe's rows of a card run cut before
    its summary (by the call's time limit), from the stage JSONs it wrote to
    DIR, against the committed JAX run; the serve stage's rows need the run
    itself. The launch row is train-gnn's own count: K2 4 a step (the
    stage's also holds the export's and the check's) and, where the run's
    SSL losses took K1 (``ssl_route`` "diag_ce"), each K1 kernel 2 a step;
    a run made before they did names no route and launched no K1. Writes
    DIR/summary.json; exit 1 if an exact gate misses."""
    got = load_reference(run_dir, HYBRID_REFERENCE)
    result = compare_hybrid(got, load_reference(names=HYBRID_REFERENCE))
    steps = got["gnn"]["steps"]
    k1 = k1_gnn_launches(steps) if got["gnn"].get("ssl_route") == "diag_ce" else {}
    rows = [exact_row("gnn.launches", got["gnn"]["launches"],
                      {"spmm_csr": 4 * steps, **k1}), *hybrid_replay_rows(got)]
    result["comparisons"] += rows
    result["exact_ok"] = result["exact_ok"] and all(r["ok"] for r in rows)
    result["misses"] += [r["name"] for r in rows if not r["ok"]]
    summary = {"recipe": "hybrid", "cut_before": "serve", "run_dir": run_dir,
               "init_seconds": got["gnn"].get("init_seconds"), **result}
    with open(os.path.join(run_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    return 0 if result["exact_ok"] else 1


def hybrid_recipe(args, stage, stages: dict, got: dict, root: str, world_extra: tuple,
                  card: str, start: float, item: dict) -> int:
    """The headline chain after vectorize (see the module docstring), its
    summary against the committed run; the exit code. ``world_extra``: the
    world's overrides and the caller's (``--set``, ``--device``), between
    which the recipe's own go."""
    world, extra = world_extra
    sets = [*world, *extra]

    def run(name: str, argv_: list[str], recipe: list[str], **kw) -> dict:
        return stage(name, [argv_[0], *world, *recipe, *extra, *argv_[1:]], **kw)

    gnn = run("gnn", ["train-gnn"], ["--set", "gnn.epochs=1",
                                     "--set", "gnn.steps_per_epoch_max=1500"],
              device_memory=True)
    run("gnn_eval", ["gnn-eval"], [])
    run("distill", ["distill"], [])
    run("gnn_eval_distilled", ["gnn-eval"], [])
    hybrid = run("hybrid", ["train-hybrid"], ["--set", "user_train.epochs=2",
                                              "--set", "user_train.ckpt_every=1"],
                 device_memory=True)
    run("rerank_hybrid", ["rerank-eval", "--vectors", "hybrid"], [])
    serve = serve_hybrid_stage([*sets, "--set", "serve.db_path=:memory:",
                                "--set", "serve.user_backend=hybrid"], root, args.requests,
                               args.device)
    stages["serve"] = {"seconds": serve["seconds"], "peak_rss_gib": peak_rss_gib()}
    print(json.dumps({"stage": "serve", **serve}), flush=True)
    with open(os.path.join(args.out, "serve.json"), "w") as f:
        json.dump(serve, f)

    result = compare_hybrid(got, load_reference(names=HYBRID_REFERENCE))
    rows = [_row("serve.served_vs_tower_err", serve["served_vs_tower_err"], None, "exact",
                 serve["served_vs_tower_err"] <= SERVE_TOL),
            _row("serve.rerank_equal_offline", serve["rerank_equal_offline"], None, "exact",
                 serve["rerank_equal_offline"] == serve["users"])]
    if args.device.startswith("cuda"):
        rows.append(exact_row("gnn.k2_launches", stages["gnn"]["k2_launches"],
                              {"spmm_csr": 4 * gnn["steps"] + 2 * 2}))
        rows.append(exact_row("gnn.k1_launches", stages["gnn"]["k1_launches"],
                              k1_gnn_launches(gnn["steps"])))
        rows += hybrid_replay_rows(got)
    for row in rows:
        result["comparisons"].append(row)
        result["exact_ok"] = result["exact_ok"] and row["ok"]
        if not row["ok"]:
            result["misses"].append(row["name"])
    cfg = cli.config_from_args(cli.parse_args(["train-hybrid", *sets]))
    gnn_steps = gnn["steps"]
    summary = {
        "card": card, "device": args.device, "recipe": "hybrid", "stages": stages,
        "train_item": {"steps": item["steps"], "graph_replays": item["graph_replays"],
                       "step_ms_median": item["step_ms_median"],
                       "k1_launches": stages["item"]["k1_launches"]},
        "train_gnn": {"steps": gnn_steps, "graph_replays": gnn["graph_replays"],
                      "step_ms_median": gnn["step_ms_median"], "train_seconds": gnn["seconds"],
                      "graph": gnn["graph"], "k1_launches": stages["gnn"]["k1_launches"],
                      "k2_launches": stages["gnn"]["k2_launches"],
                      "k2_launches_per_step": (sum(stages["gnn"]["k2_launches"].values())
                                               / gnn_steps if gnn_steps else None),
                      "peak_device_gib": stages["gnn"].get("peak_device_gib")},
        "distill": {k: got["distill"][k] for k in ("steps", "graph_replays", "step_ms_median",
                                                   "seconds", "launches")},
        "rerank_dcn": {k: got["rerank_hybrid"].get(k) for k in (
            "dcn_steps", "dcn_graph_replays", "dcn_step_ms_median", "dcn_seconds",
            "dcn_launches")},
        "rerank_seconds_split": got["rerank_hybrid"].get("seconds_split"),
        "gnn_eval": {"k2_launches": stages["gnn_eval"]["k2_launches"],
                     "k2_launches_distilled": stages["gnn_eval_distilled"]["k2_launches"]},
        "train_hybrid": {"steps": hybrid["steps"], "graph_replays": hybrid["graph_replays"],
                         "step_ms_median": hybrid["step_ms_median"],
                         "examples_per_s": (cfg.user_train.batch_size / hybrid["step_ms_median"]
                                            * 1e3 if hybrid["step_ms_median"] else None),
                         "epoch_losses": hybrid["epoch_losses"],
                         "train_seconds": hybrid["seconds"],
                         "report_seconds": hybrid.get("report_seconds"),
                         "report_seconds_split": hybrid.get("report_seconds_split"),
                         "peak_device_gib": stages["hybrid"].get("peak_device_gib")},
        "serve_latency": serve["latency"], "peak_rss_gib": peak_rss_gib(),
        "seconds": time.time() - start, **result}
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(card, flush=True)
    print(json.dumps(summary), flush=True)
    return 0 if result["exact_ok"] else 1


def stage1_recipe(args, stage, stages: dict, got: dict, root: str, extra: list[str],
                  card: str, start: float) -> int:
    """Both arms of the stage-1 A/B at 5,000 items, then at the H&M world (see
    the module docstring); the summary against the committed runs, the exit
    code. ``extra``: the caller's overrides (``--set``, ``--device``)."""
    on_card = args.device.startswith("cuda")
    epochs = ["--set", f"simcse.epochs={args.item_epochs}"]

    def purity(name: str, data_root: str, sample: int) -> None:
        t0 = time.perf_counter()
        got[name] = purity_stage(data_root, args.device, sample)
        stages[name] = {"seconds": time.perf_counter() - t0}
        print(json.dumps({"stage": name, **got[name]}), flush=True)
        with open(os.path.join(args.out, f"{name}.json"), "w") as f:
            json.dump(got[name], f)

    def trained(name: str, data_root: str, sets_: list[str] | None = None) -> dict:
        run = {k: stages[name][k] for k in ("steps", "graph_replays", "step_ms_median",
                                             "k1_launches")}
        if sets_ is not None:         # the pretrained arm
            run["table"] = frozen_table_check(data_root, sets_)
            print(json.dumps({"stage": name, "frozen_table": run["table"]}), flush=True)
        return run

    # (a) the 5,000-item world, each arm in its own data root over one world
    roots = {arm: f"{root}/ab/world_{arm}" for arm in ARMS}
    ab_runs = {}

    def ab_sets(arm: str) -> list[str]:
        return ["--set", f"data.root={roots[arm]}", *AB_WORLD,
                "--set", f"item_tower.text_encoder={arm}", *extra]

    stage("ab/gen", ["gen-data", *ab_sets("hash")])
    link_world(roots["hash"], roots["pretrained"], WORLD_FILES)
    for arm in ARMS:
        stage(f"ab/etl_{arm}", ["etl", *ab_sets(arm)])
        if arm == "pretrained":
            stage("ab/pretrain", ["pretrain-text", *ab_sets(arm)])
        stage(f"ab/item_{arm}", ["train-item", *ab_sets(arm), *epochs], device_memory=True)
        ab_runs[arm] = trained(f"ab/item_{arm}", roots[arm],
                               ab_sets(arm) if arm == "pretrained" else None)
        stage(f"ab/vectorize_{arm}", ["vectorize", *ab_sets(arm)])
        purity(f"ab/purity_{arm}", roots[arm], 0)

    # (b) the H&M world: arm A in ``root``, arm B in ``root``/world_pt over its files
    root_pt = f"{root}/world_pt"
    sets = ["--set", f"data.root={root}", *WORLD, *extra]
    sets_pt = ["--set", f"data.root={root_pt}", *WORLD,
               "--set", "item_tower.text_encoder=pretrained", *extra]
    stage("gen", ["gen-data", *sets])
    stage("etl", ["etl", *sets])
    stage("item", ["train-item", *sets, *epochs], device_memory=True)
    hm_runs = {"hash": trained("item", root)}
    stage("vectorize", ["vectorize", *sets])
    purity("knn_purity", root, 8192)
    link_world(root, root_pt, WORLD_FILES + ETL_FILES)
    stage("pretrain", ["pretrain-text", *sets_pt])
    stage("item_pt", ["train-item", *sets_pt, *epochs], device_memory=True)
    hm_runs["pretrained"] = trained("item_pt", root_pt, sets_pt)
    stage("vectorize_pt", ["vectorize", *sets_pt])
    purity("knn_purity_pt", root_pt, 8192)
    serve = serve_items_stage([*sets_pt, "--set", "serve.db_path=:memory:",
                               "--set", "serve.user_backend=history"], root_pt,
                              args.requests, args.device)
    stages["serve"] = {"seconds": serve["seconds"], "peak_rss_gib": peak_rss_gib()}
    print(json.dumps({"stage": "serve", **serve}), flush=True)
    with open(os.path.join(args.out, "serve.json"), "w") as f:
        json.dump(serve, f)

    got_ab = {name[3:]: value for name, value in got.items() if name.startswith("ab/")}
    got_ab["table"] = ab_runs["pretrained"]["table"]
    got["table"] = hm_runs["pretrained"]["table"]
    if on_card:
        got_ab["train_item"], got["train_item"] = ab_runs, hm_runs
    result = compare_stage1(got_ab, load_reference(AB_REFERENCE, AB_NAMES), got,
                            load_reference(names=STAGE1_REFERENCE))
    for name, value, ok in (
            ("serve.served_vs_vectorize_err", serve["served_vs_vectorize_err"],
             serve["served_vs_vectorize_err"] <= SERVE_TOL),
            ("serve.similarity_score_err", serve["similarity_score_err"],
             serve["similarity_score_err"] <= SERVE_TOL),
            ("serve.similarity_best_hit_first", serve["similarity_best_hit_first"],
             serve["similarity_best_hit_first"] == serve["similarity_leading_best"])):
        result["comparisons"].append(_row(name, value, None, "exact", ok, tol=SERVE_TOL))
        result["exact_ok"] = result["exact_ok"] and ok
        if not ok:
            result["misses"].append(name)
    summary = {
        "card": card, "device": args.device, "recipe": "stage1", "stages": stages,
        "train_item": {"ab": ab_runs, "hm": hm_runs},
        "purity": {"ab": {arm: got_ab[f"purity_{arm}"]["knn_purity"] for arm in ARMS},
                   "hm": {"hash": got["knn_purity"]["knn_purity"],
                          "pretrained": got["knn_purity_pt"]["knn_purity"]}},
        "serve": {k: serve[k] for k in ("served_vs_vectorize_err", "similarity_score_err",
                                        "similarity_leading_best", "similarity_best_hit_first",
                                        "latency")},
        "peak_rss_gib": peak_rss_gib(), "seconds": time.time() - start, **result}
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(card, flush=True)
    print(json.dumps(summary), flush=True)
    return 0 if result["exact_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
