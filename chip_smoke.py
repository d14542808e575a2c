"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds kernels K1 (recsys_tpu_torch/csrc/diag_ce.cu), K2
(recsys_tpu_torch/csrc/spmm.cu) and K3 (recsys_tpu_torch/csrc/fm.cu) for
sm_90a from the checkout, all at once, then:

  1. kernel vs plain: K1's forward and both backward kernels against their
     plain PyTorch forms on the card, at the SimCSE shape (B=192, D=128),
     the stage-2 LogQ form (B=200 ragged and B=768, with LogQ corrections,
     same-item and same-user collisions and ~10% invalid columns) and
     B=8192. Tolerances are the JAX suite's: loss 1e-4, grads 1e-5 (abs).
     CUDA-event times of kernel and plain form.
  2. slice: the port's CLI stages gen-data -> train-item (full-width item
     tower, batch 192, ~10 steps) -> vectorize on the card. K1's launch
     counts are zeroed just before and read just after; every kernel must
     have launched.
  3. serve: the port's HTTP server with the trained encoder answers
     ingest -> process-pending -> similarity; served vectors must match the
     vectorize matrix.

  4. kernel vs plain: K2 against its plain form, forward and gradient, on
     the small test graph (700 users, 500 items; D = 64 and 32; 1e-5 abs)
     and on a reference-scale graph made here from a seed (200,000 users,
     47,000 items, 11.3M interactions -> 22.6M directed edges; D = 64).
     There a hub row sums ~1e5 terms, which the kernel adds in edge order
     and ``index_add_`` in the order its atomics land, so both are held
     against the plain form in fp64: the kernel's error may be at most
     REF_ERR_MULT times the plain fp32 form's (plus REF_ERR_FLOOR), and the
     two fp32 forms may differ by at most REF_TOL. Two kernel calls must give
     the same bits. CUDA-event times of kernel, plain form and
     ``torch.sparse.mm`` on a CSR tensor, beside the byte bound.
  5. GNN slice: etl -> train-gnn -> distill -> gnn-eval through the CLI on
     the world of phase 2, default widths, two epochs; K2's counts are
     zeroed before and read after.
  6. the trainer at a real size: ``train_lightgcl`` on the graph of 4, batch
     8192, ten steps; K2 must launch four times a step; then
     ``final_embeddings`` through K2.

  7. kernel vs plain: K3's forward and backward kernels against the plain FM
     form and its autograd gradient on the card, at (200, 12, 16), a ragged
     (2049, 3, 8), the DeepFM training shape (2048, 20, 16) and the
     large-candidate scoring shape (131072, 20, 16), the last also in bf16.
     rtol 1e-4 / atol 1e-3 as the JAX suite's; two calls must give the same
     bits. CUDA-event times of each kernel and its plain form beside the byte
     bound, at the training and the scoring shape.
  8. reranker slice: train-reranker through the CLI on the world of phase 2
     with the default reranker config and 200 boosting iterations; both AUCs
     above 0.5; reranker_gbdt.pkl loads again and reproduces the stage's AUC.
  9. DeepFM at full width: the stage's rows with 19 sparse fields (item and
     user index, the items' and users' categorical columns) and the 10 dense
     features, ``train_deepfm`` for a few epochs at the default widths, the
     scorer over 131,072 candidate rows in one call, ``ReRankingSystem`` for a
     few users. K3's counts are zeroed before and read after: the forward
     kernel must have launched once a step and once a scoring call, the
     backward once a step, exactly.

One line holds every kernel with its launches, error, times and bound. The
last line is {"ok": true, "device": {...}}; any failure exits non-zero
without it. TF32 is off, so the plain fp32 oracle is full fp32.
"""

from __future__ import annotations

import concurrent.futures
import json
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
import urllib.request


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


try:
    import numpy as np
    import torch

    from recsys_tpu_torch.ops import contrastive_kernel as K
    from recsys_tpu_torch.ops import fm_kernel as FM
    from recsys_tpu_torch.ops import spmm as S
    from recsys_tpu_torch.ops.contrastive import bidirectional_infonce, inbatch_logq_loss
    from recsys_tpu_torch.ops.fm import fm_interaction
except ImportError as e:  # run outside the repository
    fail(f"cannot import the port ({e}); run from the repository root")

SOURCES = {"diag_ce": "recsys_tpu_torch/csrc/diag_ce.cu",
           "spmm": "recsys_tpu_torch/csrc/spmm.cu",
           "fm": "recsys_tpu_torch/csrc/fm.cu"}
REPLACES = {
    "diag_ce_fwd": "recsys_tpu/ops/pallas_contrastive.py:73",
    "diag_ce_bwd_dq": "recsys_tpu/ops/pallas_contrastive.py:97",
    "diag_ce_bwd_dk": "recsys_tpu/ops/pallas_contrastive.py:97",
    "spmm_csr": "recsys_tpu/ops/pallas_spmm.py:237",
    "spmm_hub_reduce": "recsys_tpu/ops/pallas_spmm.py:237",
    "fm_fwd": "recsys_tpu/ops/pallas_fm.py:31",
    "fm_bwd": "recsys_tpu/ops/pallas_fm.py:31",
}
# published peaks of one H100 SXM: device memory and fp32 outside the tensor cores
PEAK_BYTES_PER_S, PEAK_FP32_FLOPS = 3.35e12, 67e12
SPMM_TOL = 1e-5          # small graph, as tests/test_spmm.py
REF_TOL = 5e-5           # reference scale: kernel vs plain, both fp32 (see docstring)
REF_ERR_MULT, REF_ERR_FLOOR = 4.0, 1e-6
REF_USERS, REF_ITEMS, REF_INTERACTIONS, REF_BATCH = 200_000, 47_000, 11_300_000, 8192
LOSS_TOL, GRAD_TOL = 1e-4, 1e-5
SERVE_TOL = 2e-2  # served vs materialized rows, as tests/test_serve.py
MAIN_B, D = 192, 128
FM_RTOL, FM_ATOL = 1e-4, 1e-3   # as tests/test_pallas.py holds the Pallas FM kernel
# DeepFM at full width: 19 sparse fields + the dense block, K = fm_embed_dim
FM_FIELDS, FM_K, FM_TRAIN_B, FM_SCORE_B = 20, 16, 2048, 131072
ITEM_FIELDS = ("product_type_name", "graphical_appearance_name", "colour_group_name",
               "department_name", "section_name", "perceived_colour_value_name",
               "material", "detail", "season", "gender", "style")
USER_FIELDS = ("age_group", "gender", "style", "persona", "club_member_status",
               "fashion_news_frequency")
DEEPFM_EPOCHS, RERANK_USERS = 3, 4


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


# -- phase 1: kernel vs plain -------------------------------------------------

def make_problem(B: int, form: str, seed: int, device):
    """Inputs of one K1 call: (q, k, corr, pos, usr, valid, tau)."""
    rng = np.random.default_rng(seed)

    def unit():
        x = rng.normal(size=(B, D)).astype(np.float32)
        return torch.as_tensor(x / np.linalg.norm(x, axis=1, keepdims=True), device=device)

    q, k = unit(), unit()
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=device)
    if form == "simcse":
        uniq = -np.arange(B) - 500_000
        return (q, k, torch.zeros(B, device=device), i32(uniq), i32(uniq),
                i32(np.ones(B)), 0.08)
    pos = rng.integers(1, max(B // 4, 2), B)
    logq = rng.uniform(-8, -1, B).astype(np.float32)
    return (q, k, torch.as_tensor(logq[pos], device=device), i32(pos),
            i32(rng.integers(0, max(B // 3, 2), B)), i32(rng.random(B) > 0.1), 0.1)


def loss_fns(prob, form: str):
    """(kernel loss, plain loss) of the wrappers the trainers call."""
    q, k, corr, pos, usr, valid, tau = prob
    if form == "simcse":
        return (lambda a, b: K.fused_bidirectional_infonce(a, b, tau),
                lambda a, b: bidirectional_infonce(a, b, tau))
    logq = torch.zeros(int(pos.max()) + 1, device=q.device)
    logq[pos.long()] = corr
    kw = dict(temperature=tau, user_ids=usr, valid=valid)
    return (lambda a, b: K.fused_inbatch_logq_loss(a, b, pos, logq, **kw),
            lambda a, b: inbatch_logq_loss(a, b, pos, logq, **kw))


def value_and_grads(fn, q, k):
    a, b = q.clone().requires_grad_(True), k.clone().requires_grad_(True)
    loss = fn(a, b)
    ga, gb = torch.autograd.grad(loss, (a, b))
    return loss.detach(), ga, gb


def cuda_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def interleaved_ms(kernel_fn, plain_fn, iters: int) -> tuple[float, float]:
    """plain, kernel, kernel, plain: the mean of each pair."""
    p1, k1, k2, p2 = (cuda_ms(f, iters) for f in (plain_fn, kernel_fn, kernel_fn, plain_fn))
    return (k1 + k2) / 2, (p1 + p2) / 2


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: bytes over its memory rate or
    operations over its fp32 rate, whichever is larger."""
    by_bytes, by_ops = 1e3 * n_bytes / PEAK_BYTES_PER_S, 1e3 * n_ops / PEAK_FP32_FLOPS
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def diag_ce_bounds(B: int, dim: int) -> dict:
    """Each K1 kernel reads q, k and the per-row vectors once. The forward
    is one (B, B, D) product pass and writes loss and lse; each backward
    half recomputes the logits and multiplies them out (two passes), reads
    lse and g as well, and writes one (B, D) gradient."""
    rows, vec, pass_ops = 4 * B * dim, 4 * B, 2.0 * B * B * dim
    return {"diag_ce_fwd": bound(2 * rows + 4 * vec + 2 * vec, pass_ops),
            "diag_ce_bwd_dq": bound(2 * rows + 6 * vec + rows, 2 * pass_ops),
            "diag_ce_bwd_dk": bound(2 * rows + 6 * vec + rows, 2 * pass_ops)}


def kernel_phase(device) -> tuple[list[dict], dict]:
    shapes = [(MAIN_B, "simcse"), (200, "logq"), (768, "logq"), (8192, "logq"),
              (8192, "simcse")]
    errs = {name: 0.0 for name in K.LAUNCHES}
    per_kernel_ms = {}
    rows = []
    for B, form in shapes:
        prob = make_problem(B, form, seed=B, device=device)
        q, k, corr, pos, usr, valid, tau = prob
        meta = (corr, pos, usr, valid)
        # each kernel against its plain form, g = the mean-loss gradient
        loss_k, lse_k = K.diag_ce_fwd_cuda(q, k, *meta, tau)
        loss_p, lse_p = K.diag_ce_fwd_plain(q, k, *meta, tau)
        g = valid.float() / valid.float().sum()
        args = (q, k, *meta, lse_p, g, tau)
        dq_err = float((K.diag_ce_bwd_dq_cuda(*args) - K.diag_ce_bwd_dq_plain(*args)).abs().max())
        dk_err = float((K.diag_ce_bwd_dk_cuda(*args) - K.diag_ce_bwd_dk_plain(*args)).abs().max())
        fwd_err = float(torch.maximum((loss_k - loss_p).abs(), (lse_k - lse_p).abs()).max())
        check(fwd_err <= LOSS_TOL, f"B={B} {form}: fwd kernel err {fwd_err}")
        check(dq_err <= GRAD_TOL and dk_err <= GRAD_TOL,
              f"B={B} {form}: bwd kernel err dq {dq_err} dk {dk_err}")
        errs["diag_ce_fwd"] = max(errs["diag_ce_fwd"], fwd_err)
        errs["diag_ce_bwd_dq"] = max(errs["diag_ce_bwd_dq"], dq_err)
        errs["diag_ce_bwd_dk"] = max(errs["diag_ce_bwd_dk"], dk_err)

        # the loss the trainers call, through autograd, against the plain loss
        kern_fn, plain_fn = loss_fns(prob, form)
        got, ref = value_and_grads(kern_fn, q, k), value_and_grads(plain_fn, q, k)
        loss_err = abs(float(got[0]) - float(ref[0]))
        grad_err = max(float((x - y).abs().max()) for x, y in zip(got[1:], ref[1:]))
        check(loss_err <= LOSS_TOL and grad_err <= GRAD_TOL,
              f"B={B} {form}: loss err {loss_err}, grad err {grad_err}")
        iters = 20 if B >= 4096 else 100
        k_ms, p_ms = interleaved_ms(lambda: value_and_grads(kern_fn, q, k),
                                    lambda: value_and_grads(plain_fn, q, k), iters)
        rows.append({"B": B, "D": D, "form": form, "loss_err": loss_err,
                     "grad_err": grad_err, "fwd_bwd_ms": k_ms, "plain_fwd_bwd_ms": p_ms})
        print(json.dumps({"phase": "kernel", **rows[-1]}), flush=True)
        if B == MAIN_B:
            per_kernel_ms = {
                "diag_ce_fwd": interleaved_ms(
                    lambda: K.diag_ce_fwd_cuda(q, k, *meta, tau),
                    lambda: K.diag_ce_fwd_plain(q, k, *meta, tau), 200),
                "diag_ce_bwd_dq": interleaved_ms(
                    lambda: K.diag_ce_bwd_dq_cuda(*args),
                    lambda: K.diag_ce_bwd_dq_plain(*args), 200),
                "diag_ce_bwd_dk": interleaved_ms(
                    lambda: K.diag_ce_bwd_dk_cuda(*args),
                    lambda: K.diag_ce_bwd_dk_plain(*args), 200),
            }
    return rows, {"errs": errs, "ms": per_kernel_ms}


# -- phases 2 and 3: the slice and the server ------------------------------

def http(base: str, method: str, path: str, payload=None):
    req = urllib.request.Request(
        base + path, method=method,
        data=None if payload is None else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
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


def slice_phase(root: str, device: str = "cuda", extra_sets: tuple = ()) -> dict:
    import pandas as pd

    from recsys_tpu_torch.train.checkpoint import load_array_with_ids
    from recsys_tpu_torch.pipeline import cli
    from recsys_tpu_torch.serve.server import make_server, serve_forever_in_thread
    from recsys_tpu_torch.train.simcse import MODEL_INPUTS, restore_model, topk_items

    sets = ["--set", f"data.root={root}", "--set", "simcse.epochs=1",
            "--set", "simcse.steps_per_epoch_min=1", "--set", "serve.db_path=:memory:",
            *extra_sets, "--device", device]
    K.reset_launch_counts()  # the main path's run starts here
    gen = cli.main(["gen-data", *sets])
    n_items = gen["items"]
    train = cli.main(["train-item", *sets])
    counts_after_train = dict(K.LAUNCHES)
    check(all(n > 0 for n in counts_after_train.values()),
          f"train-item did not launch every K1 kernel: {counts_after_train}")
    check(train["steps"] >= 10, f"train-item took {train['steps']} steps")
    check(all(np.isfinite(train["losses"])), f"non-finite loss: {train['losses']}")
    vec = cli.main(["vectorize", *sets])
    mat, ids, _ = load_array_with_ids(f"{root}/item_matrix")
    check(mat.shape == (n_items + 1, 128) and ids[0] == "<pad>", f"matrix {mat.shape}")
    check(bool(np.isfinite(mat).all()), "non-finite item vectors")
    norms = np.linalg.norm(mat[1:], axis=1)
    check(bool(np.allclose(norms, 1.0, atol=1e-3)), f"row norms {norms.min()}..{norms.max()}")
    nq = min(200, n_items)
    _, top = topk_items(mat, mat[1:nq + 1], k=1, device=device)
    self_rank1 = float((top[:, 0] == np.arange(1, nq + 1)).mean())
    check(self_rank1 >= 0.95, f"self-retrieval at rank 1: {self_rank1}")

    # the trained encoder on the card against the same weights on the CPU
    cfg = cli.config_from_args(cli.parse_args(["vectorize", *sets]))
    tensors = cli._item_tensors(cfg)
    nf = tensors["std"].shape[1]
    model, _ = restore_model(cfg, f"{root}/ckpt_item", nf, device)
    cpu_model, _ = restore_model(cfg, f"{root}/ckpt_item", nf, "cpu")
    with torch.inference_mode():
        on_card = model.encode(*(torch.as_tensor(tensors[k][:64], device=device)
                                 for k in MODEL_INPUTS)).cpu()
        on_cpu = cpu_model.encode(*(torch.as_tensor(tensors[k][:64]) for k in MODEL_INPUTS))
    card_cpu_err = float((on_card - on_cpu).abs().max())
    check(card_cpu_err <= SERVE_TOL, f"encoder card vs CPU: {card_cpu_err}")
    rows_err = float(np.abs(mat[1:65] - on_card.numpy()).max())
    check(rows_err <= SERVE_TOL, f"vectorize rows vs a direct encode: {rows_err}")

    # phase 3: serve with the trained encoder
    args = cli.parse_args(["serve", *sets, "--model-backed"])
    ctx = cli.build_app(cli.config_from_args(args), args)
    server = make_server(ctx, host="127.0.0.1", port=0)
    thread = serve_forever_in_thread(server)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        health = http(base, "GET", "/")
        check(device == "cpu" or torch.cuda.get_device_name(0) in health["devices"],
              f"health: {health}")
        items = pd.read_parquet(f"{root}/items.parquet").sort_values("item_id")
        picked = items.iloc[::max(n_items // 64, 1)].head(64).to_dict("records")
        ing = http(base, "POST", "/api/controller/products/ingest",
                   {"products": [product_json(r) for r in picked]})
        check(ing.get("created") == len(picked), f"ingest: {ing}")
        t0, processed, loops = time.perf_counter(), 0, 0
        while True:
            r = http(base, "POST", "/ai-api/serving/vectors/process-pending", {})
            if r["processed_count"] == 0:
                break
            processed += r["processed_count"]
            loops += 1
        process_s = time.perf_counter() - t0
        check(processed == len(picked), f"processed {processed}")
        row_of = {pid: r for r, pid in enumerate(ids)}
        pids = [str(r["item_id"]) for r in picked]
        served = np.stack([ctx.store.get_vector(p) for p in pids])
        served_err = float(np.abs(served - mat[[row_of[p] for p in pids]]).max())
        check(served_err <= SERVE_TOL, f"served vs vectorize rows: {served_err}")
        score_err, t0 = 0.0, time.perf_counter()
        for pid in pids[:8]:
            sim = http(base, "GET", f"/api/controller/similarity/{pid}?top_k=10")
            res = sim["results"]
            check(0 < len(res) <= 10, f"similarity {pid}: {sim}")
            check(all(x["product_id"] != pid for x in res), f"query {pid} in its own list")
            for x in res:
                ref = float(mat[row_of[pid]] @ mat[row_of[x["product_id"]]])
                score_err = max(score_err, abs(x["score"] - ref))
        sim_ms = (time.perf_counter() - t0) * 1e3 / 8
        check(score_err <= SERVE_TOL, f"similarity scores vs vectorize: {score_err}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    return {"train": {k: train[k] for k in ("steps", "seconds", "step_ms_median",
                                            "first_step_ms")},
            "final_loss": train["losses"][-1], "first_loss": train["losses"][0],
            "vectorize": {k: vec[k] for k in ("shape", "seconds", "items_per_s")},
            "self_rank1": self_rank1, "card_vs_cpu_encode_err": card_cpu_err,
            "serve": {"processed": processed, "loops": loops, "process_pending_s": process_s,
                      "served_vs_vectorize_err": served_err, "score_err": score_err,
                      "similarity_ms": sim_ms},
            "launches": dict(K.LAUNCHES)}


# -- phase 4: K2 against its plain form ---------------------------------------

def normalized_edges(u, i, num_users: int, num_items: int):
    """Interactions -> both edge directions with D^-1/2 A D^-1/2 weights."""
    n = num_users + num_items
    deg = np.bincount(u, minlength=n).astype(np.float64)
    deg[num_users:] += np.bincount(i, minlength=num_items)
    d_inv = 1.0 / np.sqrt(np.clip(deg, 1.0, None))
    w = (d_inv[u] * d_inv[num_users + i]).astype(np.float32)
    return (np.concatenate([u, num_users + i]).astype(np.int32),
            np.concatenate([num_users + i, u]).astype(np.int32),
            np.concatenate([w, w]))


def reference_scale_graph(seed: int):
    """The LightGCL reference anchor's graph: uniform users, item index
    ~ U^2.5 (popularity skew), interactions not deduped, random rank-5
    factors for the global view (its cost does not depend on their values).
    Returns (BipartiteGraph, users, items) of the interactions."""
    from recsys_tpu_torch.ops.graph import BipartiteGraph

    rng = np.random.default_rng(seed)
    u = rng.integers(0, REF_USERS, REF_INTERACTIONS).astype(np.int64)
    i = (REF_ITEMS * rng.random(REF_INTERACTIONS) ** 2.5).astype(np.int64)
    src, dst, weight = normalized_edges(u, i, REF_USERS, REF_ITEMS)
    n, q = REF_USERS + REF_ITEMS, 5
    graph = BipartiteGraph(REF_USERS, REF_ITEMS, src, dst, weight,
                           rng.normal(0, 0.01, (n, q)).astype(np.float32),
                           np.abs(rng.normal(1.0, 0.1, q)).astype(np.float32),
                           rng.normal(0, 0.01, (n, q)).astype(np.float32))
    return graph, u, i


def spmm_value_and_grad(layout, x, g):
    xk = x.clone().requires_grad_(True)
    out = S.spmm(layout, xk)
    (dx,) = torch.autograd.grad((out * g).sum(), xk)
    return out.detach(), dx


def max_err(a, b) -> float:
    return float((a - b).abs().max())


def spmm_phase(device, graph) -> dict:
    rng = np.random.default_rng(0)
    # (a) the small test graph
    nu, ni = 700, 500
    pairs = np.unique(np.stack([rng.integers(0, nu, 8000), rng.integers(0, ni, 8000)], 1),
                      axis=0)
    src, dst, w = normalized_edges(pairs[:, 0], pairs[:, 1], nu, ni)
    small_err = 0.0
    for dim, max_segment in ((64, S.MAX_SEGMENT), (32, S.MAX_SEGMENT), (64, 8)):
        layout = S.csr_graph(src, dst, w, nu + ni, max_segment=max_segment, device=device)
        x, g = (torch.as_tensor(rng.normal(size=(nu + ni, dim)).astype(np.float32),
                                device=device) for _ in range(2))
        out, dx = spmm_value_and_grad(layout, x, g)
        err = max(max_err(out, S.spmm_plain(layout, x)), max_err(dx, S.spmm_plain(layout, g)))
        check(err <= SPMM_TOL, f"K2 small graph D={dim} segment={max_segment}: err {err}")
        small_err = max(small_err, err)

    # (b) the reference-scale graph
    t0 = time.perf_counter()
    layout = S.csr_graph(graph.src, graph.dst, graph.weight, graph.num_nodes, device=device)
    layout_s = time.perf_counter() - t0
    n, dim = graph.num_nodes, 64
    x, g = (torch.as_tensor(rng.normal(size=(n, dim)).astype(np.float32), device=device)
            for _ in range(2))
    S.reset_launch_counts()
    out, dx = spmm_value_and_grad(layout, x, g)
    torch.cuda.synchronize()
    check(S.LAUNCHES == {"spmm_csr": 2, "spmm_hub_reduce": 2},
          f"K2 forward + backward launches: {S.LAUNCHES}")
    check(torch.equal(S.spmm_cuda(layout, x), out), "K2: two calls differ in their bits")
    errs = {}
    for name, got, inp in (("fwd", out, x), ("grad", dx, g)):
        plain = S.spmm_plain(layout, inp)
        exact = S.spmm_plain(layout, inp.double())
        errs[name] = {"kernel_vs_plain": max_err(got, plain),
                      "kernel_vs_fp64": max_err(got.double(), exact),
                      "plain_vs_fp64": max_err(plain.double(), exact)}
        del plain, exact
        e = errs[name]
        check(e["kernel_vs_plain"] <= REF_TOL, f"K2 reference scale {name}: {e}")
        check(e["kernel_vs_fp64"] <= REF_ERR_MULT * e["plain_vs_fp64"] + REF_ERR_FLOOR,
              f"K2 reference scale {name}: kernel further from fp64 than plain: {e}")

    # each kernel alone against its plain form, with times
    partial = torch.empty((layout.num_partials, dim), device=device)
    scratch = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream
    lib = S.load_library()

    def segments_only():  # spmm_csr without the hub pass; direct library call, not counted
        code = lib.spmm_csr(layout.seg_ptr.data_ptr(), layout.seg_out.data_ptr(),
                            layout.col.data_ptr(), layout.val.data_ptr(), x.data_ptr(),
                            scratch.data_ptr(), partial.data_ptr(), layout.num_segments,
                            dim, stream)
        check(code == 0, f"spmm_csr: cudaError_t {code}")

    def hub_only():
        code = lib.spmm_hub_reduce(layout.hub_row.data_ptr(), layout.hub_ptr.data_ptr(),
                                   partial.data_ptr(), scratch.data_ptr(),
                                   layout.num_hubs, dim, stream)
        check(code == 0, f"spmm_hub_reduce: cudaError_t {code}")

    def hub_plain():  # the same sum of partial rows in plain PyTorch
        owner = torch.repeat_interleave(layout.hub_row.long(), layout.hub_ptr.diff().long())
        return torch.zeros_like(x).index_add_(0, owner, partial)

    hub_offsets = layout.hub_ptr.long()

    def hub_library():  # one PyTorch call for the per-hub sums (rows not scattered)
        return torch.segment_reduce(partial, "sum", offsets=hub_offsets, axis=0)

    segments_only()
    hub_rows = S.spmm_cuda(layout, x)[layout.hub_row.long()]
    hub_err = max_err(hub_plain()[layout.hub_row.long()], hub_rows)
    check(hub_err <= REF_TOL, f"spmm_hub_reduce vs plain: {hub_err}")
    hub_lib_err = max_err(hub_library(), hub_rows)
    check(hub_lib_err <= REF_TOL, f"spmm_hub_reduce vs segment_reduce: {hub_lib_err}")
    a_csr = torch.sparse_csr_tensor(layout.rowptr, layout.col, layout.val, size=(n, n))
    lib_err = max_err(torch.sparse.mm(a_csr, x), out)
    csr_ms, plain_ms = interleaved_ms(segments_only, lambda: S.spmm_plain(layout, x), 20)
    both_ms, library_ms = interleaved_ms(lambda: S.spmm_cuda(layout, x),
                                         lambda: torch.sparse.mm(a_csr, x), 20)
    hub_ms, hub_plain_ms = interleaved_ms(hub_only, hub_plain, 50)
    _, hub_library_ms = interleaved_ms(hub_only, hub_library, 50)
    E, P, H = layout.num_edges, layout.num_partials, layout.num_hubs
    stats = {
        "small_graph_err": small_err, "reference_scale": errs, "layout_seconds": layout_s,
        "shape": {"nodes": n, "edges": E, "dim": dim, "segments": layout.num_segments,
                  "hub_rows": H, "partials": P,
                  "max_row": int(layout.rowptr.diff().max())},
        "spmm_csr": {"max_abs_err": max(errs["fwd"]["kernel_vs_plain"],
                                        errs["grad"]["kernel_vs_plain"], small_err),
                     "ms": csr_ms, "plain_ms": plain_ms, "library_ms": library_ms,
                     "with_hub_reduce_ms": both_ms, "library_vs_kernel_err": lib_err,
                     # x, col, val, rowptr read once; out written once; one FMA per edge x feature
                     **bound(4 * (2 * n * dim + 2 * E + n + 1), 2.0 * E * dim)},
        "spmm_hub_reduce": {"max_abs_err": hub_err, "ms": hub_ms, "plain_ms": hub_plain_ms,
                            # after spmm_csr, as the wrapper runs it: its partial rows
                            # are then no longer all in cache
                            "ms_after_spmm_csr": both_ms - csr_ms,
                            "library_ms": hub_library_ms,
                            "library_vs_kernel_err": hub_lib_err,
                            **bound(4 * (P * dim + H * dim + 2 * H + 1), float(P * dim))},
    }
    return stats


# -- phase 5: the GNN slice through the CLI -------------------------------

def gnn_slice_phase(root: str) -> dict:
    from recsys_tpu_torch.pipeline import cli

    sets = ["--set", f"data.root={root}", "--set", "gnn.epochs=2"]  # --device: the default
    S.reset_launch_counts()  # the GNN path's run starts here
    etl = cli.main(["etl", *sets])
    check(etl["sanity"]["target_users"] > 0, f"etl: {etl}")
    train = cli.main(["train-gnn", *sets])
    launches = dict(S.LAUNCHES)
    # forward and backward of two layers a step; the export and the check propagate once each
    expected = 4 * train["steps"] + 2 * 2
    check(train["device"].startswith("cuda") and train["steps"] > 0
          and launches == {"spmm_csr": expected, "spmm_hub_reduce": expected},
          f"train-gnn on {train['device']}: {train['steps']} steps, K2 launches {launches}")
    check(train["check"]["ok"], f"propagation check: {train['check']}")
    losses = train["epoch_losses"]
    check(len(losses) == 2 and all(np.isfinite(losses)), f"train-gnn losses: {losses}")
    check(losses[1] < losses[0], f"train-gnn loss did not fall: {losses}")
    distill = cli.main(["distill", *sets])
    check(all(np.isfinite(distill["epoch_losses"])), f"distill: {distill['epoch_losses']}")
    check(distill["epoch_losses"][-1] < distill["epoch_losses"][0],
          f"distill loss did not fall: {distill['epoch_losses']}")
    rows = cli.main(["gnn-eval", *sets])
    with open(f"{root}/gnn_eval.json") as f:
        check(json.load(f) == json.loads(json.dumps(rows)), "gnn_eval.json differs")
    check(rows["n_eval_users"] > 0, f"gnn-eval: {rows}")
    check(rows["gnn_dot"]["recall@100"] > 0, f"gnn_dot recall: {rows['gnn_dot']}")
    return {"train": {k: train[k] for k in ("steps", "seconds", "step_ms_median",
                                            "epoch_losses", "check")},
            "distill": {"epoch_losses": [distill["epoch_losses"][0],
                                         distill["epoch_losses"][-1]],
                        "fidelity": distill["fidelity"]},
            "gnn_eval": {k: rows[k] for k in ("n_eval_users", "gnn_dot", "gnn_cos",
                                              "distill_cos", "fidelity") if k in rows},
            "launches": launches}


# -- phase 6: the trainer at a real size -----------------------------------

def trainer_phase(root: str, graph, edges_u, edges_i) -> dict:
    import statistics

    from recsys_tpu_torch.config import load_config
    from recsys_tpu_torch.train.gnn import (final_embeddings, select_propagation,
                                            train_lightgcl)

    steps = 10
    cfg = load_config(None, {"gnn": {"epochs": 1, "steps_per_epoch_max": steps}})
    check(cfg.gnn.batch_size == REF_BATCH and cfg.gnn.emb_dim == 64
          and cfg.gnn.propagation == "auto", f"not the default GNN config: {cfg.gnn}")
    S.reset_launch_counts()  # the trainer's run starts here
    t0 = time.perf_counter()
    # as the train-gnn stage does: one layout for the trainer and the export
    propagation = select_propagation(cfg.gnn, graph, graph.num_nodes, "cuda")
    check(isinstance(propagation[1], S.CsrGraph), "auto did not pick K2 on the card")
    layout_s = time.perf_counter() - t0
    state, model = train_lightgcl(cfg, graph, edges_u, edges_i, f"{root}/ckpt_gnn_ref",
                                  "cuda", propagation=propagation)
    seconds = time.perf_counter() - t0
    launches = dict(S.LAUNCHES)
    per_step = 2 * cfg.gnn.num_layers  # forward and backward of every layer
    check(state.step == steps and launches == {"spmm_csr": per_step * steps,
                                               "spmm_hub_reduce": per_step * steps},
          f"trainer: {state.step} steps, launches {launches}")
    check(len(state.losses) == 1 and np.isfinite(state.losses[0]),
          f"trainer loss: {state.losses}")
    t0 = time.perf_counter()
    users, items = final_embeddings(model, graph, cfg.gnn.num_layers, "cuda",
                                    layout=propagation[1])
    export_s = time.perf_counter() - t0
    check(S.LAUNCHES["spmm_csr"] == launches["spmm_csr"] + cfg.gnn.num_layers,
          f"final_embeddings did not go through K2: {S.LAUNCHES}")
    check(users.shape == (REF_USERS, 64) and items.shape == (REF_ITEMS, 64)
          and bool(np.isfinite(users).all() and np.isfinite(items).all()),
          "final embeddings: wrong shape or non-finite")
    step_ms = [1e3 * t for t in state.step_seconds]
    return {"steps": steps, "batch": cfg.gnn.batch_size, "epoch_loss": state.losses[0],
            "seconds": seconds, "layout_seconds": layout_s, "step_ms_median": statistics.median(step_ms[1:]),
            "first_step_ms": step_ms[0], "final_embeddings_s": export_s,
            "launches": dict(S.LAUNCHES), "launches_per_step": per_step}


# -- phase 7: K3 against its plain form -----------------------------------------

def fm_bounds(B: int, F: int, K: int, itemsize: int) -> dict:
    """The forward reads v once and writes (B,) fp32: one add and one
    multiply-add a value, a square and a subtraction a (b, k). The backward
    reads v and g and writes dv: the field sums again, then a subtraction and
    a multiply a value."""
    n = B * F * K
    return {"fm_fwd": bound(n * itemsize + 4 * B, 3.0 * n + 3.0 * B * K),
            "fm_bwd": bound(2 * n * itemsize + 4 * B, 4.0 * n)}


def fm_value_and_grad(fn, v, g):
    x = v.clone().requires_grad_(True)
    out = fn(x)
    (dv,) = torch.autograd.grad((out * g).sum(), x)
    return out.detach(), dv


def fm_phase(device) -> dict:
    shapes = [(200, 12, 16, torch.float32), (2049, 3, 8, torch.float32),
              (FM_TRAIN_B, FM_FIELDS, FM_K, torch.float32),
              (FM_SCORE_B, FM_FIELDS, FM_K, torch.float32),
              (FM_SCORE_B, FM_FIELDS, FM_K, torch.bfloat16)]
    errs = {"fm_fwd": 0.0, "fm_bwd": 0.0}
    rows = []
    for B, F, Kd, dtype in shapes:
        rng = np.random.default_rng(B + F)
        v = torch.as_tensor(rng.normal(size=(B, F, Kd)).astype(np.float32),
                            device=device).to(dtype)
        g = torch.as_tensor(rng.normal(size=B).astype(np.float32), device=device)
        ref_out, ref_dv = fm_value_and_grad(fm_interaction, v, g)
        FM.reset_launch_counts()
        out, dv = fm_value_and_grad(FM.fused_fm_interaction, v, g)
        torch.cuda.synchronize()
        check(FM.LAUNCHES == {"fm_fwd": 1, "fm_bwd": 1}, f"K3 launches: {FM.LAUNCHES}")
        check(out.dtype == torch.float32 and dv.dtype == dtype and dv.shape == v.shape,
              f"K3 output types: {out.dtype}, {dv.dtype} {tuple(dv.shape)}")
        # dv is rounded to v's type on both sides: they may land one unit apart
        ulp = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7}[dtype]
        fwd_err, bwd_err = max_err(out, ref_out), max_err(dv.float(), ref_dv.float())
        fwd_ok = bool(torch.isclose(out, ref_out, rtol=FM_RTOL, atol=FM_ATOL).all())
        bwd_ok = bool(torch.isclose(dv.float(), ref_dv.float(), rtol=FM_RTOL + ulp,
                                    atol=FM_ATOL).all())
        name = f"({B}, {F}, {Kd}) {str(dtype).split('.')[-1]}"
        check(fwd_ok and bwd_ok, f"K3 {name}: fwd err {fwd_err}, bwd err {bwd_err}")
        check(torch.equal(FM.fm_fwd_cuda(v), out) and torch.equal(FM.fm_bwd_cuda(v, g), dv),
              f"K3 {name}: two calls differ in their bits")
        if dtype == torch.float32:   # bf16 gradients differ by their rounding, not the kernel's
            errs["fm_fwd"], errs["fm_bwd"] = max(errs["fm_fwd"], fwd_err), max(errs["fm_bwd"], bwd_err)
        row = {"shape": [B, F, Kd], "dtype": str(dtype).split(".")[-1],
               "fwd_err": fwd_err, "bwd_err": bwd_err}
        if B in (FM_TRAIN_B, FM_SCORE_B):
            iters = 200 if B == FM_TRAIN_B else 30
            fwd = interleaved_ms(lambda: FM.fm_fwd_cuda(v), lambda: fm_interaction(v), iters)
            bwd = interleaved_ms(lambda: FM.fm_bwd_cuda(v, g), lambda: FM.fm_bwd_plain(v, g),
                                 iters)
            bounds = fm_bounds(B, F, Kd, v.element_size())
            row.update({"fm_fwd": {"ms": fwd[0], "plain_ms": fwd[1], **bounds["fm_fwd"]},
                        "fm_bwd": {"ms": bwd[0], "plain_ms": bwd[1], **bounds["fm_bwd"]}})
        rows.append(row)
        print(json.dumps({"phase": "fm_kernel", **row}), flush=True)
    timed = {(tuple(r["shape"]), r["dtype"]): r for r in rows if "fm_fwd" in r}
    return {"errs": errs,
            "train": timed[((FM_TRAIN_B, FM_FIELDS, FM_K), "float32")],
            "score": timed[((FM_SCORE_B, FM_FIELDS, FM_K), "float32")],
            "score_bf16": timed[((FM_SCORE_B, FM_FIELDS, FM_K), "bfloat16")]}


# -- phase 8: train-reranker through the CLI -------------------------------------

def reranker_slice_phase(root: str) -> tuple[dict, dict]:
    from recsys_tpu_torch.pipeline import cli
    from recsys_tpu_torch.train.reranker import GBDTRanker

    sets = ["--set", f"data.root={root}"]  # --device: the default
    args = cli.parse_args(["train-reranker", *sets])
    cfg = cli.config_from_args(args)
    rc = cfg.reranker
    check((rc.cross_layers, tuple(rc.deep_hidden), rc.batch_size, rc.lr, rc.epochs,
           rc.negative_source, rc.candidate_top_k, rc.fm_embed_dim)
          == (3, (128, 64), FM_TRAIN_B, 3e-3, 30, "candidates", 100, FM_K),
          f"not the default reranker config: {rc}")
    out = cli.main(["train-reranker", *sets])
    check(out["device"].startswith("cuda") and out["examples"] > 0, f"train-reranker: {out}")
    for key in ("gbdt_auc", "dcn_auc"):
        check(np.isfinite(out[key]) and out[key] > 0.5, f"train-reranker {key}: {out[key]}")
    check(out["negative_source"] == "candidates" and out["dcn_loss"] == "bce",
          f"train-reranker: {out}")
    # the artifact, read back, scores the stage's held-out rows to the stage's AUC
    rows = cli.reranker_rows(cfg)
    check(len(rows["y"]) == out["examples"], "the stage's rows were not rebuilt")
    X, y, split = rows["X"], rows["y"], rows["split"]
    model = GBDTRanker.load(f"{root}/reranker_gbdt.pkl")
    check(model.n_iter_ == out["gbdt_iterations"], "reranker_gbdt.pkl: another forest")
    proba = model.predict_proba(X[split:])
    check(round(model.auc(X[split:], y[split:]), 4) == out["gbdt_auc"],
          "reranker_gbdt.pkl does not reproduce the stage's AUC")
    check(np.array_equal(GBDTRanker.load(f"{root}/reranker_gbdt.pkl").predict_proba(X[split:]),
                         proba), "two loads of reranker_gbdt.pkl differ")
    return out, rows


# -- phase 9: DeepFM at full width -------------------------------------------------

def deepfm_phase(root: str, rows: dict) -> dict:
    import statistics

    import pandas as pd

    from recsys_tpu_torch.config import load_config
    from recsys_tpu_torch.data.ranker_features import build_rank_features
    from recsys_tpu_torch.eval.recall import topk_scores
    from recsys_tpu_torch.train.reranker import ReRankingSystem, auc_score, train_deepfm

    cfg = load_config(None, {"reranker": {"epochs": DEEPFM_EPOCHS}})
    mat, item_map, item_meta = rows["item_matrix"], rows["item_map"], rows["item_meta"]
    items = pd.read_parquet(f"{root}/items.parquet").set_index("item_id")
    users = pd.read_parquet(f"{root}/users.parquet").set_index("user_id")
    check(all(c in items.columns for c in ITEM_FIELDS)
          and all(c in users.columns for c in USER_FIELDS), "the world lacks a field column")

    def codes(frame, columns, order):
        """(len(order) + 1, len(columns)) ids, row 0 and unknown values = 0."""
        frame = frame.reindex(order)
        out = np.zeros((len(order) + 1, len(columns)), np.int32)
        for c, col in enumerate(columns):
            out[1:, c] = pd.factorize(frame[col])[0] + 1
        return out

    user_order = sorted(users.index)
    user_row = {u: r + 1 for r, u in enumerate(user_order)}
    item_codes = codes(items, ITEM_FIELDS, list(item_map.ids))
    user_codes = codes(users, USER_FIELDS, user_order)
    uvec_table = np.stack([mat[0]] + [rows["user_vecs"].get(u, mat[0]) for u in user_order])

    def sparse_ids(uidx, iidx):
        return np.concatenate([iidx[:, None], uidx[:, None], item_codes[iidx],
                               user_codes[uidx]], axis=1).astype(np.int32)

    def dense_rows(uidx, iidx):
        return build_rank_features(uvec_table[uidx], mat[iidx],
                                   np.zeros((len(uidx), 3), np.float32), item_meta[iidx])

    uidx = np.array([user_row[u] for u in rows["user_ids"]])
    iidx, y, split = rows["item_idx"].astype(np.int64), rows["y"], rows["split"]
    ids = sparse_ids(uidx, iidx)
    field_sizes = (len(mat), len(user_order) + 1, *(int(m) + 1 for m in item_codes.max(0)),
                   *(int(m) + 1 for m in user_codes.max(0)))
    check(ids.shape[1] + 1 == FM_FIELDS and ids.shape[1] >= 16,
          f"{ids.shape[1]} sparse fields")
    check(np.array_equal(dense_rows(uidx, iidx), rows["X"]), "dense rows differ from the stage's")
    # standardized on the training rows, as train_dcn does: with no user price
    # history the price-ratio column is ~1e6
    mu = rows["X"][:split].mean(axis=0, keepdims=True)
    sd = rows["X"][:split].std(axis=0, keepdims=True) + 1e-6

    def standardized(feats):
        return ((feats - mu) / sd).astype(np.float32)

    dense = standardized(rows["X"])

    FM.reset_launch_counts()  # the DeepFM path's run starts here
    t0 = time.perf_counter()
    state, model, scorer = train_deepfm(cfg, ids[:split], dense[:split], y[:split],
                                        field_sizes)
    train_s = time.perf_counter() - t0
    device = next(model.parameters()).device
    check(device.type == "cuda", "train_deepfm did not take the card")
    check(state.step == DEEPFM_EPOCHS * (split // min(FM_TRAIN_B, split)) and state.step > 0,
          f"train_deepfm took {state.step} steps on {split} rows")
    check(all(np.isfinite(state.losses)) and state.losses[-1] < state.losses[0],
          f"DeepFM loss did not fall: {state.losses}")
    scoring_calls = 0

    def score(i, d):
        nonlocal scoring_calls
        scoring_calls += 1
        return scorer(i, d)

    auc = auc_score(y[split:], score(ids[split:], dense[split:]))
    check(auc > 0.5, f"DeepFM held-out AUC {auc}")

    # the large-candidate scoring path: 131,072 (user, item) rows in one call
    rng = np.random.default_rng(cfg.data.seed)
    cu = rng.integers(1, len(user_order) + 1, FM_SCORE_B)
    ci = rng.integers(1, len(mat), FM_SCORE_B)
    cand_ids, cand_dense = sparse_ids(cu, ci), standardized(dense_rows(cu, ci))
    score(cand_ids[:256], cand_dense[:256])   # first use of this shape family, untimed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    proba = score(cand_ids, cand_dense)
    score_s = time.perf_counter() - t0
    check(proba.shape == (FM_SCORE_B,) and bool(np.isfinite(proba).all())
          and 0.0 <= proba.min() and proba.max() <= 1.0, "candidate scores out of range")
    kernel_fm = model.fm
    model.fm = fm_interaction   # the same model with the plain FM form (no launch)
    try:
        plain_proba = scorer(cand_ids, cand_dense)
    finally:
        model.fm = kernel_fm
    plain_err = float(np.abs(proba - plain_proba).max())
    check(plain_err <= 1e-4, f"scorer with K3 vs with the plain FM form: {plain_err}")

    # retrieve-then-rerank with that scorer: the adapter repeats the system's
    # retrieval to know which items the feature rows belong to
    items_on_card = torch.as_tensor(mat, device=device)
    recommended = []
    for u in rng.choice(np.unique(uidx), RERANK_USERS, replace=False):
        uvec = uvec_table[u]

        def rerank_scorer(feats, u=u, uvec=uvec):
            _, idx = topk_scores(torch.as_tensor(uvec[None], device=device), items_on_card, 100)
            idx = idx[0].cpu().numpy()
            check(np.allclose(feats[:, 0], (uvec[None] * mat[idx]).sum(-1), atol=1e-5),
                  "rerank features do not belong to the retrieved items")
            return score(sparse_ids(np.full(len(idx), u), idx), standardized(feats))

        system = ReRankingSystem(mat, item_meta, rerank_scorer, retrieve_k=100, final_k=10)
        got, p = system.recommend(uvec, np.zeros(3, np.float32))
        check(len(got) == 10 and len(set(got.tolist())) == 10 and (got > 0).all()
              and bool((p[:-1] >= p[1:]).all()), f"recommend: {got} {p}")
        recommended.append(got.tolist())
    torch.cuda.synchronize()
    launches = dict(FM.LAUNCHES)
    check(launches == {"fm_fwd": state.step + scoring_calls, "fm_bwd": state.step},
          f"K3 launches {launches}: {state.step} steps, {scoring_calls} scoring calls")
    step_ms = [1e3 * t for t in state.step_seconds]
    return {"rows": int(split), "fields": FM_FIELDS, "field_sizes": list(field_sizes),
            "steps": state.step, "epoch_losses": state.losses, "train_seconds": train_s,
            "step_ms_median": statistics.median(step_ms[1:]), "first_step_ms": step_ms[0],
            "held_out_auc": auc, "scoring_calls": scoring_calls,
            "score_131072_seconds": score_s, "scorer_vs_plain_fm_err": plain_err,
            "recommended": recommended, "launches": launches}


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "python": sys.version.split()[0], "allow_tf32": False}), flush=True)
    print(card_line(), flush=True)
    t0 = time.perf_counter()
    modules = {"diag_ce": K, "spmm": S, "fm": FM}
    with concurrent.futures.ThreadPoolExecutor(len(modules)) as pool:  # one nvcc per source, together
        for job in [pool.submit(m.load_library) for m in modules.values()]:
            job.result()
    print(json.dumps({"build": SOURCES, "seconds": time.perf_counter() - t0,
                      "nvcc_seconds": {n: m.BUILD_INFO.get("seconds")
                                       for n, m in modules.items()},
                      "cached": [m.BUILD_INFO.get("cached") for m in modules.values()],
                      "ptxas": [ln.strip() for m in modules.values()
                                for ln in m.BUILD_INFO.get("ptxas", "").splitlines()
                                if "registers" in ln or "spill" in ln]}), flush=True)

    _rows, kstats = kernel_phase(device)
    root = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        result = slice_phase(root)
        print(json.dumps({"phase": "slice", **result}), flush=True)
        graph, edges_u, edges_i = reference_scale_graph(seed=0)
        sstats = spmm_phase(device, graph)
        print(json.dumps({"phase": "spmm_kernel", **sstats}), flush=True)
        gnn = gnn_slice_phase(root)
        print(json.dumps({"phase": "gnn_slice", **gnn}), flush=True)
        trainer = trainer_phase(root, graph, edges_u, edges_i)
        print(json.dumps({"phase": "gnn_trainer", **trainer}), flush=True)
        del graph, edges_u, edges_i
        fstats = fm_phase(device)
        reranker, rows = reranker_slice_phase(root)
        print(json.dumps({"phase": "reranker_slice", **reranker}), flush=True)
        deepfm = deepfm_phase(root, rows)
        print(json.dumps({"phase": "deepfm", **deepfm}), flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    k1_bounds = diag_ce_bounds(MAIN_B, D)
    kernels = [{"name": name, "route": "cuda", "source": SOURCES["diag_ce"],
                "replaces": REPLACES[name], "launches": result["launches"][name],
                "max_abs_err": kstats["errs"][name],
                "ms": kstats["ms"][name][0], "plain_ms": kstats["ms"][name][1],
                **k1_bounds[name], "library_ms": None}
               for name in K.LAUNCHES]
    # K2's launches are the trainer's at the real size; the CLI path's go beside them
    kernels += [{"name": name, "route": "cuda", "source": SOURCES["spmm"],
                 "replaces": REPLACES[name], "launches": trainer["launches"][name],
                 "launches_cli_path": gnn["launches"][name],
                 **{k: sstats[name][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                 "bound_by", "library_ms")}}
                for name in S.LAUNCHES]
    # K3's times are at the training shape, where most of its launches are; the
    # scoring shape (one launch a request) goes beside them
    kernels += [{"name": name, "route": "cuda", "source": SOURCES["fm"],
                 "replaces": REPLACES[name], "launches": deepfm["launches"][name],
                 "max_abs_err": fstats["errs"][name], **fstats["train"][name],
                 "library_ms": None,
                 "scoring_shape": fstats["score"][name],
                 "scoring_shape_bf16": fstats["score_bf16"][name]}
                for name in FM.LAUNCHES]
    check(all(k["launches"] > 0 for k in kernels), f"kernel not on the main path: {kernels}")
    check(not any(m.split(".")[0] in ("jax", "flax", "optax", "recsys_tpu")
                  for m in sys.modules), "the port pulled in JAX or the JAX package")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    try:
        main()
    except SystemExit:
        raise
    except BaseException:  # noqa: BLE001 — any failure is a failed smoke run
        traceback.print_exc()
        fail("uncaught exception")
