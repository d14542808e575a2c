"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds kernels K1 (recsys_tpu_torch/csrc/diag_ce.cu), K2
(recsys_tpu_torch/csrc/spmm.cu), K3 (recsys_tpu_torch/csrc/fm.cu) and K4
(recsys_tpu_torch/csrc/ring.cu) for sm_90a from the checkout, all at once,
then (phases 10 and 11 run after 6, while the graph of 4 is still there):

  1. kernel vs plain: K1's forward and both backward kernels against their
     plain PyTorch forms on the card, at the SimCSE shape (B=192, D=128),
     the LogQ form (B=200 ragged, at D = 128, 64 and 256, and B=768, with
     LogQ corrections, same-item and same-user collisions and ~10% invalid
     columns), B=8192, and the shape stage 2 really runs: B = 768 users x 4
     positions = 3072 rows, user ids repeated four times, positive ids drawn
     with popularity skew from a 47,000-item catalog (same-item collisions),
     one user whose four rows are one position four times; and the CPU test
     world's 16 x 2. Tolerances are the JAX suite's: loss 1e-4, grads 1e-5
     (abs); two dk calls must give the same bits. CUDA-event times of kernel
     and plain form, per kernel at B=192, 3072 and 8192.
  2. slice: the port's CLI stages gen-data -> train-item (full-width item
     tower, batch 192, ~10 steps) -> vectorize on the card. K1's launch
     counts are zeroed just before and read just after; every kernel must
     have launched.
  3. serve: the port's HTTP server with the trained encoder answers
     ingest -> process-pending -> similarity; served vectors must match the
     vectorize matrix.

  4. kernel vs plain: K2 in both of its modes ("f32", and "bf16": x rounded
     to bf16, weights and sums in fp32) against the plain form of the same
     mode, forward and gradient, on the small test graph (700 users, 500
     items; D = 64, 32 and 128; 1e-5 abs: both sides sum the same values in
     fp32) and on a reference-scale graph made here from a seed (200,000
     users, 47,000 items, 11.3M interactions -> 22.6M directed edges; D = 64).
     There a hub row sums ~1e5 terms, which the kernel adds in a fixed order
     and ``index_add_`` in the order its atomics land, so both are held
     against the plain form in fp64 (of the same rounded x): the kernel's
     error may be at most REF_ERR_MULT times the plain fp32 form's (plus
     REF_ERR_FLOOR), and the two fp32 forms may differ by at most REF_TOL. Two
     kernel calls must give the same bits. CUDA-event times of kernel, plain
     form and ``torch.sparse.mm`` on a CSR tensor, beside each mode's byte
     bound (x counted in 2 bytes in "bf16").
  5. GNN slice: etl -> train-gnn -> distill -> gnn-eval through the CLI on
     the world of phase 2, default widths, two epochs, the trainer in the
     mode ``select_propagation`` picks on the card ("bf16"); K2's counts are
     zeroed before and read after. Then K2's time at that graph.
  6. the trainer at a real size: ``train_lightgcl`` on the graph of 4, batch
     8192, ten steps, in that mode; K2 must launch four times a step; then
     ``final_embeddings`` through K2 ("f32").

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

  10. kernel vs plain: K4, the ring all-gather, over S virtual ranks laid over
     the one card, each with its own buffers: one way and both ways at S = 2,
     3, 4 and 8 on shards (768, 1000) fp32, (24, 128) bf16 and a ragged
     (7, 33) fp32, and on the data axis of a 4 x 2 mesh (two rings of four).
     Every rank's output must equal the plain hop loop's and ``torch.cat``'s
     bit for bit, two calls must agree, 100 calls back to back with one
     synchronise at the end must leave no error word, and a launch that leaves
     a rank out must end by its spin budget and be reported. CUDA-event times
     of kernel, plain loop and S calls of ``torch.cat`` beside the byte bound.
     These are device-memory times of virtual ranks on one card; no time
     between cards is taken here.
  11. sharded retrieval at full width: 768 user vectors x 128 against a
     47,000-row item matrix (row 0 = PAD) with a prior, k = 500, over a model
     axis of 4 and of 8 virtual shards: ``topk_scores(mesh=...)`` (through
     ``sharded_topk``), ``sharded_topk_ring_merge`` and ``ring_sharded_topk``
     one way and both ways on the same per-shard scores. 36M fp32 scores hold
     exact ties, and ``torch.topk`` promises no order among them, so a result
     is held as a top-k, not as a list: its values must equal the dense top-k
     values of the same scores bit for bit, every index must hold its value, be
     distinct and never be the PAD row; the ring merge, which orders ties, must
     equal the stable two-key sort exactly. Values also agree with the port's
     dense ``topk_scores`` (one product over the whole catalog) within rtol
     1e-6 + 1e-6. K4's counts are zeroed before and read after: one launch a
     ``ring_sharded_topk`` call, exactly. Then the edge-sharded propagation on
     the 22.6M-edge graph of 4 over 4 shards against the plain propagation,
     forward and gradient (REF_TOL), and one ``train_lightgcl`` step with
     ``gnn.propagation=segment_sum_sharded``.
  12. the sharded path through the entry points: ``vectorize`` over a data
     axis of 4 virtual shards (rows equal to phase 2's within SERVE_TOL),
     ``train-item`` through the CLI with ``mesh.num_data=4 --virtual-shards``
     at the full item-tower width, batch 192 (losses finite; K1's counts are
     zeroed before and read after: the gathered views go through each K1
     kernel twice a step, exactly, as on one device; with corruption and
     dropout rates 0 the loss falls and the first step's loss is within
     DP_LOSS_TOL of the ``num_data=1`` run from the same seed), then
     ``dryrun_multichip(8)``, whose stage-2 step reports finite losses with
     the dense and the all-to-all item lookups.
  13. the user-tower slice through the CLI on the world of phase 2:
     ``train-user`` at the default (full) widths, cut to two epochs, then
     ``eval``, then ``serve --model-backed`` with ``serve.user_backend=stage2``
     (ingest, interactions for a few users, users' process-pending, then
     ``GET /api/controller/recommendations/{uid}``). K1's counts are zeroed
     before ``train-user`` and read after ``eval``: each K1 kernel once an
     optimizer step, exactly, and none from ``eval``. Losses finite, the epoch
     mean falling, Recall@{20,100,500} > 0, the served user vector within
     SERVE_TOL of the tower's eval forward on the same left-padded history, no
     PAD row in any list.
  14. the stage-2 step at the reference shape (``bench.py``'s: B 768, L 50,
     47,000 items, a log-normal ``logq``, a unit-row item matrix), built here:
     20 steps of ``make_stage2_step`` after 2 warm-up steps, median step time
     through ``StepTimer``, K1 exactly 20 launches a kernel; five more steps
     under ``torch.profiler`` for K1's share of the device time; then
     ``evaluate_stage2``'s full-catalog top-500 for the 768 users.
  15. the hybrid slice through the CLI on the world of phase 2, reusing its
     stage-1 matrix, phase 5's GNN artifacts and phase 13's eval sidecars:
     ``train-hybrid`` at full width (the tower's 4 layers, batch 768; 4 epochs
     x 13 passes = 52 steps; the ensemble report on), ``ensemble-eval``,
     ``rerank-eval --vectors hybrid`` (HYBRID_RERANK_ITERS boosting
     iterations, the DCN arm), then ``serve --vectors hybrid --model-backed``
     with ``serve.user_backend=hybrid`` and requests in rerank, blend and
     cosine mode for a few users. Gates: the epoch loss finite and falling,
     ``hybrid_best`` Recall@100 > 0, the served user vector within SERVE_TOL of
     the tower's forward on the same history and GNN vector, the HTTP rerank
     list equal to ``rerank_serve_topk``'s offline list, the HTTP blend (the
     device form on the card) equal to the host blend, and no launch of K1-K4
     across the phase (the path has no hand kernel).
  16. the hybrid step at phase 14's shape (768 users x 50 positions, 47,000
     items, content 128 + GNN 64, 4 layers), built here from a seed: 20 steps
     after 2 warm-up steps (median through ``StepTimer``), five under
     ``torch.profiler`` (device busy and idle share, launches a step, the
     top device items), the adapted catalog's top-500 for the 768 users, and
     the device time and host cost of a one-element add (the smallest launch).

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
    from recsys_tpu_torch.parallel import ring as R
except ImportError as e:  # run outside the repository
    fail(f"cannot import the port ({e}); run from the repository root")

SOURCES = {"diag_ce": "recsys_tpu_torch/csrc/diag_ce.cu",
           "spmm": "recsys_tpu_torch/csrc/spmm.cu",
           "fm": "recsys_tpu_torch/csrc/fm.cu",
           "ring": "recsys_tpu_torch/csrc/ring.cu"}
REPLACES = {
    "diag_ce_fwd": "recsys_tpu/ops/pallas_contrastive.py:73",
    "diag_ce_bwd_dq": "recsys_tpu/ops/pallas_contrastive.py:97",
    "diag_ce_bwd_dk": "recsys_tpu/ops/pallas_contrastive.py:97",
    "spmm_csr": "recsys_tpu/ops/pallas_spmm.py:237",
    "spmm_hub_reduce": "recsys_tpu/ops/pallas_spmm.py:237",
    "fm_fwd": "recsys_tpu/ops/pallas_fm.py:31",
    "fm_bwd": "recsys_tpu/ops/pallas_fm.py:31",
    "ring_uni": "recsys_tpu/parallel/pallas_ring.py:81",
    "ring_bidi": "recsys_tpu/parallel/pallas_ring.py:127",
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
# K4: the packed top-k candidates (768 rows x 2 x 500), a data shard's embeddings, a ragged shard
RING_SHAPES = (((768, 1000), torch.float32), ((24, 128), torch.bfloat16),
               ((7, 33), torch.float32))
RING_SIZES, RING_TIMED_S = (2, 3, 4, 8), 8
RETRIEVAL_USERS, RETRIEVAL_ROWS, RETRIEVAL_K = 768, 47_000, 500
# first-step loss on 4 data shards (quarter batches through the bf16 tower)
# against one device (the whole batch); both take K1 on the (192, 128) views
DP_LOSS_TOL = 1e-3
# stage 2 at the reference shape (bench.py:71-95) and the rows its loss sees
STAGE2_B, STAGE2_L, STAGE2_P, STAGE2_ITEMS, STAGE2_STEPS = 768, 50, 4, 47_000, 20
# the hybrid slice (phase 15): 4 epochs x 13 passes of the 1,000-user world (one
# 768-user batch a pass) = 52 steps; the rerank GBDT's boosting iterations
HYBRID_EPOCHS, HYBRID_STEPS_MIN, HYBRID_RERANK_ITERS, HYBRID_GNN_DIM = 4, 13, 100, 64


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


# -- phase 1: kernel vs plain -------------------------------------------------

def make_problem(B: int, form: str, seed: int, device, dim: int = D, positions: int = 1):
    """Inputs of one K1 call: (q, k, corr, pos, usr, valid, tau)."""
    rng = np.random.default_rng(seed)

    def unit():
        x = rng.normal(size=(B, dim)).astype(np.float32)
        return torch.as_tensor(x / np.linalg.norm(x, axis=1, keepdims=True), device=device)

    q, k = unit(), unit()
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=device)
    if form == "stage2":
        # B = users x positions rows in user order; popular items collide
        pos = 1 + (STAGE2_ITEMS * rng.random(B) ** 3).astype(np.int64)
        logq = rng.normal(-8.0, 1.0, STAGE2_ITEMS + 1).astype(np.float32)
        # user 0 has one real position: its rows are that position's, repeated
        q[1:positions], k[1:positions] = q[0], k[0]
        pos[1:positions] = pos[0]
        return (q, k, torch.as_tensor(logq[pos], device=device), i32(pos),
                i32(np.repeat(np.arange(B // positions), positions)), i32(np.ones(B)), 0.1)
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
    # stage 2 passes no valid mask (every sampled row is real)
    kw = dict(temperature=tau, user_ids=usr, **({} if form == "stage2" else {"valid": valid}))
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
    shapes = [(MAIN_B, "simcse", D, 1), (200, "logq", D, 1), (200, "logq", 64, 1),
              (200, "logq", 256, 1), (768, "logq", D, 1), (16 * 2, "stage2", D, 2),
              (STAGE2_B * STAGE2_P, "stage2", D, STAGE2_P), (8192, "logq", D, 1),
              (8192, "simcse", D, 1)]
    errs = {name: 0.0 for name in K.LAUNCHES}
    per_kernel_ms = {}
    rows = []
    for B, form, dim, positions in shapes:
        prob = make_problem(B, form, seed=B + dim, device=device, dim=dim, positions=positions)
        q, k, corr, pos, usr, valid, tau = prob
        meta = (corr, pos, usr, valid)
        # each kernel against its plain form, g = the mean-loss gradient
        loss_k, lse_k = K.diag_ce_fwd_cuda(q, k, *meta, tau)
        loss_p, lse_p = K.diag_ce_fwd_plain(q, k, *meta, tau)
        g = valid.float() / valid.float().sum()
        args = (q, k, *meta, lse_p, g, tau)
        dq_err = float((K.diag_ce_bwd_dq_cuda(*args) - K.diag_ce_bwd_dq_plain(*args)).abs().max())
        dk = K.diag_ce_bwd_dk_cuda(*args)
        dk_err = float((dk - K.diag_ce_bwd_dk_plain(*args)).abs().max())
        check(torch.equal(K.diag_ce_bwd_dk_cuda(*args), dk),
              f"B={B} D={dim} {form}: two dk calls differ in their bits")
        fwd_err = float(torch.maximum((loss_k - loss_p).abs(), (lse_k - lse_p).abs()).max())
        check(fwd_err <= LOSS_TOL, f"B={B} D={dim} {form}: fwd kernel err {fwd_err}")
        check(dq_err <= GRAD_TOL and dk_err <= GRAD_TOL,
              f"B={B} D={dim} {form}: bwd kernel err dq {dq_err} dk {dk_err}")
        errs["diag_ce_fwd"] = max(errs["diag_ce_fwd"], fwd_err)
        errs["diag_ce_bwd_dq"] = max(errs["diag_ce_bwd_dq"], dq_err)
        errs["diag_ce_bwd_dk"] = max(errs["diag_ce_bwd_dk"], dk_err)

        # the loss the trainers call, through autograd, against the plain loss
        kern_fn, plain_fn = loss_fns(prob, form)
        got, ref = value_and_grads(kern_fn, q, k), value_and_grads(plain_fn, q, k)
        loss_err = abs(float(got[0]) - float(ref[0]))
        grad_err = max(float((x - y).abs().max()) for x, y in zip(got[1:], ref[1:]))
        check(loss_err <= LOSS_TOL and grad_err <= GRAD_TOL,
              f"B={B} D={dim} {form}: loss err {loss_err}, grad err {grad_err}")
        iters = 20 if B >= 4096 else 100
        k_ms, p_ms = interleaved_ms(lambda: value_and_grads(kern_fn, q, k),
                                    lambda: value_and_grads(plain_fn, q, k), iters)
        rows.append({"B": B, "D": dim, "form": form, "loss_err": loss_err,
                     "grad_err": grad_err, "fwd_bwd_ms": k_ms, "plain_fwd_bwd_ms": p_ms})
        print(json.dumps({"phase": "kernel", **rows[-1]}), flush=True)
        if (B in (MAIN_B, 8192) and form == "simcse") or B == STAGE2_B * STAGE2_P:
            per_kernel_ms[B] = {   # per kernel, beside its bound
                "diag_ce_fwd": interleaved_ms(
                    lambda: K.diag_ce_fwd_cuda(q, k, *meta, tau),
                    lambda: K.diag_ce_fwd_plain(q, k, *meta, tau), 2 * iters),
                "diag_ce_bwd_dq": interleaved_ms(
                    lambda: K.diag_ce_bwd_dq_cuda(*args),
                    lambda: K.diag_ce_bwd_dq_plain(*args), 2 * iters),
                "diag_ce_bwd_dk": interleaved_ms(
                    lambda: K.diag_ce_bwd_dk_cuda(*args),
                    lambda: K.diag_ce_bwd_dk_plain(*args), 2 * iters),
            }
    by_shape = {}
    for B in (8192, STAGE2_B * STAGE2_P):
        by_shape[B] = {name: {"ms": ms, "plain_ms": plain_ms, **diag_ce_bounds(B, D)[name]}
                       for name, (ms, plain_ms) in per_kernel_ms[B].items()}
        print(json.dumps({"phase": f"kernel_B{B}", **by_shape[B]}), flush=True)
    return rows, {"errs": errs, "ms": per_kernel_ms[MAIN_B], "B8192": by_shape[8192],
                  "B3072": by_shape[STAGE2_B * STAGE2_P]}


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


def spmm_value_and_grad(layout, x, g, precision):
    xk = x.clone().requires_grad_(True)
    out = S.spmm(layout, xk, precision)
    (dx,) = torch.autograd.grad((out * g).sum(), xk)
    return out.detach(), dx


def max_err(a, b) -> float:
    return float((a - b).abs().max())


def spmm_phase(device, graph) -> dict:
    rng = np.random.default_rng(0)
    # (a) the small test graph: both modes, every width, forward and gradient
    nu, ni = 700, 500
    pairs = np.unique(np.stack([rng.integers(0, nu, 8000), rng.integers(0, ni, 8000)], 1),
                      axis=0)
    src, dst, w = normalized_edges(pairs[:, 0], pairs[:, 1], nu, ni)
    small_err = {mode: 0.0 for mode in S.PRECISIONS}
    for dim, max_segment in ((64, S.MAX_SEGMENT), (32, S.MAX_SEGMENT), (128, S.MAX_SEGMENT),
                             (64, 8)):
        layout = S.csr_graph(src, dst, w, nu + ni, max_segment=max_segment, device=device)
        x, g = (torch.as_tensor(rng.normal(size=(nu + ni, dim)).astype(np.float32),
                                device=device) for _ in range(2))
        for mode in S.PRECISIONS:
            out, dx = spmm_value_and_grad(layout, x, g, mode)
            err = max(max_err(out, S.spmm_plain(layout, x, mode)),
                      max_err(dx, S.spmm_plain(layout, g, mode)))
            check(err <= SPMM_TOL,
                  f"K2 small graph {mode} D={dim} segment={max_segment}: err {err}")
            check(torch.equal(S.spmm_cuda(layout, x, mode), out),
                  f"K2 small graph {mode} D={dim}: two calls differ in their bits")
            small_err[mode] = max(small_err[mode], err)

    # (b) the reference-scale graph
    t0 = time.perf_counter()
    layout = S.csr_graph(graph.src, graph.dst, graph.weight, graph.num_nodes, device=device)
    layout_s = time.perf_counter() - t0
    n, dim = graph.num_nodes, 64
    x, g = (torch.as_tensor(rng.normal(size=(n, dim)).astype(np.float32), device=device)
            for _ in range(2))
    errs, outs = {}, {}
    for mode in S.PRECISIONS:
        S.reset_launch_counts()
        out, dx = spmm_value_and_grad(layout, x, g, mode)
        torch.cuda.synchronize()
        check(S.LAUNCHES == {"spmm_csr": 2, "spmm_hub_reduce": 2},
              f"K2 {mode} forward + backward launches: {S.LAUNCHES}")
        check(torch.equal(S.spmm_cuda(layout, x, mode), out),
              f"K2 {mode}: two calls differ in their bits")
        outs[mode] = out
        errs[mode] = {}
        for name, got, inp in (("fwd", out, x), ("grad", dx, g)):
            plain = S.spmm_plain(layout, inp, mode)
            exact = S.spmm_plain(layout, inp.double(), mode)   # the same rounding of x
            e = errs[mode][name] = {"kernel_vs_plain": max_err(got, plain),
                                    "kernel_vs_fp64": max_err(got.double(), exact),
                                    "plain_vs_fp64": max_err(plain.double(), exact)}
            del plain, exact
            check(e["kernel_vs_plain"] <= REF_TOL, f"K2 reference scale {mode} {name}: {e}")
            check(e["kernel_vs_fp64"] <= REF_ERR_MULT * e["plain_vs_fp64"] + REF_ERR_FLOOR,
                  f"K2 reference scale {mode} {name}: kernel further from fp64 than plain: {e}")
        del dx
    bf16_vs_f32 = max_err(outs["bf16"], outs["f32"])   # what the trainer's mode rounds away
    out = outs["f32"]

    # each kernel alone against its plain form, with times
    partial = torch.empty((layout.num_partials, dim), device=device)
    scratch = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream
    lib = S.load_library()
    x_as = {"f32": x, "bf16": x.to(torch.bfloat16)}

    def segments_only(mode):  # spmm_csr without the cast and the hub pass; not counted
        code = lib.spmm_csr(layout.seg_order.data_ptr(), layout.seg_ptr.data_ptr(),
                            layout.seg_out.data_ptr(), layout.col.data_ptr(),
                            layout.val.data_ptr(), x_as[mode].data_ptr(), int(mode == "bf16"),
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

    segments_only("f32")
    hub_rows = S.spmm_cuda(layout, x, "f32")[layout.hub_row.long()]
    hub_err = max_err(hub_plain()[layout.hub_row.long()], hub_rows)
    check(hub_err <= REF_TOL, f"spmm_hub_reduce vs plain: {hub_err}")
    hub_lib_err = max_err(hub_library(), hub_rows)
    check(hub_lib_err <= REF_TOL, f"spmm_hub_reduce vs segment_reduce: {hub_lib_err}")
    a_csr = torch.sparse_csr_tensor(layout.rowptr, layout.col, layout.val, size=(n, n))
    lib_err = max_err(torch.sparse.mm(a_csr, x), out)
    E, P, H = layout.num_edges, layout.num_partials, layout.num_hubs
    by_mode = {}
    for mode in S.PRECISIONS:
        csr_ms, plain_ms = interleaved_ms(lambda: segments_only(mode),
                                          lambda: S.spmm_plain(layout, x, mode), 20)
        both_ms, library_ms = interleaved_ms(lambda: S.spmm_cuda(layout, x, mode),
                                             lambda: torch.sparse.mm(a_csr, x), 20)
        x_bytes = x_as[mode].element_size()
        by_mode[mode] = {
            "max_abs_err": max(errs[mode]["fwd"]["kernel_vs_plain"],
                               errs[mode]["grad"]["kernel_vs_plain"], small_err[mode]),
            "ms": csr_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            # the wrapper's call: the cast of x (bf16), spmm_csr, spmm_hub_reduce
            "wrapper_ms": both_ms,
            # x (in the mode's type), col, val, rowptr read once; out written once in
            # fp32; one multiply-add per edge and feature
            **bound(n * dim * (x_bytes + 4) + 4 * (2 * E + n + 1), 2.0 * E * dim)}
        # a floor under the cache share: device memory at its peak rate could have
        # delivered at most ms * peak of the E * row bytes the kernel gathered
        gathered = E * dim * x_bytes
        by_mode[mode]["gathered_bytes"] = gathered
        by_mode[mode]["cache_share_at_least"] = max(
            0.0, 1.0 - 1e-3 * csr_ms * PEAK_BYTES_PER_S / gathered)
    cast_ms = cuda_ms(lambda: x.to(torch.bfloat16), 50)
    segments_only("f32")
    hub_ms, hub_plain_ms = interleaved_ms(hub_only, hub_plain, 50)
    _, hub_library_ms = interleaved_ms(hub_only, hub_library, 50)
    main = by_mode["bf16"]   # the trainer's mode
    stats = {
        "small_graph_err": small_err, "reference_scale": errs, "layout_seconds": layout_s,
        "bf16_vs_f32_out": bf16_vs_f32, "bf16_cast_ms": cast_ms,
        "shape": {"nodes": n, "edges": E, "dim": dim, "segments": layout.num_segments,
                  "hub_rows": H, "partials": P,
                  "max_row": int(layout.rowptr.diff().max())},
        "spmm_csr": {**main, "mode": "bf16", "f32": by_mode["f32"],
                     "library_vs_kernel_err": lib_err},
        "spmm_hub_reduce": {"max_abs_err": hub_err, "ms": hub_ms, "plain_ms": hub_plain_ms,
                            # after spmm_csr, as the wrapper runs it: its partial rows
                            # are then no longer all in cache
                            "ms_after_spmm_csr": main["wrapper_ms"] - main["ms"] - cast_ms,
                            "library_ms": hub_library_ms,
                            "library_vs_kernel_err": hub_lib_err,
                            **bound(4 * (P * dim + H * dim + 2 * H + 1), float(P * dim))},
    }
    return stats


# -- phase 5: the GNN slice through the CLI -------------------------------

def cli_graph_spmm_times(cfg) -> dict:
    """K2 at the graph ``train-gnn`` built (the shape of the CLI path's launches):
    the wrapper's call in both modes beside the plain form and the byte bound."""
    from recsys_tpu_torch.data.etl import time_split
    from recsys_tpu_torch.pipeline import cli
    from recsys_tpu_torch.train.gnn import graph_from_transactions

    items, _, tx = cli._load_world(cfg)
    train_tx, _, _ = time_split(tx, cfg.data.valid_days)
    user_map = {u: r for r, u in enumerate(sorted(train_tx["user_id"].unique()))}
    item_map = {i: r for r, i in enumerate(sorted(items["item_id"].astype(str)))}
    graph = graph_from_transactions(train_tx, user_map, item_map, cfg.gnn, cfg.data.seed)
    layout = S.csr_graph(graph.src, graph.dst, graph.weight, graph.num_nodes, device="cuda")
    n, dim, E = graph.num_nodes, cfg.gnn.emb_dim, layout.num_edges
    x = torch.as_tensor(np.random.default_rng(5).normal(size=(n, dim)).astype(np.float32),
                        device="cuda")
    out = {"nodes": n, "edges": E, "dim": dim, "hub_rows": layout.num_hubs}
    for mode in S.PRECISIONS:
        err = max_err(S.spmm_cuda(layout, x, mode), S.spmm_plain(layout, x, mode))
        check(err <= SPMM_TOL, f"K2 {mode} at the CLI path's graph: err {err}")
        ms, plain_ms = interleaved_ms(lambda: S.spmm_cuda(layout, x, mode),
                                      lambda: S.spmm_plain(layout, x, mode), 200)
        x_bytes = 2 if mode == "bf16" else 4
        out[mode] = {"wrapper_ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
                     **bound(n * dim * (x_bytes + 4) + 4 * (2 * E + n + 1), 2.0 * E * dim)}
    return out


def gnn_slice_phase(root: str) -> dict:
    from recsys_tpu_torch.pipeline import cli

    sets = ["--set", f"data.root={root}", "--set", "gnn.epochs=2"]  # --device: the default
    S.reset_launch_counts()  # the GNN path's run starts here
    etl = cli.main(["etl", *sets])
    check(etl["sanity"]["target_users"] > 0, f"etl: {etl}")
    train = cli.main(["train-gnn", *sets])
    launches = dict(S.LAUNCHES)   # read here: the timing below is not the path
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
            "spmm_at_this_graph": cli_graph_spmm_times(cli.config_from_args(
                cli.parse_args(["train-gnn", *sets]))),
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
    from recsys_tpu_torch.train.gnn import (final_embeddings, select_propagation, spmm_bf16,
                                            train_lightgcl)

    steps = 10
    cfg = load_config(None, {"gnn": {"epochs": 1, "steps_per_epoch_max": steps}})
    check(cfg.gnn.batch_size == REF_BATCH and cfg.gnn.emb_dim == 64
          and cfg.gnn.propagation == "auto", f"not the default GNN config: {cfg.gnn}")
    S.reset_launch_counts()  # the trainer's run starts here
    t0 = time.perf_counter()
    # as the train-gnn stage does: one layout for the trainer and the export
    propagation = select_propagation(cfg.gnn, graph, graph.num_nodes, "cuda")
    check(isinstance(propagation[1], S.CsrGraph) and propagation[0] is spmm_bf16,
          "auto did not pick K2 in the trainer's bf16 mode on the card")
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


# -- phase 10: K4 against its plain form ------------------------------------------

def ring_shards(S: int, shape, dtype, device, seed: int = 0) -> list:
    rng = np.random.default_rng(1000 * seed + S)
    return [torch.as_tensor(rng.normal(size=shape).astype(np.float32), device=device).to(dtype)
            for _ in range(S)]


def ring_name(S: int, bidirectional: bool) -> str:
    return "ring_bidi" if bidirectional and S > 2 else "ring_uni"


def bits_differ(a, b) -> float:
    """0.0 when equal bit for bit, else the largest difference (inf for NaN)."""
    if torch.equal(a, b):
        return 0.0
    d = float((a.double() - b.double()).abs().max())
    return d if d > 0 else float("inf")


def ring_phase(device) -> dict:
    from recsys_tpu_torch.config import MeshConfig
    from recsys_tpu_torch.parallel.mesh import build_mesh

    errs = {"ring_uni": 0.0, "ring_bidi": 0.0}
    cases = 0
    for shape, dtype in RING_SHAPES:
        for S in RING_SIZES:
            shards = ring_shards(S, shape, dtype, device)
            whole = torch.cat(shards)
            for both in (False, True):
                name = ring_name(S, both)
                R.reset_launch_counts()
                out = R.ring_all_gather(shards, both)
                again = R.ring_all_gather(shards, both)
                torch.cuda.synchronize()
                R.check_errors()
                check(R.LAUNCHES[name] == 2 and sum(R.LAUNCHES.values()) == 2,
                      f"K4 S={S} {shape}: launches {R.LAUNCHES}")
                plain = R.ring_all_gather_plain(shards, both)
                check(len({o.data_ptr() for o in out}) == S, "K4: ranks share an output")
                for r in range(S):
                    err = max(bits_differ(out[r], plain[r]), bits_differ(out[r], whole),
                              bits_differ(again[r], out[r]))
                    errs[name] = max(errs[name], err)
                    check(err == 0.0, f"K4 {name} S={S} {shape} {dtype} rank {r}: differs by {err}")
                cases += 1

    # the data axis of a 4 x 2 mesh: two rings of four, each over every second device
    mesh = build_mesh(MeshConfig(num_data=4, num_model=2), ["cuda:0"] * 8)
    rings = mesh.groups("data")
    check(len(rings) == 2 and all(len(ring) == 4 for ring in rings), f"rings: {rings}")
    for g, ring in enumerate(rings):
        shards = [s.to(dev) for s, dev in
                  zip(ring_shards(4, (8, 4), torch.float32, device, seed=g + 1), ring)]
        for both in (False, True):
            for o in R.ring_all_gather(shards, both):
                check(torch.equal(o, torch.cat(shards)), f"K4 on the strided axis, ring {g}")

    # 100 calls back to back, one synchronise at the end
    sets = [ring_shards(8, (64, 100), torch.float32, device, seed=10 + i) for i in range(4)]
    outs = [R.ring_all_gather(sets[i % 4], bool(i % 2)) for i in range(100)]
    torch.cuda.synchronize()
    R.check_errors()
    check(all(torch.equal(o, torch.cat(sets[i % 4])) for i, out in enumerate(outs) for o in out),
          "K4: 100 calls back to back")
    del outs

    # a rank left out of the launch: its neighbour's wait must end and be reported
    pair = ring_shards(2, (16, 16), torch.float32, device, seed=20)
    t0 = time.perf_counter()
    R._launch(pair, first=0, count=1, spin_seconds=0.01)
    torch.cuda.synchronize()
    gave_up_s = time.perf_counter() - t0
    try:
        R.check_errors()
        fail("K4: a wait that cannot end was not reported")
    except RuntimeError as e:
        check("rank 0" in str(e) and "hop 0" in str(e), f"K4 time-out report: {e}")
    check(gave_up_s < 1.0, f"K4: the bounded wait took {gave_up_s} s")
    out = R.ring_all_gather(pair)
    torch.cuda.synchronize()
    R.check_errors()
    check(torch.equal(out[0], torch.cat(pair)) and torch.equal(out[1], out[0]),
          "K4: the call after a time-out")

    # times: the wrapper as the path calls it, the plain hop loop, S calls of torch.cat
    timed = []
    for shape, dtype in RING_SHAPES:
        for S in (4, RING_TIMED_S):
            shards = ring_shards(S, shape, dtype, device)
            chunk_bytes = shards[0].numel() * shards[0].element_size()
            row = {"S": S, "shape": list(shape), "dtype": str(dtype).split(".")[-1],
                   "chunk_bytes": chunk_bytes,
                   # every rank reads S chunks and writes S chunks; nothing is computed
                   **bound(2 * S * S * chunk_bytes, 0.0)}
            iters = 50 if chunk_bytes > 1 << 20 else 200
            for both in (False, True):
                k_ms, p_ms = interleaved_ms(lambda: R.ring_all_gather(shards, both),
                                            lambda: R.ring_all_gather_plain(shards, both), iters)
                k2_ms, lib_ms = interleaved_ms(lambda: R.ring_all_gather(shards, both),
                                               lambda: [torch.cat(shards) for _ in range(S)],
                                               iters)
                row[ring_name(S, both)] = {"ms": (k_ms + k2_ms) / 2, "plain_ms": p_ms,
                                           "library_ms": lib_ms}
            torch.cuda.synchronize()
            R.check_errors()
            timed.append(row)
            print(json.dumps({"phase": "ring_kernel", **row}), flush=True)
    main = next(r for r in timed if r["S"] == RING_TIMED_S and r["shape"] == [768, 1000])
    lib = R.load_library()
    return {"errs": errs, "cases": cases, "gave_up_seconds": gave_up_s, "timed": timed,
            "main": main, "resident_blocks": lib.ring_max_resident_blocks(0),
            "blocks_per_rank": {name: R.blocks_per_rank(main["chunk_bytes"], RING_TIMED_S, d,
                                                        lib.ring_max_resident_blocks(0))
                                for name, d in (("ring_uni", 1), ("ring_bidi", 2))}}


# -- phase 11: sharded retrieval and edge-sharded propagation at full width ---------

def check_topk(name: str, vals, idx, scores, ref_vals) -> None:
    """A (B, k) result held as a top-k of ``scores`` (see the docstring)."""
    check(torch.equal(vals, ref_vals), f"{name}: values are not the dense top-k values")
    check(torch.equal(scores.gather(1, idx), vals), f"{name}: an index does not hold its value")
    check(int(idx.min()) > 0, f"{name}: the PAD row came back")
    ordered = idx.sort(dim=1).values
    check(bool((ordered[:, 1:] != ordered[:, :-1]).all()), f"{name}: an index twice in a row")


def sharded_retrieval_phase(device, root: str, graph, edges_u, edges_i) -> dict:
    from recsys_tpu_torch.config import MeshConfig, load_config
    from recsys_tpu_torch.eval.recall import sharded_scores, topk_scores
    from recsys_tpu_torch.ops.graph import make_edge_sharded_propagate, propagate
    from recsys_tpu_torch.parallel.collectives import sharded_topk, sharded_topk_ring_merge
    from recsys_tpu_torch.parallel.mesh import build_mesh
    from recsys_tpu_torch.train.gnn import train_lightgcl

    rng = np.random.default_rng(11)
    users = rng.normal(size=(RETRIEVAL_USERS, D)).astype(np.float32)
    users = torch.as_tensor(users / np.linalg.norm(users, axis=1, keepdims=True), device=device)
    items = torch.as_tensor(rng.normal(size=(RETRIEVAL_ROWS, D)).astype(np.float32),
                            device=device)
    prior = torch.as_tensor((0.05 * rng.random(RETRIEVAL_ROWS)).astype(np.float32),
                            device=device)
    k = RETRIEVAL_K
    dense_vals, dense_idx = topk_scores(users, items, k, prior=prior)
    dense_ms = cuda_ms(lambda: topk_scores(users, items, k, prior=prior), 10)
    out = {"users": RETRIEVAL_USERS, "rows": RETRIEVAL_ROWS, "k": k, "dense_ms": dense_ms,
           "by_shards": {}}
    R.reset_launch_counts()  # the sharded retrieval path's run starts here
    ring_calls = {"ring_uni": 0, "ring_bidi": 0}
    kept = {}
    for shards_n in (4, 8):
        mesh = build_mesh(MeshConfig(num_data=1, num_model=shards_n), ["cuda:0"] * shards_n)
        per_shard = sharded_scores(users, items, mesh, True, prior)
        check(len(per_shard) == shards_n
              and per_shard[0].shape == (RETRIEVAL_USERS, RETRIEVAL_ROWS // shards_n),
              f"per-shard scores: {[tuple(s.shape) for s in per_shard]}")
        scores = torch.cat(per_shard, dim=1)     # the reference's view; no path uses it
        check(bool(torch.isinf(scores[:, 0]).all() and torch.isfinite(scores[:, 1:]).all()),
              "only the global PAD row is masked")
        ref_vals, ref_idx = torch.topk(scores, k)
        stable = torch.sort(scores, dim=1, descending=True, stable=True)
        ties = int((ref_vals[:, 1:] == ref_vals[:, :-1]).sum())

        vals, idx = topk_scores(users, items, k, mesh=mesh, prior=prior)
        check_topk(f"topk_scores(mesh 1x{shards_n})", vals, idx, scores, ref_vals)
        check(bool(torch.isclose(vals, dense_vals, rtol=1e-6, atol=1e-6).all()),
              f"topk_scores(mesh 1x{shards_n}) vs the dense product: "
              f"{max_err(vals, dense_vals)}")
        agree = {"topk_scores_vs_dense": float((idx == dense_idx).float().mean())}
        check(agree["topk_scores_vs_dense"] >= 0.99, f"indices vs dense: {agree}")
        for r, (v, i) in enumerate(sharded_topk_ring_merge(per_shard, k)):
            check(torch.equal(v, stable.values[:, :k]) and torch.equal(i, stable.indices[:, :k]),
                  f"sharded_topk_ring_merge, shard {r} of {shards_n}: not the stable order")
        for both in (False, True):
            name = ring_name(shards_n, both)
            before = dict(R.LAUNCHES)
            got = R.ring_sharded_topk(per_shard, k, both)
            torch.cuda.synchronize()
            R.check_errors()
            ring_calls[name] += 1
            check(R.LAUNCHES[name] == before[name] + 1
                  and sum(R.LAUNCHES.values()) == sum(before.values()) + 1,
                  f"ring_sharded_topk launched {before} -> {R.LAUNCHES}")
            for r, (v, i) in enumerate(got):
                check_topk(f"ring_sharded_topk {name}, shard {r} of {shards_n}", v, i, scores,
                           ref_vals)
            agree[name + "_vs_topk"] = float((got[0][1] == ref_idx).float().mean())
        out["by_shards"][shards_n] = {"exact_ties_in_topk": ties, "index_agreement": agree}
        kept[shards_n] = (mesh, per_shard)
        del scores, stable
    check(R.LAUNCHES == ring_calls, f"K4 launches {R.LAUNCHES}, calls {ring_calls}")
    out["launches"] = dict(R.LAUNCHES)    # read here; the timing loops below are not the path
    for shards_n, (mesh, per_shard) in kept.items():
        out["by_shards"][shards_n].update({
            "topk_scores_mesh_ms": cuda_ms(
                lambda: topk_scores(users, items, k, mesh=mesh, prior=prior), 10),
            "sharded_topk_ms": cuda_ms(lambda: sharded_topk(per_shard, k), 10),
            "ring_merge_ms": cuda_ms(lambda: sharded_topk_ring_merge(per_shard, k), 5),
            "ring_sharded_topk_uni_ms": cuda_ms(
                lambda: R.ring_sharded_topk(per_shard, k, False), 10),
            "ring_sharded_topk_bidi_ms": cuda_ms(
                lambda: R.ring_sharded_topk(per_shard, k, True), 10)})
    torch.cuda.synchronize()
    R.check_errors()
    del kept, per_shard

    # the edge-sharded propagation on the reference-scale graph, 4 shards
    mesh = build_mesh(MeshConfig(num_data=1, num_model=4), ["cuda:0"] * 4)
    n, dim = graph.num_nodes, 64
    prop_fn, place_edges = make_edge_sharded_propagate(mesh, n, "model")
    args = place_edges(graph.src, graph.dst, graph.weight)
    check(len(args) == 4 and sum(len(s) for s, _, _ in args) >= len(graph.src),
          "edge shards")
    src, dst, w = (torch.as_tensor(a, device=device) for a in
                   (graph.src.astype(np.int64), graph.dst.astype(np.int64), graph.weight))
    x, g = (torch.as_tensor(rng.normal(size=(n, dim)).astype(np.float32), device=device)
            for _ in range(2))

    def value_and_grad(fn):
        xk = x.clone().requires_grad_(True)
        y = fn(xk)
        (dx,) = torch.autograd.grad((y * g).sum(), xk)
        return y.detach(), dx

    got, ref = value_and_grad(lambda t: prop_fn(args, t)), \
        value_and_grad(lambda t: propagate(t, src, dst, w, n))
    prop_err = {"fwd": max_err(got[0], ref[0]), "grad": max_err(got[1], ref[1])}
    check(max(prop_err.values()) <= REF_TOL, f"edge-sharded propagation vs plain: {prop_err}")
    with torch.no_grad():
        sharded_ms, plain_ms = interleaved_ms(lambda: prop_fn(args, x),
                                              lambda: propagate(x, src, dst, w, n), 5)
    del got, ref, src, dst, w, x, g
    out["edge_sharded"] = {"shards": 4, "edges": int(len(graph.src)), "err": prop_err,
                           "ms": sharded_ms, "plain_ms": plain_ms}

    # one trainer step with the sharded propagation (no K2 on this branch)
    cfg = load_config(None, {"gnn": {"epochs": 1, "steps_per_epoch_max": 1,
                                     "propagation": "segment_sum_sharded"}})
    S.reset_launch_counts()
    state, _ = train_lightgcl(cfg, graph, edges_u, edges_i, f"{root}/ckpt_gnn_sharded", "cuda",
                              mesh=mesh)
    check(state.step == 1 and np.isfinite(state.losses[0]) and sum(S.LAUNCHES.values()) == 0,
          f"sharded trainer step: {state.step} steps, loss {state.losses}, K2 {S.LAUNCHES}")
    out["trainer_step"] = {"loss": state.losses[0], "step_ms": 1e3 * state.step_seconds[0]}
    return out


# -- phase 12: the sharded path through the entry points ---------------------------

def sharded_slice_phase(root: str, n_items: int) -> dict:
    import os

    from recsys_tpu_torch.dryrun import dryrun_multichip
    from recsys_tpu_torch.pipeline import cli
    from recsys_tpu_torch.train.checkpoint import load_array_with_ids

    ref_mat, _, _ = load_array_with_ids(f"{root}/item_matrix")     # phase 2's, one device

    def world(name: str) -> list[str]:
        """A data root with phase 2's world in it, and the stage's --set list."""
        path = f"{root}/{name}"
        os.makedirs(path)
        for f in ("items.parquet", "users.parquet", "transactions.parquet"):
            shutil.copy(f"{root}/{f}", path)
        return ["--set", f"data.root={path}", "--set", "simcse.epochs=1",
                "--set", "simcse.steps_per_epoch_min=1"]

    dp = ["--set", "mesh.num_data=4", "--virtual-shards"]           # --device: the default
    sets = world("dp")
    shutil.copytree(f"{root}/ckpt_item", f"{root}/dp/ckpt_item")
    vec = cli.main(["vectorize", *sets, *dp])
    mat, _, _ = load_array_with_ids(f"{root}/dp/item_matrix")
    vec_err = float(np.abs(mat - ref_mat).max())
    check(mat.shape == (n_items + 1, 128) and vec_err <= SERVE_TOL,
          f"vectorize on 4 data shards vs one device: {mat.shape}, {vec_err}")

    K.reset_launch_counts()
    train = cli.main(["train-item", *sets, *dp])
    check(train["mesh"] == {"data": 4, "model": 1} and train["device"].startswith("cuda")
          and train["steps"] >= 10 and all(np.isfinite(train["losses"])),
          f"train-item on 4 data shards: {train}")
    # the gathered (B, D) views go through K1 as on one device: each kernel once a
    # direction of the loss, so twice a step
    check(all(n == 2 * train["steps"] for n in K.LAUNCHES.values()),
          f"K1 on the data-parallel step: {K.LAUNCHES} in {train['steps']} steps")
    k1_launches = dict(K.LAUNCHES)

    # corruption and dropout off: the loss falls, and the first step's loss is the one-device run's
    quiet = ["--set", "simcse.feature_dropout=0.0", "--set", "item_tower.dropout=0.0"]
    sharded = cli.main(["train-item", *world("dp_quiet"), *quiet, *dp])
    single = cli.main(["train-item", *world("one_quiet"), *quiet])
    check(single["mesh"] == {"data": 1, "model": 1}, f"the one-device run: {single['mesh']}")
    first_err = abs(sharded["losses"][0] - single["losses"][0])
    check(first_err <= DP_LOSS_TOL,
          f"first-step loss on 4 shards {sharded['losses'][0]} vs one {single['losses'][0]}")
    check(all(np.isfinite(sharded["losses"])) and sharded["losses"][-1] < sharded["losses"][0],
          f"the sharded loss did not fall: {sharded['losses']}")
    dry = dryrun_multichip(8)
    check(dry["mesh"] == {"data": 4, "model": 2}
          and all(np.isfinite(dry[key]) for key in ("stage1", "gnn", "ckpt_resume",
                                                     "stage2", "a2a")),
          f"dryrun_multichip: {dry}")
    return {"vectorize": {"err_vs_one_device": vec_err, "seconds": vec["seconds"],
                          "items_per_s": vec["items_per_s"]},
            "train": {**{key: train[key] for key in ("steps", "seconds", "step_ms_median",
                                                     "first_step_ms")},
                      "k1_launches": k1_launches},
            "losses": [train["losses"][0], train["losses"][-1]],
            "quiet": {"first_loss_sharded": sharded["losses"][0],
                      "first_loss_one_device": single["losses"][0], "first_loss_err": first_err,
                      "last_loss_sharded": sharded["losses"][-1],
                      "step_ms_median_sharded": sharded["step_ms_median"],
                      "step_ms_median_one_device": single["step_ms_median"]},
            "dryrun": {key: (list(v) if isinstance(v, tuple) else v) for key, v in dry.items()}}


# -- phase 13: the user-tower slice through the CLI ---------------------------------

def left_padded_batch(cfg, item_map, events: list[tuple[str, float]]) -> dict:
    """One user's stage-2 batch from (item id, ts) events, newest last, built
    here apart from the server's code: ids by the stage-2 map, time buckets by
    days before the newest event, static features zero (unknown when
    serving)."""
    from recsys_tpu_torch.data.dataset import TIME_BUCKET_EDGES

    L, utc = cfg.user_tower.max_len, cfg.user_tower
    events = events[-L:]
    k = len(events)
    b = {key: np.zeros((1, L), np.int64)
         for key in ("input_ids", "target_ids", "time_buckets", "seq_mask")}
    b["user_buckets"] = np.zeros((1, utc.static_bucket_fields), np.int64)
    b["user_cats"] = np.zeros((1, utc.static_cat_fields), np.int64)
    b["user_cont"] = np.zeros((1, utc.static_cont_fields), np.float32)
    b["input_ids"][0, L - k:] = [item_map.idx(pid) for pid, _ in events]
    days = np.array([(events[-1][1] - ts) / 86400.0 for _, ts in events])
    b["time_buckets"][0, L - k:] = np.digitize(days, TIME_BUCKET_EDGES[1:])
    b["seq_mask"][0, L - k:] = 1
    return b


def user_slice_phase(root: str) -> dict:
    import pandas as pd

    from recsys_tpu_torch.eval.recall import topk_scores
    from recsys_tpu_torch.pipeline import cli
    from recsys_tpu_torch.serve.server import make_server, serve_forever_in_thread
    from recsys_tpu_torch.train.checkpoint import load_array_with_ids
    from recsys_tpu_torch.train.sasrec import prepare_stage2, restore_stage2, tensors_to

    sets = ["--set", f"data.root={root}", "--set", "user_train.epochs=2",
            "--set", "serve.db_path=:memory:", "--set", "serve.user_backend=stage2"]
    K.reset_launch_counts()  # this path's run starts here
    train = cli.main(["train-user", *sets])
    after_train = dict(K.LAUNCHES)
    ev = cli.main(["eval", *sets])
    launches = dict(K.LAUNCHES)
    check(launches == after_train, f"eval launched K1: {after_train} -> {launches}")
    check(all(n == train["steps"] for n in launches.values()),
          f"K1 on train-user: {launches} in {train['steps']} steps")
    losses = train["epoch_losses"]
    check(train["device"].startswith("cuda") and len(losses) == 2
          and all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"train-user epoch losses {losses}")
    check(ev["n_eval"] > 0 and all(ev[f"recall@{k}"] > 0 for k in (20, 100, 500)),
          f"eval recall: {ev}")
    uvecs, _, _ = load_array_with_ids(f"{root}/eval_uvecs")
    mat, _, _ = load_array_with_ids(f"{root}/eval_item_matrix")
    _, top = topk_scores(torch.as_tensor(uvecs, device="cuda"),
                         torch.as_tensor(mat, device="cuda"), 500)
    check(int(top.min()) > 0, "a PAD row in an eval list")

    args = cli.parse_args(["serve", *sets, "--model-backed"])
    cfg = cli.config_from_args(args)
    ctx = cli.build_app(cfg, args)
    check(ctx.user_backend == "stage-2 tower (best checkpoint)", f"backend {ctx.user_backend}")
    items, users, tx = cli._load_world(cfg)
    data = prepare_stage2(cfg, items, users, tx)
    _, user_vectors, _ = restore_stage2(cfg, data, f"{root}/ckpt_user", "cuda")
    shoppers = list(tx["user_id"].drop_duplicates()[:RERANK_USERS])
    server = make_server(ctx, host="127.0.0.1", port=0)
    thread = serve_forever_in_thread(server)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    served_err, n_results, rec_ms = 0.0, 0, []
    try:
        catalog = items.sort_values("item_id").to_dict("records")
        http(base, "POST", "/api/controller/products/ingest",
             {"products": [product_json(r) for r in catalog]})
        while http(base, "POST", "/ai-api/serving/vectors/process-pending",
                   {})["processed_count"]:
            pass
        histories = {}
        for uid in shoppers:
            rows = tx[tx["user_id"] == uid].sort_values("day", kind="stable").tail(12)
            # a second apart within a day, so the store's time order is this order
            histories[uid] = [(str(i), 86400.0 * float(d) + j)
                              for j, (i, d) in enumerate(zip(rows["item_id"], rows["day"]))]
            ins = http(base, "POST", "/api/v1/debug/insert-manual-data", {
                "users": [{"user_id": str(uid)}],
                "sessions": [{"user_id": str(uid), "events": [
                    {"product_id": pid, "action_type": 3, "ts": ts}
                    for pid, ts in histories[uid]]}]})
            check(ins.get("ok", True) is not False, f"insert-manual-data: {ins}")
        done = http(base, "POST", "/ai-api/serving/users/process-pending", {})
        check(done["processed_count"] == len(shoppers), f"users process-pending: {done}")
        for uid in shoppers:
            t0 = time.perf_counter()
            rec = http(base, "GET", f"/api/controller/recommendations/{uid}?top_k=20")
            rec_ms.append(1e3 * (time.perf_counter() - t0))
            res = rec["results"]
            check(0 < len(res) <= 20 and all(r["product_id"] != "<pad>" for r in res),
                  f"recommendations for {uid}: {rec}")
            n_results += len(res)
            want = user_vectors(tensors_to(left_padded_batch(cfg, data["item_map"],
                                                             histories[uid]), "cuda"))
            served = ctx.store.get_user_vector(str(uid))
            served_err = max(served_err, float(np.abs(served - want.cpu().numpy()[0]).max()))
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    check(served_err <= SERVE_TOL, f"served user vectors vs the tower: {served_err}")
    return {"train": {k: train[k] for k in ("steps", "seconds", "step_ms_median",
                                            "epoch_losses")},
            "eval": {k: ev[k] for k in ("recall@20", "recall@100", "recall@500", "n_eval",
                                        "step_ms_median")},
            "blend_best": ev["blend"]["best_metrics"], "baselines": ev["baselines"],
            "serve": {"users": len(shoppers), "results": n_results,
                      "served_vs_tower_err": served_err,
                      "recommendation_ms_median": float(np.median(rec_ms))},
            "launches": launches}


# -- phase 14: the stage-2 step at the reference shape ---------------------------------

def reference_stage2(device, seed: int = 0) -> dict:
    """The stage-2 step at ``bench.py``'s shape, built from a seed: the default
    (full) widths, one batch of 768 users x 50 real positions with random ids
    over a 47,000-item catalog, a log-normal ``logq``, a unit-row item matrix.
    Returns the config, the step, the eval forward, the batch (numpy and on
    the device), the model and a generator."""
    from recsys_tpu_torch.config import Config
    from recsys_tpu_torch.train import sasrec
    from recsys_tpu_torch.train.state import TrainState

    cfg = Config()
    utc = cfg.user_tower
    rng = np.random.default_rng(seed)
    B, L, N = STAGE2_B, STAGE2_L, STAGE2_ITEMS
    batch_np = {
        "input_ids": rng.integers(1, N + 1, (B, L)), "target_ids": rng.integers(1, N + 1, (B, L)),
        "time_buckets": rng.integers(0, utc.num_time_buckets, (B, L)),
        "seq_mask": np.ones((B, L), np.int64),
        "user_buckets": rng.integers(0, 10, (B, utc.static_bucket_fields)),
        "user_cats": rng.integers(0, 2, (B, utc.static_cat_fields)),
        "user_cont": rng.normal(0, 1, (B, utc.static_cont_fields)).astype(np.float32)}
    logq = rng.normal(-8.0, 1.0, N + 1).astype(np.float32)
    items = rng.normal(size=(N + 1, utc.d_model)).astype(np.float32)
    items /= np.linalg.norm(items, axis=1, keepdims=True)
    items[0] = 0.0
    model = sasrec.init_stage2_params(cfg, N + 1, items, device, seed=0)
    state = TrainState(model, sasrec.make_stage2_optimizer(cfg, model, steps_per_epoch=1787))
    step, user_vectors = sasrec.make_stage2_step(cfg, state, logq)
    return {"cfg": cfg, "step": step, "user_vectors": user_vectors, "batch_np": batch_np,
            "batch": sasrec.tensors_to(batch_np, device), "model": model, "rng": rng,
            "generator": torch.Generator(device).manual_seed(seed)}


def stage2_step_phase(device) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from recsys_tpu_torch.train import sasrec
    from recsys_tpu_torch.train.state import StepTimer

    ref = reference_stage2(device)
    cfg, step, batch, gen = ref["cfg"], ref["step"], ref["batch"], ref["generator"]
    B, N, rng = STAGE2_B, STAGE2_ITEMS, ref["rng"]
    for _ in range(2):                     # warm-up: allocator, cuBLAS handles
        step(batch, gen)
    K.reset_launch_counts()  # this path's run starts here
    timer, losses = StepTimer(device), []
    for _ in range(STAGE2_STEPS):
        losses.append(step(batch, gen)["loss"])
        timer.mark()
    seconds = timer.seconds()
    launches = dict(K.LAUNCHES)
    check(all(n == STAGE2_STEPS for n in launches.values()),
          f"K1 on the stage-2 step: {launches} in {STAGE2_STEPS} steps")
    losses = [float(x) for x in losses]
    check(all(np.isfinite(losses)), f"stage-2 losses {losses}")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            step(batch, gen)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / 5
    # self time: a kernel's own row holds its device time, the op that launched it none
    dev = {e.key: (getattr(e, "self_device_time_total", None)
                   or getattr(e, "self_cuda_time_total", 0.0)) for e in prof.key_averages()}
    busy_ms = sum(dev.values()) / 1e3 / 5
    k1_ms = sum(v for k, v in dev.items() if "diag_ce" in k) / 1e3 / 5
    # the full-catalog top-500 of evaluate_stage2 for the 768 users
    data = {"tensors": {**ref["batch_np"], "user_ids": [f"u{r}" for r in range(B)]},
            "targets_idx": {f"u{r}": set(rng.integers(1, N + 1, 3).tolist()) for r in range(B)}}
    eval_timer = StepTimer(device)
    metrics = sasrec.evaluate_stage2(cfg, ref["model"], ref["user_vectors"], data, device,
                                     timer=eval_timer)
    check(metrics["n_eval"] == B and all(np.isfinite(v) for v in metrics.values()),
          f"evaluate_stage2 at the reference shape: {metrics}")
    return {"step_ms_median": 1e3 * float(np.median(seconds)),
            "step_ms": [1e3 * x for x in seconds], "losses": [losses[0], losses[-1]],
            "launches": launches, "profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "k1_device_ms": k1_ms, "k1_share_of_device": k1_ms / busy_ms if busy_ms else None,
            "eval_ms": 1e3 * sum(eval_timer.seconds()), "eval": metrics}


# -- phase 15: the hybrid slice through the CLI ---------------------------------------

def all_launches() -> dict:
    return {**K.LAUNCHES, **S.LAUNCHES, **FM.LAUNCHES, **R.LAUNCHES}


def hybrid_slice_phase(root: str) -> dict:
    from recsys_tpu_torch.pipeline import cli
    from recsys_tpu_torch.serve import recommend as RC
    from recsys_tpu_torch.serve.server import make_server, serve_forever_in_thread
    from recsys_tpu_torch.train import hybrid as H
    from recsys_tpu_torch.train.sasrec import prepare_stage2, tensors_to

    sets = ["--set", f"data.root={root}", "--set", f"user_train.epochs={HYBRID_EPOCHS}",
            "--set", f"user_train.hybrid_steps_per_epoch_min={HYBRID_STEPS_MIN}",
            "--set", "serve.db_path=:memory:", "--set", "serve.user_backend=hybrid"]
    before = all_launches()
    t0 = time.perf_counter()
    train = cli.main(["train-hybrid", *sets])
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ens = cli.main(["ensemble-eval", *sets])
    ens_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rr = cli.main(["rerank-eval", *sets, "--vectors", "hybrid",
                   "--iterations", str(HYBRID_RERANK_ITERS)])
    rr_s = time.perf_counter() - t0
    losses = train["epoch_losses"]
    check(train["device"].startswith("cuda") and train["steps"] >= 50
          and all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"train-hybrid: {train['steps']} steps, epoch losses {losses}")
    check(train["hybrid_best"].get("recall@100", 0) > 0, f"hybrid_best {train['hybrid_best']}")
    check({"ensemble", "ensemble_alive", "blend", "significance"} <= set(train),
          f"train-hybrid report: {sorted(train)}")
    check(ens["stage2_x_gnn"]["standalone_a"]["recall@100"] > 0, f"ensemble-eval: {ens}")
    check(rr["reranked"]["recall@100"] > 0 and rr["gbdt_auc"] is not None,
          f"rerank-eval --vectors hybrid: {rr}")

    args = cli.parse_args(["serve", *sets, "--vectors", "hybrid", "--model-backed"])
    cfg = cli.config_from_args(args)
    ctx = cli.build_app(cfg, args)
    check(ctx.user_backend == "hybrid tower (best checkpoint)", f"backend {ctx.user_backend}")
    assets = ctx.rec_assets
    check(assets is not None and assets.ranker is not None and assets.vectors == "hybrid",
          "serve --vectors hybrid loaded no rerank assets")
    items, users, tx = cli._load_world(cfg)
    data = prepare_stage2(cfg, items, users, tx)
    content, gnn_items, gu, gu_ids = cli._hybrid_inputs(cfg, data)
    _, uv, _ = H.restore_hybrid(cfg, data, content, gnn_items, f"{root}/ckpt_hybrid", "cuda")
    gnn_of = {str(u): gu[r] for r, u in enumerate(gu_ids)}
    shoppers = [u for u in tx["user_id"].drop_duplicates() if str(u) in gnn_of][:RERANK_USERS]
    server = make_server(ctx, host="127.0.0.1", port=0)
    thread = serve_forever_in_thread(server)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    served_err, rec_ms = 0.0, {m: [] for m in ("rerank", "blend", "cosine")}
    try:
        catalog = items.sort_values("item_id").to_dict("records")
        http(base, "POST", "/api/controller/products/ingest",
             {"products": [product_json(r) for r in catalog]})
        while http(base, "POST", "/ai-api/serving/vectors/process-pending",
                   {})["processed_count"]:
            pass
        histories = {}
        for uid in shoppers:
            rows = tx[tx["user_id"] == uid].sort_values("day", kind="stable").tail(12)
            histories[uid] = [(str(i), 86400.0 * float(d) + j)
                              for j, (i, d) in enumerate(zip(rows["item_id"], rows["day"]))]
            ins = http(base, "POST", "/api/v1/debug/insert-manual-data", {
                "users": [{"user_id": str(uid)}],
                "sessions": [{"user_id": str(uid), "events": [
                    {"product_id": pid, "action_type": 3, "ts": ts}
                    for pid, ts in histories[uid]]}]})
            check(ins.get("ok", True) is not False, f"insert-manual-data: {ins}")
        done = http(base, "POST", "/ai-api/serving/users/process-pending", {})
        check(done["processed_count"] == len(shoppers), f"users process-pending: {done}")
        for uid in shoppers:
            got = {}
            for mode in rec_ms:
                t0 = time.perf_counter()
                got[mode] = http(base, "GET", f"/api/controller/recommendations/{uid}"
                                              f"?top_k=20&mode={mode}")
                rec_ms[mode].append(1e3 * (time.perf_counter() - t0))
                res = got[mode]["results"]
                check(0 < len(res) <= 20 and all(r["product_id"] != "<pad>" for r in res)
                      and got[mode].get("mode", "cosine") == mode,
                      f"{mode} recommendations for {uid}: {got[mode]}")
            served = ctx.store.get_user_vector(str(uid))
            b = left_padded_batch(cfg, data["item_map"], histories[uid])
            want = uv(tensors_to(b, "cuda"),
                      torch.as_tensor(gnn_of[str(uid)][None], device="cuda"))
            served_err = max(served_err, float(np.abs(served - want.cpu().numpy()[0]).max()))
            events = ctx.store.user_histories([str(uid)])[str(uid)]
            iidx, days = RC.store_events_arrays(assets, events)
            offline = RC.rerank_serve_topk(assets, served[None], [(iidx, days)],
                                           int(days.max()) + 1, 20,
                                           pool_size=cfg.serve.rerank_pool,
                                           m_cos=cfg.serve.rerank_m_cos,
                                           m_pop=cfg.serve.rerank_m_pop)
            check([r["product_id"] for r in got["rerank"]["results"]]
                  == [assets.pid_of(int(r)) for r in offline[0] if int(r) != 0],
                  f"HTTP rerank list for {uid} differs from rerank_serve_topk's")
            host = RC.blend_topk(assets, served[None], [iidx], cfg.serve.blend_alpha,
                                 cfg.serve.blend_beta, 20, backend="host")
            check([r["product_id"] for r in got["blend"]["results"]]
                  == [assets.pid_of(int(r)) for r in host[0]],
                  f"HTTP blend (device) list for {uid} differs from the host blend")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    check(served_err <= SERVE_TOL, f"served user vectors vs the hybrid tower: {served_err}")
    after = all_launches()
    check(after == before, f"the hybrid slice launched a hand kernel: {before} -> {after}")
    return {"train": {k: train[k] for k in ("steps", "seconds", "step_ms_median", "epoch_losses",
                                            "logit_scale", "report_seconds")},
            "stage_seconds": {"train-hybrid": train_s, "ensemble-eval": ens_s,
                              "rerank-eval": rr_s},
            "hybrid_best": train["hybrid_best"], "hybrid_history": train["hybrid_history"],
            "blend_best": train["blend"]["best_metrics"], "gnn_arm": train["gnn_arm"],
            "ensemble_eval_weighted": ens["stage2_x_gnn"]["weighted"]["best"],
            "rerank": {k: rr[k] for k in ("reranked", "gbdt_auc", "dcn_auc", "gbdt_seconds",
                                          "gbdt_iterations")},
            "serve": {"users": len(shoppers), "served_vs_tower_err": served_err,
                      "recommendation_ms_median": {m: float(np.median(v))
                                                   for m, v in rec_ms.items()}},
            "hand_kernel_launches": {k: after[k] - before[k] for k in after}}


# -- phase 16: the hybrid step at the stage-2 reference shape ----------------------------

def profile_steps(fn, n: int) -> dict:
    """``n`` calls of ``fn`` under ``torch.profiler``: wall and device time a
    call, device launches a call and the top device items by self time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / n
    dev, count = {}, 0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)
        if t > 0:
            dev[e.key] = t / 1e3 / n
            count += e.count
    busy = sum(dev.values())
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": max(0.0, 1.0 - busy / wall_ms) if wall_ms else None,
            "launches_per_call": count / n,
            "top_device_items_ms": {k[:160]: v for k, v in top}}


def hybrid_step_phase(device) -> dict:
    from recsys_tpu_torch.config import Config
    from recsys_tpu_torch.train import hybrid as H
    from recsys_tpu_torch.train.sasrec import tensors_to
    from recsys_tpu_torch.train.state import StepTimer, TrainState

    cfg = Config()
    utc = cfg.user_tower
    rng = np.random.default_rng(0)
    B, L, N = STAGE2_B, STAGE2_L, STAGE2_ITEMS
    batch_np = {
        "input_ids": rng.integers(1, N + 1, (B, L)), "target_ids": rng.integers(1, N + 1, (B, L)),
        "time_buckets": rng.integers(0, utc.num_time_buckets, (B, L)),
        "seq_mask": np.ones((B, L), np.int64),
        "user_buckets": rng.integers(0, 10, (B, utc.static_bucket_fields)),
        "user_cats": rng.integers(0, 2, (B, utc.static_cat_fields)),
        "user_cont": rng.normal(0, 1, (B, utc.static_cont_fields)).astype(np.float32)}
    logq = rng.normal(-8.0, 1.0, N + 1).astype(np.float32)
    content = rng.normal(size=(N + 1, D)).astype(np.float32)
    content /= np.linalg.norm(content, axis=1, keepdims=True)
    content[0] = 0.0
    gnn_items = rng.normal(0, 0.1, (N + 1, HYBRID_GNN_DIM)).astype(np.float32)
    gnn_items[0] = 0.0
    model = H.build_hybrid_model(cfg, N + 1, D, HYBRID_GNN_DIM, device, seed=0)
    check(model.encoder.num_layers == 4, "the hybrid tower must have its 4 layers")
    opt, sched = H.make_hybrid_optimizer(cfg.user_train, model, 1000)
    state = TrainState(model, opt, sched)
    step, uv, im = H.make_hybrid_step(cfg, state, content, gnn_items, logq)
    batch = tensors_to(batch_np, device)
    gnn_users = torch.as_tensor(rng.normal(0, 0.1, (B, HYBRID_GNN_DIM)).astype(np.float32),
                                device=device)
    gen = torch.Generator(device).manual_seed(0)
    for _ in range(2):                     # warm-up: allocator, cuBLAS handles
        step(batch, gnn_users, gen)
    before = all_launches()
    timer, losses = StepTimer(device), []
    for _ in range(STAGE2_STEPS):
        losses.append(step(batch, gnn_users, gen)["loss"])
        timer.mark()
    seconds = timer.seconds()
    losses = [float(x) for x in losses]
    check(all(np.isfinite(losses)), f"hybrid losses {losses}")
    check(all_launches() == before, "the hybrid step launched a hand kernel")
    prof = profile_steps(lambda: step(batch, gnn_users, gen), 5)
    # the adapted catalog and the top-500 of hybrid_eval for the 768 users
    t0 = time.perf_counter()
    items = im()
    _, top = torch.topk(uv(batch, gnn_users) @ items.T, 500, dim=1)
    torch.cuda.synchronize()
    eval_ms = 1e3 * (time.perf_counter() - t0)
    # the smallest launch torch makes: a one-element add, its device time and host cost
    one = torch.zeros(1, device=device)
    launch = profile_steps(lambda: one.add_(1.0), 200)
    return {"shape": {"users": B, "positions": L, "catalog": N, "content_dim": D,
                      "gnn_dim": HYBRID_GNN_DIM, "layers": 4},
            "step_ms_median": 1e3 * float(np.median(seconds)),
            "step_ms": [1e3 * x for x in seconds], "losses": [losses[0], losses[-1]],
            "profiled": prof, "eval_top500_ms": eval_ms,
            "one_element_kernel": {"device_ms": launch["device_busy_ms"],
                                   "host_ms_per_call": launch["wall_ms"]}}


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    start = time.perf_counter()
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "python": sys.version.split()[0], "allow_tf32": False}), flush=True)
    print(card_line(), flush=True)
    t0 = time.perf_counter()
    modules = {"diag_ce": K, "spmm": S, "fm": FM, "ring": R}
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
        rstats = ring_phase(device)
        print(json.dumps({"phase": "ring_kernel_summary",
                          **{k: v for k, v in rstats.items() if k != "timed"}}), flush=True)
        retrieval = sharded_retrieval_phase(device, root, graph, edges_u, edges_i)
        print(json.dumps({"phase": "sharded_retrieval", **retrieval}), flush=True)
        del graph, edges_u, edges_i
        fstats = fm_phase(device)
        reranker, rows = reranker_slice_phase(root)
        print(json.dumps({"phase": "reranker_slice", **reranker}), flush=True)
        deepfm = deepfm_phase(root, rows)
        print(json.dumps({"phase": "deepfm", **deepfm}), flush=True)
        sharded = sharded_slice_phase(root, result["vectorize"]["shape"][0] - 1)
        print(json.dumps({"phase": "sharded_slice", **sharded}), flush=True)
        user = user_slice_phase(root)
        print(json.dumps({"phase": "user_slice", **user}), flush=True)
        stage2 = stage2_step_phase(device)
        print(json.dumps({"phase": "stage2_step", **stage2}), flush=True)
        seconds = {"phases_1_to_14": time.perf_counter() - start}
        hybrid = hybrid_slice_phase(root)
        print(json.dumps({"phase": "hybrid_slice", **hybrid}), flush=True)
        seconds["phase_15"] = time.perf_counter() - start - sum(seconds.values())
        hstep = hybrid_step_phase(device)
        print(json.dumps({"phase": "hybrid_step", **hstep}), flush=True)
        seconds["phase_16"] = time.perf_counter() - start - sum(seconds.values())
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"seconds": {**seconds, "total": time.perf_counter() - start}}), flush=True)

    # K1's launches are the main path's: train-item (phase 2) and train-user (phase
    # 13); its times are at the SimCSE shape, stage 2's B = 3072 and 8192 beside them
    k1_bounds = diag_ce_bounds(MAIN_B, D)
    kernels = [{"name": name, "route": "cuda", "source": SOURCES["diag_ce"],
                "replaces": REPLACES[name],
                "launches": result["launches"][name] + user["launches"][name],
                "launches_train_item": result["launches"][name],
                "launches_train_user": user["launches"][name],
                "max_abs_err": kstats["errs"][name],
                "ms": kstats["ms"][name][0], "plain_ms": kstats["ms"][name][1],
                **k1_bounds[name], "library_ms": None,
                "B3072": kstats["B3072"][name], "B8192": kstats["B8192"][name]}
               for name in K.LAUNCHES]
    # K2's launches are the trainer's at the real size, its times those of the
    # trainer's mode (bf16) there; the f32 mode and the CLI path's launches and graph
    # go beside them
    kernels += [{"name": name, "route": "cuda", "source": SOURCES["spmm"],
                 "replaces": REPLACES[name], "launches": trainer["launches"][name],
                 "launches_cli_path": gnn["launches"][name],
                 **{k: sstats[name][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                 "bound_by", "library_ms")}}
                for name in S.LAUNCHES]
    kernels[len(K.LAUNCHES)].update({"mode": "bf16", "f32_mode": sstats["spmm_csr"]["f32"],
                                     "cli_path_graph": gnn["spmm_at_this_graph"]})
    # K3's times are at the training shape, where most of its launches are; the
    # scoring shape (one launch a request) goes beside them
    kernels += [{"name": name, "route": "cuda", "source": SOURCES["fm"],
                 "replaces": REPLACES[name], "launches": deepfm["launches"][name],
                 "max_abs_err": fstats["errs"][name], **fstats["train"][name],
                 "library_ms": None,
                 "scoring_shape": fstats["score"][name],
                 "scoring_shape_bf16": fstats["score_bf16"][name]}
                for name in FM.LAUNCHES]
    # K4's launches are phase 11's (one a ring_sharded_topk call); its times are at
    # S = 8 virtual ranks on the one card and the packed top-k chunk: device-memory
    # times, no time between cards
    kernels += [{"name": name, "route": "cuda", "source": SOURCES["ring"],
                 "replaces": REPLACES[name], "launches": retrieval["launches"][name],
                 "max_abs_err": rstats["errs"][name], **rstats["main"][name],
                 "bound_ms": rstats["main"]["bound_ms"], "bound_by": rstats["main"]["bound_by"],
                 "virtual_ranks": RING_TIMED_S, "chunk_bytes": rstats["main"]["chunk_bytes"]}
                for name in R.LAUNCHES]
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
