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
     (abs); two dq and two dk calls must give the same bits. CUDA-event times of kernel
     and plain form, per kernel at B=192, 3072 and 8192.
  2. slice: the port's CLI stages gen-data -> train-item (full-width item
     tower, batch 192, ~10 steps) -> vectorize on the card. train-item runs
     its step as one CUDA graph (``train/step_graph.StepGraph``): the first
     WARMUP_STEPS steps eagerly, every later one a replay, exactly. K1's launch
     counts (a captured launch counts once a replay) are zeroed just before
     and read just after; every kernel must have launched. Then the item step
     on that catalog, eager and captured, from one seeded state with
     ``simcse.feature_dropout=0`` and ``item_tower.dropout=0`` (the name-word
     deletion draws from generators of one seed): GRAPH_STEPS steps on the
     same batches, losses within GRAPH_LOSS_TOL every step and parameters
     within GRAPH_PARAM_TOL at the end (the same kernels replayed; a sum by
     atomics, as in the embedding backward, may add in another order); the
     step medians in turns (eager, captured, captured, eager; CUDA events),
     K1 twice a step, a replay under ``set_sync_debug_mode("error")`` (no
     host sync inside it), and five steps of each under ``torch.profiler``
     (device busy and idle share, kernels run and host launch calls a step).
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
     kernel calls must give the same bits. A call is one launch: the hub rows
     (rows of more than 256 edges) are finished inside it, and must equal
     ``hub_finish_plain`` of the partial rows it wrote bit for bit; 200 calls
     and three replays of a CUDA-graph capture must equal the eager call bit
     for bit, and the arrival counters must be zero after them. CUDA-event
     times of kernel, plain form and ``torch.sparse.mm`` on a CSR tensor,
     beside each mode's byte bound (x counted in 2 bytes in "bf16").
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
     bits. CUDA-event times of each kernel (the wrapper in a loop) and its
     plain form, and the kernel's device time (``torch.profiler``), beside the
     byte bound, at the training and the scoring shape.
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
     optimizer step, exactly, and none from ``eval``; every step after the
     eager warm-up a graph replay. Losses finite, the epoch
     mean falling, Recall@{20,100,500} > 0, the served user vector within
     SERVE_TOL of the tower's eval forward on the same left-padded history, no
     PAD row in any list.
  14. the stage-2 step at the reference shape (``bench.py``'s: B 768, L 50,
     47,000 items, a log-normal ``logq``, a unit-row item matrix; four
     batches of users), built here, through ``StepGraph`` eager and captured:
     the captured step against the eager one from one seeded state with
     ``user_tower.dropout=0``, ``user_train.random_cut_prob=0`` and the
     sampled positions fixed through ``draws`` (GRAPH_STEPS steps, the
     tolerances of phase 2); then both with the default config, the step
     medians in turns (StepTimer), K1 exactly once a step; a replay under
     ``set_sync_debug_mode("error")``; five steps of each under
     ``torch.profiler`` (busy and idle share, kernels run and host launch
     calls a step, K1's share of the device time); then
     ``evaluate_stage2``'s full-catalog top-500 for 768 users.
  15. the hybrid slice through the CLI on the world of phase 2, reusing its
     stage-1 matrix, phase 5's GNN artifacts and phase 13's eval sidecars:
     ``train-hybrid`` at full width (the tower's 4 layers, batch 768; 4 epochs
     x 13 passes = 52 steps; the ensemble report on), ``ensemble-eval``,
     ``rerank-eval --vectors hybrid`` (HYBRID_RERANK_ITERS boosting
     iterations, the DCN arm), then ``serve --vectors hybrid --model-backed``
     with ``serve.user_backend=hybrid`` and requests in rerank, blend and
     cosine mode for a few users. Gates: the epoch loss finite and falling,
     every step after the warm-up a graph replay (``graph_replays``),
     ``hybrid_best`` Recall@100 > 0, the served user vector within SERVE_TOL of
     the tower's forward on the same history and GNN vector, the HTTP rerank
     list equal to ``rerank_serve_topk``'s offline list, the HTTP blend (the
     device form on the card) equal to the host blend, and no launch of K1-K4
     across the phase (the path has no hand kernel).
  16. the hybrid step at phase 14's shape (768 users x 50 positions, 47,000
     items, content 128 + GNN 64, 4 layers; four batches of users), built
     here from a seed, through ``train/hybrid.hybrid_runner`` eager and
     captured: the captured step against the eager one from one seeded state
     with ``user_tower.dropout=0``, ``user_train.random_cut_prob=0`` and the
     GNN keep mask fixed through ``draws`` (the tolerances of phase 2), and
     the same with the default config (every draw from the registered
     generator; reported, not gated); then both with the default config, the
     step medians in turns (StepTimer), a replay under
     ``set_sync_debug_mode("error")``, five steps of each under
     ``torch.profiler`` (device busy and idle share, kernels run and host
     launch calls a step, the top device items), no hand kernel launched, the
     adapted catalog's top-500 for 768 users, and the device time and host
     cost of a one-element add (the smallest launch).

  17. the device indexes at full size, on bench_retrieval.py's four catalogs
     (47,000 items k = 500 and k = 50, 105,000, 1,000,000; B = 1024 queries,
     D = 128, ``default_rng(0)``, PAD row zero): exact (``topk_scores``), int8
     (``ops/quant.int8_topk``) and IVF (``ops/ivf``, nlist / nprobe as there)
     timed with CUDA events over chained repeats, the IVF build's seconds
     (IVF dropped from a row whose build passes IVF_BUILD_LIMIT_S), recalls
     against exact. Gates: the int8 accumulator equals the exact integer
     product for every query; the int8 top-k equals the plain form's
     tie-exact top-k; at 47,000 items IVF with every bucket probed gives the
     exact top-k (values within IVF_TOL, ids equal but for ties at the edge);
     no launch of K1-K4.
  18. serving on the world of phase 2 through ``cli.build_app`` with
     ``serve.ann_backend=int8`` and then ``ivf`` (at the default probe
     count, 8 of ~45 buckets here) behind the HTTP server: ingest,
     process-pending, similarity for items whose exact best hit leads the
     second by more than SERVE_TOL, ten answers each, none the item itself,
     scores within SERVE_TOL of the exact ones over the stored vectors, no
     hand kernel. int8 gives the exact top hit for each of SIMILARITY_QUERIES
     such items. IVF probes a few buckets, so it promises no exact top hit:
     over IVF_QUERIES such items its share of exact top hits must reach
     IVF_TOP_HIT_FLOOR; beside it, the index with every bucket probed gives
     the exact top hit for each of them.
     With int8, POST /train/item-tower and /train/user-tower (one epoch
     each) on the store, with TRAIN_ROUTE_USERS users' purchases:
     "trained", finite losses, each K1 kernel twice a step (SimCSE) and once a
     step (stage 2).
  19. the pretrained text encoder from H&M-format CSVs, in its own data root:
     articles.csv (the 25 Kaggle columns), customers.csv and
     transactions_train.csv written here from a seed at the default world's
     scale (2,000 articles, 1,000 customers, 40,000 transactions over 120
     days), then ``ingest-hm`` -> ``etl`` -> ``pretrain-text`` ->
     ``train-item --set item_tower.text_encoder=pretrained`` (full width,
     batch 192, 10 steps) -> ``vectorize`` -> ``serve --model-backed`` ->
     ``orchestrate --once`` over 64 ingested products, then one scheduler
     cycle whose weekly branch is due (an injected clock): ``/train/start``
     trains in the background. The gates of phases 2 and 3, and: the
     artifact has nonzero rows; each K1 kernel exactly twice a step in
     ``train-item`` and in the background training; the checkpoint's
     ``pretrained_embedding`` bit-identical to the artifact; orchestrate
     drains all 64. Last, two steps of each encoder under
     ``metrics.profile_trace``: the trace file names K1 six times a step;
     launches and device time a step, pretrained beside hash; then each
     encoder's step median over 10 untraced steps, in turns (hash,
     pretrained, pretrained, hash), and the host CPU's name.
  20. the main path at the H&M catalog: the world of
     scripts/quality_hm_v4_data.sh (105,000 items, 365 days,
     ``data.repeat_prob=0.10``, ``data.name_style_words=2``) cut to fit the
     run: users 1,370,000 -> 60,000, ``simcse.epochs`` 3 -> 1,
     ``user_train.epochs`` 25 -> 1, HM_CUT_REQUESTS recommendations. Through
     the CLI: gen-data -> etl (host work, in a child process started
     before the kernels build, so that it runs beside phases 1-19) ->
     train-item (full width, 546 steps) -> vectorize -> train-user (full
     width) -> eval -> serve --model-backed
     with ``serve.user_backend=stage2``, blend mode over the 105,001-row
     catalog. Gates: gen-data's and etl's JSON, eval's n_eval and the
     popularity and repurchase baselines (within 1e-12) equal to
     HM_CUT_REF, the JAX package's numbers; each K1 kernel exactly twice a
     train-item step and once a train-user step, none from eval; both
     trainers' steps graph replays after the warm-up; train-item's
     losses finite and falling (the mean of the last 50 steps below the
     first 50's), train-user's finite (one epoch); Recall@{20,100,500} > 0;
     the served user vector within SERVE_TOL of the tower's; tie order:
     ``topk_scores``, the device blend and the blend sweep on a 105,001-row
     matrix of repeated rows equal to a numpy reference that puts equal
     scores lowest index first (``np.lexsort``). Then ``topk_scores``'
     top-500 at (768, 105,001): ``torch.topk`` against ``stable_topk`` on
     the same scores, in turns, and the whole call, CUDA events.
  21. the headline recipe (``scripts/torch_quality_hm.py --recipe hybrid``)
     on phase 20's world and stage-1 matrix, cut: train-gnn (HM_CUT_GNN_STEPS
     steps; the graph's size in its JSON) -> gnn-eval -> distill ->
     train-hybrid (one epoch at full width, captured, no ensemble report) ->
     rerank-eval --vectors hybrid (HM_CUT_RERANK: a small pool) -> serve
     --model-backed --vectors hybrid, one recommendation a mode (rerank,
     blend, cosine) for a user of the GNN artifact. Gates: K2 exactly four
     times a train-gnn step plus the export's and the check's two each, the
     GNN check; gnn-eval's and the hybrid's and the rerank's recalls finite
     and > 0; every train-hybrid step after the warm-up a graph replay, no hand
     kernel there; the served user vector within SERVE_TOL of the tower's
     forward on the same history and GNN row; the HTTP rerank list equal to
     ``rerank_serve_topk``'s offline list.

Phase 2 also holds each K1 kernel to exactly two launches a step.

One line holds every kernel with its launches, error, times and bound. The
last line is {"ok": true, "device": {...}}; any failure exits non-zero
without it. TF32 is off, so the plain fp32 oracle is full fp32.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
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
    from recsys_tpu_torch.train.step_graph import WARMUP_STEPS
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
# stage 2 at the reference shape (bench.py:71-95) and the rows its loss sees; the
# phase's data holds STAGE2_BATCHES batches of users
STAGE2_B, STAGE2_L, STAGE2_P, STAGE2_ITEMS, STAGE2_STEPS = 768, 50, 4, 47_000, 20
STAGE2_BATCHES = 4
# a captured step against the eager step from the same state (phases 2 and 14):
# GRAPH_STEPS steps on the same batches, losses within GRAPH_LOSS_TOL every step,
# every parameter within GRAPH_PARAM_TOL at the end; step times in turns of
# TURN_STEPS steps (eager, captured, captured, eager)
GRAPH_STEPS, GRAPH_LOSS_TOL, GRAPH_PARAM_TOL, TURN_STEPS = 20, 1e-5, 1e-5, 10
TURNS = ("eager", "captured", "captured", "eager")
# the hybrid slice (phase 15): 4 epochs x 13 passes of the 1,000-user world (one
# 768-user batch a pass) = 52 steps; the rerank GBDT's boosting iterations
HYBRID_EPOCHS, HYBRID_STEPS_MIN, HYBRID_RERANK_ITERS, HYBRID_GNN_DIM = 4, 13, 100, 64
# the device indexes (phase 17): bench_retrieval.py's catalogs (items, k, nlist, nprobe),
# queries and chained repeats; IVF at full probe against the exact top-k (unit rows,
# sums in another order); the 1M row drops IVF if its build passes the limit
RETRIEVAL_CATALOGS = ((47_000, 500, 256, 32), (47_000, 50, 256, 16),
                      (105_000, 500, 512, 32), (1_000_000, 100, 1024, 32))
RETRIEVAL_B, RETRIEVAL_REPS, IVF_TOL, IVF_BUILD_LIMIT_S = 1024, 20, 1e-5, 120.0
# phase 18: similarity queries a backend, users whose purchases feed /train/user-tower;
SIMILARITY_QUERIES, TRAIN_ROUTE_USERS = 16, 64
# IVF served at its default probe count: the share of IVF_QUERIES well-separated
# items whose top hit is the exact one. IVF misses a few in a hundred of them
# in this world (PERF.md); the floor lies over five binomial deviations below
# that share at 256 queries. IVF_FULL_PROBE probes every bucket (more than any
# nlist here), where the answer is the exact one.
IVF_QUERIES, IVF_TOP_HIT_FLOOR, IVF_FULL_PROBE = 256, 0.85, 1 << 16
# phase 20: the H&M world's shape (scripts/quality_hm_v4_data.sh) with its users cut
# from 1,370,000 to 60,000; one epoch of each tower; 546 SimCSE steps (105,000 // 192)
HM_CUT_ITEMS, HM_CUT_ITEM_STEPS, HM_CUT_REQUESTS = 105_000, 546, 5
HM_CUT_WORLD_TIMEOUT_S = 300.0   # the wait for gen-data and etl once phase 19 has ended
# phase 21: the headline recipe on phase 20's world, cut: GNN steps, and rerank-eval's
# pool (its cosine and popularity arms), inner-split users and boosting iterations
HM_CUT_GNN_STEPS, HM_CUT_SERVE_PRODUCTS = 300, 256
HM_CUT_RERANK = ("--pool", "128", "--m-cos", "96", "--m-pop", "32", "--sample", "2000",
                 "--iterations", "50")
HM_CUT_WORLD = ("--set", f"data.num_items={HM_CUT_ITEMS}", "--set", "data.num_users=60000",
                "--set", "data.days=365", "--set", "data.repeat_prob=0.10",
                "--set", "data.name_style_words=2")
# the JAX package's numbers at HM_CUT_WORLD, printed by scripts/jax_hm_cut_reference.py
# (its gen-data and etl stages, prepare_stage2 and baseline_report, on the CPU)
HM_CUT_REF = {
    "gen": {"items": 105000, "users": 60000, "transactions": 1463167,
            "oracle": {"oracle_recall": 0.22993149481819777,
                       "popularity_recall": 0.04180572633058142, "k": 100,
                       "target_rows": 5693}},
    "etl": {"split_day": 358,
            "sanity": {"pad_inside_sequence": 0, "target_users": 9502,
                       "covered_target_users": 9501, "coverage": 0.9998947589981056},
            "missing": {"missing_tx": 0, "total_tx": 1463167}},
    "n_eval": 9499,
    "baselines": {"popularity": {"recall@20": 0.015601357445235728,
                                 "recall@100": 0.03758803045570062,
                                 "recall@500": 0.07681937963546562},
                  "repurchase": {"recall@20": 0.15698900180424677,
                                 "recall@100": 0.183654829922859,
                                 "recall@500": 0.20733779677879127}}}


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
        dq, dk = K.diag_ce_bwd_dq_cuda(*args), K.diag_ce_bwd_dk_cuda(*args)
        dq_err = float((dq - K.diag_ce_bwd_dq_plain(*args)).abs().max())
        dk_err = float((dk - K.diag_ce_bwd_dk_plain(*args)).abs().max())
        # both sum partial results of several blocks, in a fixed order
        check(torch.equal(K.diag_ce_bwd_dq_cuda(*args), dq)
              and torch.equal(K.diag_ce_bwd_dk_cuda(*args), dk),
              f"B={B} D={dim} {form}: two dq or dk calls differ in their bits")
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


def slice_phase(root: str, device: str = "cuda", extra_sets: tuple = (),
                world: tuple = (("gen-data",),), via_orchestrate: bool = False) -> dict:
    """The CLI stages of ``world`` (each a stage and its own arguments), then
    train-item -> vectorize -> serve with the trained encoder. The served
    catalog is drained by a process-pending loop here, or with
    ``via_orchestrate`` by ``orchestrate --once`` and then one scheduler cycle
    whose weekly trigger is due (``/train/start`` must launch K1)."""
    import pandas as pd

    from recsys_tpu_torch.train.checkpoint import load_array_with_ids
    from recsys_tpu_torch.pipeline import cli
    from recsys_tpu_torch.serve.server import make_server, serve_forever_in_thread
    from recsys_tpu_torch.train.simcse import MODEL_INPUTS, restore_model, topk_items

    sets = ["--set", f"data.root={root}", "--set", "simcse.epochs=1",
            "--set", "simcse.steps_per_epoch_min=1", "--set", "serve.db_path=:memory:",
            *extra_sets, "--device", device]
    stage_seconds, stages = {}, {}
    for stage in world:
        t0 = time.perf_counter()
        stages[stage[0]] = cli.main([*stage, *sets])
        stage_seconds[stage[0]] = time.perf_counter() - t0
    n_items = len(pd.read_parquet(f"{root}/items.parquet"))
    K.reset_launch_counts()  # the main path's run starts here
    t0 = time.perf_counter()
    train = cli.main(["train-item", *sets])
    stage_seconds["train-item"] = time.perf_counter() - t0
    counts_after_train = dict(K.LAUNCHES)
    check(device == "cpu" or all(n == 2 * train["steps"] for n in counts_after_train.values()),
          f"train-item: K1 launches {counts_after_train} in {train['steps']} steps "
          "(each kernel twice a step, one a direction)")
    check(device == "cpu" or train["graph_replays"] == train["steps"] - WARMUP_STEPS,
          f"train-item: {train['graph_replays']} graph replays in {train['steps']} steps")
    check(train["steps"] >= 10, f"train-item took {train['steps']} steps")
    check(all(np.isfinite(train["losses"])), f"non-finite loss: {train['losses']}")
    t0 = time.perf_counter()
    vec = cli.main(["vectorize", *sets])
    stage_seconds["vectorize"] = time.perf_counter() - t0
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
    if cfg.item_tower.text_encoder == "pretrained":   # the frozen table never moved
        from recsys_tpu_torch.data.text_pretrain import load_text_pretrain

        table = cpu_model.encoder.text_encoder.pretrained_embedding
        check(torch.equal(table, torch.as_tensor(load_text_pretrain(f"{root}/text_pretrain"))),
              "the checkpoint's pretrained_embedding differs from the artifact")
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
        if via_orchestrate:
            drained = cli.main(["orchestrate", "--once", "--server", base])
            processed, loops = drained["vectorized"], drained["loops"]
        else:
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
        weekly = weekly_trigger(base, ctx, device) if via_orchestrate else None
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    out = {"stage_seconds": stage_seconds, "world": stages} if via_orchestrate else {}
    if weekly:
        out["weekly"] = weekly
    return {**out, "train": {k: train[k] for k in ("steps", "graph_replays", "seconds",
                                                   "step_ms_median", "first_step_ms")},
            "final_loss": train["losses"][-1], "first_loss": train["losses"][0],
            "vectorize": {k: vec[k] for k in ("shape", "seconds", "items_per_s")},
            "self_rank1": self_rank1, "card_vs_cpu_encode_err": card_cpu_err,
            "serve": {"processed": processed, "loops": loops, "process_pending_s": process_s,
                      "served_vs_vectorize_err": served_err, "score_err": score_err,
                      "similarity_ms": sim_ms},
            "launches": counts_after_train}


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
        check(S.LAUNCHES == {"spmm_csr": 2},
              f"K2 {mode} forward + backward: one launch each: {S.LAUNCHES}")
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

    # the kernel alone against its plain form, with times
    partial = torch.empty((layout.num_partials, dim), device=device)
    scratch = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream
    x_as = {"f32": x, "bf16": x.to(torch.bfloat16)}

    def segments_only(mode):  # spmm_csr without the cast of x; not counted
        S.launch_csr(layout, x_as[mode], scratch, partial, stream)

    hub_finish = hub_finish_checks(layout, x, scratch, partial, segments_only)
    a_csr = torch.sparse_csr_tensor(layout.rowptr, layout.col, layout.val, size=(n, n))
    lib_err = max_err(torch.sparse.mm(a_csr, x), out)
    E = layout.num_edges
    by_mode = {}
    for mode in S.PRECISIONS:
        csr_ms, plain_ms = interleaved_ms(lambda: segments_only(mode),
                                          lambda: S.spmm_plain(layout, x, mode), 20)
        wrapper_ms, library_ms = interleaved_ms(lambda: S.spmm_cuda(layout, x, mode),
                                                lambda: torch.sparse.mm(a_csr, x), 20)
        x_bytes = x_as[mode].element_size()
        by_mode[mode] = {
            "max_abs_err": max(errs[mode]["fwd"]["kernel_vs_plain"],
                               errs[mode]["grad"]["kernel_vs_plain"], small_err[mode]),
            "ms": csr_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            # the wrapper's call: the cast of x (bf16), then the one launch
            "wrapper_ms": wrapper_ms,
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
    check(int(S.hub_counters(layout, stream).abs().sum()) == 0,
          "K2: arrival counters not zero after the timed calls")
    main = by_mode["bf16"]   # the trainer's mode
    stats = {
        "small_graph_err": small_err, "reference_scale": errs, "layout_seconds": layout_s,
        "bf16_vs_f32_out": bf16_vs_f32, "bf16_cast_ms": cast_ms,
        "shape": {"nodes": n, "edges": E, "dim": dim, "segments": layout.num_segments,
                  "hub_rows": layout.num_hubs, "partials": layout.num_partials,
                  "max_row": int(layout.rowptr.diff().max())},
        "spmm_csr": {**main, "mode": "bf16", "f32": by_mode["f32"],
                     "library_vs_kernel_err": lib_err, "hub_finish": hub_finish},
    }
    return stats


def hub_finish_checks(layout, x, out, partial, segments_only) -> dict:
    """The hub rows K2 finishes inside its launch, on the reference-scale
    graph: bit-equal to ``hub_finish_plain`` of the partial rows that launch
    wrote (both modes); one launch a call; 200 calls bit-identical; a
    CUDA-graph capture replayed three times bit-equal to the eager call; the
    arrival counters at zero after all of it. Times of the plain finish and
    of ``torch.segment_reduce`` on the same partial rows, beside the bound of
    a separate pass (partial rows read once, hub rows written once)."""
    hub_row = layout.hub_row.long()
    equal = {}
    for mode in S.PRECISIONS:
        segments_only(mode)
        torch.cuda.synchronize()
        equal[mode] = torch.equal(out[hub_row], S.hub_finish_plain(layout, partial))
        check(equal[mode], f"K2 {mode}: hub rows differ from hub_finish_plain")
    S.reset_launch_counts()
    first = S.spmm_cuda(layout, x, "bf16")
    check(S.LAUNCHES == {"spmm_csr": 1}, f"K2: launches a call {S.LAUNCHES}")
    differ = sum(not torch.equal(S.spmm_cuda(layout, x, "bf16"), first) for _ in range(200))
    check(differ == 0, f"K2: {differ} of 200 calls differ from the first in their bits")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):   # the capture stream's counters, made before capture
        S.spmm_cuda(layout, x, "bf16")
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        captured = S.spmm_cuda(layout, x, "bf16")
    replays_equal = True
    for _ in range(3):
        captured.zero_()
        graph.replay()
        torch.cuda.synchronize()
        replays_equal &= torch.equal(captured, first)
    check(replays_equal, "K2: a CUDA-graph replay differs from the eager call")
    stream = torch.cuda.current_stream().cuda_stream
    zero = all(int(S.hub_counters(layout, s).abs().sum()) == 0
               for s in (stream, side.cuda_stream))
    check(zero, "K2: arrival counters not zero after the calls")
    del graph, captured

    segments_only("f32")
    offsets = layout.hub_ptr.long()
    library = torch.segment_reduce(partial, "sum", offsets=offsets, axis=0)
    plain = S.hub_finish_plain(layout, partial)
    library_err = max_err(library, plain)
    check(library_err <= REF_TOL, f"K2 hub rows vs segment_reduce: {library_err}")
    plain_ms = cuda_ms(lambda: S.hub_finish_plain(layout, partial), 5)
    library_ms = cuda_ms(lambda: torch.segment_reduce(partial, "sum", offsets=offsets,
                                                      axis=0), 50)
    P, H, dim = layout.num_partials, layout.num_hubs, x.shape[1]
    return {"hub_rows": H, "partial_rows": P,
            "largest_hub_segments": int(layout.hub_ptr.diff().max()) if H else 0,
            "bit_equal": equal, "calls_differing_of_200": differ,
            "graph_replays_bit_equal": replays_equal, "counters_zero": zero,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library_vs_plain_err": library_err,
            "separate_pass_bound": bound(4 * (P * dim + H * dim + 2 * H + 1), float(P * dim))}


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
          and launches == {"spmm_csr": expected},
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
    check(state.step == steps and launches == {"spmm_csr": per_step * steps},
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
            dev = {name: profile_steps(fn, iters)["device_busy_ms"]
                   for name, fn in (("fm_fwd", lambda: FM.fm_fwd_cuda(v)),
                                    ("fm_bwd", lambda: FM.fm_bwd_cuda(v, g)))}
            row.update({"kernel": {"fwd": FM.kernel_of(v),
                                    "bwd": FM.kernel_of(v, torch.empty_like(v))},
                        "fm_fwd": {"ms": fwd[0], "device_ms": dev["fm_fwd"],
                                   "plain_ms": fwd[1], **bounds["fm_fwd"]},
                        "fm_bwd": {"ms": bwd[0], "device_ms": dev["fm_bwd"],
                                   "plain_ms": bwd[1], **bounds["fm_bwd"]}})
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
    check(train["graph_replays"] == 0, "the data-parallel step runs eagerly")
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
    check(train["graph_replays"] == train["steps"] - WARMUP_STEPS,
          f"train-user: {train['graph_replays']} graph replays in {train['steps']} steps")
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
    return {"train": {k: train[k] for k in ("steps", "graph_replays", "seconds",
                                            "step_ms_median", "epoch_losses")},
            "eval": {k: ev[k] for k in ("recall@20", "recall@100", "recall@500", "n_eval",
                                        "step_ms_median")},
            "blend_best": ev["blend"]["best_metrics"], "baselines": ev["baselines"],
            "serve": {"users": len(shoppers), "results": n_results,
                      "served_vs_tower_err": served_err,
                      "recommendation_ms_median": float(np.median(rec_ms))},
            "launches": launches}


# -- phase 14: the stage-2 step at the reference shape ---------------------------------

def reference_stage2_world(seed: int = 0, items: int = STAGE2_ITEMS) -> dict:
    """The stage-2 data at ``bench.py``'s shape, built from a seed: STAGE2_BATCHES
    batches of 768 users x 50 real positions with random ids over an
    ``items`` catalog, a log-normal ``logq``, a unit-row item matrix."""
    from recsys_tpu_torch.config import Config

    utc = Config().user_tower
    rng = np.random.default_rng(seed)
    n, L, N = STAGE2_B * STAGE2_BATCHES, STAGE2_L, items
    rows = {
        "input_ids": rng.integers(1, N + 1, (n, L)), "target_ids": rng.integers(1, N + 1, (n, L)),
        "time_buckets": rng.integers(0, utc.num_time_buckets, (n, L)),
        "seq_mask": np.ones((n, L), np.int64),
        "user_buckets": rng.integers(0, 10, (n, utc.static_bucket_fields)),
        "user_cats": rng.integers(0, 2, (n, utc.static_cat_fields)),
        "user_cont": rng.normal(0, 1, (n, utc.static_cont_fields)).astype(np.float32)}
    logq = rng.normal(-8.0, 1.0, N + 1).astype(np.float32)
    matrix = rng.normal(size=(N + 1, utc.d_model)).astype(np.float32)
    matrix /= np.linalg.norm(matrix, axis=1, keepdims=True)
    matrix[0] = 0.0
    return {"rows": rows, "logq": logq, "matrix": matrix, "items": N, "rng": rng}


def stage2_trainer(world: dict, device, capture: bool, cfg=None, seed: int = 0) -> dict:
    """A stage-2 trainer on ``world`` (the default (full) widths unless
    ``cfg``), seeded: its step through a ``StepGraph`` (captured or eager),
    the model, the eval forward and the data on the device."""
    from recsys_tpu_torch.config import Config
    from recsys_tpu_torch.train import sasrec
    from recsys_tpu_torch.train.state import TrainState
    from recsys_tpu_torch.train.step_graph import StepGraph

    cfg = cfg or Config()
    model = sasrec.init_stage2_params(cfg, world["items"] + 1, world["matrix"], device, seed=0)
    state = TrainState(model, sasrec.make_stage2_optimizer(cfg, model, steps_per_epoch=1787))
    step, user_vectors = sasrec.make_stage2_step(cfg, state, world["logq"])
    data = sasrec.tensors_to(world["rows"], device)
    gen = torch.Generator(device).manual_seed(seed)
    return {"cfg": cfg, "runner": StepGraph(step, state, data, STAGE2_B, gen, capture=capture),
            "model": model, "user_vectors": user_vectors, "data": data}


def batch_indices(n: int, batch: int, count: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [rng.permutation(n)[:batch] for _ in range(count)]


def captured_vs_eager(make, batches, loss_of, draws=None) -> dict:
    """``make(capture)`` -> (runner, model), two trainers from the same seeded
    state; both run the same batches (and draws): the largest loss gap of
    any step, and of any parameter at the end."""
    (eager, m_eager), (graph, m_graph) = make(False), make(True)
    gaps = []
    for i, idx in enumerate(batches):
        d = None if draws is None else draws[i]
        gaps.append(abs(float(loss_of(eager(idx, d))) - float(loss_of(graph(idx, d)))))
    param_gap = max(float((a - b).abs().max())
                    for a, b in zip(m_eager.state_dict().values(), m_graph.state_dict().values()))
    check(graph.replays == len(batches) - WARMUP_STEPS and eager.replays == 0,
          f"replays: captured {graph.replays}, eager {eager.replays} in {len(batches)} steps")
    check(max(gaps) <= GRAPH_LOSS_TOL, f"captured vs eager losses: {gaps}")
    check(param_gap <= GRAPH_PARAM_TOL, f"captured vs eager parameters: {param_gap}")
    return {"steps": len(batches), "max_loss_gap": max(gaps), "loss_gaps": gaps,
            "max_param_gap": param_gap}


def steps_in_turns(runners: dict, batches, device) -> dict:
    """Each runner's CUDA-event step times (``StepTimer``) in TURNS of
    TURN_STEPS steps; the median by runner."""
    from recsys_tpu_torch.train.state import StepTimer

    times = {name: [] for name in runners}
    it = iter(batches)
    for name in TURNS:
        timer = StepTimer(device)
        for _ in range(TURN_STEPS):
            runners[name](next(it))
            timer.mark()
        times[name] += timer.seconds()
    return {name: {"step_ms_median": 1e3 * float(np.median(t)), "step_ms": [1e3 * x for x in t]}
            for name, t in times.items()}


def stage2_step_phase(device) -> dict:
    """Phase 14: the stage-2 step at the reference shape, eager and captured."""
    import dataclasses

    from recsys_tpu_torch.config import Config
    from recsys_tpu_torch.train import sasrec
    from recsys_tpu_torch.train.state import StepTimer

    world = reference_stage2_world()
    B, N, n = STAGE2_B, STAGE2_ITEMS, STAGE2_B * STAGE2_BATCHES
    # the captured step against the eager one: dropout and the random cut off, the
    # sampled positions fixed (every slot is real here)
    base = Config()
    quiet = dataclasses.replace(
        base, user_tower=dataclasses.replace(base.user_tower, dropout=0.0),
        user_train=dataclasses.replace(base.user_train, random_cut_prob=0.0))
    prng = np.random.default_rng(1)
    draws = [{"positions": torch.as_tensor(prng.integers(0, STAGE2_L, (B, STAGE2_P)),
                                           device=device)} for _ in range(GRAPH_STEPS)]

    def make(capture):
        t = stage2_trainer(world, device, capture, cfg=quiet)
        return t["runner"], t["model"]

    held = captured_vs_eager(make, batch_indices(n, B, GRAPH_STEPS, seed=2),
                             lambda out: out["loss"], draws)
    del make
    # step times in turns, the default config; the counts start after each
    # trainer's warm-up and capture
    trainers = {"eager": stage2_trainer(world, device, False),
                "captured": stage2_trainer(world, device, True)}
    runners = {name: t["runner"] for name, t in trainers.items()}
    batches = iter(batch_indices(n, B, 6 + len(TURNS) * TURN_STEPS + 11, seed=3))
    for _ in range(3):
        for runner in runners.values():
            runner(next(batches))
    K.reset_launch_counts()  # this path's run starts here
    turns = steps_in_turns(runners, batches, device)
    launches = dict(K.LAUNCHES)
    n_steps = len(TURNS) * TURN_STEPS
    check(all(n == n_steps for n in launches.values()),
          f"K1 on the stage-2 step: {launches} in {n_steps} steps")
    # no host sync inside a replay
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        runners["captured"](next(batches))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    traced = {name: profile_steps(lambda r=runner: r(next(batches)), 5)
              for name, runner in runners.items()}
    for prof in traced.values():
        prof["k1_share_of_device"] = (prof["k1_device_ms"] / prof["device_busy_ms"]
                                      if prof["device_busy_ms"] else None)
    # the full-catalog top-500 of evaluate_stage2 for 768 users
    cap = trainers["captured"]
    rows = {k: v[:B] for k, v in world["rows"].items()}
    data = {"tensors": {**rows, "user_ids": [f"u{r}" for r in range(B)]},
            "targets_idx": {f"u{r}": set(world["rng"].integers(1, N + 1, 3).tolist())
                            for r in range(B)}}
    eval_timer = StepTimer(device)
    metrics = sasrec.evaluate_stage2(cap["cfg"], cap["model"], cap["user_vectors"], data,
                                     device, timer=eval_timer)
    check(metrics["n_eval"] == B and all(np.isfinite(v) for v in metrics.values()),
          f"evaluate_stage2 at the reference shape: {metrics}")
    return {"held": held, "turns": turns, "launches": launches, "traced": traced,
            "replay_under_sync_debug": "error", "eval_ms": 1e3 * sum(eval_timer.seconds()),
            "eval": metrics}


def item_step_phase(root: str, device) -> dict:
    """Phase 2's item-tower step, eager and captured, on phase 2's catalog at
    batch 192: held against each other from the same state with
    ``simcse.feature_dropout=0`` and ``item_tower.dropout=0`` (the name-word
    deletion still draws, from generators of the same seed), then the step
    medians in turns and five steps of each under the profiler."""
    import dataclasses

    from recsys_tpu_torch.data.vocab import StdVocab
    from recsys_tpu_torch.pipeline import cli
    from recsys_tpu_torch.train import simcse
    from recsys_tpu_torch.train.state import TrainState
    from recsys_tpu_torch.train.step_graph import StepGraph

    base = cli.config_from_args(cli.parse_args(["train-item", "--set", f"data.root={root}"]))
    tensors = cli._item_tensors(base)
    data = simcse.item_tensors_to(tensors, device)
    n, bs = tensors["std"].shape[0], base.simcse.batch_size

    def make(cfg, capture):
        model = simcse.build_model(cfg, StdVocab().size, tensors["std"].shape[1], device,
                                   seed=cfg.data.seed)
        opt, sched = simcse.make_optimizer(cfg, model, total_steps=100)   # 10 warm-up steps
        state = TrainState(model, opt, sched)
        gen = torch.Generator(device).manual_seed(cfg.data.seed)
        return StepGraph(simcse.make_train_step(state, cfg), state, data, bs, gen,
                         capture=capture), model

    quiet = dataclasses.replace(
        base, simcse=dataclasses.replace(base.simcse, feature_dropout=0.0),
        item_tower=dataclasses.replace(base.item_tower, dropout=0.0))
    held = captured_vs_eager(lambda capture: make(quiet, capture),
                             batch_indices(n, bs, GRAPH_STEPS, seed=2), lambda out: out[0])
    runners = {name: make(base, name == "captured")[0] for name in ("eager", "captured")}
    batches = iter(batch_indices(n, bs, 6 + len(TURNS) * TURN_STEPS + 11, seed=3))
    for _ in range(3):
        for runner in runners.values():
            runner(next(batches))
    K.reset_launch_counts()
    turns = steps_in_turns(runners, batches, device)
    n_steps = len(TURNS) * TURN_STEPS
    check(all(n == 2 * n_steps for n in K.LAUNCHES.values()),
          f"K1 on the item step: {K.LAUNCHES} in {n_steps} steps")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        runners["captured"](next(batches))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    traced = {name: profile_steps(lambda r=runner: r(next(batches)), 5)
              for name, runner in runners.items()}
    return {"batch": bs, "held": held, "turns": turns, "traced": traced}


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
    check(train["graph_replays"] == train["steps"] - WARMUP_STEPS,
          f"train-hybrid: {train['graph_replays']} graph replays in {train['steps']} steps")
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
    return {"train": {k: train[k] for k in ("steps", "graph_replays", "seconds", "step_ms_median",
                                            "epoch_losses", "logit_scale", "report_seconds")},
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

# the host's launch calls: kernels one by one, and whole graphs
HOST_LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cuGraphLaunch")


def profile_steps(fn, n: int) -> dict:
    """``n`` calls of ``fn`` under ``torch.profiler``: wall and device time a
    call, device launches (kernels run) and host launch calls a call, K1's
    device time a call and the top device items by self time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / n
    dev, count, host = {}, 0, 0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)
        if t > 0:
            dev[e.key] = t / 1e3 / n
            count += e.count
        elif e.key.startswith(HOST_LAUNCH_CALLS):
            host += e.count
    busy = sum(dev.values())
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": max(0.0, 1.0 - busy / wall_ms) if wall_ms else None,
            "launches_per_call": count / n, "host_launch_calls_per_call": host / n,
            "k1_device_ms": sum(v for k, v in dev.items() if "diag_ce" in k),
            "top_device_items_ms": {k[:160]: v for k, v in top}}


def hybrid_world(seed: int = 0) -> dict:
    """Phase 14's stage-2 data (``reference_stage2_world``) with the hybrid
    tower's inputs: its unit-row item matrix as the content rows, GNN item
    and user rows of HYBRID_GNN_DIM, all from the same seed."""
    world = reference_stage2_world(seed)
    rng, N = world["rng"], world["items"]
    gnn_items = rng.normal(0, 0.1, (N + 1, HYBRID_GNN_DIM)).astype(np.float32)
    gnn_items[0] = 0.0
    n = world["rows"]["input_ids"].shape[0]
    return {**world, "gnn_items": gnn_items,
            "gnn_users": rng.normal(0, 0.1, (n, HYBRID_GNN_DIM)).astype(np.float32)}


def hybrid_trainer(world: dict, device, capture: bool, cfg=None, seed: int = 0) -> dict:
    """A hybrid trainer on ``world`` (the default (full) widths unless
    ``cfg``: the tower's 4 layers), seeded: its step through
    ``train/hybrid.hybrid_runner`` (captured or eager), the model, the eval
    forward, the item matrix and the data on the device."""
    from recsys_tpu_torch.config import Config
    from recsys_tpu_torch.train import hybrid as H
    from recsys_tpu_torch.train.sasrec import tensors_to
    from recsys_tpu_torch.train.state import TrainState

    cfg = cfg or Config()
    model = H.build_hybrid_model(cfg, world["items"] + 1, D, HYBRID_GNN_DIM, device, seed=0)
    check(model.encoder.num_layers == 4, "the hybrid tower must have its 4 layers")
    opt, sched = H.make_hybrid_optimizer(cfg.user_train, model, 1000)
    state = TrainState(model, opt, sched)
    step, uv, im = H.make_hybrid_step(cfg, state, world["matrix"], world["gnn_items"],
                                      world["logq"])
    data = tensors_to(world["rows"], device)
    gnn = torch.as_tensor(world["gnn_users"], device=device)
    gen = torch.Generator(device).manual_seed(seed)
    return {"runner": H.hybrid_runner(step, state, data, gnn, STAGE2_B, gen, capture=capture),
            "model": model, "user_vectors": uv, "item_matrix": im, "data": data, "gnn": gnn}


def hybrid_step_phase(device) -> dict:
    """Phase 16: the hybrid step at phase 14's shape, eager and captured."""
    import dataclasses

    from recsys_tpu_torch.config import Config

    world = hybrid_world()
    B, n = STAGE2_B, STAGE2_B * STAGE2_BATCHES
    # the captured step against the eager one: dropout and the random cut off, the
    # GNN keep mask fixed through draws
    base = Config()
    quiet = dataclasses.replace(
        base, user_tower=dataclasses.replace(base.user_tower, dropout=0.0),
        user_train=dataclasses.replace(base.user_train, random_cut_prob=0.0))
    krng = np.random.default_rng(1)
    draws = [{"gnn_keep": torch.as_tensor(krng.random((B, 1)) < 0.7, device=device)}
             for _ in range(GRAPH_STEPS)]

    def make(cfg):
        def trainer(capture):
            t = hybrid_trainer(world, device, capture, cfg=cfg)
            return t["runner"], t["model"]
        return trainer

    before = all_launches()
    held = captured_vs_eager(make(quiet), batch_indices(n, B, GRAPH_STEPS, seed=2),
                             lambda out: out["loss"], draws)
    # the default config, every draw from the registered generator: reported
    (eager, m_eager), (graph, m_graph) = make(base)(False), make(base)(True)
    gaps = [abs(float(eager(idx)["loss"]) - float(graph(idx)["loss"]))
            for idx in batch_indices(n, B, GRAPH_STEPS, seed=4)]
    default_gaps = {"max_loss_gap": max(gaps), "max_param_gap": max(
        float((a - b).abs().max())
        for a, b in zip(m_eager.state_dict().values(), m_graph.state_dict().values()))}
    del eager, graph, m_eager, m_graph
    trainers = {"eager": hybrid_trainer(world, device, False),
                "captured": hybrid_trainer(world, device, True)}
    runners = {name: t["runner"] for name, t in trainers.items()}
    batches = iter(batch_indices(n, B, 6 + len(TURNS) * TURN_STEPS + 11, seed=3))
    for _ in range(3):
        for runner in runners.values():
            runner(next(batches))
    turns = steps_in_turns(runners, batches, device)
    for name, t in turns.items():
        check(all(np.isfinite(t["step_ms"])), f"hybrid step times ({name}): {t}")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss = runners["captured"](next(batches))["loss"]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(bool(torch.isfinite(loss)), f"hybrid loss {loss}")
    traced = {name: profile_steps(lambda r=runner: r(next(batches)), 5)
              for name, runner in runners.items()}
    check(all_launches() == before, "the hybrid step launched a hand kernel")
    # the adapted catalog and the top-500 of hybrid_eval for the 768 users
    cap = trainers["captured"]
    t0 = time.perf_counter()
    items = cap["item_matrix"]()
    rows = {k: v[:B] for k, v in cap["data"].items()}
    _, top = torch.topk(cap["user_vectors"](rows, cap["gnn"][:B]) @ items.T, 500, dim=1)
    torch.cuda.synchronize()
    eval_ms = 1e3 * (time.perf_counter() - t0)
    # the smallest launch torch makes: a one-element add, its device time and host cost
    one = torch.zeros(1, device=device)
    launch = profile_steps(lambda: one.add_(1.0), 200)
    return {"shape": {"users": B, "positions": STAGE2_L, "catalog": world["items"],
                      "content_dim": D, "gnn_dim": HYBRID_GNN_DIM, "layers": 4},
            "held": held, "default_config_gaps": default_gaps, "turns": turns,
            "graph_replays": cap["runner"].replays,
            "replay_under_sync_debug": "error", "traced": traced, "eval_top500_ms": eval_ms,
            "one_element_kernel": {"device_ms": launch["device_busy_ms"],
                                   "host_ms_per_call": launch["wall_ms"]}}


# -- phase 17: the device indexes at full size -----------------------------------------

def chained_ms(fn, q0: torch.Tensor, reps: int) -> float:
    """``fn(q) -> (vals, idx)`` ``reps`` times, each query nudged by the
    previous answer's first value so that every call waits on the one before
    (as bench_retrieval.py chains them); CUDA events over the chain."""
    fn(q0)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    q = q0
    start.record()
    for _ in range(reps):
        vals, _ = fn(q)
        q = q0 + 1e-6 * vals[:, :1]
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def recall_vs(idx: torch.Tensor, ref: torch.Tensor) -> float:
    """Mean share of each row of ``ref`` that ``idx`` holds."""
    a, e = idx.cpu().numpy(), ref.cpu().numpy()
    return float(np.mean([len(set(a[r].tolist()) & set(e[r].tolist())) / e.shape[1]
                          for r in range(len(e))]))


def check_int8(name: str, q: torch.Tensor, qi, k: int) -> None:
    """The int8 accumulator equals the exact integer product (float64 on the
    card: exact below 2^53) for every query; the top-k equals the plain
    form's stable sort for the first 64."""
    from recsys_tpu_torch.ops import quant as Q

    uq, _ = Q._quantize_queries(q, qi.col_scale)
    for s in range(0, uq.shape[0], 128):
        got = Q.int8_accumulate(uq[s:s + 128], qi).long()
        want = (uq[s:s + 128].double() @ qi.q.double().T).long()
        check(torch.equal(got, want), f"{name}: int8 accumulator != the integer product")
    vals, idx = Q.int8_topk(q[:64], qi, k)
    pv, pi, _ = Q.int8_topk_plain(q[:64], qi, k)
    check(torch.equal(idx, pi) and torch.equal(vals, pv),
          f"{name}: int8 top-k differs from the plain tie-exact top-k")


def check_full_probe(name: str, q: torch.Tensor, items: torch.Tensor, vals, idx, k: int):
    """IVF with every bucket probed against the exact top-k of the same
    cosine scores: values within IVF_TOL in order, the same ids except where
    an item scores within IVF_TOL of the k-th value (a tie at the edge)."""
    qn = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    scores = qn @ (items / torch.linalg.vector_norm(items, dim=-1, keepdim=True)
                   .clamp(min=1e-12)).T
    scores[:, 0] = -torch.inf
    ev, ei = torch.topk(scores, k + 1, dim=1)
    err = float((vals - ev[:, :k]).abs().max())
    check(err <= IVF_TOL, f"{name}: full-probe IVF values off the exact top-k by {err}")
    kth = ev[:, k - 1].cpu().numpy()
    got, want = idx.long().cpu().numpy(), ei[:, :k].cpu().numpy()
    for r in range(len(got)):
        diff = set(got[r].tolist()) ^ set(want[r].tolist())
        if diff:
            sc = scores[r, list(diff)].cpu().numpy()
            check(bool((sc >= kth[r] - IVF_TOL).all()),
                  f"{name}: full-probe IVF ids differ from the exact top-k in row {r}")


def retrieval_phase(device) -> list[dict]:
    from recsys_tpu_torch.eval.recall import topk_scores
    from recsys_tpu_torch.ops import ivf as I
    from recsys_tpu_torch.ops import quant as Q

    before = all_launches()
    rng = np.random.default_rng(0)     # bench_retrieval.py's draws, catalog after catalog
    rows, built = [], {}
    for n_items, k, nlist, nprobe in RETRIEVAL_CATALOGS:
        items_np = rng.normal(0, 1, (n_items + 1, D)).astype(np.float32)
        items_np[0] = 0
        q0 = torch.as_tensor(rng.normal(0, 1, (RETRIEVAL_B, D)).astype(np.float32),
                             device=device)
        items = torch.as_tensor(items_np, device=device)
        name = f"{n_items} items, k={k}"
        row = {"n_items": n_items, "k": k, "batch": RETRIEVAL_B, "ivf_nlist": nlist,
               "ivf_nprobe": nprobe}
        exact = lambda u: topk_scores(u, items, k)
        qi = Q.quantize_items_int8(items, device=device)
        int8 = lambda u: Q.int8_topk(u, qi, k)
        check_int8(name, q0, qi, k)
        row["exact_ms"] = chained_ms(exact, q0, RETRIEVAL_REPS)
        row["int8_ms"] = chained_ms(int8, q0, RETRIEVAL_REPS)
        _, ie = exact(q0)
        row["int8_recall"] = recall_vs(int8(q0)[1], ie)
        t0 = time.perf_counter()
        ivf = I.build_ivf(items_np, nlist=nlist, iters=10, device=device)
        torch.cuda.synchronize()
        row["ivf_build_s"] = time.perf_counter() - t0
        row["ivf_cap"] = ivf.cap
        if row["ivf_build_s"] > IVF_BUILD_LIMIT_S:
            row["ivf"] = f"skipped: the build took over {IVF_BUILD_LIMIT_S} s"
        else:
            search = lambda u: I.ivf_search(ivf, u, k, nprobe)
            row["ivf_ms"] = chained_ms(search, q0, RETRIEVAL_REPS)
            row["ivf_recall"] = recall_vs(search(q0)[1], ie)
            if n_items == RETRIEVAL_ROWS:
                vals, idx = I.ivf_search(ivf, q0, k, nlist)
                check_full_probe(name, q0, items, vals, idx, k)
                row["full_probe_equals_exact"] = True
        del ivf, qi, items
        torch.cuda.empty_cache()
        rows.append(row)
        print(json.dumps({"phase": "retrieval", **row}), flush=True)
    after = all_launches()
    check(after == before, f"the device indexes launched a hand kernel: {before} -> {after}")
    return rows


# -- phase 18: serving with the device indexes and the /train/* routes -------------------

def device_index_serve_phase(root: str, device: str = "cuda", extra_sets: tuple = ()) -> dict:
    import pandas as pd

    from recsys_tpu_torch.pipeline import cli
    from recsys_tpu_torch.serve.ann import Int8DeviceIndex, IvfDeviceIndex
    from recsys_tpu_torch.serve.server import make_server, serve_forever_in_thread

    base_sets = ["--set", f"data.root={root}", "--set", "serve.db_path=:memory:",
                 "--set", "simcse.epochs=1", "--set", "simcse.steps_per_epoch_min=1",
                 "--set", "user_train.epochs=1", *extra_sets, "--device", device]
    items = pd.read_parquet(f"{root}/items.parquet").sort_values("item_id")
    catalog = items.to_dict("records")
    tx = pd.read_parquet(f"{root}/transactions.parquet")
    out = {}
    for backend, cls in (("int8", Int8DeviceIndex), ("ivf", IvfDeviceIndex)):
        args = cli.parse_args(["serve", *base_sets, "--model-backed",
                               "--set", f"serve.ann_backend={backend}"])
        ctx = cli.build_app(cli.config_from_args(args), args)
        check(isinstance(ctx.index, cls) and ctx.index.device.type == device,
              f"serve.ann_backend={backend}: {type(ctx.index).__name__}")
        server = make_server(ctx, host="127.0.0.1", port=0)
        thread = serve_forever_in_thread(server)
        base = f"http://127.0.0.1:{server.server_address[1]}"
        row = {}
        try:
            http(base, "POST", "/api/controller/products/ingest",
                 {"products": [product_json(r) for r in catalog]})
            while http(base, "POST", "/ai-api/serving/vectors/process-pending",
                       {})["processed_count"]:
                pass
            # the exact answer from the stored vectors; queries whose best hit leads the
            # second by more than SERVE_TOL, so that the exact top hit is well defined
            # under int8's rounding
            ids, vecs = ctx.store.all_vectors()
            unit = vecs / np.linalg.norm(vecs, axis=1, keepdims=True)
            cos = unit @ unit.T
            np.fill_diagonal(cos, -np.inf)
            order = np.argsort(-cos, axis=1)[:, :2]
            gap = cos[np.arange(len(ids)), order[:, 0]] - cos[np.arange(len(ids)), order[:, 1]]
            n_queries = SIMILARITY_QUERIES if backend == "int8" else IVF_QUERIES
            queries = [r for r in range(len(ids)) if gap[r] > SERVE_TOL][:n_queries]
            check(len(queries) == n_queries, f"{backend}: {len(queries)} queries")
            before, score_err, sim_ms, hits = all_launches(), 0.0, [], []
            col = {pid: r for r, pid in enumerate(ids)}
            for r in queries:
                t0 = time.perf_counter()
                sim = http(base, "GET", f"/api/controller/similarity/{ids[r]}?top_k=10")
                sim_ms.append(1e3 * (time.perf_counter() - t0))
                res = sim["results"]
                check(len(res) == 10 and all(x["product_id"] != ids[r] for x in res),
                      f"{backend} similarity for {ids[r]}: {res[:3]}")
                hits.append(res[0]["product_id"] == ids[order[r, 0]])
                check(backend == "ivf" or hits[-1], f"{backend} similarity for {ids[r]}: "
                      f"{res[:3]}, exact top hit {ids[order[r, 0]]}")
                for x in res:
                    score_err = max(score_err, abs(x["score"] - float(cos[r, col[x["product_id"]]])))
            check(score_err <= SERVE_TOL, f"{backend} similarity scores vs exact: {score_err}")
            check(all_launches() == before, f"{backend} similarity launched a hand kernel")
            row.update({"similarity_ms_median": float(np.median(sim_ms)),
                        "score_err_vs_exact": score_err, "queries": len(queries),
                        "top_hit_equals_exact": float(np.mean(hits))})
            if backend == "ivf":
                row["nprobe"] = ctx.index.nprobe
                check(row["top_hit_equals_exact"] >= IVF_TOP_HIT_FLOOR,
                      f"ivf at nprobe {ctx.index.nprobe}: top hit exact for "
                      f"{row['top_hit_equals_exact']} of the queries, under {IVF_TOP_HIT_FLOOR}")
                ext, _ = ctx.index.topk(vecs[queries], 2, nprobe=IVF_FULL_PROBE)
                full = [next(ctx.int_to_pid.get(x) for x in got.tolist()
                             if ctx.int_to_pid.get(x) != ids[r]) == ids[order[r, 0]]
                        for got, r in zip(ext, queries)]
                check(all(full), f"ivf with every bucket probed: top hit exact for "
                      f"{sum(full)} of {len(full)} queries")
            if backend == "int8":    # the /train/* routes once, on the store just filled
                row["train"] = train_routes(base, tx, device)
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=10)
        out[backend] = row
    return out


def train_routes(base: str, tx, device: str) -> dict:
    """POST /train/item-tower and /train/user-tower on a store holding the
    world's catalog and TRAIN_ROUTE_USERS users' purchases: each trains,
    with finite losses, and launches each K1 kernel as often as its loss
    calls it (twice a step for SimCSE's two directions, once for stage 2)."""
    shoppers = tx["user_id"].drop_duplicates()[:TRAIN_ROUTE_USERS]
    for uid in shoppers:
        rows = tx[tx["user_id"] == uid].sort_values("day", kind="stable").tail(12)
        sessions = [{"user_id": str(uid), "started_at": 86400.0 * float(d) + j,
                     "events": [{"product_id": str(i), "action_type": 5,
                                 "ts": 86400.0 * float(d) + j}]}
                    for j, (i, d) in enumerate(zip(rows["item_id"], rows["day"]))]
        ins = http(base, "POST", "/api/v1/debug/insert-manual-data",
                   {"users": [{"user_id": str(uid)}], "sessions": sessions})
        check(ins.get("ok", True) is not False, f"insert-manual-data: {ins}")
    out = {}
    for route, per_step in (("item-tower", 2), ("user-tower", 1)):
        K.reset_launch_counts()
        t0 = time.perf_counter()
        r = http(base, "POST", f"/ai-api/serving/train/{route}", {"epochs": 1})
        seconds = time.perf_counter() - t0
        check(r.get("trained") == route and r["steps"] > 0 and len(r["losses"]) > 0
              and all(np.isfinite(r["losses"])), f"/train/{route}: {r}")
        check(device == "cpu" or all(n == per_step * r["steps"] for n in K.LAUNCHES.values()),
              f"/train/{route}: K1 launches {K.LAUNCHES} in {r['steps']} steps")
        out[route] = {"steps": r["steps"], "seconds": seconds, "losses": [r["losses"][0],
                                                                          r["losses"][-1]],
                      "k1_launches": dict(K.LAUNCHES),
                      **{key: r[key] for key in ("items", "epochs", "final") if key in r}}
    return out


# -- phase 19: the pretrained text encoder from H&M-format CSVs ---------------------------

HM_ADJ = ("soft", "slim", "relaxed", "cropped", "ribbed", "classic", "oversized", "fitted",
          "light", "warm", "wide", "long", "short", "pleated", "printed", "washed", "basic",
          "cosy", "sporty", "smart", "cotton", "linen", "wool", "denim", "satin", "fleece",
          "padded", "lace", "striped", "checked", "tailored", "flared", "tapered", "knitted",
          "hooded", "zipped", "buttoned", "stretch", "waterproof", "vintage")
HM_LINE = ("Idro", "Basic", "Tilly", "Luna", "Nova", "Ava", "Max", "Leo", "Ella", "Mia",
           "Oslo", "Rio", "Paris", "Milo", "Zoe", "Ruby", "Noah", "Ivy", "Finn", "Kai",
           "Lola", "Theo", "Nora", "Otto", "Sky")
HM_TYPES = (("Vest top", "Garment Upper body", "Jersey Basic"),
            ("Sweater", "Garment Upper body", "Knitwear"),
            ("Blouse", "Garment Upper body", "Blouses"),
            ("Jacket", "Garment Upper body", "Outdoor"),
            ("Trousers", "Garment Lower body", "Trousers Denim"),
            ("Shorts", "Garment Lower body", "Shorts"),
            ("Skirt", "Garment Lower body", "Skirts"),
            ("Dress", "Garment Full body", "Dresses Ladies"),
            ("Jumpsuit/Playsuit", "Garment Full body", "Dresses Ladies"),
            ("Socks", "Socks & Tights", "Socks and Tights"),
            ("Sneakers", "Shoes", "Shoes"),
            ("Bag", "Accessories", "Accessories"))
HM_APPEAR = ("Solid", "Stripe", "Denim", "Melange", "All over pattern", "Glitter", "Lace",
             "Check")
HM_COLOURS = ("Black", "White", "Dark Blue", "Light Beige", "Grey", "Dark Red", "Green",
              "Pink", "Yellow", "Orange")
HM_VALUES = ("Dark", "Light", "Medium Dusty", "Bright", "Dusty Light")
HM_INDEX = (("A", "Ladieswear", 1, "Ladieswear"), ("F", "Menswear", 3, "Menswear"),
            ("D", "Divided", 2, "Divided"), ("H", "Children Sizes 92-140", 4, "Baby/Children"),
            ("S", "Sport", 5, "Sport"))
HM_SECTIONS = ("Womens Everyday Basics", "Men Underwear", "Divided Collection", "Kids Sport",
               "Womens Tailoring", "Mens Casual", "Ladies Sport")
HM_MATERIALS = ("cotton", "linen", "wool", "polyester", "viscose", "denim", "jersey",
                "cashmere", "satin", "fleece")
HM_FITS = ("slim", "loose", "relaxed", "oversized", "fitted", "regular fit", "skinny", "wide",
           "cropped", "high waist")
HM_DETAILS = ("ribbed", "pleated", "button", "zip", "pocket", "hood", "collar", "drawstring",
              "elasticated", "embroidered", "printed", "lined", "long sleeves", "v-neck")
HM_FUNCTIONS = ("warm", "breathable", "waterproof", "stretch", "lightweight", "soft")
HM_ARTICLES, HM_CUSTOMERS, HM_TRANSACTIONS, HM_DAYS = 2000, 1000, 40_000, 120


def write_hm_csvs(hm_dir: str, seed: int = 0) -> dict:
    """articles.csv (the 25 Kaggle columns), customers.csv and
    transactions_train.csv (ISO t_dat over HM_DAYS days) at the default
    world's scale, made from ``seed``. Values come from small lexicons; a
    name is a unique (adjective, type, line) triple and the description
    names a fit, a material, two details and a function, so the RE tags
    fill from ``detail_desc``."""
    import pandas as pd

    os.makedirs(hm_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    pick = lambda seq, n: [seq[i] for i in rng.integers(0, len(seq), n)]
    n = HM_ARTICLES
    triple = rng.choice(len(HM_ADJ) * len(HM_TYPES) * len(HM_LINE), n, replace=False)
    adj, rest = np.divmod(triple, len(HM_TYPES) * len(HM_LINE))
    typ, line = np.divmod(rest, len(HM_LINE))
    appear, colour, value = (rng.integers(0, len(x), n) for x in (HM_APPEAR, HM_COLOURS,
                                                                 HM_VALUES))
    index, section = rng.integers(0, len(HM_INDEX), n), rng.integers(0, len(HM_SECTIONS), n)
    art_ids = [f"{100000001 + 1237 * i:010d}" for i in range(n)]
    dets = rng.integers(0, len(HM_DETAILS), (n, 2))
    articles = pd.DataFrame({
        "article_id": art_ids, "product_code": [a[:7] for a in art_ids],
        "prod_name": [f"{HM_ADJ[a].capitalize()} {HM_TYPES[t][0].lower()} {HM_LINE[ln]}"
                      for a, t, ln in zip(adj, typ, line)],
        "product_type_no": 250 + typ, "product_type_name": [HM_TYPES[t][0] for t in typ],
        "product_group_name": [HM_TYPES[t][1] for t in typ],
        "graphical_appearance_no": 1010000 + appear,
        "graphical_appearance_name": [HM_APPEAR[a] for a in appear],
        "colour_group_code": colour, "colour_group_name": [HM_COLOURS[c] for c in colour],
        "perceived_colour_value_id": value,
        "perceived_colour_value_name": [HM_VALUES[v] for v in value],
        "perceived_colour_master_id": colour,
        "perceived_colour_master_name": [HM_COLOURS[c].split()[-1] for c in colour],
        "department_no": 1000 + typ, "department_name": [HM_TYPES[t][2] for t in typ],
        "index_code": [HM_INDEX[i][0] for i in index],
        "index_name": [HM_INDEX[i][1] for i in index],
        "index_group_no": [HM_INDEX[i][2] for i in index],
        "index_group_name": [HM_INDEX[i][3] for i in index],
        "section_no": section, "section_name": [HM_SECTIONS[x] for x in section],
        "garment_group_no": 1000 + typ, "garment_group_name": [HM_TYPES[t][2] for t in typ],
        "detail_desc": [f"{f.capitalize()} {HM_TYPES[t][0].lower()} in {m} with "
                        f"{HM_DETAILS[d0]} and {HM_DETAILS[d1]}. {fn.capitalize()}."
                        for f, t, m, (d0, d1), fn in zip(
                            pick(HM_FITS, n), typ, pick(HM_MATERIALS, n), dets,
                            pick(HM_FUNCTIONS, n))],
    })
    articles.to_csv(f"{hm_dir}/articles.csv", index=False)
    cust_ids = [rng.bytes(32).hex() for _ in range(HM_CUSTOMERS)]
    ages = rng.integers(16, 80, HM_CUSTOMERS).astype(float)
    ages[rng.random(HM_CUSTOMERS) < 0.05] = np.nan
    pd.DataFrame({
        "customer_id": cust_ids,
        "FN": np.where(rng.random(HM_CUSTOMERS) < 0.4, 1.0, np.nan),
        "Active": np.where(rng.random(HM_CUSTOMERS) < 0.4, 1.0, np.nan),
        "club_member_status": pick(("ACTIVE", "PRE-CREATE", "LEFT CLUB"), HM_CUSTOMERS),
        "fashion_news_frequency": pick(("NONE", "Regularly", "Monthly"), HM_CUSTOMERS),
        "age": ages, "postal_code": [rng.bytes(8).hex() for _ in range(HM_CUSTOMERS)],
    }).to_csv(f"{hm_dir}/customers.csv", index=False)
    m = HM_TRANSACTIONS
    day = np.sort(rng.integers(0, HM_DAYS, m))
    origin = np.datetime64("2020-05-25")
    tx = pd.DataFrame({
        "t_dat": [str(origin + int(d)) for d in day],
        "customer_id": [cust_ids[i] for i in (HM_CUSTOMERS * rng.random(m) ** 1.5).astype(int)],
        "article_id": [art_ids[i] for i in (n * rng.random(m) ** 2).astype(int)],
        "price": np.round(rng.uniform(0.005, 0.08, m), 6),
        "sales_channel_id": rng.integers(1, 3, m),
    })
    tx.to_csv(f"{hm_dir}/transactions_train.csv", index=False)
    return {"articles": n, "customers": HM_CUSTOMERS, "transactions": m}


def host_cpu() -> str:
    """The host CPU's model name and the cores this process may use (the
    host-side stage seconds are this machine's)."""
    try:
        with open("/proc/cpuinfo") as f:
            name = next((ln.split(":", 1)[1].strip() for ln in f
                         if ln.startswith("model name")), "unknown")
    except OSError:
        name = "unknown"
    return f"{name}, {len(os.sched_getaffinity(0))} cores"


def weekly_trigger(base: str, ctx, device: str) -> dict:
    """One scheduler cycle whose weekly branch is due (an injected clock):
    the hourly drain finds nothing left, ``/train/start`` answers and starts
    the item trainer in the background, which launches each K1 kernel twice a
    step."""
    from recsys_tpu_torch.pipeline import cli

    runs, train_fn = [], ctx.train_item_fn
    ctx.train_item_fn = lambda **kw: runs.append(train_fn(**kw)) or runs[-1]
    K.reset_launch_counts()
    t0 = time.perf_counter()
    recs, _ = cli.orchestrate_cycles(lambda method, path, payload=None:
                                     http(base, method, path, payload), 1,
                                     now_fn=lambda: 1e9)
    rec = recs[0]
    check(rec["hourly"] == {"vectorized": 0, "loops": 0}, f"hourly cycle: {rec}")
    check(rec.get("weekly", {}).get("started") is True, f"/train/start: {rec}")
    for t in ctx._bg_threads:
        t.join(timeout=600)
    seconds = time.perf_counter() - t0
    check(len(runs) == 1 and runs[0].get("trained") == "item-tower"
          and all(np.isfinite(runs[0]["losses"])), f"/train/start's training: {runs}")
    steps = runs[0]["steps"]
    check(device == "cpu" or all(n == 2 * steps for n in K.LAUNCHES.values()),
          f"/train/start: K1 launches {K.LAUNCHES} in {steps} steps")
    return {"seconds": seconds, "steps": steps, "items": runs[0]["items"],
            "k1_launches": dict(K.LAUNCHES)}


def encoder_run(root: str, text_encoder: str, steps: int):
    """The train-item config of ``root``'s world with ``text_encoder`` and
    the first ``steps`` batches of its catalog."""
    from recsys_tpu_torch.pipeline import cli

    sets = ["--set", f"data.root={root}", "--set", "simcse.epochs=1",
            "--set", "simcse.steps_per_epoch_min=1", "--set", f"simcse.batch_size={MAIN_B}",
            "--set", f"item_tower.text_encoder={text_encoder}"]
    cfg = cli.config_from_args(cli.parse_args(["train-item", *sets]))
    return cfg, {k: v[:steps * MAIN_B] for k, v in cli._item_tensors(cfg).items()}


def step_ms_in_turns(root: str, device: str, art) -> dict:
    """train-item's step median (host clock, steps after the first), each
    encoder 10 steps on the same batches, in turns: hash, pretrained,
    pretrained, hash."""
    from recsys_tpu_torch.train.simcse import train_simcse

    out = {"hash": [], "pretrained": []}
    for enc in ("hash", "pretrained", "pretrained", "hash"):
        cfg, sub = encoder_run(root, enc, 10)
        state = train_simcse(cfg, sub, f"{root}/ckpt_turns_{enc}", device,
                             text_pretrain=art if enc == "pretrained" else None)
        out[enc].append(1e3 * float(np.median(state.step_seconds[1:])))
    return out


def traced_steps(root: str, device: str, text_encoder: str, art) -> dict:
    """Two train-item steps (batch MAIN_B, full width) under
    ``metrics.profile_trace``: the trace file, the kernels it names and the
    launches a step."""
    from recsys_tpu_torch.train.metrics import profile_trace
    from recsys_tpu_torch.train.simcse import train_simcse

    cfg, sub = encoder_run(root, text_encoder, 2)
    trace_dir = f"{root}/trace_{text_encoder}"
    with profile_trace(trace_dir, device=device):
        state = train_simcse(cfg, sub, f"{root}/ckpt_trace_{text_encoder}", device,
                             text_pretrain=art if text_encoder == "pretrained" else None)
    check(state.step == 2, f"traced run took {state.step} steps")
    files = [f for f in os.listdir(trace_dir) if f.endswith(".pt.trace.json")]
    check(len(files) == 1, f"profile_trace wrote {files}")
    with open(os.path.join(trace_dir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    k1 = sum("diag_ce_kernel" in e.get("name", "") for e in kernels)
    check(device == "cpu" or k1 == 6 * state.step,
          f"the trace names {k1} K1 kernels in {state.step} steps")
    return {"steps": state.step, "trace_file": files[0], "k1_kernels": k1,
            "launches_a_step": len(kernels) / max(state.step, 1),
            "device_ms_a_step": sum(e.get("dur", 0.0) for e in kernels) / 1e3 / max(state.step, 1),
            "step_ms": [1e3 * x for x in state.step_seconds]}


def pretrained_slice_phase(root: str, hash_slice: dict, device: str = "cuda") -> dict:
    """ingest-hm -> etl -> pretrain-text -> train-item with the pretrained
    encoder (full width) -> vectorize -> serve -> orchestrate, on H&M-format
    CSVs made here; then two traced steps of each encoder."""
    from recsys_tpu_torch.data.text_pretrain import load_text_pretrain

    data_root = f"{root}/hm_world"
    hm_dir = f"{root}/hm_csv"
    t0 = time.perf_counter()
    csvs = write_hm_csvs(hm_dir)
    csv_seconds = time.perf_counter() - t0
    out = slice_phase(data_root, device,
                      extra_sets=("--set", "item_tower.text_encoder=pretrained"),
                      world=(("ingest-hm", "--hm-dir", hm_dir), ("etl",), ("pretrain-text",)),
                      via_orchestrate=True)
    world = out.pop("world")
    check(world["ingest-hm"]["items"] == HM_ARTICLES, f"ingest-hm: {world['ingest-hm']}")
    pre = world["pretrain-text"]
    check(pre["nonzero_rows"] > 0 and pre["shape"] == [8192, 128], f"pretrain-text: {pre}")
    check(out["serve"]["processed"] == 64, f"orchestrate drained {out['serve']}")
    out["stage_seconds"]["orchestrate"] = out["serve"]["process_pending_s"]
    art = load_text_pretrain(pre["artifact"])
    traced = {enc: traced_steps(data_root, device, enc, art) for enc in ("pretrained", "hash")}
    return {"csvs": {**csvs, "seconds": csv_seconds}, "pretrain_text": pre,
            "host_cpu": host_cpu(), "ingest_hm": world["ingest-hm"], **out, "traced": traced,
            "step_ms_in_turns": step_ms_in_turns(data_root, device, art),
            "hash_encoder_phase2": {k: hash_slice["train"][k]
                                    for k in ("steps", "step_ms_median", "first_step_ms")}}


# -- phase 20: the main path at the H&M catalog, users cut ------------------------

def hm_cut_sets(root: str, device) -> list[str]:
    return ["--set", f"data.root={root}", *HM_CUT_WORLD, "--set", "simcse.epochs=1",
            "--set", "user_train.epochs=1", "--set", "serve.db_path=:memory:",
            "--set", "serve.user_backend=stage2", "--device", str(device)]


# the child of hm_cut_world_start: the CLI's gen-data and etl, one tagged line each
HM_CUT_CHILD = """
import json, sys, time
from recsys_tpu_torch.pipeline import cli
for stage in ("gen-data", "etl"):
    t0 = time.perf_counter()
    out = cli.main([stage, *sys.argv[1:]])
    print("hm_cut " + json.dumps({"stage": stage, "seconds": time.perf_counter() - t0,
                                  "out": out}), flush=True)
"""


def hm_cut_world_start(root: str) -> subprocess.Popen:
    """Phase 20's gen-data and etl, host work only, through the CLI in a
    child process started before the kernels build, so that they run beside
    phases 1-19; its output goes to files in ``root``."""
    with open(f"{root}/hm_cut_world.out", "w") as out, \
            open(f"{root}/hm_cut_world.err", "w") as err:
        return subprocess.Popen(
            [sys.executable, "-c", HM_CUT_CHILD, *hm_cut_sets(f"{root}/hm_cut", "cuda")],
            cwd=os.path.dirname(os.path.abspath(__file__)), stdout=out, stderr=err,
            env={**os.environ, "OMP_NUM_THREADS": "2"})


def hm_cut_world_stop(world: subprocess.Popen) -> None:
    if world.poll() is None:
        world.kill()
        world.wait()


def hm_cut_phase(root: str, device, world: subprocess.Popen) -> dict:
    """gen-data -> etl (``world``, the child of ``hm_cut_world_start(root)``)
    -> train-item -> vectorize -> train-user -> eval -> serve on the H&M
    world's shape with its users cut (HM_CUT_WORLD), then the tie order of the
    three dense top-k sites and their cost at the eval shape."""
    import pandas as pd

    from recsys_tpu_torch.data.dataset import IdMap
    from recsys_tpu_torch.pipeline import cli
    from recsys_tpu_torch.serve.server import make_server, serve_forever_in_thread
    from recsys_tpu_torch.train.checkpoint import load_array_with_ids
    from recsys_tpu_torch.train.sasrec import restore_stage2, tensors_to

    t_phase = time.perf_counter()
    data = f"{root}/hm_cut"
    sets = hm_cut_sets(data, device)
    seconds, out = {}, {}
    try:
        rc = world.wait(timeout=HM_CUT_WORLD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        rc = None
    with open(f"{root}/hm_cut_world.err") as f:
        err = f.read()[-3000:]
    check(rc == 0, f"gen-data / etl child: exit {rc}: {err}")
    with open(f"{root}/hm_cut_world.out") as f:
        for rec in [json.loads(ln[len("hm_cut "):]) for ln in f if ln.startswith("hm_cut ")]:
            out[rec["stage"]], seconds[rec["stage"]] = rec["out"], rec["seconds"]
    check(set(out) == {"gen-data", "etl"}, f"gen-data / etl child printed {sorted(out)}")
    seconds["world_wait"] = time.perf_counter() - t_phase
    for stage in ("train-item", "vectorize", "train-user", "eval"):
        if stage in ("train-item", "train-user"):
            K.reset_launch_counts()       # each training stage's run starts here
        t0 = time.perf_counter()
        out[stage] = cli.main([stage, *sets])
        seconds[stage] = time.perf_counter() - t0
        if stage in ("train-item", "train-user"):
            out[stage]["launches"] = dict(K.LAUNCHES)
    gen, etl, item, user, ev = (out[k] for k in ("gen-data", "etl", "train-item", "train-user",
                                                  "eval"))
    check({k: gen[k] for k in HM_CUT_REF["gen"]} == HM_CUT_REF["gen"],
          f"gen-data {gen} against the JAX package's {HM_CUT_REF['gen']}")
    check({k: etl[k] for k in HM_CUT_REF["etl"]} == HM_CUT_REF["etl"],
          f"etl {etl} against the JAX package's {HM_CUT_REF['etl']}")
    check(all(n == 2 * item["steps"] for n in item["launches"].values())
          and item["steps"] == HM_CUT_ITEM_STEPS,
          f"train-item: K1 {item['launches']} in {item['steps']} steps")
    for name, run in (("train-item", item), ("train-user", user)):
        check(run["graph_replays"] == run["steps"] - WARMUP_STEPS,
              f"{name}: {run['graph_replays']} graph replays in {run['steps']} steps")
    losses = np.asarray(item["losses"])
    check(bool(np.isfinite(losses).all()) and losses[-50:].mean() < losses[:50].mean(),
          f"train-item losses: first {losses[:50].mean()}, last {losses[-50:].mean()}")
    check(out["vectorize"]["shape"] == [HM_CUT_ITEMS + 1, 128], f"vectorize {out['vectorize']}")
    after_eval = dict(K.LAUNCHES)
    check(after_eval == user["launches"], f"eval launched K1: {user['launches']} -> {after_eval}")
    check(all(n == user["steps"] for n in user["launches"].values()),
          f"train-user: K1 {user['launches']} in {user['steps']} steps")
    check(bool(np.isfinite(user["epoch_losses"]).all()), f"train-user {user['epoch_losses']}")
    check(ev["n_eval"] == HM_CUT_REF["n_eval"] and all(ev[f"recall@{k}"] > 0
                                                         for k in (20, 100, 500)),
          f"eval n_eval {ev['n_eval']} (JAX {HM_CUT_REF['n_eval']}), recalls {ev}")
    for name in ("popularity", "repurchase"):
        for key, want in HM_CUT_REF["baselines"][name].items():
            got = ev["baselines"][name][key]
            check(abs(got - want) <= 1e-12, f"baseline {name} {key}: {got} (JAX {want})")

    # serve: five recommendations in blend mode over the 105,001-row catalog
    t0 = time.perf_counter()
    args = cli.parse_args(["serve", *sets, "--model-backed"])
    cfg = cli.config_from_args(args)
    ctx = cli.build_app(cfg, args)
    check(ctx.user_backend == "stage-2 tower (best checkpoint)" and ctx.rec_assets is not None,
          f"serve: {ctx.user_backend}")
    _, uv_ids, _ = load_array_with_ids(f"{data}/eval_uvecs")
    mat, mat_ids, _ = load_array_with_ids(f"{data}/eval_item_matrix")
    item_map = IdMap(mat_ids[1:])
    _, user_vectors, _ = restore_stage2(cfg, {"item_map": item_map}, f"{data}/ckpt_user", device)
    tx = pd.read_parquet(f"{data}/transactions.parquet")
    shoppers = [str(u) for u in uv_ids[:HM_CUT_REQUESTS]]
    server = make_server(ctx, host="127.0.0.1", port=0)
    thread = serve_forever_in_thread(server)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    served_err, rec_ms = 0.0, []
    try:
        histories, tx_user = {}, tx["user_id"].astype(str)
        for uid in shoppers:
            rows = tx[tx_user == uid].sort_values("day", kind="stable").tail(12)
            histories[uid] = [(str(i), 86400.0 * float(d) + j)
                              for j, (i, d) in enumerate(zip(rows["item_id"], rows["day"]))]
        # the histories' products: ingest -> process-pending until drained
        pids = sorted({pid for h in histories.values() for pid, _ in h})
        items = pd.read_parquet(f"{data}/items.parquet")
        picked = items[items["item_id"].astype(str).isin(pids)].to_dict("records")
        http(base, "POST", "/api/controller/products/ingest",
             {"products": [product_json(r) for r in picked]})
        processed = 0
        while (n := http(base, "POST", "/ai-api/serving/vectors/process-pending",
                         {})["processed_count"]):
            processed += n
        check(processed == len(pids), f"process-pending: {processed} of {len(pids)} products")
        for uid in shoppers:
            http(base, "POST", "/api/v1/debug/insert-manual-data", {
                "users": [{"user_id": uid}],
                "sessions": [{"user_id": uid, "events": [
                    {"product_id": pid, "action_type": 3, "ts": ts}
                    for pid, ts in histories[uid]]}]})
        done = http(base, "POST", "/ai-api/serving/users/process-pending", {})
        check(done["processed_count"] == len(shoppers), f"users process-pending: {done}")
        for uid in shoppers:
            t1 = time.perf_counter()
            rec = http(base, "GET", f"/api/controller/recommendations/{uid}?top_k=20&mode=blend")
            rec_ms.append(1e3 * (time.perf_counter() - t1))
            res = rec["results"]
            check(rec.get("mode") == "blend" and len(res) == 20
                  and all(r["product_id"] not in (None, "<pad>") for r in res),
                  f"blend recommendations for {uid}: {rec}")
            want = user_vectors(tensors_to(left_padded_batch(cfg, item_map, histories[uid]),
                                           device))
            served_err = max(served_err, float(np.abs(ctx.store.get_user_vector(uid)
                                                      - want.cpu().numpy()[0]).max()))
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    check(served_err <= SERVE_TOL, f"served user vectors vs the tower: {served_err}")
    seconds["serve"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ties = tie_order_checks(device)
    seconds["ties"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    topk_cost = eval_topk_cost(device, mat)
    seconds["topk_cost"] = time.perf_counter() - t0
    seconds["phase"] = time.perf_counter() - t_phase
    return {"gen": gen, "etl": etl,
            "train_item": {k: item[k] for k in ("steps", "graph_replays", "seconds",
                                                "step_ms_median", "first_step_ms",
                                                "launches")},
            "item_loss_first_last": [float(losses[:50].mean()), float(losses[-50:].mean())],
            "vectorize": {k: out["vectorize"][k] for k in ("shape", "seconds", "items_per_s")},
            "train_user": {k: user[k] for k in ("steps", "graph_replays", "seconds",
                                                "step_ms_median", "epoch_losses",
                                                "launches")},
            "eval": {k: ev[k] for k in ("recall@20", "recall@100", "recall@500", "n_eval",
                                        "step_ms_median", "seconds")},
            "baselines": ev["baselines"], "blend_best": ev["blend"]["best_metrics"],
            "serve": {"users": len(shoppers), "products": processed,
                      "served_vs_tower_err": served_err,
                      "blend_ms_median": float(np.median(rec_ms))},
            "ties": ties, "topk_cost": topk_cost, "stage_seconds": seconds}


def lexsort_topk(scores: np.ndarray, k: int) -> np.ndarray:
    """Top-k ids of each row by (value descending, index ascending)."""
    cols = np.broadcast_to(np.arange(scores.shape[1]), scores.shape)
    return np.lexsort((cols, -scores), axis=1)[:, :k]


def tie_order_checks(device) -> dict:
    """The three dense top-k sites on the card against a numpy reference
    that puts equal values lowest index first: an H&M-sized matrix whose rows
    are 128 basis directions, each repeated ~820 times (the products are
    exact, the distinct scores 0.01 apart, every top-k cuts a tie group)."""
    from recsys_tpu_torch.eval import baselines as B
    from recsys_tpu_torch.eval.recall import topk_scores
    from recsys_tpu_torch.serve import recommend as RC

    rng = np.random.default_rng(0)
    n, dim, q = HM_CUT_ITEMS, 128, 64
    group = rng.integers(0, dim, n)
    items = np.zeros((n + 1, dim), np.float32)
    items[np.arange(1, n + 1), group] = 1.0
    users = (np.stack([rng.permutation(dim) for _ in range(q)]) - 64).astype(np.float32) * 0.01
    logq = np.concatenate([[-20.0], rng.permutation(dim)[group] * 0.05 - 3.0]).astype(np.float32)
    hist = rng.integers(0, n + 1, (q, 8))
    scores = users @ items.T
    scores[:, 0] = -np.inf
    _, idx = topk_scores(torch.as_tensor(users, device=device),
                         torch.as_tensor(items, device=device), 500)
    check(np.array_equal(idx.cpu().numpy(), lexsort_topk(scores, 500)),
          "topk_scores: equal scores not lowest index first")

    def blend_ref(alpha: float, beta: float, rows) -> np.ndarray:
        cos = scores[rows].copy()
        cos[:, 0] = 0.0                                   # the PAD row's cosine
        cos = (cos - cos.min(1, keepdims=True)) / (cos.max(1, keepdims=True)
                                                    - cos.min(1, keepdims=True))
        seen = np.zeros_like(cos)
        seen[np.repeat(np.arange(len(rows)), hist.shape[1]), hist[rows].reshape(-1)] = 1.0
        lo, hi = float(logq.min()), float(logq.max())
        pop = ((logq.astype(np.float64) - lo) / (hi - lo)).astype(np.float32)
        s = np.float32(1 - alpha) * cos + np.float32(alpha) * pop[None, :] + np.float32(beta) * seen
        s[:, 0] = -np.inf
        return s

    ids = [f"p{r}" for r in range(1, n + 1)]
    assets = RC.RecommendAssets(ids, items, logq, np.zeros(n + 1, np.float32), device=device)
    got = RC._blend_topk_device(assets, users[:8], [h[h > 0] for h in hist[:8]], 0.1, 1.0, 20)
    check(np.array_equal(got, lexsort_topk(blend_ref(0.1, 1.0, np.arange(8)), 20)),
          "device blend: equal scores not lowest index first")
    combos = [(a, b) for a in (0.0, 0.1) for b in (0.0, 1.0)]
    lists, real = [], B.recall_at_ks
    B.recall_at_ks = lambda idx, *a, **kw: (lists.append(np.array(idx)), real(idx, *a, **kw))[1]
    try:
        uids = [f"u{r}" for r in range(q)]
        B.blend_sweep(users, items, logq, hist, uids, {u: {1} for u in uids},
                      alphas=(0.0, 0.1), betas=(0.0, 1.0), device=device)
    finally:
        B.recall_at_ks = real
    check(len(lists) == len(combos), f"blend sweep: {len(lists)} lists")
    for (alpha, beta), got in zip(combos, lists):
        check(np.array_equal(got, lexsort_topk(blend_ref(alpha, beta, np.arange(q)), 500)),
              f"blend sweep a{alpha} b{beta}: equal scores not lowest index first")
    return {"topk_scores": "lowest index first", "blend_device": "lowest index first",
            "blend_sweep": f"lowest index first, {len(combos)} combinations",
            "shape": [q, n + 1]}


def eval_topk_cost(device, matrix: np.ndarray) -> dict:
    """``topk_scores``' top-500 at the eval batch (768 users) over the trained
    catalog: ``torch.topk`` (the parent's) against ``stable_topk`` on the same
    scores, and the whole call (product + top-k), CUDA events."""
    from recsys_tpu_torch.eval.recall import topk_scores
    from recsys_tpu_torch.ops.topk import stable_topk

    items = torch.as_tensor(matrix, device=device)
    u = torch.as_tensor(np.random.default_rng(1).normal(size=(768, items.shape[1]))
                        .astype(np.float32), device=device)
    scores = u @ (items / items.norm(dim=1, keepdim=True).clamp(min=1e-12)).T
    scores[:, 0] = -torch.inf
    plain = [cuda_ms(lambda: torch.topk(scores, 500, dim=1), 10)]
    stable = [cuda_ms(lambda: stable_topk(scores, 500), 10)]
    plain.append(cuda_ms(lambda: torch.topk(scores, 500, dim=1), 10))
    stable.insert(0, cuda_ms(lambda: stable_topk(scores, 500), 10))
    whole = cuda_ms(lambda: topk_scores(u, items, 500), 10)
    check(torch.equal(torch.topk(scores, 500, dim=1).values, stable_topk(scores, 500)[0]),
          "stable_topk values differ from torch.topk's")
    return {"shape": list(scores.shape), "k": 500, "torch_topk_ms": plain,
            "stable_topk_ms": stable, "topk_scores_ms": whole,
            "stable_over_torch": float(np.mean(stable) / np.mean(plain))}


# -- phase 21: the headline recipe on phase 20's world ------------------------------

def hm_cut_hybrid_phase(root: str, device) -> dict:
    """train-gnn -> gnn-eval -> distill -> train-hybrid (captured) ->
    rerank-eval --vectors hybrid -> serve --vectors hybrid on phase 20's world
    and its stage-1 matrix (the stages of ``scripts/torch_quality_hm.py
    --recipe hybrid``, cut: HM_CUT_GNN_STEPS GNN steps, one hybrid epoch
    without the ensemble report, a small rerank pool, one request a mode)."""
    import pandas as pd

    from recsys_tpu_torch.data.dataset import IdMap
    from recsys_tpu_torch.pipeline import cli
    from recsys_tpu_torch.serve import recommend as RC
    from recsys_tpu_torch.serve.server import make_server, serve_forever_in_thread
    from recsys_tpu_torch.train import hybrid as H
    from recsys_tpu_torch.train.sasrec import tensors_to

    data = f"{root}/hm_cut"
    sets = [*hm_cut_sets(data, device), "--set", "gnn.epochs=1",
            "--set", f"gnn.steps_per_epoch_min={HM_CUT_GNN_STEPS}",
            "--set", f"gnn.steps_per_epoch_max={HM_CUT_GNN_STEPS}",
            "--set", "user_train.hybrid_report=false", "--set", "serve.user_backend=hybrid"]
    seconds, out = {}, {}
    for stage, extra in (("train-gnn", ()), ("gnn-eval", ()), ("distill", ()),
                         ("train-hybrid", ()),
                         ("rerank-eval", ("--vectors", "hybrid", *HM_CUT_RERANK))):
        if stage == "train-gnn":
            S.reset_launch_counts()       # the GNN trainer's run starts here
        before = all_launches()
        t0 = time.perf_counter()
        out[stage] = cli.main([stage, *sets, *extra])
        seconds[stage] = time.perf_counter() - t0
        out[stage]["launches"] = {k: v - before[k] for k, v in all_launches().items()
                                  if v != before[k]}
    gnn, rows, hyb, rr = (out[k] for k in ("train-gnn", "gnn-eval", "train-hybrid",
                                            "rerank-eval"))
    # forward and backward of two layers a step; the export and the check propagate once each
    check(gnn["steps"] == HM_CUT_GNN_STEPS and gnn["check"]["ok"]
          and gnn["launches"] == {"spmm_csr": 4 * gnn["steps"] + 2 * 2},
          f"train-gnn: {gnn['steps']} steps, K2 {gnn['launches']}, check {gnn['check']}")
    check(all(np.isfinite(gnn["epoch_losses"])), f"train-gnn losses {gnn['epoch_losses']}")
    for arm in ("gnn_dot", "gnn_cos"):
        check(all(np.isfinite(v) and v > 0 for k, v in rows[arm].items() if k != "n_eval"),
              f"gnn-eval {arm}: {rows[arm]}")
    check(np.isfinite(out["distill"]["fidelity"]["fidelity"]), f"distill {out['distill']}")
    check(hyb["graph_replays"] == hyb["steps"] - WARMUP_STEPS and hyb["steps"] > WARMUP_STEPS,
          f"train-hybrid: {hyb['graph_replays']} graph replays in {hyb['steps']} steps")
    check(all(np.isfinite(hyb["epoch_losses"])) and not hyb["launches"]
          and all(np.isfinite(v) and v > 0 for k, v in hyb["hybrid_best"].items()
                  if k != "n_eval"),
          f"train-hybrid: losses {hyb['epoch_losses']}, best {hyb['hybrid_best']}, "
          f"hand kernels {hyb['launches']}")
    check(all(np.isfinite(v) and v > 0 for k, v in rr["reranked"].items() if k != "n_eval")
          and rr["gbdt_auc"] is not None, f"rerank-eval --vectors hybrid: {rr}")

    # serve: one request a mode over the hybrid matrix and its rerank GBDT
    t0 = time.perf_counter()
    args = cli.parse_args(["serve", *sets, "--vectors", "hybrid", "--model-backed"])
    cfg = cli.config_from_args(args)
    ctx = cli.build_app(cfg, args)
    assets = ctx.rec_assets
    check(ctx.user_backend == "hybrid tower (best checkpoint)" and assets is not None
          and assets.ranker is not None and assets.vectors == "hybrid",
          f"serve --vectors hybrid: {ctx.user_backend}")
    item_map = IdMap(assets.item_ids)
    stub = {"item_map": item_map, "logq": np.zeros(len(item_map) + 1, np.float32)}
    content, gnn_items, gu, gu_ids = cli._hybrid_inputs(cfg, stub)
    _, uv, _ = H.restore_hybrid(cfg, stub, content, gnn_items, f"{data}/ckpt_hybrid", device)
    gnn_of = {str(u): gu[r] for r, u in enumerate(gu_ids)}
    tx = pd.read_parquet(f"{data}/transactions.parquet")
    uid = str(gu_ids[0])
    rows_u = tx[tx["user_id"].astype(str) == uid].sort_values("day", kind="stable").tail(12)
    history = [(str(i), 86400.0 * float(d) + j)
               for j, (i, d) in enumerate(zip(rows_u["item_id"], rows_u["day"]))]
    server = make_server(ctx, host="127.0.0.1", port=0)
    thread = serve_forever_in_thread(server)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    rec_ms, got = {}, {}
    try:
        items = pd.read_parquet(f"{data}/items.parquet")
        # the history's products and more, so that cosine mode has unseen ones to offer
        pids = sorted({pid for pid, _ in history}
                      | set(items["item_id"].astype(str)[:HM_CUT_SERVE_PRODUCTS]))
        http(base, "POST", "/api/controller/products/ingest",
             {"products": [product_json(r) for r in
                           items[items["item_id"].astype(str).isin(pids)].to_dict("records")]})
        while http(base, "POST", "/ai-api/serving/vectors/process-pending", {})["processed_count"]:
            pass
        http(base, "POST", "/api/v1/debug/insert-manual-data", {
            "users": [{"user_id": uid}],
            "sessions": [{"user_id": uid, "events": [
                {"product_id": pid, "action_type": 3, "ts": ts} for pid, ts in history]}]})
        done = http(base, "POST", "/ai-api/serving/users/process-pending", {})
        check(done["processed_count"] == 1, f"users process-pending: {done}")
        for mode in ("rerank", "blend", "cosine"):
            t1 = time.perf_counter()
            got[mode] = http(base, "GET", f"/api/controller/recommendations/{uid}"
                                          f"?top_k=20&mode={mode}")
            rec_ms[mode] = 1e3 * (time.perf_counter() - t1)
            res = got[mode]["results"]
            check(0 < len(res) <= 20 and got[mode].get("mode", "cosine") == mode
                  and all(r["product_id"] not in (None, "<pad>") for r in res),
                  f"{mode} recommendations for {uid}: {got[mode]}")
        served = ctx.store.get_user_vector(uid)
        want = uv(tensors_to(left_padded_batch(cfg, item_map, history), device),
                  torch.as_tensor(gnn_of[uid][None], device=device))
        served_err = float(np.abs(served - want.cpu().numpy()[0]).max())
        iidx, days = RC.store_events_arrays(assets, ctx.store.user_histories([uid])[uid])
        offline = RC.rerank_serve_topk(assets, served[None], [(iidx, days)],
                                       int(days.max()) + 1, 20,
                                       pool_size=cfg.serve.rerank_pool,
                                       m_cos=cfg.serve.rerank_m_cos,
                                       m_pop=cfg.serve.rerank_m_pop)
        check([r["product_id"] for r in got["rerank"]["results"]]
              == [assets.pid_of(int(r)) for r in offline[0] if int(r) != 0],
              f"HTTP rerank list for {uid} differs from rerank_serve_topk's")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    check(served_err <= SERVE_TOL, f"served user vector vs the hybrid tower: {served_err}")
    seconds["serve"] = time.perf_counter() - t0
    return {"train_gnn": {k: gnn[k] for k in ("steps", "seconds", "step_ms_median",
                                              "epoch_losses", "check", "graph", "launches")},
            "gnn_eval": {k: rows[k] for k in ("n_eval_users", "gnn_dot", "gnn_cos")},
            "distill": {"shape": out["distill"]["shape"],
                        "fidelity": out["distill"]["fidelity"]},
            "train_hybrid": {k: hyb[k] for k in ("steps", "graph_replays", "seconds",
                                                 "step_ms_median", "epoch_losses",
                                                 "hybrid_best")},
            "rerank": {k: rr[k] for k in ("reranked", "pool_ceiling", "gbdt_auc", "dcn_auc",
                                          "pool_size", "train_users", "gbdt_seconds",
                                          "seconds")},
            "serve": {"served_vs_tower_err": served_err, "recommendation_ms": rec_ms},
            "stage_seconds": seconds}


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
    root = tempfile.mkdtemp(prefix="chip_smoke_")
    world = hm_cut_world_start(root)           # phase 20's data, beside phases 1-19
    try:
        t0 = time.perf_counter()
        modules = {"diag_ce": K, "spmm": S, "fm": FM, "ring": R}
        # one nvcc per source, together
        with concurrent.futures.ThreadPoolExecutor(len(modules)) as pool:
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
        result = slice_phase(root)
        print(json.dumps({"phase": "slice", **result}), flush=True)
        item_step = item_step_phase(root, device)
        print(json.dumps({"phase": "item_step", **item_step}), flush=True)
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
        retrieval_phase(device)
        seconds["phase_17"] = time.perf_counter() - start - sum(seconds.values())
        indexes = device_index_serve_phase(root)
        print(json.dumps({"phase": "device_index_serve", **indexes}), flush=True)
        seconds["phase_18"] = time.perf_counter() - start - sum(seconds.values())
        pretrained = pretrained_slice_phase(root, result)
        print(json.dumps({"phase": "pretrained_slice", **pretrained}), flush=True)
        seconds["phase_19"] = time.perf_counter() - start - sum(seconds.values())
        hm_cut = hm_cut_phase(root, device, world)
        print(json.dumps({"phase": "hm_cut", **hm_cut}), flush=True)
        seconds["phase_20"] = time.perf_counter() - start - sum(seconds.values())
        hm_hybrid = hm_cut_hybrid_phase(root, device)
        print(json.dumps({"phase": "hm_cut_hybrid", **hm_hybrid}), flush=True)
        seconds["phase_21"] = time.perf_counter() - start - sum(seconds.values())
    finally:
        hm_cut_world_stop(world)
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"seconds": {**seconds, "total": time.perf_counter() - start}}), flush=True)

    # K1's launches are the main path's: train-item (phase 2), train-user (phase 13),
    # train-item with the pretrained encoder (phase 19), and train-item and
    # train-user at the H&M catalog (phase 20); its times are at the SimCSE
    # shape, stage 2's B = 3072 and 8192 beside them
    k1_bounds = diag_ce_bounds(MAIN_B, D)
    kernels = [{"name": name, "route": "cuda", "source": SOURCES["diag_ce"],
                "replaces": REPLACES[name],
                "launches": (result["launches"][name] + user["launches"][name]
                             + pretrained["launches"][name]
                             + hm_cut["train_item"]["launches"][name]
                             + hm_cut["train_user"]["launches"][name]),
                "launches_train_item": result["launches"][name],
                "launches_train_user": user["launches"][name],
                "launches_train_item_pretrained": pretrained["launches"][name],
                "launches_hm_cut_train_item": hm_cut["train_item"]["launches"][name],
                "launches_hm_cut_train_user": hm_cut["train_user"]["launches"][name],
                "max_abs_err": kstats["errs"][name],
                "ms": kstats["ms"][name][0], "plain_ms": kstats["ms"][name][1],
                **k1_bounds[name], "library_ms": None,
                "B3072": kstats["B3072"][name], "B8192": kstats["B8192"][name]}
               for name in K.LAUNCHES]
    # K2's launches are the trainer's at the real size and train-gnn's at the H&M
    # catalog (phase 21), its times those of the trainer's mode (bf16) at the real
    # size; the f32 mode and the CLI path's launches and graph go beside them
    kernels += [{"name": name, "route": "cuda", "source": SOURCES["spmm"],
                 "replaces": REPLACES[name],
                 "launches": (trainer["launches"][name]
                              + hm_hybrid["train_gnn"]["launches"][name]),
                 "launches_trainer": trainer["launches"][name],
                 "launches_hm_cut_train_gnn": hm_hybrid["train_gnn"]["launches"][name],
                 "launches_cli_path": gnn["launches"][name],
                 **{k: sstats[name][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                 "bound_by", "library_ms")}}
                for name in S.LAUNCHES]
    kernels[len(K.LAUNCHES)].update({"mode": "bf16", "f32_mode": sstats["spmm_csr"]["f32"],
                                     "wrapper_ms": sstats["spmm_csr"]["wrapper_ms"],
                                     "hub_finish": sstats["spmm_csr"]["hub_finish"],
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
