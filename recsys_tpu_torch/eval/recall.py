"""Full-catalog retrieval evaluation: Recall@{20,100,500}.

Counterpart of the dense, exact part of ``recsys_tpu/eval/recall.py``:
normalize the item matrix once, score the whole catalog (``U @ I^T``), take
top-max(K) on the device (equal scores lowest index first, as
``jax.lax.top_k``), then compute set-intersection recall on the host
with users absent from the ground truth dropped from the denominator. The
recall helpers count what the JAX package's loops count, bit for bit, in
array form (``TargetTable``). On a mesh whose model
axis is > 1 the item matrix and the prior are row-sharded, every shard
scores its rows and ``parallel/collectives.sharded_topk`` merges, so eval and
serving share one retrieval path. ``method="approx"`` on the dense path is
``jax.lax.approx_max_k`` as the TPU computes it (``ops/approx_topk.py``: the
scores binned inside the fp32 kernel on the card, the plain form on the
CPU); on the sharded path it is ignored, as in the JAX package.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from recsys_tpu_torch.ops.approx_topk import approx_topk_f32
from recsys_tpu_torch.ops.topk import stable_topk
from recsys_tpu_torch.parallel.collectives import sharded_topk
from recsys_tpu_torch.parallel.mesh import Mesh, shard_rows


def _normalized(item_matrix: torch.Tensor, normalize_items: bool) -> torch.Tensor:
    items = item_matrix.float()
    if normalize_items:
        items = items / torch.linalg.norm(items, dim=-1, keepdim=True).clamp(min=1e-12)
    return items


def sharded_scores(user_vecs: torch.Tensor, item_matrix: torch.Tensor, mesh: Mesh,
                   normalize_items: bool = True, prior: torch.Tensor | None = None
                   ) -> list[torch.Tensor]:
    """The score matrix column-sharded over the mesh's model axis: shard i
    holds (B, N_local), its rows of the row-sharded item matrix (and prior)
    against the replicated user vectors. Only the global PAD row is masked:
    column 0 of shard 0. The rows must divide by the axis size."""
    items = shard_rows(mesh, _normalized(item_matrix, normalize_items))
    priors = None if prior is None else shard_rows(mesh, prior.float())
    out = []
    for i, it in enumerate(items):
        scores = user_vecs.float().to(it.device) @ it.T
        if priors is not None:
            scores = scores + priors[i][None, :]
        if i == 0:
            scores[:, 0] = -torch.inf
        out.append(scores)
    return out


def topk_scores(user_vecs: torch.Tensor, item_matrix: torch.Tensor, k: int,
                mesh: Mesh | None = None, normalize_items: bool = True,
                prior: torch.Tensor | None = None, method: str = "exact",
                recall_target: float = 0.95):
    """(B, D) x (N+1, D) -> (vals, idx) (B, k); PAD row 0 excluded.

    With a mesh whose model axis is > 1 the item matrix is row-sharded and the
    top-k is merged across the shards (the result of the axis's first shard,
    on its device); otherwise one dense product and top-k.

    ``prior``: optional per-item additive score (N+1,) — e.g. a scaled
    log-popularity blend — applied before top-k; on a mesh it is sharded like
    the item matrix. Equal scores come back lowest index first, as
    ``jax.lax.top_k`` returns them (``ops/topk.stable_topk``).

    ``method="approx"`` (dense path only) takes ``jax.lax.approx_max_k``'s
    answer at ``recall_target`` (``ops/approx_topk.approx_topk_f32``). The
    sharded path is always exact, as in the JAX package."""
    if method not in ("exact", "approx"):
        raise ValueError(f"topk_scores method {method!r}: want 'exact' or 'approx'")
    if mesh is not None and mesh.shape[mesh.axis_names[1]] > 1:
        return sharded_topk(
            sharded_scores(user_vecs, item_matrix, mesh, normalize_items, prior), k)[0]
    items = _normalized(item_matrix, normalize_items)
    if method == "approx":
        return approx_topk_f32(user_vecs, items, prior, k, recall_target)
    scores = user_vecs.float() @ items.T
    if prior is not None:
        scores = scores + prior.float()[None, :]
    scores[:, 0] = -torch.inf
    return stable_topk(scores, k)


_CHUNK_ROWS = 1 << 13
_MISS = np.iinfo(np.int64).max


class TargetTable:
    """The non-empty target sets of ``user_ids`` in the flat form that recall
    scores against: ``rows`` (the users with targets, in order), ``lens``
    (each set's size) and ``items`` (the sets' items in that order). A
    caller that scores many lists against one target dict builds it once
    and passes it as ``table``."""

    def __init__(self, user_ids, targets_idx: dict):
        sets = [targets_idx.get(u) for u in user_ids]
        self.rows = np.fromiter((r for r, s in enumerate(sets) if s), np.int64)
        self.lens = np.fromiter((len(sets[r]) for r in self.rows), np.int64, len(self.rows))
        self.items = np.fromiter((i for r in self.rows for i in sets[r]), np.int64,
                                 int(self.lens.sum()))


def _positions_chunk(topk, rows, lens, starts, items, width, order, pos):
    block = topk[rows[order], :width]
    ln, st = lens[order], starts[order]
    for t in range(int(ln[0])):           # lens descend: the rows with a t-th target lead
        m = int(np.count_nonzero(ln > t))
        eq = block[:m] == items[st[:m] + t][:, None]
        first = eq.argmax(1)
        pos[st[:m] + t] = np.where(eq[np.arange(m), first], first, _MISS)


def _first_positions(topk: np.ndarray, rows, lens, items) -> np.ndarray:
    """For each target, the first column of its user's top-k row that holds
    it, or ``_MISS``. A repeated index in a row counts once, as a set
    intersection counts it."""
    pos = np.full(len(items), _MISS, np.int64)
    if topk.shape[1] == 0 or not len(rows):
        return pos
    starts = np.cumsum(lens) - lens
    order = np.argsort(-lens, kind="stable")
    chunks = [order[s:s + _CHUNK_ROWS] for s in range(0, len(order), _CHUNK_ROWS)]

    def scan(o):
        _positions_chunk(topk, rows, lens, starts, items, topk.shape[1], o, pos)
    if len(chunks) == 1:
        scan(chunks[0])
    else:   # numpy's compares release the GIL; the chunks write disjoint targets
        with ThreadPoolExecutor(min(4, os.cpu_count() or 1)) as pool:
            list(pool.map(scan, chunks))
    return pos


def _recall_rows(topk_idx, table: TargetTable, ks) -> dict:
    """{k: per-row recall@k} over the users with targets, in order."""
    topk = np.asarray(topk_idx)
    if len(table.rows):
        topk = topk[:, :max(ks)]
    pos = _first_positions(topk, table.rows, table.lens, table.items)
    owner = np.repeat(np.arange(len(table.rows)), table.lens)
    return {k: np.bincount(owner[pos < k], minlength=len(table.rows)) / table.lens
            for k in ks}


def recall_at_ks(topk_idx: np.ndarray, user_ids: list, targets_idx: dict,
                 ks=(20, 100, 500), *, table: TargetTable | None = None) -> dict:
    """targets_idx: user_id -> set of target item indices. Users without
    targets are dropped from the denominator (reference `:679-699`). Hits
    are distinct items; each user's recall is added in user order, as a
    loop over the users adds it. ``table``: ``TargetTable(user_ids,
    targets_idx)`` where the caller has built it."""
    ks = sorted(ks)
    table = TargetTable(user_ids, targets_idx) if table is None else table
    vals = _recall_rows(topk_idx, table, ks)
    n_eval = len(table.rows)
    if n_eval == 0:
        return {f"recall@{k}": 0.0 for k in ks} | {"n_eval": 0}
    return {f"recall@{k}": float(np.cumsum(vals[k])[-1]) / n_eval for k in ks} \
        | {"n_eval": n_eval}


def recall_per_user(topk_idx: np.ndarray, user_ids, targets_idx: dict,
                    k: int, *, table: TargetTable | None = None) -> tuple[np.ndarray, list]:
    """Per-user recall@k over users WITH targets (same denominator semantics
    as ``recall_at_ks``). Returns (values, kept_user_ids) — the raw material
    for bootstrap confidence intervals and paired system comparisons."""
    table = TargetTable(user_ids, targets_idx) if table is None else table
    vals = _recall_rows(topk_idx, table, [k])[k]
    uids = user_ids if isinstance(user_ids, (list, tuple)) else list(user_ids)
    return np.asarray(vals, np.float64), [uids[r] for r in table.rows]


def bootstrap_mean_ci(values: np.ndarray, n_boot: int = 1000, seed: int = 0,
                      level: float = 0.95) -> dict:
    """Percentile bootstrap CI on the mean of per-user values. Chunked so a
    200k-user eval doesn't allocate an (n_boot, n) resample matrix at once."""
    values = np.asarray(values, np.float64)
    n = len(values)
    if n == 0:
        return {"mean": 0.0, "lo": 0.0, "hi": 0.0, "n": 0}
    rng = np.random.default_rng(seed)
    means = np.empty(n_boot, np.float64)
    chunk = max(1, min(n_boot, int(2e7) // max(n, 1)))
    for s0 in range(0, n_boot, chunk):
        b = min(chunk, n_boot - s0)
        idx = rng.integers(0, n, (b, n))
        means[s0:s0 + b] = values[idx].mean(1)
    a = (1.0 - level) / 2.0
    lo, hi = np.quantile(means, [a, 1.0 - a])
    return {"mean": float(values.mean()), "lo": float(lo), "hi": float(hi),
            "n": n}


def paired_delta_ci(a: np.ndarray, b: np.ndarray, n_boot: int = 1000,
                    seed: int = 0, level: float = 0.95) -> dict:
    """Paired bootstrap on mean(a - b) over the SAME users — the honest test
    for "system A beats system B": per-user differencing removes the shared
    user-difficulty variance that independent CIs double-count.
    ``p_improve`` = fraction of bootstrap resamples with a positive delta."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"paired arrays differ: {a.shape} vs {b.shape}")
    d = a - b
    n = len(d)
    if n == 0:
        return {"delta": 0.0, "lo": 0.0, "hi": 0.0, "p_improve": 0.0, "n": 0}
    rng = np.random.default_rng(seed)
    means = np.empty(n_boot, np.float64)
    chunk = max(1, min(n_boot, int(2e7) // max(n, 1)))
    for s0 in range(0, n_boot, chunk):
        bsz = min(chunk, n_boot - s0)
        idx = rng.integers(0, n, (bsz, n))
        means[s0:s0 + bsz] = d[idx].mean(1)
    q = (1.0 - level) / 2.0
    lo, hi = np.quantile(means, [q, 1.0 - q])
    return {"delta": float(d.mean()), "lo": float(lo), "hi": float(hi),
            "p_improve": float((means > 0).mean()), "n": n}


def evaluate_retrieval(forward_fn, batches, item_matrix, targets_idx,
                       ks=(20, 100, 500), mesh: Mesh | None = None) -> dict:
    """Generic retrieval eval: ``forward_fn(batch) -> (B, D) user vectors``;
    ``batches`` yields (batch, user_ids)."""
    max_k = max(ks)
    all_idx, all_uids = [], []
    for batch, uids in batches:
        u = forward_fn(batch)
        _, idx = topk_scores(u, item_matrix, max_k, mesh=mesh)
        all_idx.append(idx.cpu().numpy())
        all_uids.extend(uids)
    if not all_idx:
        return {f"recall@{k}": 0.0 for k in ks} | {"n_eval": 0}
    return recall_at_ks(np.concatenate(all_idx), all_uids, targets_idx, ks)


def target_rows(user_ids, targets_idx: dict) -> np.ndarray:
    """Row indices of users that have validation targets — the shared
    eval-filtering step (recall_at_ks drops target-less users from the
    denominator, so scoring them is pure waste)."""
    return np.array([r for r, u in enumerate(user_ids) if u in targets_idx],
                    np.int64)
