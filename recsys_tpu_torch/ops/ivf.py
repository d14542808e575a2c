"""IVF (inverted-file) approximate retrieval on the card.

Counterpart of ``recsys_tpu/ops/ivf.py``: a clustered, fixed-shape index
that keeps the search as dense batched products, for catalogs where the
exact scan (``eval/recall.topk_scores``) stops being free (1M+ items).

Build (host loops, products on the device):
  * spherical k-means over the L2-normalized catalog: Lloyd iterations with
    the assignment on the device (``x @ c.T``, then the best centroid) and
    the centroid sums on the host with ``np.add.at``, a sum in a fixed
    order (an atomic ``index_add_`` on the card sums in no fixed order);
    the random draws are the JAX package's, from ``default_rng(seed)``;
  * items packed into equal-capacity buckets, one per centroid:
    best-score-first greedy over the ``choices`` nearest centroids, spilling
    to the next one with room, so the device arrays stay rectangular; empty
    slots hold id 0 (the PAD row).

Search: centroid scores, the top-``nprobe`` buckets, then a loop over the
probe slots (the JAX ``lax.scan``): gather the bucket's ids and vectors,
score them, merge into the running top-k by a top-k over [running,
bucket]. Every top-k here is ``ops/topk.stable_topk``: equal scores lowest
index first, as ``jax.lax.top_k``, so ties and the -inf padding give the
JAX ids.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from recsys_tpu_torch.device import resolve_device
from recsys_tpu_torch.ops.topk import stable_topk


def _l2n(x: np.ndarray) -> np.ndarray:
    return x / np.clip(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12, None)


def _assign_chunk(x: torch.Tensor, centroids: torch.Tensor, choices: int):
    """Top-``choices`` centroid scores + ids for a chunk of vectors."""
    return stable_topk(x @ centroids.T, choices)


def kmeans(x: np.ndarray, nlist: int, iters: int = 10, seed: int = 0, chunk: int = 65536,
           device: torch.device | str = "cuda") -> np.ndarray:
    """Spherical k-means (cosine): returns (nlist, D) unit centroids.

    Lloyd iterations with the assignment on ``device``; empty clusters are
    re-seeded from random points so every bucket stays usable."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    x = _l2n(np.asarray(x, np.float32))
    n = len(x)
    cent = x[rng.choice(n, size=min(nlist, n), replace=False)]
    if len(cent) < nlist:  # degenerate: fewer points than clusters
        cent = np.concatenate([cent, rng.normal(0, 1, (nlist - len(cent), x.shape[1]))])
    cent = _l2n(cent.astype(np.float32))
    x_dev = torch.as_tensor(x, device=device)
    for _ in range(max(iters, 1)):
        c_dev = torch.as_tensor(cent, device=device)
        assign = torch.cat([_assign_chunk(x_dev[s:s + chunk], c_dev, 1)[1][:, 0]
                            for s in range(0, n, chunk)]).cpu().numpy()
        sums = np.zeros_like(cent)
        np.add.at(sums, assign, x)
        counts = np.bincount(assign, minlength=nlist).astype(np.float32)
        empty = counts == 0
        if empty.any():
            sums[empty] = x[rng.integers(0, n, int(empty.sum()))]
            counts[empty] = 1.0
        cent = _l2n(sums / counts[:, None])
    return cent


@dataclass
class IvfIndexArrays:
    """Device-resident index: rectangular, PAD id 0 in empty slots."""

    centroids: torch.Tensor    # (nlist, D) unit rows
    bucket_ids: torch.Tensor   # (nlist, cap) int32 catalog indices, 0 = empty
    bucket_vecs: torch.Tensor  # (nlist, cap, D) unit rows (0 on padding)

    @property
    def nlist(self) -> int:
        return self.centroids.shape[0]

    @property
    def cap(self) -> int:
        return self.bucket_ids.shape[1]


def build_ivf(item_matrix: np.ndarray, nlist: int | None = None, iters: int = 10,
              seed: int = 0, choices: int = 8, balance: float = 1.5,
              device: torch.device | str = "cuda") -> IvfIndexArrays:
    """Cluster catalog rows 1..N of an (N+1, D) matrix (PAD row 0 skipped)
    into equal-capacity buckets on ``device``.

    ``balance`` bounds the target capacity at ``ceil(N/nlist * balance)``;
    items whose ``choices`` nearest buckets are all full force a capacity
    bump (rare; it shows in the arrays' shape)."""
    device = resolve_device(device)
    mat = np.asarray(item_matrix, np.float32)
    x = _l2n(mat[1:])
    n = len(x)
    if n == 0:
        raise ValueError("empty catalog")
    if nlist is None:
        nlist = max(1, int(np.sqrt(n)))
    nlist = min(nlist, n)
    cent = kmeans(x, nlist, iters=iters, seed=seed, device=device)
    choices = min(choices, nlist)

    x_dev, c_dev = torch.as_tensor(x, device=device), torch.as_tensor(cent, device=device)
    chunk = 65536
    parts = [_assign_chunk(x_dev[s:s + chunk], c_dev, choices) for s in range(0, n, chunk)]
    vals = torch.cat([v for v, _ in parts]).cpu().numpy()
    idxs = torch.cat([i for _, i in parts]).cpu().numpy()

    cap = int(np.ceil(n / nlist * balance))
    buckets: list[list[int]] = [[] for _ in range(nlist)]
    # best-score-first greedy fill over successive choice ranks
    unassigned = np.arange(n)
    for c in range(choices):
        if not len(unassigned):
            break
        order = unassigned[np.argsort(-vals[unassigned, c])]
        still = []
        for it in order:
            b = int(idxs[it, c])
            if len(buckets[b]) < cap:
                buckets[b].append(int(it))
            else:
                still.append(it)
        unassigned = np.array(still, np.int64)
    for it in unassigned:  # every choice full: force into the nearest
        buckets[int(idxs[it, 0])].append(int(it))
    cap = max(cap, max(len(b) for b in buckets))

    bucket_ids = np.zeros((nlist, cap), np.int32)
    bucket_vecs = np.zeros((nlist, cap, x.shape[1]), np.float32)
    for b, lst in enumerate(buckets):
        if lst:
            rows = np.asarray(lst, np.int64)
            bucket_ids[b, :len(lst)] = rows + 1      # catalog indices (1-based)
            bucket_vecs[b, :len(lst)] = x[rows]
    return IvfIndexArrays(c_dev, torch.as_tensor(bucket_ids, device=device),
                          torch.as_tensor(bucket_vecs, device=device))


def ivf_search(index: IvfIndexArrays, queries, k: int, nprobe: int):
    """(B, D) queries -> (vals, idx) (B, k) over the probed buckets, on the
    index's device.

    Cosine space: bucket vectors are unit rows; queries are normalized here
    so scores match ``topk_scores(..., normalize_items=True)`` up to the
    query's (rank-preserving) norm. Fewer than k probed items leave -inf
    with id 0 in the tail."""
    q = torch.as_tensor(queries, dtype=torch.float32, device=index.centroids.device)
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp(min=1e-12)
    nprobe = min(nprobe, index.nlist)
    _, probes = stable_topk(q @ index.centroids.T, nprobe)          # (B, nprobe)
    vals = torch.full((q.shape[0], k), -torch.inf, device=q.device)
    idx = torch.zeros((q.shape[0], k), dtype=torch.int32, device=q.device)
    for p in range(nprobe):
        b = probes[:, p]
        bids = index.bucket_ids[b]                                   # (B, cap)
        s = torch.bmm(index.bucket_vecs[b], q[:, :, None])[:, :, 0]  # (B, cap)
        s = torch.where(bids == 0, -torch.inf, s)
        vals, sel = stable_topk(torch.cat([vals, s], dim=1), k)
        idx = torch.cat([idx, bids], dim=1).gather(1, sel)
    return vals, idx
