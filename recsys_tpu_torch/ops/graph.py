"""Sparse bipartite graph construction and the plain propagation forms.

Counterpart of ``recsys_tpu/ops/graph.py``. ``BipartiteGraph``,
``_randomized_svd`` and ``build_graph`` are the JAX package's numpy/scipy
code (``build_graph`` dedups the pairs on a 1-D key, which sorts them as
the JAX package's row-wise ``np.unique`` does), so both packages build
identical arrays from the same interactions. ``propagate`` is gather x weight followed by ``index_add_``
(the counterpart of ``segment_sum``); ``propagate_chunked`` bounds the
(E, D) message array over a host-resident edge list. The hand-written CUDA
sparse product that the trainer uses on the card is ``ops/spmm.py``.
``make_edge_sharded_propagate`` shards the edge list over a mesh axis.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class BipartiteGraph:
    """Symmetric normalized user-item graph in COO form.

    Nodes are stacked [users (Nu) | items (Ni)]. ``src/dst/weight`` contain
    BOTH edge directions, padded to a fixed length with weight-0 self loops
    on node 0 (the JAX package's fixed shapes; the port keeps the arrays equal).
    """

    num_users: int
    num_items: int
    src: np.ndarray      # (E,) int32
    dst: np.ndarray      # (E,) int32
    weight: np.ndarray   # (E,) float32 — D^-1/2 A D^-1/2 normalization
    svd_u: np.ndarray    # (N, q)
    svd_s: np.ndarray    # (q,)
    svd_v: np.ndarray    # (N, q)

    @property
    def num_nodes(self) -> int:
        return self.num_users + self.num_items


def _randomized_svd(mat_vec, mat_tvec, n_rows: int, n_cols: int, q: int,
                    niter: int, rng: np.random.Generator):
    """Randomized low-rank SVD via subspace iteration (host, one-time)."""
    k = min(q + 4, min(n_rows, n_cols))
    omega = rng.normal(size=(n_cols, k)).astype(np.float64)
    y = mat_vec(omega)
    for _ in range(niter):
        y = mat_vec(mat_tvec(y))
    qmat, _ = np.linalg.qr(y)
    b = mat_tvec(qmat).T          # (k, n_cols)
    ub, s, vt = np.linalg.svd(b, full_matrices=False)
    u = qmat @ ub
    return (u[:, :q].astype(np.float32), s[:q].astype(np.float32),
            vt[:q].T.astype(np.float32))


def build_graph(user_idx: np.ndarray, item_idx: np.ndarray, num_users: int,
                num_items: int, svd_rank: int = 5, svd_iters: int = 2,
                pad_multiple: int = 1024, seed: int = 0) -> BipartiteGraph:
    """Deduped (user, item) interactions -> normalized symmetric COO graph +
    low-rank SVD of the normalized adjacency."""
    u, i = np.asarray(user_idx).astype(np.int64), np.asarray(item_idx).astype(np.int64)
    # the sorted distinct (user, item) pairs, through one 1-D key
    lo = int(i.min()) if len(i) else 0
    span = int(i.max()) - lo + 1 if len(i) else 1
    keys = np.unique(u * span + (i - lo))
    u, i = keys // span, keys % span + lo
    n = num_users + num_items
    deg = np.zeros(n, np.float64)
    np.add.at(deg, u, 1.0)
    np.add.at(deg, num_users + i, 1.0)
    d_inv_sqrt = 1.0 / np.sqrt(np.clip(deg, 1.0, None))
    w = (d_inv_sqrt[u] * d_inv_sqrt[num_users + i]).astype(np.float32)

    src = np.concatenate([u, num_users + i]).astype(np.int32)
    dst = np.concatenate([num_users + i, u]).astype(np.int32)
    weight = np.concatenate([w, w]).astype(np.float32)
    # pad to a fixed multiple with zero-weight edges (node 0 self loop)
    E = len(src)
    target = ((E + pad_multiple - 1) // pad_multiple) * pad_multiple
    pad = target - E
    src = np.concatenate([src, np.zeros(pad, np.int32)])
    dst = np.concatenate([dst, np.zeros(pad, np.int32)])
    weight = np.concatenate([weight, np.zeros(pad, np.float32)])

    # host-side randomized SVD of the (N, N) normalized adjacency
    import scipy.sparse as sp
    adj = sp.coo_matrix(
        (np.concatenate([w, w]),
         (np.concatenate([u, num_users + i]), np.concatenate([num_users + i, u]))),
        shape=(n, n)).tocsr()
    rng = np.random.default_rng(seed)
    su, ss, sv = _randomized_svd(lambda x: adj @ x, lambda x: adj.T @ x,
                                 n, n, svd_rank, svd_iters, rng)
    return BipartiteGraph(num_users, num_items, src, dst, weight, su, ss, sv)


def propagate(x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
              weight: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """One normalized-adjacency propagation step: out = A_norm @ x, as
    gather + ``index_add_`` over the COO edge list."""
    msgs = x[src.long()] * weight[:, None]
    out = torch.zeros((num_nodes, x.shape[1]), dtype=msgs.dtype, device=x.device)
    return out.index_add_(0, dst.long(), msgs)


def propagate_chunked(x: torch.Tensor, src: np.ndarray, dst: np.ndarray,
                      weight: np.ndarray, num_nodes: int,
                      edge_chunk: int = 4_194_304) -> torch.Tensor:
    """Memory-bounded ``A_norm @ x`` over a host-resident edge list.

    :func:`propagate` materializes the full (E, D) message array; this form
    moves ``edge_chunk`` edges to ``x``'s device at a time and accumulates
    the per-chunk sums. Sum order differs from the single-shot form only at
    fp32 ulp level."""
    def on_device(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), device=x.device).to(dtype)

    E = len(src)
    if E <= edge_chunk:
        return propagate(x, on_device(src, torch.int64), on_device(dst, torch.int64),
                         on_device(weight, torch.float32), num_nodes)
    x = x.float()
    acc = torch.zeros((num_nodes, x.shape[1]), dtype=torch.float32, device=x.device)
    for s0 in range(0, E, edge_chunk):
        e = min(s0 + edge_chunk, E)
        msgs = (x[on_device(src[s0:e], torch.int64)]
                * on_device(weight[s0:e], torch.float32)[:, None])
        acc.index_add_(0, on_device(dst[s0:e], torch.int64), msgs)
    return acc


def svd_propagate(x: torch.Tensor, svd_u: torch.Tensor, svd_s: torch.Tensor,
                  svd_v: torch.Tensor) -> torch.Tensor:
    """Global (low-rank) view propagation: \\hat{A} x = U (S * (V^T x))."""
    return svd_u @ (svd_s[:, None] * (svd_v.T @ x))


def make_edge_sharded_propagate(mesh, num_nodes: int, axis: str = "model"):
    """Edge-sharded propagation: the edge list is sharded over ``axis``, each
    shard sums its slice into a full (num_nodes, D) partial on its device, and
    one sum over the shards merges. x stays whole on its own device; autograd
    broadcasts the cotangent to every shard and adds the shards' gradients.

    Returns ``(prop_fn, place_edges)``: ``place_edges(src, dst, weight)`` pads
    the edge arrays to the axis size (dst 0 / weight 0 pads add nothing) and
    puts one slice on each of the axis's devices; ``prop_fn(args, x)`` matches
    the ``select_propagation`` contract and returns on x's device."""
    from recsys_tpu_torch.parallel.mesh import pad_to_multiple, shard

    n_shards = mesh.shape[axis]

    def place_edges(src, dst, weight):
        src, _ = pad_to_multiple(np.asarray(src), n_shards)
        dst, _ = pad_to_multiple(np.asarray(dst), n_shards)
        weight, _ = pad_to_multiple(np.asarray(weight, np.float32), n_shards, fill=0.0)
        parts = [shard(mesh, a, axis) for a in (src, dst, weight)]
        return [(s.long(), d.long(), w) for s, d, w in zip(*parts)]

    def prop_fn(args, x):
        out = None
        for src, dst, w in args:
            partial = propagate(x.to(src.device), src, dst, w, num_nodes).to(x.device)
            out = partial if out is None else out + partial
        return out

    return prop_fn, place_edges
