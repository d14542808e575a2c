"""Collective building blocks over the shards of one axis group.

Counterpart of ``recsys_tpu/parallel/collectives.py``. Where the JAX function
runs inside a ``shard_map`` region and names its axis, the function here takes
the list of that axis's shards (shard i on device i) and returns one result
per shard. A replicated result is S equal tensors, each on its shard's
device; shards that share a device share the tensor. Everything is built from
``torch.cat``, ``torch.stack``, sums and ``.to(device)``, so autograd gives the
transposes: reduce-scatter for the gather, scatter to the owner for the
lookup's sum.

  * ``gather_global_negatives`` - (B_local, D) embeddings -> the (B_global, D)
    negatives matrix on every shard.
  * ``sharded_topk`` - top-k over a column-sharded score matrix: per-shard
    top-k, global re-indexing, one merge; equal scores lowest global index
    first, as the JAX function's ``jax.lax.top_k`` calls give them.
  * ``sharded_topk_ring_merge`` - the same with the merge folded into S-1
    ring hops under a strict total order.
  * ``rowsharded_lookup`` / ``rowsharded_lookup_a2a`` - embedding lookup into
    a row-sharded table for replicated / sharded ids.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from recsys_tpu_torch.ops.topk import stable_topk


def _once_per_device(shards: Sequence[torch.Tensor], make: Callable) -> list:
    """``make(device)`` for every distinct device of ``shards``, handed out in
    shard order: the replicated result of a collective."""
    made: dict[torch.device, object] = {}
    out = []
    for s in shards:
        if s.device not in made:
            made[s.device] = make(s.device)
        out.append(made[s.device])
    return out


def all_gather(shards: Sequence[torch.Tensor], tiled: bool = False) -> list[torch.Tensor]:
    """Every shard's tensor on every shard: stacked on a new leading axis, or
    concatenated along dim 0 when ``tiled``."""
    join = torch.cat if tiled else torch.stack
    return _once_per_device(shards, lambda dev: join([s.to(dev) for s in shards]))


def psum(shards: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """The sum of the shards' tensors on every shard, added in shard order."""
    def total(dev):
        acc = shards[0].to(dev)
        for s in shards[1:]:
            acc = acc + s.to(dev)
        return acc

    return _once_per_device(shards, total)


def gather_global_negatives(local_embs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """All-gather per-shard embeddings into one global negatives matrix
    (B_global, D) on every shard. Each shard's gradient comes back from every
    shard that used its rows."""
    return all_gather(local_embs, tiled=True)


def local_index_offset(index: int, local_rows: int) -> int:
    """Global row offset of shard ``index``'s slice of a row-sharded table."""
    return index * local_rows


def _local_topk(scores_shards: Sequence[torch.Tensor], k: int):
    """Per-shard top-k with the indices shifted to global ids, equal scores
    lowest index first."""
    vals, idx = [], []
    for i, scores in enumerate(scores_shards):
        n_local = scores.shape[-1]
        v, j = stable_topk(scores, min(k, n_local))
        vals.append(v)
        idx.append(j + local_index_offset(i, n_local))
    return vals, idx


def sharded_topk(scores_shards: Sequence[torch.Tensor], k: int
                 ) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Top-k over the concatenation of per-shard score slices.

    ``scores_shards[i]``: (B, N_local), shard i's columns of the full (B, N)
    score matrix. Returns ``(values, global_indices)``, each (B, k), for every
    shard, identical on all of them: local top-k, all-gather of the (B, k)
    candidates, final top-k of the (B, S*k) pool. The pool lies in shard
    order, so its lowest position among equal scores is the lowest global
    index: the merge's ``stable_topk`` keeps ``jax.lax.top_k``'s order."""
    vals, idx = _local_topk(scores_shards, k)
    B = vals[0].shape[0]
    all_vals, all_idx = all_gather(vals), all_gather(idx)     # (S, B, k_local) each

    def merge(av, ai):
        merged_vals = av.movedim(0, 1).reshape(B, -1)
        merged_idx = ai.movedim(0, 1).reshape(B, -1)
        top_vals, pos = stable_topk(merged_vals, min(k, merged_vals.shape[-1]))
        return top_vals, torch.gather(merged_idx, -1, pos)

    merged: dict[int, tuple] = {}
    out = []
    for av, ai in zip(all_vals, all_idx):      # one merge per distinct device
        if id(av) not in merged:
            merged[id(av)] = merge(av, ai)
        out.append(merged[id(av)])
    return out


def sharded_topk_ring_merge(scores_shards: Sequence[torch.Tensor], k: int
                            ) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """``sharded_topk`` with the candidate merge folded into the ring hops:
    the candidate sets move one neighbour on per hop and each shard folds the
    arriving set into its running (B, k), so per-hop traffic and merge cost
    stay O(k) whatever the shard count.

    Each shard folds the sets in another rotation order, so the merge selects
    under the strict total order (value descending, global index ascending):
    ``torch.topk`` promises no order among ties, a two-key sort does. Tied
    scores at the k boundary then keep the same candidates on every shard."""
    vals, idx = _local_topk(scores_shards, k)
    num = len(scores_shards)

    def merge(av, ai, bv, bi):
        mv, mi = torch.cat([av, bv], dim=-1), torch.cat([ai, bi], dim=-1)
        by_idx = torch.argsort(mi, dim=-1, stable=True)
        mv, mi = torch.gather(mv, -1, by_idx), torch.gather(mi, -1, by_idx)
        by_val = torch.argsort(mv, dim=-1, descending=True, stable=True)
        kk = min(k, mv.shape[-1])
        return (torch.gather(mv, -1, by_val)[..., :kk],
                torch.gather(mi, -1, by_val)[..., :kk])

    acc = list(zip(vals, idx))
    cur = list(zip(vals, idx))
    for _ in range(num - 1):
        # one hop: shard i's current set goes to shard i + 1
        cur = [tuple(t.to(vals[i].device) for t in cur[(i - 1) % num]) for i in range(num)]
        acc = [merge(*acc[i], *cur[i]) for i in range(num)]
    return acc


def rowsharded_lookup_a2a(table_shards: Sequence[torch.Tensor],
                          ids_shards: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """All-to-all row-sharded lookup for sharded id batches: every shard gets
    the full id list, answers for its own rows, and the exchange returns each
    shard its own slice's embeddings.

    ``ids_shards[i]``: (B_local,), shard i's slice of the global id batch.
    Returns the (B_local, D) embeddings of ``ids_shards[i]`` on shard i."""
    all_ids = all_gather(ids_shards)                       # (S, B_local) on every shard
    answers = []
    for j, table in enumerate(table_shards):
        n_local = table.shape[0]
        local = all_ids[j] - local_index_offset(j, n_local)
        mine = (local >= 0) & (local < n_local)
        rows = table[local.clamp(0, n_local - 1)]
        answers.append(torch.where(mine[..., None], rows, torch.zeros_like(rows)))
    # slot i of shard j's answer goes to shard i, which sums over contributors
    out = []
    for i, ids in enumerate(ids_shards):
        acc = answers[0][i].to(ids.device)
        for a in answers[1:]:
            acc = acc + a[i].to(ids.device)
        out.append(acc)
    return out


def rowsharded_lookup(table_shards: Sequence[torch.Tensor], ids) -> list[torch.Tensor]:
    """Rows of a row-sharded (V_local, D) table for replicated ``ids`` (one
    tensor, or one copy per shard): each shard contributes its own rows, zeros
    elsewhere, and a sum over the shards merges. The sum's transpose sends
    each row's gradient to the shard that owns it."""
    if isinstance(ids, torch.Tensor):
        ids = [ids] * len(table_shards)
    parts = []
    for j, (table, ids_j) in enumerate(zip(table_shards, ids)):
        n_local = table.shape[0]
        local = ids_j.to(table.device) - local_index_offset(j, n_local)
        mine = (local >= 0) & (local < n_local)
        rows = table[local.clamp(0, n_local - 1)]
        parts.append(torch.where(mine[..., None], rows, torch.zeros_like(rows)))
    return psum(parts)
