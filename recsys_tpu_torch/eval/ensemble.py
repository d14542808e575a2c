"""Ensemble retrieval evaluators: count-mix, weighted-score, RRF.

Counterpart of ``recsys_tpu/eval/ensemble.py``. Each model contributes its
per-user top-M candidate ids + scores, and the ensemble layer fuses the
ranked lists. Two backends behind ``alpha_sweep``:

  * the host fusers - the JAX package's numpy code, copied as it is: float64,
    duplicate ids summed onto their first occurrence with ``np.add.reduceat``,
    and a per-row top-k whose uint64 key packs (descending score bits,
    position) so that ties resolve by first occurrence;
  * the device fusers (``_dev_first_sums``, ``_dev_topk_first``,
    ``_dev_minmax_rows``, ``_dev_dedup_take``, ``_alpha_sweep_device``) - the
    same math in torch on the card, chunked over users. They compute in
    float64 as the host does (the JAX package's device twins use float32), and
    in the host's order, so their lists equal the host's element for element,
    ties included:
      - torch has no multi-key sort: (id, position) sorts as one int64 key
        ``id * M + position``, unique, so the sort order is fixed;
      - the top-k key is the host's packed key, compared as int64 (the uint64
        key with its top bit flipped), also unique, so ``torch.topk``'s lack
        of a promise about ties never matters;
      - a group's sum is never an atomic ``scatter_add_``/``index_add_``,
        whose order changes from run to run: it is added up in the order
        ``np.add.reduceat`` uses, the first member plus numpy's pairwise sum of
        the rest (exact for groups of up to 129 members; a chunk with a larger
        group is summed on the host).
"""

from __future__ import annotations

import numpy as np
import torch

from recsys_tpu_torch.eval.recall import TargetTable, recall_at_ks


def _argsort_by_id_stable(idx: np.ndarray) -> np.ndarray:
    """Per-row argsort by id with position tiebreak. Composite-key quicksort
    (id * M + position) — ~6x faster than kind="stable" at the XL eval shape
    (1.1 s vs 6.8 s for 31.7k x 2000 measured on the 2-vCPU host)."""
    M = idx.shape[1]
    comp = idx.astype(np.int64) * M + np.arange(M, dtype=np.int64)[None]
    return np.argsort(comp, axis=1)


def _dedup_take(rows: np.ndarray, k: int) -> np.ndarray:
    """Per row: first k distinct entries (order-preserving), -1 padded."""
    B, M = rows.shape
    order = _argsort_by_id_stable(rows)
    srt = np.take_along_axis(rows, order, 1)
    dup_sorted = np.zeros((B, M), bool)
    dup_sorted[:, 1:] = srt[:, 1:] == srt[:, :-1]
    dup = np.zeros((B, M), bool)
    np.put_along_axis(dup, order, dup_sorted, 1)
    # sort by (is_duplicate, original position): non-dups keep their
    # relative order up front, dups sink to the tail
    key = dup.astype(np.int64) * M + np.arange(M, dtype=np.int64)[None]
    take = np.argsort(key, axis=1)[:, :k]
    out = np.take_along_axis(rows, take, 1)
    return np.where(np.take_along_axis(dup, take, 1), -1, out)


def _group_sums(idx: np.ndarray, scores_list) -> tuple:
    """Per row, for each scores array: sum scores of duplicate ids onto the
    first occurrence (0 at later occurrences). Returns (sums_list, first_mask).

    Sorting per row (kind="stable", axis=1) is a segmented sort whose output,
    read flat, is already globally run-grouped (runs never cross the row
    boundary), so duplicate-group sums are one flat cumsum — no global
    63M-element np.unique sort (7x slower measured at the 31.7k x 2000 XL
    eval shape). The sort structure is shared across all scores arrays so an
    alpha sweep pays for it once."""
    B, M = idx.shape
    order = _argsort_by_id_stable(idx)
    sidx = np.take_along_axis(idx, order, 1)
    start = np.ones((B, M), bool)
    start[:, 1:] = sidx[:, 1:] != sidx[:, :-1]
    starts = np.flatnonzero(start.ravel())
    first = np.zeros((B, M), bool)
    np.put_along_axis(first, order, start, 1)
    sums = []
    for scores in scores_list:
        ss = np.take_along_axis(scores.astype(np.float64), order, 1)
        # reduceat = direct left-to-right segment sums — bit-identical to the
        # reference dict's incremental accumulation (a cumsum-difference is
        # not, and ulp drift flips tie orders)
        seg = np.add.reduceat(ss.ravel(), starts)
        out_sorted = np.zeros(B * M)
        out_sorted[starts] = seg
        out = np.empty((B, M), np.float64)
        np.put_along_axis(out, order, out_sorted.reshape(B, M), 1)
        sums.append(out)
    return sums, first


def _sum_to_first(idx: np.ndarray, scores: np.ndarray) -> np.ndarray:
    """Per row: sum scores of duplicate ids onto the first occurrence;
    later occurrences become -inf. (B, M) -> (B, M)."""
    (s,), first = _group_sums(idx, [scores])
    return np.where(first, s, -np.inf)


def _topk_rows(idx: np.ndarray, scores: np.ndarray, k: int) -> np.ndarray:
    """Per-row ids of the k highest scores (-inf entries -> -1 padding).
    Ties resolve by original position (first-occurrence order, matching the
    reference's stable ``sorted`` over dict-insertion order).

    argpartition alone picks an ARBITRARY subset when ties straddle the k-th
    score, so the sort key packs (descending-score bits, position) into ONE
    uint64: IEEE-754 doubles map monotonically to uint64 (flip all bits when
    negative, else set the sign bit), and the low ceil(log2(M)) mantissa bits
    are traded for the position tiebreak (~2^-38 relative precision — far
    below any meaningful score gap). One O(B*M) argpartition + one (B, k)
    sort; no stable sorts, no cumsum passes."""
    B, M = idx.shape
    k = min(k, M)
    b = np.ascontiguousarray(scores, dtype=np.float64).view(np.uint64)
    sign = np.uint64(1) << np.uint64(63)
    asc = np.where(b & sign, ~b, b | sign)     # ascending-float order
    nbits = max(1, int(np.ceil(np.log2(M))))
    comp = (~asc & ~np.uint64((1 << nbits) - 1)) \
        | np.arange(M, dtype=np.uint64)[None]  # descending score, pos tiebreak
    take = np.argpartition(comp, k - 1, axis=1)[:, :k]
    fine = np.argsort(np.take_along_axis(comp, take, 1), axis=1)  # total order
    take = np.take_along_axis(take, fine, 1)
    out = np.take_along_axis(idx, take, 1)
    return np.where(np.isneginf(np.take_along_axis(scores, take, 1)), -1, out)


def count_mix_ensemble(idx_a: np.ndarray, idx_b: np.ndarray, k: int,
                       alpha: float) -> np.ndarray:
    """Take ceil(alpha*k) from model A's list then fill from model B,
    deduplicating (the reference's count-mix, `:797-993`)."""
    na = int(np.ceil(alpha * k))
    merged = np.concatenate([idx_a[:, :na], idx_b, idx_a[:, na:]], axis=1)
    return _dedup_take(merged, k)


def _minmax_rows(s: np.ndarray) -> np.ndarray:
    s = s.astype(np.float64)
    lo = s.min(axis=1, keepdims=True)
    hi = s.max(axis=1, keepdims=True)
    rng = hi - lo
    return np.where(rng > 0, (s - lo) / np.where(rng > 0, rng, 1.0),
                    np.ones_like(s))


class WeightedFuser:
    """Alpha-sweepable weighted-score fusion with the alpha-invariant work
    (id concat, duplicate grouping, per-model group sums) hoisted out: each
    ``fuse(k, alpha)`` is just a blend + top-k."""

    def __init__(self, idx_a, scores_a, idx_b, scores_b):
        self.idx = np.concatenate([idx_a, idx_b], axis=1)
        na, nb = idx_a.shape[1], idx_b.shape[1]
        za = np.zeros_like(scores_a, dtype=np.float64)
        zb = np.zeros_like(scores_b, dtype=np.float64)
        sa = np.concatenate([_minmax_rows(scores_a), zb], axis=1)
        sb = np.concatenate([za, _minmax_rows(scores_b)], axis=1)
        (self.sum_a, self.sum_b), self.first = _group_sums(self.idx, [sa, sb])

    def fuse(self, k: int, alpha: float) -> np.ndarray:
        sc = np.where(self.first,
                      alpha * self.sum_a + (1 - alpha) * self.sum_b, -np.inf)
        return _topk_rows(self.idx, sc, k)


def weighted_score_ensemble(idx_a, scores_a, idx_b, scores_b, k: int,
                            alpha: float) -> np.ndarray:
    """Union candidate pool; min-max normalize each model's scores over its
    own list; weighted sum alpha*A + (1-alpha)*B; top-k (`:1001-1227`).
    Candidates missing from a model's list get that model's minimum (0)."""
    return WeightedFuser(idx_a, scores_a, idx_b, scores_b).fuse(k, alpha)


def rrf_ensemble(idx_a: np.ndarray, idx_b: np.ndarray, k: int,
                 k_rrf: int = 200) -> np.ndarray:
    """Reciprocal-rank fusion: score = sum 1/(k_rrf + rank + 1) (`:1238-1448`)."""
    ra = 1.0 / (k_rrf + np.arange(idx_a.shape[1], dtype=np.float64) + 1)
    rb = 1.0 / (k_rrf + np.arange(idx_b.shape[1], dtype=np.float64) + 1)
    idx = np.concatenate([idx_a, idx_b], axis=1)
    sc = np.concatenate([np.broadcast_to(ra, idx_a.shape),
                         np.broadcast_to(rb, idx_b.shape)], axis=1)
    return _topk_rows(idx, _sum_to_first(idx, sc), k)




def alpha_sweep(method: str, model_a: tuple, model_b: tuple, user_ids,
                targets_idx: dict, ks=(20, 100, 500),
                alphas=(1.0, 0.9, 0.8, 0.7, 0.6, 0.5, 0.4, 0.3, 0.2, 0.1, 0.0),
                k_rrf: int = 200, device: torch.device | str | None = None,
                table: TargetTable | None = None) -> dict:
    """Sweep the fusion weight and report recall per alpha + the best.

    model_a/model_b: (topm_idx, topm_scores) arrays, aligned to user_ids.
    ``device=None`` runs the host fusers; a torch device runs the device
    fusers there (the same lists, see the module docstring). ``table``:
    ``TargetTable(user_ids, targets_idx)`` where the caller has built it."""
    table = TargetTable(user_ids, targets_idx) if table is None else table
    if device is not None:
        return _alpha_sweep_device(method, model_a, model_b, user_ids, targets_idx, ks,
                                   alphas, k_rrf, device=device, table=table)
    idx_a, sc_a = model_a
    idx_b, sc_b = model_b
    max_k = max(ks)
    wf = (WeightedFuser(idx_a, sc_a, idx_b, sc_b)
          if method == "weighted" else None)
    recalls = {}
    for alpha in alphas:
        if method == "count_mix":
            fused = count_mix_ensemble(idx_a, idx_b, max_k, alpha)
        elif method == "weighted":
            fused = wf.fuse(max_k, alpha)
        elif method == "rrf":
            fused = rrf_ensemble(idx_a, idx_b, max_k, k_rrf)
        else:
            raise ValueError(method)
        recalls[alpha] = recall_at_ks(fused, user_ids, targets_idx, ks, table=table)
        if method == "rrf":  # rank fusion has no alpha; one row suffices
            break
    return _best_of(recalls, ks)


def _best_of(table: dict, ks) -> dict:
    key = f"recall@{sorted(ks)[min(1, len(ks) - 1)]}"
    best_alpha = max(table, key=lambda a: table[a][key])
    return {"table": table, "best_alpha": best_alpha, "best": table[best_alpha]}


# -- device backend -------------------------------------------------------------

_SIGN = -(1 << 63)          # int64 with only the top bit set


def _positions(B: int, M: int, device) -> torch.Tensor:
    return torch.arange(M, device=device).expand(B, M)


def _sorted_by_id(idx: torch.Tensor):
    """Per row: (ids sorted by (id, position), the sort order)."""
    B, M = idx.shape
    key = idx.long() * M + _positions(B, M, idx.device)
    _, order = torch.sort(key, dim=1)
    return torch.gather(idx.long(), 1, order), order


def _unsort(sorted_vals: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Values in sorted order back to the original positions."""
    return torch.empty_like(sorted_vals).scatter_(1, order, sorted_vals)


def _numpy_reduce_order_sums(vals: torch.Tensor, starts: torch.Tensor,
                             lengths: torch.Tensor) -> torch.Tensor:
    """Sum of each run ``vals[s : s + n]`` (flat float64) in the order
    ``np.add.reduceat`` adds it: the first member, plus numpy's pairwise sum
    of the rest (plain left to right under 8 members; 8 running partial sums
    combined as a tree, then the remainder, from 8 to 128). Runs of more than
    129 members are not handled (see ``_dev_first_sums``)."""
    rest = lengths - 1
    block = torch.where(rest >= 8, rest - rest % 8, torch.zeros_like(rest))
    lanes = torch.zeros(len(starts), 8, dtype=vals.dtype, device=vals.device)
    longest = int(rest.max()) if len(rest) else 0
    for j in range(longest):
        live = j < block
        if not bool(live.any()):
            break
        v = vals[(starts + 1 + j).clamp(max=len(vals) - 1)]
        lanes[:, j % 8] += torch.where(live, v, torch.zeros_like(v))
    tree = ((lanes[:, 0] + lanes[:, 1]) + (lanes[:, 2] + lanes[:, 3])) \
        + ((lanes[:, 4] + lanes[:, 5]) + (lanes[:, 6] + lanes[:, 7]))
    tail = torch.where(rest >= 8, tree, torch.zeros_like(tree))
    for j in range(longest):
        live = (j >= block) & (j < rest)
        if not bool(live.any()):
            continue
        v = vals[(starts + 1 + j).clamp(max=len(vals) - 1)]
        tail = torch.where(live, tail + v, tail)
    first = vals[starts]
    return torch.where(rest > 0, first + tail, first)


def _dev_first_sums(idx: torch.Tensor, scores_list):
    """Device twin of ``_group_sums``: per row, sum each scores array over
    duplicate-id groups onto the first occurrence (0 at later ones), float64.
    Returns (sums, first)."""
    B, M = idx.shape
    sid, order = _sorted_by_id(idx)
    start = torch.ones_like(sid, dtype=torch.bool)
    start[:, 1:] = sid[:, 1:] != sid[:, :-1]
    first = _unsort(start, order)
    flat_start = start.reshape(-1)
    starts = torch.nonzero(flat_start).flatten()
    lengths = torch.diff(starts, append=torch.tensor([B * M], device=idx.device))
    if int(lengths.max()) > 129:          # numpy's recursive split: sum on the host
        sums, first_h = _group_sums(idx.cpu().numpy(),
                                    [s.double().cpu().numpy() for s in scores_list])
        return [torch.as_tensor(s, device=idx.device) for s in sums], \
            torch.as_tensor(first_h, device=idx.device)
    sums = []
    for sc in scores_list:
        ss = torch.gather(sc.double(), 1, order).reshape(-1)
        out = torch.zeros(B * M, dtype=torch.float64, device=idx.device)
        out[starts] = _numpy_reduce_order_sums(ss, starts, lengths)
        sums.append(_unsort(out.reshape(B, M), order))
    return sums, first


def _dev_topk_first(idx: torch.Tensor, scores: torch.Tensor, k: int) -> torch.Tensor:
    """Device twin of ``_topk_rows``: per-row top-k ids by the host's packed
    (descending score, position) key; -inf entries -> -1."""
    B, M = idx.shape
    k = min(k, M)
    b = scores.double().contiguous().view(torch.int64)
    asc = torch.where(b < 0, ~b, b | _SIGN)            # the uint64 ascending-float key
    nbits = max(1, int(np.ceil(np.log2(M))))
    comp = (~asc & ~((1 << nbits) - 1)) | _positions(B, M, idx.device)
    _, take = torch.topk(comp ^ _SIGN, k, dim=1, largest=False, sorted=True)
    out = torch.gather(idx.long(), 1, take)
    return torch.where(torch.isneginf(torch.gather(scores.double(), 1, take)),
                       torch.full_like(out, -1), out)


def _dev_minmax_rows(s: torch.Tensor) -> torch.Tensor:
    s = s.double()
    lo = s.min(dim=1, keepdim=True).values
    hi = s.max(dim=1, keepdim=True).values
    rng = hi - lo
    return torch.where(rng > 0, (s - lo) / torch.where(rng > 0, rng, torch.ones_like(rng)),
                       torch.ones_like(s))


def _dev_dedup_take(merged: torch.Tensor, k: int) -> torch.Tensor:
    """Device twin of ``_dedup_take``: first k distinct ids in column order,
    -1 padded."""
    B, M = merged.shape
    sid, order = _sorted_by_id(merged)
    dup_sorted = torch.zeros_like(sid, dtype=torch.bool)
    dup_sorted[:, 1:] = sid[:, 1:] == sid[:, :-1]
    dup = _unsort(dup_sorted, order)
    key = dup.long() * M + _positions(B, M, merged.device)
    _, take = torch.topk(key, min(k, M), dim=1, largest=False, sorted=True)
    out = torch.gather(merged.long(), 1, take)
    return torch.where(torch.gather(dup, 1, take), torch.full_like(out, -1), out)


def _alpha_sweep_device(method, model_a, model_b, user_ids, targets_idx, ks, alphas,
                        k_rrf, chunk: int = 2048, device="cuda",
                        table: TargetTable | None = None) -> dict:
    """The sweep of ``alpha_sweep`` on ``device``, ``chunk`` users at a time;
    the alpha-invariant work of a chunk (sort, group sums) is done once."""
    table = TargetTable(user_ids, targets_idx) if table is None else table
    idx_a, sc_a = model_a
    idx_b, sc_b = model_b
    max_k = max(ks)
    Ma, Mb = idx_a.shape[1], idx_b.shape[1]
    alphas = list(alphas) if method != "rrf" else [list(alphas)[0]]
    if method not in ("count_mix", "weighted", "rrf"):
        raise ValueError(method)
    parts: list[list[np.ndarray]] = [[] for _ in alphas]
    for s0 in range(0, len(idx_a), chunk):
        ia = torch.as_tensor(np.asarray(idx_a[s0:s0 + chunk], np.int64), device=device)
        ib = torch.as_tensor(np.asarray(idx_b[s0:s0 + chunk], np.int64), device=device)
        idx = torch.cat([ia, ib], dim=1)
        if method == "count_mix":
            fused = []
            for alpha in alphas:
                na = int(np.ceil(alpha * max_k))
                merged = torch.cat([ia[:, :na], ib, ia[:, na:]], dim=1)
                fused.append(_dev_dedup_take(merged, max_k))
        elif method == "weighted":
            sa = _dev_minmax_rows(torch.as_tensor(np.ascontiguousarray(sc_a[s0:s0 + chunk]),
                                                  device=device))
            sb = _dev_minmax_rows(torch.as_tensor(np.ascontiguousarray(sc_b[s0:s0 + chunk]),
                                                  device=device))
            (sum_a, sum_b), first = _dev_first_sums(
                idx, [torch.cat([sa, torch.zeros_like(sb)], 1),
                      torch.cat([torch.zeros_like(sa), sb], 1)])
            neg = torch.full_like(sum_a, -np.inf)
            fused = [_dev_topk_first(idx, torch.where(
                first, alpha * sum_a + (1 - alpha) * sum_b, neg), max_k) for alpha in alphas]
        else:
            rr = torch.cat([1.0 / (k_rrf + torch.arange(m, dtype=torch.float64,
                                                        device=device) + 1)
                            for m in (Ma, Mb)])
            (s,), first = _dev_first_sums(idx, [rr.expand_as(idx)])
            fused = [_dev_topk_first(idx, torch.where(first, s, torch.full_like(s, -np.inf)),
                                     max_k)]
        for m, f in enumerate(fused):
            parts[m].append(f.cpu().numpy())
    recalls = {}
    for m, alpha in enumerate(alphas):
        fused = (np.concatenate(parts[m]) if parts[m]
                 else np.zeros((0, max_k), np.int64))
        recalls[alpha] = recall_at_ks(fused, user_ids, targets_idx, ks, table=table)
    return _best_of(recalls, ks)
