"""Non-learned retrieval baselines and the prior-blend sweep.

Counterpart of ``recsys_tpu/eval/baselines.py``; the host code is the JAX
package's:

* ``popularity_topk`` - one global ranking by training-window popularity (the
  popularity that drives LogQ correction), the same list for every user;
* ``repurchase_topk`` - each user's own history ranked by (count, recency),
  padded with global popularity;
* ``content_profile_topk`` - the mean of the user's history's stage-1 content
  vectors, cosine top-k;
* ``blend_sweep`` - the tower's cosine scores fused with the popularity prior
  and a seen-item bonus over an (alpha, beta) grid.

All emit top-k index matrices for ``recall_at_ks``, so the denominator is the
tower eval's. The JAX package's jitted device paths are plain PyTorch here
and run where ``device`` says: the card by default (``device.resolve_device``
raises where there is none), ``"cpu"`` when the caller asks; ``device=None``
takes the JAX package's host numpy path. The device top-k returns equal
scores lowest index first, as the JAX device paths' ``jax.lax.top_k``
(``ops/topk.stable_topk``); the host paths keep numpy's order.
"""

from __future__ import annotations

import numpy as np
import torch

from recsys_tpu_torch.device import resolve_device
from recsys_tpu_torch.eval.recall import TargetTable, recall_at_ks, recall_per_user
from recsys_tpu_torch.ops.topk import stable_topk


def popularity_ranking(logq: np.ndarray, max_k: int) -> np.ndarray:
    """Global item ranking (1-based indices, PAD row 0 excluded) from the
    log-popularity vector (PAD row is -20, `etl.logq_from_item_features`)."""
    order = np.argsort(-np.asarray(logq))
    order = order[order != 0]
    return order[:max_k].astype(np.int64)


def popularity_topk(logq: np.ndarray, num_users: int, max_k: int) -> np.ndarray:
    """(num_users, max_k) — the same popular list for everyone."""
    ranking = popularity_ranking(logq, max_k)
    if len(ranking) < max_k:  # tiny catalogs: pad with PAD row (never a hit)
        ranking = np.pad(ranking, (0, max_k - len(ranking)))
    return np.broadcast_to(ranking, (num_users, max_k)).copy()


def repurchase_topk(histories: list[np.ndarray], logq: np.ndarray,
                    max_k: int) -> np.ndarray:
    """Per-user buy-again ranking.

    ``histories[u]`` holds the user's training item indices in time order
    (0 = padding, ignored). Items are ranked by purchase count, ties broken
    by recency; remaining slots are filled from the global popularity
    ranking (skipping items already listed).
    """
    pop = popularity_ranking(logq, max_k + max(len(h) for h in histories) + 1
                             if histories else max_k)
    n = len(histories)
    out = np.zeros((n, max_k), np.int64)
    # head: per-user (count desc, recency desc) ranking of history items —
    # cheap (histories are <= max_len). The popularity FILL below is the
    # hot part: a per-user scan of the 500-deep pop list was ~30 min of
    # pure Python at 218k users; instead compute seen-membership of the pop
    # list for a whole chunk of users with one broadcast compare.
    heads = []
    hist_pad = np.zeros((n, max(len(h) for h in histories) if n else 1),
                        np.int64)
    for r, hist in enumerate(histories):
        hist = np.asarray(hist)
        hist = hist[hist > 0]
        if len(hist):
            uniq, counts = np.unique(hist, return_counts=True)
            last_pos = {int(it): p for p, it in enumerate(hist)}
            order = sorted(uniq.tolist(),
                           key=lambda it: (-counts[np.searchsorted(uniq, it)],
                                           -last_pos[int(it)]))
            head = order[:max_k]   # fill skips only RANKED items (original
            heads.append(head)     # semantics: seen = set(ranked))
            hist_pad[r, :len(head)] = head
        else:
            heads.append([])
    chunk = 2048
    for s0 in range(0, n, chunk):
        hp = hist_pad[s0:s0 + chunk]                       # (C, H)
        mem = (pop[None, :, None] == hp[:, None, :]).any(-1)   # (C, |pop|)
        for r in range(len(hp)):
            head = heads[s0 + r]
            fill = pop[~mem[r]][: max_k - len(head)]
            row = np.concatenate([np.asarray(head, np.int64), fill])
            out[s0 + r, : len(row)] = row
    return out


def content_profile_topk(histories: list[np.ndarray], item_matrix: np.ndarray,
                         max_k: int, *, half_life: float | None = None,
                         device: torch.device | str | None = "cuda") -> np.ndarray:
    """Training-free content retrieval: each user's vector is the mean of
    their history items' stage-1 content vectors (cosine top-k, PAD row 0
    excluded).

    This bounds how much of the dataset's signal lives in the *content
    space alone* — the measurable twin of the reference's content-based
    premise (its item tower exists precisely so user affinity can be read
    off content vectors, `item_tower.py`, `mined_inference.py:194-225`).
    The gap between this and a trained tower isolates what sequence
    modeling adds; the gap to the latent-cluster oracle (synthetic worlds)
    isolates how much cluster signal stage-1 embeddings capture.

    ``half_life`` > 0 weights history positions by recency
    (w = 0.5**(age/half_life), age in positions from the end).
    """
    items = np.asarray(item_matrix, np.float32).copy()
    items /= np.clip(np.linalg.norm(items, axis=-1, keepdims=True), 1e-12, None)
    n = len(histories)
    # profile build as ONE sparse matmul (a per-user Python loop was ~10 min
    # of the 218k-user H&M eval): rows = users, cols = items, values = the
    # (optionally recency-decayed) normalized weights
    from scipy import sparse

    rows_l, cols_l, vals_l = [], [], []
    for r, hist in enumerate(histories):
        hist = np.asarray(hist)
        hist = hist[hist > 0]
        if not len(hist):
            continue
        if half_life:
            age = np.arange(len(hist) - 1, -1, -1, dtype=np.float32)
            w = 0.5 ** (age / half_life)
            w /= w.sum()
        else:
            w = np.full(len(hist), 1.0 / len(hist), np.float32)
        rows_l.append(np.full(len(hist), r, np.int64))
        cols_l.append(hist.astype(np.int64))
        vals_l.append(w)
    if rows_l:
        m = sparse.csr_matrix(
            (np.concatenate(vals_l),
             (np.concatenate(rows_l), np.concatenate(cols_l))),
            shape=(n, items.shape[0]), dtype=np.float32)
        profiles = np.asarray(m @ items, np.float32)
    else:
        profiles = np.zeros((n, items.shape[1]), np.float32)
    norms = np.linalg.norm(profiles, axis=-1, keepdims=True)
    profiles /= np.clip(norms, 1e-12, None)
    if device is not None:
        device = resolve_device(device)
        # the host branch's clamp: topk(k) needs k <= N; tiny catalogs with
        # large eval ks pad the tail with PAD (never a hit)
        k = min(max_k, items.shape[0] - 1)
        idx, _ = _chunked_device_topk(profiles, items, k, device)
        if k < max_k:
            idx = np.pad(idx, ((0, 0), (0, max_k - k)))
        return idx
    out = np.zeros((n, max_k), np.int64)
    chunk = 2048
    for s0 in range(0, n, chunk):
        scores = profiles[s0:s0 + chunk] @ items.T
        scores[:, 0] = -np.inf
        k = min(max_k, scores.shape[1] - 1)
        idx = np.argpartition(-scores, k, axis=1)[:, :max_k]
        order = np.take_along_axis(scores, idx, 1).argsort(1)[:, ::-1]
        out[s0:s0 + chunk] = np.take_along_axis(idx, order, 1)
    return out


def _chunked_device_topk(user_vecs: np.ndarray, items: np.ndarray, max_k: int,
                         device: torch.device | str, chunk: int = 2048):
    """Chunked (U, N) scoring + top-k on ``device`` (items already normalized
    by the caller; one upload of the matrix)."""
    from recsys_tpu_torch.eval.recall import topk_scores

    im = torch.as_tensor(np.asarray(items, np.float32), device=device)
    vals, idx = [], []
    for s0 in range(0, len(user_vecs), chunk):
        u = torch.as_tensor(np.asarray(user_vecs[s0:s0 + chunk], np.float32), device=device)
        v, i = topk_scores(u, im, max_k, normalize_items=False)
        vals.append(v.cpu().numpy())
        idx.append(i.cpu().numpy())
    if not idx:
        return np.zeros((0, max_k), np.int64), np.zeros((0, max_k), np.float32)
    return np.concatenate(idx).astype(np.int64), np.concatenate(vals)


def _minmax(x: np.ndarray) -> np.ndarray:
    lo, hi = float(x.min()), float(x.max())
    return (x - lo) / (hi - lo) if hi > lo else np.zeros_like(x)


def _combo_key(alpha, beta) -> str:
    """Blend-table key for an (alpha, beta) combo. Floats are normalized
    (``0`` and ``0.0`` both -> ``a0.0``) so the model-only row keeps its
    canonical ``a0.0_b0.0`` name whatever numeric types the caller swept."""
    return f"a{float(alpha)}_b{float(beta)}"


def blend_sweep(user_vecs: np.ndarray, item_matrix: np.ndarray,
                logq: np.ndarray, histories: np.ndarray, user_ids,
                targets_idx: dict, ks=(20, 100, 500),
                alphas=(0.0, 0.1, 0.2, 0.3, 0.5, 0.7, 0.9),
                betas=(0.0, 0.3, 1.0), device: torch.device | str | None = "cuda",
                per_user_k: int | None = None) -> dict:
    """Prior-blended retrieval: fuse the tower's cosine scores with the
    popularity prior and a seen-item (repurchase) bonus, sweeping weights.

    The towers score with cosine (both sides L2-normalized, reference
    `v1_usertower_train.py:566`), so item POPULARITY can only be encoded
    directionally and REPURCHASE affinity not at all — on retail data both
    carry large mass (see `baseline_report`). The blend restores them at
    serving time, reference-ensemble style (min-max normalized weighted
    sum, `mined_inference.py:1115-1144`):

        score = (1-alpha) * minmax_u(cos) + alpha * minmax(logq) + beta * seen

    Two backends behind one contract: host numpy, chunked over users (an
    unchunked score matrix is ~6 GB per array at 31k eval users x 47k items),
    and with ``device`` given, ``_blend_sweep_device``: per batch of users
    one resident (B, N+1) score block on that device, every (alpha, beta)
    combination masked, blended and cut to an exact top-k there.
    """
    targets = TargetTable(user_ids, targets_idx)      # one table for every combination
    if device is not None:
        return _blend_sweep_device(user_vecs, item_matrix, logq, histories, user_ids,
                                   targets_idx, ks, alphas, betas, per_user_k, device, targets)
    # np.array (copy): asarray of a device buffer can hand back a
    # read-only view, breaking the in-place normalize
    items = np.array(item_matrix, np.float32)
    items /= np.clip(np.linalg.norm(items, axis=-1, keepdims=True), 1e-12, None)
    u = np.asarray(user_vecs, np.float32)
    pop = _minmax(np.asarray(logq, np.float64)).astype(np.float32)
    max_k = max(ks)
    combos = [(a, b) for a in alphas for b in betas]
    idx_parts: dict = {c: [] for c in combos}
    chunk = 2048
    for s0 in range(0, len(u), chunk):
        cos = u[s0:s0 + chunk] @ items.T                    # (C, N+1)
        cos = (cos - cos.min(1, keepdims=True)) / \
            np.clip(cos.max(1, keepdims=True) - cos.min(1, keepdims=True),
                    1e-12, None)
        h = histories[s0:s0 + chunk]
        seen = np.zeros_like(cos)
        rows = np.repeat(np.arange(len(h)), h.shape[1])
        seen[rows, h.reshape(-1)] = 1.0
        for alpha, beta in combos:
            s = (1 - alpha) * cos + alpha * pop[None, :] + beta * seen
            s[:, 0] = -np.inf
            idx = np.argpartition(-s, max_k, axis=1)[:, :max_k]
            order = np.take_along_axis(s, idx, 1).argsort(1)[:, ::-1]
            idx_parts[(alpha, beta)].append(np.take_along_axis(idx, order, 1))
    table: dict = {}
    for alpha, beta in combos:
        idx = (np.concatenate(idx_parts[(alpha, beta)])
               if idx_parts[(alpha, beta)]
               else np.zeros((0, max_k), np.int64))
        table[_combo_key(alpha, beta)] = recall_at_ks(idx, user_ids, targets_idx, ks,
                                                      table=targets)
    key = f"recall@{sorted(ks)[min(1, len(ks) - 1)]}"
    best = max(table, key=lambda t: table[t][key])
    out = {"table": table, "best": best, "best_metrics": table[best]}
    if per_user_k is not None:
        name_of = {_combo_key(a, b): (a, b) for a, b in combos}
        full_idx = {nm: np.concatenate(idx_parts[c]) if idx_parts[c]
                    else np.zeros((0, max_k), np.int64)
                    for nm, c in name_of.items()
                    if nm == best or nm == "a0.0_b0.0"}
        out["_per_user"] = _blend_per_user(full_idx, best, user_ids, targets_idx,
                                           per_user_k, targets)
    return out


def _blend_per_user(full_idx: dict, best: str, user_ids, targets_idx,
                    per_user_k: int, targets: TargetTable) -> dict:
    pu: dict = {"k": per_user_k}
    vals, kept = recall_per_user(full_idx[best], user_ids, targets_idx,
                                 per_user_k, table=targets)
    pu["best"], pu["uids"] = vals, kept
    if "a0.0_b0.0" in full_idx:
        pu["model_only"], _ = recall_per_user(full_idx["a0.0_b0.0"],
                                              user_ids, targets_idx,
                                              per_user_k, table=targets)
    return pu


def _blend_sweep_device(user_vecs, item_matrix, logq, histories, user_ids,
                        targets_idx, ks, alphas, betas,
                        per_user_k: int | None, device: torch.device | str,
                        targets: TargetTable) -> dict:
    """Device backend of ``blend_sweep``, the same math in plain PyTorch,
    with the JAX device sweep's order among equal scores (``jax.lax.top_k``:
    lowest index first). The recalls equal the host's when no two scores tie
    at the k boundary."""
    device = resolve_device(device)
    items = np.array(item_matrix, np.float32)
    items /= np.clip(np.linalg.norm(items, axis=-1, keepdims=True), 1e-12, None)
    pop = _minmax(np.asarray(logq, np.float64)).astype(np.float32)
    max_k = max(ks)
    combos = [(a, b) for a in alphas for b in betas]
    items_dev = torch.as_tensor(items, device=device)
    pop_dev = torch.as_tensor(pop, device=device)
    parts: list[np.ndarray] = []                         # (M, B, k) a batch
    bs = 1024
    for s0 in range(0, len(user_vecs), bs):
        u = torch.as_tensor(np.asarray(user_vecs[s0:s0 + bs], np.float32), device=device)
        h = torch.as_tensor(np.asarray(histories[s0:s0 + bs], np.int64), device=device)
        cos = u @ items_dev.T                                  # (B, N+1)
        lo, hi = cos.min(1, keepdim=True).values, cos.max(1, keepdim=True).values
        cos = (cos - lo) / (hi - lo).clamp(min=1e-12)
        seen = torch.zeros_like(cos).scatter_(1, h, 1.0)
        per_combo = []
        for alpha, beta in combos:
            s = (1 - alpha) * cos + alpha * pop_dev[None, :] + beta * seen
            s[:, 0] = -torch.inf                               # PAD row
            per_combo.append(stable_topk(s, max_k)[1])
        parts.append(torch.stack(per_combo).cpu().numpy())
    table: dict = {}
    for m, (alpha, beta) in enumerate(combos):
        idx = (np.concatenate([p[m] for p in parts])
               if parts else np.zeros((0, max_k), np.int64))
        table[_combo_key(alpha, beta)] = recall_at_ks(idx, user_ids, targets_idx, ks,
                                                      table=targets)
    key = f"recall@{sorted(ks)[min(1, len(ks) - 1)]}"
    best = max(table, key=lambda t: table[t][key])
    out = {"table": table, "best": best, "best_metrics": table[best]}
    if per_user_k is not None:
        name_of = {_combo_key(a, b): m for m, (a, b) in enumerate(combos)}
        full_idx = {nm: (np.concatenate([p[m] for p in parts]) if parts
                         else np.zeros((0, max_k), np.int64))
                    for nm, m in name_of.items()
                    if nm == best or nm == "a0.0_b0.0"}
        out["_per_user"] = _blend_per_user(full_idx, best, user_ids, targets_idx,
                                           per_user_k, targets)
    return out


def baseline_report(tensors: dict, logq: np.ndarray, targets_idx: dict,
                    ks=(20, 100, 500), item_matrix: np.ndarray | None = None,
                    per_user_k: int | None = None,
                    device: torch.device | str | None = "cuda") -> dict:
    """All training-free baselines evaluated with the tower-eval denominator
    semantics.

    ``tensors`` is the stage-2 tensor dict (`build_sasrec_tensors`): the
    user's training history is the left-padded ``input_ids`` row plus the
    final target item (the causal shift drops it from the inputs).
    ``item_matrix`` (the (N+1, D) stage-1 content matrix, PAD row 0) adds
    the content-profile baseline.

    ``per_user_k``: when set, the report gains a ``"_per_user"`` block with
    per-user recall@k arrays (one per baseline, aligned to ``"uids"``) for
    bootstrap CIs / paired significance tests (`recall.paired_delta_ci`).
    ``device`` scores the content profiles there (see ``content_profile_topk``).
    """
    user_ids = list(tensors["user_ids"])
    max_k = max(ks)
    n = len(user_ids)
    full = np.concatenate([tensors["input_ids"],
                           tensors["target_ids"][:, -1:]], axis=1)
    histories = [full[r] for r in range(n)]
    idx = {
        "popularity": popularity_topk(logq, n, max_k),
        "repurchase": repurchase_topk(histories, logq, max_k),
    }
    if item_matrix is not None:
        idx["content_profile"] = content_profile_topk(histories, item_matrix,
                                                      max_k, device=device)
        idx["content_profile_recency"] = content_profile_topk(
            histories, item_matrix, max_k, half_life=10.0, device=device)
    targets = TargetTable(user_ids, targets_idx)
    report = {name: recall_at_ks(m, user_ids, targets_idx, ks, table=targets)
              for name, m in idx.items()}
    if per_user_k is not None:
        pu: dict = {"k": per_user_k}
        for name, m in idx.items():
            vals, kept = recall_per_user(m, user_ids, targets_idx, per_user_k,
                                         table=targets)
            pu[name] = vals
            pu["uids"] = kept
        report["_per_user"] = pu
    return report
