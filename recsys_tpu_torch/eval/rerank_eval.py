"""Learned-reranker serving eval: full-recall Recall@k of the PRODUCTION
ranking pipeline (candidate generation -> feature build -> GBDT rerank).

The reference's serving design ends in a CatBoost reranker over mined
candidates (`tower_code/ranker_model_train.py`, `SURVEY.md` §2.9) but it
never evaluates the reranked pipeline at recall — only pointwise AUC.
This module closes that gap AND answers a question the cosine towers
cannot: a dot-product retriever is structurally blind to repurchase
affinity (`eval/baselines.py` docstring), while a ranker with user-item
history features can LEARN it — making this the learned-model row that
competes with the repurchase heuristic on retail-shaped data.

Protocol (leakage-safe):
* the ranker trains on an INNER time split: histories/features from days
  < split_day - valid_days, labels = purchases in the following
  valid_days window (still entirely inside the tower's training window);
* the ranker is then frozen and evaluated on the real validation week
  with histories/features from the full training window — the exact
  deployment regime;
* candidates per user = union(tower cosine top-M, the user's seen items,
  global popularity top-P) — the three serving sources.

Known train/deploy skew (accepted, documented): the ranker's training
features/candidates come from a tower checkpoint that was itself trained
through the inner label window [split2, split_day), so the cosine signal
the ranker learns against is partially memorized relative to deployment,
where the validation week is unseen by everything. Final reported recall
is honest (labels never leak), but the ranker's learned feature weights
are calibrated on a slightly optimistic cosine feature. Re-training the
pool tower on the inner window would remove the skew at ~1 extra stage-2
run per eval; measured rerank lift is robust without it.

All pair features come from one sorted-key (user_row * N + item) index
over the transaction window (searchsorted probes; no Python dicts at
33M-row scale).

The port's own copy of ``recsys_tpu/eval/rerank_eval.py``: numpy as in the
original, except the device branch of ``cosine_topm``, which scores through
``eval/recall.topk_scores`` on a torch device. ``model`` in ``rerank_topk``
is anything with ``predict_proba(X) -> (n,)``, e.g. ``GBDTRanker``.
"""

from __future__ import annotations

import numpy as np
import torch

from recsys_tpu_torch.device import resolve_device
from recsys_tpu_torch.eval.recall import topk_scores

PAD = 0  # item index 0 is the PAD row everywhere in the framework


def pair_index(user_rows: np.ndarray, item_idx: np.ndarray,
               days: np.ndarray, num_items_pad: int):
    """Sorted unique (user_row, item) pair index with per-pair purchase
    count and last purchase day.

    Returns (keys_sorted, counts, last_day) — probe with
    ``np.searchsorted(keys_sorted, u * N + i)``.
    """
    keys = user_rows.astype(np.int64) * num_items_pad + item_idx.astype(np.int64)
    order = np.argsort(keys, kind="stable")
    ks = keys[order]
    ds = days[order].astype(np.int32)
    new = np.empty(len(ks), bool)
    if len(ks):
        new[0] = True
        np.not_equal(ks[1:], ks[:-1], out=new[1:])
    starts = np.flatnonzero(new)
    uniq = ks[starts]
    counts = np.diff(np.append(starts, len(ks))).astype(np.int32)
    # last day per pair: max over the run (days within a run are unordered)
    last = np.maximum.reduceat(ds, starts) if len(ks) else ds
    return uniq, counts, last


def pair_lookup(uniq_keys, values, user_rows, items, num_items_pad,
                default=0):
    """values[pair] for each (user_rows[j], items[j]); ``default`` where
    the pair never occurred. Vectorized searchsorted probe."""
    cand = user_rows.astype(np.int64) * num_items_pad + items.astype(np.int64)
    pos = np.searchsorted(uniq_keys, cand)
    pos = np.minimum(pos, max(len(uniq_keys) - 1, 0))
    hit = (uniq_keys[pos] == cand) if len(uniq_keys) else np.zeros(len(cand), bool)
    out = np.full(len(cand), default, values.dtype if len(values) else np.int32)
    if len(uniq_keys):
        out[hit] = values[pos[hit]]
    return out


def build_pools(cos_idx: np.ndarray, seen_lists: list[np.ndarray],
                pop_ranking: np.ndarray, pool_size: int
                ) -> tuple[np.ndarray, np.ndarray]:
    """(U, pool_size) candidate pools: cosine top-M ∪ seen ∪ popularity,
    first-occurrence dedup, PAD(0)-padded. Also returns source flags
    packed as bits: 1=cosine, 2=seen, 4=pop."""
    U = len(cos_idx)
    P = pool_size
    pools = np.zeros((U, P), np.int64)
    flags = np.zeros((U, P), np.int8)
    pop = np.asarray(pop_ranking, np.int64)
    for r in range(U):
        seen = np.asarray(seen_lists[r], np.int64)
        seen = seen[seen > 0]
        cand = np.concatenate([cos_idx[r], seen, pop])
        src = np.concatenate([np.full(len(cos_idx[r]), 1, np.int8),
                              np.full(len(seen), 2, np.int8),
                              np.full(len(pop), 4, np.int8)])
        uniq, first = np.unique(cand, return_index=True)
        # OR the source bits of every occurrence onto the unique id
        bits = np.zeros(len(uniq), np.int8)
        inv = np.searchsorted(uniq, cand)
        np.bitwise_or.at(bits, inv, src)
        # keep first-occurrence order (cosine rank first, then seen, pop);
        # drop PAD/non-positive ids BEFORE truncating so a PAD landing in
        # the first P uniques doesn't silently shrink the pool
        order = np.sort(first)
        ids = cand[order]
        ids = ids[ids > 0][:P]
        pools[r, :len(ids)] = ids
        bits_of = bits[np.searchsorted(uniq, ids)]
        flags[r, :len(ids)] = bits_of
    return pools, flags


NUM_FEATURES = 16
FEATURE_NAMES = ["cos_minmax", "logq_norm", "log1p_count", "days_since_last",
                 "is_seen", "from_cosine", "price_log", "pool_pos",
                 "from_pop", "count_share", "hist_len_log", "user_recency",
                 "cos_raw", "ui_max", "ui_std", "price_diff"]


def pool_features(pools, flags, uvecs, item_matrix, logq, pair_keys,
                  pair_counts, pair_last, now_day, num_items_pad,
                  price_log, hist_lens=None, user_last_day=None,
                  items_prenormalized: bool = False,
                  user_price=None) -> np.ndarray:
    """(U, P, F) feature tensor, F = NUM_FEATURES (names above).

    The first 7 are the round-3 set; round 4 adds pool-position (a
    cosine-rank proxy — pools keep cosine-first first-occurrence order),
    the popularity source flag, the candidate's share of the user's
    purchases, history length and user recency (chasing the in-pool
    headroom VERDICT r3 weak #3 measured: ceiling@512 ~6pp above the
    reranked@100). ``hist_lens``/``user_last_day`` are per-user arrays;
    absent (older callers) the three user-level features stay zero.

    Round 5 (VERDICT r4 item 2: the GBDT leaned on pool_pos while pair
    features stayed thin) adds the reference FeatureEngineer's u*i
    interaction stats (`temp_model/ranker_skelet.py:13-89`): raw cosine
    (absolute calibration the per-user minmax destroys), elementwise
    u⊙i max and std (for L2-normalized vectors u⊙i SUMS to the cosine,
    so the mean is redundant — max/std carry the extra signal; std comes
    from one squared-matrices einsum, no (U,P,D) materialization), and
    the price gap |item price − user's mean history price| when
    ``user_price`` (per-user mean price_log) is given."""
    U, P = pools.shape
    im = np.asarray(item_matrix, np.float32)
    if not items_prenormalized:  # serving passes the cached normed matrix
        im = im / np.clip(np.linalg.norm(im, axis=-1, keepdims=True),
                          1e-12, None)
    uv = np.asarray(uvecs, np.float32)
    uv = uv / np.clip(np.linalg.norm(uv, axis=-1, keepdims=True), 1e-12, None)
    feats = np.zeros((U, P, NUM_FEATURES), np.float32)
    lqn = np.asarray(logq, np.float32)
    lqn = (lqn - lqn.min()) / max(lqn.max() - lqn.min(), 1e-12)
    rows = np.repeat(np.arange(U, dtype=np.int64), P)
    cnt = pair_lookup(pair_keys, pair_counts, rows, pools.reshape(-1),
                      num_items_pad).reshape(U, P)
    last = pair_lookup(pair_keys, pair_last, rows, pools.reshape(-1),
                       num_items_pad, default=-1).reshape(U, P)
    D = im.shape[1]
    im_sq = im * im
    chunk = 1024  # (chunk, P, D) elementwise product for ui_max stays <0.5 GB
    for s0 in range(0, U, chunk):
        sl = slice(s0, min(s0 + chunk, U))
        cand = im[pools[sl]]                       # (c, P, D)
        cos = np.einsum("upd,ud->up", cand, uv[sl])
        lo = cos.min(1, keepdims=True)
        hi = cos.max(1, keepdims=True)
        feats[sl, :, 0] = (cos - lo) / np.clip(hi - lo, 1e-12, None)
        feats[sl, :, 12] = cos
        prod = cand * uv[sl][:, None, :]           # u ⊙ i
        feats[sl, :, 13] = prod.max(-1)
        # Var(u⊙i) over dims = E[(u⊙i)^2] - mean^2, mean = cos / D
        ex2 = np.einsum("upd,ud->up", im_sq[pools[sl]], uv[sl] * uv[sl]) / D
        feats[sl, :, 14] = np.sqrt(np.clip(ex2 - (cos / D) ** 2, 0.0, None))
    feats[:, :, 1] = lqn[pools]
    feats[:, :, 2] = np.log1p(cnt)
    feats[:, :, 3] = np.where(last >= 0, (now_day - last) / 365.0, 2.0)
    feats[:, :, 4] = (cnt > 0).astype(np.float32)
    feats[:, :, 5] = (flags & 1).astype(np.float32)
    feats[:, :, 6] = price_log[pools]
    feats[:, :, 7] = np.tile(np.arange(P, dtype=np.float32) / P, (U, 1))
    feats[:, :, 8] = ((flags & 4) > 0).astype(np.float32)
    if hist_lens is not None:
        hl = np.asarray(hist_lens, np.float32)
        feats[:, :, 9] = cnt / np.maximum(hl[:, None], 1.0)
        feats[:, :, 10] = np.log1p(hl)[:, None]
    if user_last_day is not None:
        uld = np.asarray(user_last_day, np.float32)
        feats[:, :, 11] = np.where(uld[:, None] >= 0,
                                   (now_day - uld[:, None]) / 365.0, 2.0)
    if user_price is not None:
        up = np.asarray(user_price, np.float32)
        feats[:, :, 15] = np.abs(price_log[pools] - up[:, None])
    return feats


def rerank_topk(model, feats, pools, k, batch_rows: int = 8192) -> np.ndarray:
    """Score every pool candidate with the trained ranker and take the
    per-user top-k (PAD entries masked out)."""
    U, P, F = feats.shape
    out = np.zeros((U, k), np.int64)
    for s0 in range(0, U, batch_rows):
        sl = slice(s0, min(s0 + batch_rows, U))
        sc = model.predict_proba(
            feats[sl].reshape(-1, F)).reshape(-1, P).astype(np.float64)
        sc[pools[sl] == PAD] = -np.inf
        kk = min(k, P)
        idx = np.argpartition(-sc, kk - 1, axis=1)[:, :kk]
        order = np.take_along_axis(sc, idx, 1).argsort(1)[:, ::-1]
        top = np.take_along_axis(pools[sl], np.take_along_axis(idx, order, 1), 1)
        top[np.take_along_axis(sc, np.take_along_axis(idx, order, 1), 1)
            == -np.inf] = PAD
        out[sl, :kk] = top
    return out


def cosine_topm(uvecs: np.ndarray, item_matrix: np.ndarray, m: int,
                device: bool | None = None,
                prenormalized: bool = False,
                torch_device: torch.device | str = "cuda") -> np.ndarray:
    """Full-catalog cosine top-M candidate generation. ``device=True`` scores
    on ``torch_device`` in chunks of users (the (218k, 105k) score matrix is
    chip work); ``device=False`` is the chunked numpy form on the host;
    ``None`` takes the device for more than 2e8 scores. The PAD column never
    comes back."""
    if prenormalized:
        im = np.asarray(item_matrix, np.float32)
    else:
        im = np.asarray(item_matrix, np.float32).copy()
        im /= np.clip(np.linalg.norm(im, axis=-1, keepdims=True), 1e-12, None)
    if device is None:
        device = len(uvecs) * len(im) > 2e8
    m = min(m, im.shape[0] - 1)
    if device:
        dev = resolve_device(torch_device)
        items = torch.as_tensor(im, device=dev)
        out = np.zeros((len(uvecs), m), np.int64)
        for s0 in range(0, len(uvecs), 2048):
            u = torch.as_tensor(np.asarray(uvecs[s0:s0 + 2048], np.float32), device=dev)
            _, idx = topk_scores(u, items, m, normalize_items=False)
            out[s0:s0 + 2048] = idx.cpu().numpy()
        return out
    out = np.zeros((len(uvecs), m), np.int64)
    for s0 in range(0, len(uvecs), 2048):
        sc = np.asarray(uvecs[s0:s0 + 2048], np.float32) @ im.T
        sc[:, PAD] = -np.inf
        idx = np.argpartition(-sc, m - 1, axis=1)[:, :m]
        order = np.take_along_axis(sc, idx, 1).argsort(1)[:, ::-1]
        out[s0:s0 + 2048] = np.take_along_axis(idx, order, 1)
    return out
