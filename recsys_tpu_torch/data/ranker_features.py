"""Reranker feature engineering + training-data importers.

The port's own copy of ``recsys_tpu/data/ranker_features.py`` (numpy only,
unchanged, so both packages draw the same rows from the same ``Generator``).
Re-implements the reference's tabular recipe:

  * ``build_rank_features`` — two-tower score, element-wise u*i
    mean/max/std, user/item metadata, price-difference ratio
    (`temp_model/ranker_skelet.py:13-89` FeatureEngineer);
  * ``context_vector`` — the 20-d context block from the dead-but-specified
    ContextFeatureEngineer (`utils/util.py:129-216`): cyclical hour sin/cos,
    weekday one-hot, log1p view counts, CTR, recency, device one-hot;
  * ``import_interactions`` — positive purchases + 1:N random negatives
    with group ids for ranking (`utils/monitor/log_importer.py:6-97`).
"""

from __future__ import annotations

import numpy as np

RANK_FEATURE_NAMES = (
    "two_tower_score", "ui_mean", "ui_max", "ui_std",
    "user_price_mean", "user_cnt", "user_recency",
    "item_pop", "item_price", "price_diff_ratio",
)


def build_rank_features(user_vecs: np.ndarray, item_vecs: np.ndarray,
                        user_meta: np.ndarray, item_meta: np.ndarray) -> np.ndarray:
    """(B,D) x (B,D) x (B,3) x (B,2) -> (B, 10) dense feature block.

    user_meta columns: [price_mean, cnt, recency]; item_meta: [pop, price].
    """
    ui = user_vecs * item_vecs
    score = ui.sum(-1, keepdims=True)
    feats = np.concatenate([
        score,
        ui.mean(-1, keepdims=True), ui.max(-1, keepdims=True),
        ui.std(-1, keepdims=True),
        user_meta,
        item_meta,
        # price-diff ratio between the user's average price and the item
        ((item_meta[:, 1:2] - user_meta[:, 0:1])
         / np.clip(np.abs(user_meta[:, 0:1]), 1e-6, None)),
    ], axis=1).astype(np.float32)
    return feats


def cross_features(user_meta: np.ndarray, item_meta: np.ndarray,
                   user_activity: np.ndarray, item_velocity: np.ndarray) -> np.ndarray:
    """Explicit cross features for the reranker (reference
    `utils/data_preprocessing/feature_processor.py:26-195`): price gap and
    velocity x activity interaction. (B, 2) block appended to the base."""
    price_gap = item_meta[:, 1:2] - user_meta[:, 0:1]
    vel_act = (item_velocity * user_activity)[:, None]
    return np.concatenate([price_gap, vel_act], axis=1).astype(np.float32)


def context_vector(hour: np.ndarray, weekday: np.ndarray, view_count: np.ndarray,
                   click_count: np.ndarray, recency_days: np.ndarray,
                   device: np.ndarray) -> np.ndarray:
    """(B,) ints/floats -> (B, 20) context block: hour sin/cos (2) +
    weekday one-hot (7) + log1p views (1) + CTR (1) + recency (1) +
    device one-hot (3) + padding to 20."""
    B = len(hour)
    out = np.zeros((B, 20), np.float32)
    out[:, 0] = np.sin(2 * np.pi * hour / 24.0)
    out[:, 1] = np.cos(2 * np.pi * hour / 24.0)
    out[np.arange(B), 2 + np.clip(weekday, 0, 6)] = 1.0
    out[:, 9] = np.log1p(view_count)
    out[:, 10] = click_count / np.clip(view_count, 1.0, None)
    out[:, 11] = np.log1p(recency_days)
    out[np.arange(B), 12 + np.clip(device, 0, 2)] = 1.0
    return out


def import_interactions(tx_df, num_items: int, item_map, rng: np.random.Generator,
                        neg_per_pos: int = 5):
    """Purchase log -> (user_id, item_idx, label, group_id) with 1:N random
    negative sampling for group-wise ranking."""
    users, items, labels, groups = [], [], [], []
    for g, (uid, iid) in enumerate(zip(tx_df["user_id"], tx_df["item_id"])):
        pos = item_map.idx(iid)
        if pos == 0:
            continue
        users.append(uid); items.append(pos); labels.append(1); groups.append(g)
        negs = rng.integers(1, num_items + 1, size=neg_per_pos)
        for n in negs:
            users.append(uid); items.append(int(n)); labels.append(0); groups.append(g)
    return (np.array(users), np.array(items, np.int32),
            np.array(labels, np.int32), np.array(groups, np.int32))


def import_interactions_candidates(tx_df, user_vecs: dict, item_matrix: np.ndarray,
                                   item_map, rng: np.random.Generator,
                                   neg_per_pos: int = 5, top_k: int = 100):
    """Candidate-conditioned ranker data: negatives sampled from the
    retrieval tower's OWN top-k for each user instead of uniformly.

    A reranker only ever scores tower candidates at serve time
    (`ReRankingSystem`, reference `temp_model/ranker_skelet.py:155-237`
    retrieves top-100 then reranks); uniform negatives make its AUC look
    great against items the tower would never surface. Sampling hard
    in-candidate negatives aligns train and serve distributions so AUC
    reflects actual rerank value.
    """
    users_u = [u for u in dict.fromkeys(tx_df["user_id"]) if u in user_vecs]
    if not users_u:
        return (np.array([]), np.array([], np.int32),
                np.array([], np.int32), np.array([], np.int32))
    U = np.stack([user_vecs[u] for u in users_u])          # (U, D)
    scores = U @ item_matrix[1:].T                         # skip PAD row 0
    k = min(top_k, scores.shape[1])
    cand = np.argpartition(-scores, k - 1, axis=1)[:, :k] + 1  # 1-based idx
    cand_of = {u: cand[r] for r, u in enumerate(users_u)}
    bought: dict = {}
    for uid, iid in zip(tx_df["user_id"], tx_df["item_id"]):
        bought.setdefault(uid, set()).add(item_map.idx(iid))

    users, items, labels, groups = [], [], [], []
    g = 0
    for uid, iid in zip(tx_df["user_id"], tx_df["item_id"]):
        pos = item_map.idx(iid)
        if pos == 0 or uid not in cand_of:
            continue
        pool = cand_of[uid]
        own = bought[uid]
        negs = [c for c in pool if c not in own]
        if len(negs) < neg_per_pos:  # tower candidates exhausted by history
            continue
        pick = rng.choice(len(negs), size=neg_per_pos, replace=False)
        users.append(uid); items.append(pos); labels.append(1); groups.append(g)
        for j in pick:
            users.append(uid); items.append(int(negs[j]))
            labels.append(0); groups.append(g)
        g += 1
    return (np.array(users), np.array(items, np.int32),
            np.array(labels, np.int32), np.array(groups, np.int32))
