"""Feature-engineering / statistics pipeline.

Re-implements the reference's ETL feature recipe (SURVEY.md §2.6; reference
`staticstics/preprosess_agg_parallel.py`) on plain pandas/numpy, producing
the exact artifact set the towers train on:

  * item features — `raw_probability` global popularity (the LogQ source),
    1w/1m log-popularity + velocity (clipped [-1, 5]), steadiness, log price,
    log days-since-release, with cold-start imputation for items < 14 days
    old (reference `make_item_features` :168-240);
  * user features — price stats, counts, recency, channel / weekend ratios,
    active months; q=10 quantile bucketing for price/count/recency; standard
    scaling of the continuous block; metadata indices
    (reference `make_user_features` :279-406);
  * purchase sequences — per-user last-``max_len`` items + day deltas
    relative to the last event (reference `process_sequence_row` :410-431);
  * global-time split + last-7-day validation targets
    (reference `make_validation_target_file` :51-76,
    `utils/data_split/pref_data_split_gts.py:40-146`);
  * the data audits, here as callable checks a real test suite asserts on
    (reference `final_sanity_check` :685-732, `check_sequence_distribution`
    :633-680, `deep_inspect_missing_items` :496-521).

Scaler state (bucket edges, mean/std) is fitted on TRAIN and applied to
validation — the reference shares its processor/scaler the same way
(`v1_refine_usertower.py:61-70`, `mined_inference.py:57-118`).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import pandas as pd

WEEK = 7
MONTH = 28


# -- splits ----------------------------------------------------------------

def time_split(tx: pd.DataFrame, valid_days: int = 7):
    """Global-time split: train = everything before the last ``valid_days``,
    valid = the final window (its purchases are the retrieval ground truth)."""
    split_day = int(tx["day"].max()) - valid_days + 1
    train = tx[tx["day"] < split_day].reset_index(drop=True)
    valid = tx[tx["day"] >= split_day].reset_index(drop=True)
    return train, valid, split_day


def grouped_lists(keys, values, sort: bool = True) -> dict:
    """key -> the list of its values in row order; the keys sorted (a
    groupby's order) or in the order they first appear; a missing key forms
    no group."""
    codes, uniques = pd.factorize(keys, sort=sort)
    keep = np.flatnonzero(codes >= 0)
    order = keep[np.argsort(codes[keep], kind="stable")]
    vals = np.asarray(values)[order].tolist()
    ends = np.cumsum(np.bincount(codes[keep], minlength=len(uniques))).tolist()
    return {u: vals[s:e] for u, s, e in zip(uniques.tolist(), [0] + ends[:-1], ends)}


def make_validation_target(valid_tx: pd.DataFrame) -> dict[str, list[str]]:
    """user_id -> list of distinct items purchased in the target window, in
    the order of their first purchase."""
    pairs = valid_tx[["user_id", "item_id"]].drop_duplicates()
    return grouped_lists(pairs["user_id"], pairs["item_id"])


# -- item features ---------------------------------------------------------

def make_item_features(train_tx: pd.DataFrame, items: pd.DataFrame,
                       split_day: int) -> pd.DataFrame:
    counts = train_tx.groupby("item_id").size()
    total = max(int(counts.sum()), 1)
    last_w = train_tx[train_tx["day"] >= split_day - WEEK]
    last_m = train_tx[train_tx["day"] >= split_day - MONTH]
    prev_w = train_tx[(train_tx["day"] >= split_day - 2 * WEEK) & (train_tx["day"] < split_day - WEEK)]
    prev_m = train_tx[(train_tx["day"] >= split_day - 2 * MONTH) & (train_tx["day"] < split_day - MONTH)]

    df = items[["item_id", "price", "release_day"]].copy()
    cnt = df["item_id"].map(counts).fillna(0.0).astype(float)
    df["raw_probability"] = cnt / total
    cw = df["item_id"].map(last_w.groupby("item_id").size()).fillna(0.0).astype(float)
    cm = df["item_id"].map(last_m.groupby("item_id").size()).fillna(0.0).astype(float)
    pw = df["item_id"].map(prev_w.groupby("item_id").size()).fillna(0.0).astype(float)
    pm = df["item_id"].map(prev_m.groupby("item_id").size()).fillna(0.0).astype(float)
    df["pop_1w_log"] = np.log1p(cw)
    df["pop_1m_log"] = np.log1p(cm)
    df["velocity_1w"] = ((cw - pw) / (pw + 1.0)).clip(-1.0, 5.0)
    df["velocity_1m"] = ((cm - pm) / (pm + 1.0)).clip(-1.0, 5.0)

    # steadiness: mean/std over 12 weekly buckets
    weekly = train_tx[train_tx["day"] >= split_day - 12 * WEEK].copy()
    weekly["week"] = (split_day - 1 - weekly["day"]) // WEEK
    pivot = weekly.groupby(["item_id", "week"]).size().unstack(fill_value=0)
    steady = pivot.mean(axis=1) / (pivot.std(axis=1) + 1.0)
    df["steady_score_log"] = np.log1p(df["item_id"].map(steady).fillna(0.0))

    df["avg_item_price_log"] = np.log1p(
        df["item_id"].map(train_tx.groupby("item_id")["price"].mean()).fillna(df["price"]))
    age_days = (split_day - df["release_day"]).clip(lower=0)
    df["days_since_release_log"] = np.log1p(age_days)

    # cold start: items younger than 14 days inherit median popularity stats
    cold = age_days < 14
    for col in ("pop_1w_log", "pop_1m_log", "steady_score_log"):
        median = df.loc[~cold, col].median() if (~cold).any() else 0.0
        df.loc[cold & (cnt == 0), col] = median
    return df


ITEM_SIDE_COLS = ("pop_1m_log", "velocity_1m", "avg_item_price_log", "days_since_release_log")


def logq_from_item_features(item_feats: pd.DataFrame, item_order: list[str],
                            pad_value: float = -20.0) -> np.ndarray:
    """(N+1,) log-popularity vector aligned to model item indexing (row 0 =
    PAD at ``pad_value`` — reference `get_logq_probs`,
    `v1_refine_usertower.py:124-137`)."""
    probs = item_feats.set_index("item_id")["raw_probability"]
    at = probs.index.get_indexer(pd.Index(item_order, dtype=object))
    q = np.where(at >= 0, probs.to_numpy()[at], 0.0).astype(np.float32)
    logq = np.log(np.clip(q, 1e-12, None))
    logq[q <= 0] = pad_value
    return np.concatenate([[pad_value], logq]).astype(np.float32)


def seasonal_logq(train_tx: pd.DataFrame, item_order: list[str], season: str,
                  pad_value: float = -20.0) -> np.ndarray | None:
    """Season-conditioned popularity prior: (N+1,) log-prob computed only
    from transactions whose session season matches ``season`` (tx carry the
    reference's ``UserSession.season`` field). The serving blend swaps this
    in for the global logq when the request season is known — seasonal
    items stop being diluted by off-season mass. None when the log has no
    season column (e.g. the H&M CSV import path)."""
    if "season" in train_tx.columns:
        sel = train_tx[train_tx["season"] == season]
    elif "day" in train_tx.columns:
        from recsys_tpu_torch.data.synthetic import SEASONS, season_of_day
        sel = train_tx[np.asarray(SEASONS)[
            season_of_day(train_tx["day"].to_numpy())] == season]
    else:
        return None
    if len(sel) == 0:
        return None
    counts = sel.groupby("item_id").size()
    total = float(counts.sum())
    q = np.array([counts.get(i, 0.0) / total for i in item_order], np.float32)
    logq = np.log(np.clip(q, 1e-12, None))
    logq[q <= 0] = pad_value
    return np.concatenate([[pad_value], logq]).astype(np.float32)


# -- user features ---------------------------------------------------------

_AGE_TO_BUCKET = {"18-24": 0, "25-34": 1, "35-49": 2, "50+": 3}
_CLUB_IDX = {"active": 0, "pre_create": 1, "left": 2}
_NEWS_IDX = {"none": 0, "regularly": 1, "monthly": 2}

USER_BUCKET_COLS = ("price_mean_b", "cnt_b", "recency_b", "age_bucket")
USER_CAT_COLS = ("club_idx", "news_idx", "fn", "active", "channel_pref")
USER_CONT_COLS = ("weekend_ratio", "active_months", "price_std_s", "price_last_s")


@dataclass
class UserScaler:
    """Train-fitted quantile edges + mean/std, reapplied to validation."""
    edges: dict[str, np.ndarray] = field(default_factory=dict)
    mean: dict[str, float] = field(default_factory=dict)
    std: dict[str, float] = field(default_factory=dict)

    def fit_bucket(self, name: str, values: pd.Series, q: int = 10) -> None:
        self.edges[name] = np.unique(np.quantile(values.to_numpy(float), np.linspace(0, 1, q + 1)[1:-1]))

    def bucket(self, name: str, values: pd.Series) -> np.ndarray:
        return np.digitize(values.to_numpy(float), self.edges[name])

    def fit_scale(self, name: str, values: pd.Series) -> None:
        v = values.to_numpy(float)
        self.mean[name] = float(v.mean())
        self.std[name] = float(v.std() + 1e-6)

    def scale(self, name: str, values: pd.Series) -> np.ndarray:
        return ((values.to_numpy(float) - self.mean[name]) / self.std[name]).astype(np.float32)


def make_user_features(train_tx: pd.DataFrame, users: pd.DataFrame, split_day: int,
                       scaler: UserScaler | None = None) -> tuple[pd.DataFrame, UserScaler]:
    g = train_tx.groupby("user_id")
    agg = pd.DataFrame({
        "price_mean": g["price"].mean(),
        "price_std": g["price"].std().fillna(0.0),
        "price_last": g["price"].last(),
        "cnt": g.size().astype(float),
        "recency": (split_day - g["day"].max()).astype(float),
        "channel_pref": (g["channel"].mean() > 1.5).astype(int),
        # vectorized (cython groupby) forms — per-group python lambdas were
        # ~30 s of ETL on a 200k-user world
        "weekend_ratio": (train_tx["day"] % 7 >= 5).astype(float)
                         .groupby(train_tx["user_id"]).mean(),
        "active_months": g["day"].nunique().astype(float) / MONTH,
    })
    df = users.merge(agg, left_on="user_id", right_index=True, how="left")
    for c in ("price_mean", "price_std", "price_last", "cnt"):
        df[c] = df[c].fillna(0.0)
    df["recency"] = df["recency"].fillna(float(split_day))
    df["channel_pref"] = df["channel_pref"].fillna(0).astype(int)
    df["weekend_ratio"] = df["weekend_ratio"].fillna(0.0)
    df["active_months"] = df["active_months"].fillna(0.0)

    fit = scaler is None
    scaler = scaler or UserScaler()
    if fit:
        scaler.fit_bucket("price_mean_b", df["price_mean"])
        scaler.fit_bucket("cnt_b", df["cnt"])
        scaler.fit_bucket("recency_b", df["recency"])
        for c in ("price_std", "price_last"):
            scaler.fit_scale(c, df[c])
    df["price_mean_b"] = scaler.bucket("price_mean_b", df["price_mean"])
    df["cnt_b"] = scaler.bucket("cnt_b", df["cnt"])
    df["recency_b"] = scaler.bucket("recency_b", df["recency"])
    df["price_std_s"] = scaler.scale("price_std", df["price_std"])
    df["price_last_s"] = scaler.scale("price_last", df["price_last"])
    df["age_bucket"] = df["age_group"].map(_AGE_TO_BUCKET).fillna(0).astype(int)
    df["club_idx"] = df["club_member_status"].map(_CLUB_IDX).fillna(0).astype(int)
    df["news_idx"] = df["fashion_news_frequency"].map(_NEWS_IDX).fillna(0).astype(int)
    return df, scaler


# -- sequences -------------------------------------------------------------

def sequence_windows(train_tx: pd.DataFrame, max_len: int = 50):
    """Each user's last ``max_len`` purchases as flat arrays: (user ids, in
    sorted order; each window's length; the item ids, user by user, oldest
    first; each purchase's day delta to the user's last one)."""
    df = train_tx.sort_values(["user_id", "day"], kind="stable")
    uids = df["user_id"].to_numpy()
    items = df["item_id"].to_numpy()
    days = df["day"].to_numpy()
    starts = np.flatnonzero(np.concatenate([[True], uids[1:] != uids[:-1]])) \
        if len(uids) else np.zeros(0, np.int64)
    ends = np.append(starts[1:], len(uids))
    lo = np.maximum(starts, ends - max_len)
    lens = ends - lo
    group = np.repeat(np.arange(len(lens)), lens)
    pos = lo[group] + np.arange(int(lens.sum())) - (np.cumsum(lens) - lens)[group]
    deltas = (days[ends[group] - 1] - days[pos]).astype(np.int64)
    return uids[starts], lens, items[pos], deltas


def make_sequences(train_tx: pd.DataFrame, max_len: int = 50) -> pd.DataFrame:
    """Per-user purchase sequence (last ``max_len``) + day deltas relative to
    the final event. Items are string ids here; the dataset stage maps to
    model indices and left-pads."""
    if len(train_tx) == 0:
        return pd.DataFrame(columns=["user_id", "sequence",
                                     "sequence_deltas", "seq_len"])
    uids, lens, items, deltas = sequence_windows(train_tx, max_len)
    items, deltas = list(items), deltas.tolist()
    ends = np.cumsum(lens).tolist()
    bounds = list(zip([0] + ends[:-1], ends))
    return pd.DataFrame({"user_id": uids.tolist(),
                         "sequence": [items[s:e] for s, e in bounds],
                         "sequence_deltas": [deltas[s:e] for s, e in bounds],
                         "seq_len": lens})


def aggregate_histories(tx: pd.DataFrame, out_json: str | None = None) -> dict:
    """Per-customer article/date lists + per-article counts (the reference's
    polars aggregation + JSON export, `staticstics/data_agg.py:29-61`)."""
    user_hist = {
        uid: {"items": list(g["item_id"]), "days": [int(d) for d in g["day"]]}
        for uid, g in tx.sort_values("day", kind="stable").groupby("user_id")
    }
    article_counts = tx.groupby("item_id").size().astype(int).to_dict()
    out = {"user_histories": user_hist, "article_counts": article_counts}
    if out_json:
        import json
        with open(out_json, "w") as f:
            json.dump(out, f, indent=1)
    return out


# -- audits (real tests assert on these) ----------------------------------

def final_sanity_check(sequences: pd.DataFrame, targets: dict[str, list[str]]) -> dict:
    """(1) no empty/padding entries inside any sequence; (2) coverage of
    validation-target users by the sequence table."""
    bad_pad = int(sum(any(i in ("", None, "<pad>") for i in s) for s in sequences["sequence"]))
    have = set(sequences["user_id"])
    covered = sum(1 for u in targets if u in have)
    return {
        "pad_inside_sequence": bad_pad,
        "target_users": len(targets),
        "covered_target_users": covered,
        "coverage": covered / max(len(targets), 1),
    }


def check_sequence_distribution(train_seqs: pd.DataFrame, valid_seqs: pd.DataFrame,
                                threshold: float = 5.0) -> dict:
    m1 = float(train_seqs["seq_len"].mean())
    m2 = float(valid_seqs["seq_len"].mean())
    return {"train_mean": m1, "valid_mean": m2, "ok": abs(m1 - m2) < threshold}


def deep_inspect_missing_items(tx: pd.DataFrame, items: pd.DataFrame) -> dict:
    known = set(items["item_id"])
    missing = int((~tx["item_id"].isin(known)).sum())
    return {"missing_tx": missing, "total_tx": len(tx)}
