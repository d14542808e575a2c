"""Offline analysis utilities: stratified K-fold and persona clustering.

Counterpart of ``recsys_tpu/data/analysis.py``, host code with the same
lazy imports of scikit-learn and scipy inside each function (the port itself
needs neither): the stratified 5-fold split over product groups with
rare-class dropping, the behavioral persona clustering (7 behavior features
-> KMeans -> auto-tagged persona labels) and the sequence-distribution
statistics.
"""

from __future__ import annotations

import numpy as np
import pandas as pd


def stratified_kfold(items: pd.DataFrame, label_col: str = "product_type_name",
                     n_splits: int = 5, seed: int = 0) -> pd.DataFrame:
    """Add a ``fold`` column stratified by ``label_col``; classes with fewer
    than ``n_splits`` members are dropped (fold = -1)."""
    from sklearn.model_selection import StratifiedKFold

    out = items.copy()
    out["fold"] = -1
    counts = out[label_col].value_counts()
    keep = out[label_col].isin(counts[counts >= n_splits].index)
    idx = out.index[keep]
    labels = out.loc[idx, label_col]
    skf = StratifiedKFold(n_splits=n_splits, shuffle=True, random_state=seed)
    for f, (_, test_rows) in enumerate(skf.split(np.zeros(len(idx)), labels)):
        out.loc[idx[test_rows], "fold"] = f
    return out


PERSONA_FEATURES = ("basket_size", "avg_price", "category_entropy",
                    "long_tail_ratio", "weekend_ratio", "repurchase_rate",
                    "relative_price")


def behavior_features(tx: pd.DataFrame, items: pd.DataFrame) -> pd.DataFrame:
    """Per-user 7-feature behavior block (the clustering input)."""
    from scipy.stats import entropy

    item_cat = items.set_index("item_id")["product_type_name"]
    pop = tx["item_id"].value_counts()
    tail_items = set(pop[pop <= pop.quantile(0.5)].index)
    global_price = tx["price"].mean()

    rows = []
    for uid, g in tx.groupby("user_id"):
        per_day = g.groupby("day").size()
        cats = g["item_id"].map(item_cat).value_counts(normalize=True)
        rows.append({
            "user_id": uid,
            "basket_size": float(per_day.mean()),
            "avg_price": float(g["price"].mean()),
            "category_entropy": float(entropy(cats)) if len(cats) else 0.0,
            "long_tail_ratio": float(g["item_id"].isin(tail_items).mean()),
            "weekend_ratio": float((g["day"] % 7 >= 5).mean()),
            "repurchase_rate": 1.0 - g["item_id"].nunique() / len(g),
            "relative_price": float(g["price"].mean() / max(global_price, 1e-9)),
        })
    return pd.DataFrame(rows)


_TAG_RULES = (
    ("Premium_Picker", "relative_price", 1.2, "Budget_Hunter", 0.8),
    ("Weekend_Shopper", "weekend_ratio", 0.4, None, None),
    ("Explorer", "category_entropy", 1.5, "Loyalist", 0.5),
    ("Bulk_Buyer", "basket_size", 3.0, None, None),
)


def cluster_personas(behavior: pd.DataFrame, n_clusters: int = 8,
                     seed: int = 0) -> tuple[pd.DataFrame, dict]:
    """KMeans over standardized behavior features; each cluster auto-tagged
    from its centroid ("Weekend_Shopper & Premium_Picker" style)."""
    from sklearn.cluster import KMeans
    from sklearn.preprocessing import StandardScaler

    X = behavior[list(PERSONA_FEATURES)].to_numpy(float)
    Xs = StandardScaler().fit_transform(X)
    n_clusters = min(n_clusters, len(behavior))
    km = KMeans(n_clusters=n_clusters, random_state=seed, n_init=10).fit(Xs)
    out = behavior.copy()
    out["cluster"] = km.labels_

    centroids = pd.DataFrame(
        [X[km.labels_ == c].mean(axis=0) for c in range(n_clusters)],
        columns=list(PERSONA_FEATURES))
    tags: dict[int, str] = {}
    for c, row in centroids.iterrows():
        parts = []
        for hi_tag, feat, hi_thr, lo_tag, lo_thr in _TAG_RULES:
            if row[feat] >= hi_thr:
                parts.append(hi_tag)
            elif lo_tag is not None and row[feat] <= lo_thr:
                parts.append(lo_tag)
        tags[c] = " & ".join(parts[:2]) if parts else "Mainstream"
    out["persona_tag"] = out["cluster"].map(tags)
    return out, tags


def sequence_distribution_stats(seqs: pd.DataFrame,
                                known_items: set | None = None) -> dict:
    """Sequence-length / long-tail / id-coverage EDA as structured data
    (reference ``analyze_distributions``, `v1_refine_usertower.py:141-192`,
    which printed + plotted; here the numbers are the artifact so they can
    be logged and asserted on).

    ``seqs`` is `etl.make_sequences` output (a ``sequence`` list column);
    ``known_items`` optionally checks id-mapping coverage."""
    if len(seqs) == 0:
        out = {"len_mean": 0.0, "len_median": 0.0, "len_p90": 0.0,
               "len_p95": 0.0, "len_max": 0, "unique_items": 0,
               "top10pct_coverage": 0.0}
        if known_items is not None:
            out["unmapped_items"] = 0
        return out
    lengths = seqs["sequence"].apply(len)
    all_items = [i for s in seqs["sequence"] for i in s]
    counts = pd.Series(all_items).value_counts()
    top_n = max(1, int(len(counts) * 0.1))
    out = {
        "len_mean": float(lengths.mean()),
        "len_median": float(lengths.median()),
        "len_p90": float(lengths.quantile(0.9)),
        "len_p95": float(lengths.quantile(0.95)),
        "len_max": int(lengths.max()),
        "unique_items": int(len(counts)),
        "top10pct_coverage": float(counts.iloc[:top_n].sum() / max(len(all_items), 1)),
    }
    if known_items is not None:
        out["unmapped_items"] = int(sum(1 for i in counts.index
                                        if i not in known_items))
    return out
