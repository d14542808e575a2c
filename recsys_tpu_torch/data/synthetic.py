"""Persona-driven synthetic H&M-style dataset + deterministic fake-LLM
feature enrichment.

The reference's test fixtures are a 2-item seed list plus a persona prompt
that asks Gemini to synthesize purchase logs (SURVEY.md §4.4; reference
`airflow/dags/temp_data.py`, `llm_model_sys_instructions/persona_t.md`).
Here that generator is code: 16 personas (4 age bands x 2 genders x 2
styles) with the prompt's statistical purchase-distribution guide (30%
single-item / 30% two-item / 40% multi-item sessions), Zipf-skewed item
popularity (so LogQ correction has something real to correct), and seasonal
drift: every item carries a catalog season, the year cycles through the
reference's 3-value Season enum in quarters, and in-season items draw
``season_boost`` x likelier (per-season cumulative-weight tables keep every
basket draw O(log n)). Transactions record the session's season.

The fake LLM (`enrich_item`) implements the RE-feature contract of the
reference prompts (`gemini_flash_compatible_with_Gemma-prompter.txt`: JSON
of reinforced_feature_value per product; `description_tokenizer`: the 9
[CAT]..[LOC] tag fields) as deterministic rules — measurement-ratio
geometry tiers included — so CI needs no external LLM and enrichment is
reproducible bit-for-bit.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from recsys_tpu_torch.config import DataConfig
from recsys_tpu_torch.data.vocab import DEFAULT_STD_VOCAB, RE_FEATURE_KEYS

AGE_BANDS = ["18-24", "25-34", "35-49", "50+"]
GENDERS = ["female", "male"]
STYLES = ["trend", "classic"]

# style -> preferred graphical appearances / sections; persona taste anchors
_STYLE_APPEAR = {
    "trend": ["print_all_over", "colour_block", "neon", "glitter", "print_placement"],
    "classic": ["solid", "stripe", "check", "melange", "washed"],
}
_GENDER_SECTION = {
    "female": ["womens_everyday", "womens_trend", "womens_classic", "womens_casual", "lingerie"],
    "male": ["mens_basic", "mens_trend", "mens_classic", "sportswear"],
}

_UPPER = ["tshirt", "shirt", "blouse", "sweater", "hoodie", "cardigan", "top", "jacket", "coat", "blazer"]
_LOWER = ["skirt", "trousers", "jeans", "shorts", "leggings"]
_FULL = ["dress", "jumpsuit"]

_MATERIALS = ["cotton", "linen", "wool", "polyester", "viscose", "denim", "leather", "silk", "jersey"]
_DETAILS = ["ribbed", "pleated", "button_front", "zip", "pocket", "hooded", "collar", "ruffle", "seam"]
_CONTEXTS = ["office", "weekend", "party", "sport", "beach", "lounge", "daily"]

# -- seasons (reference `database.py:47-50` Season enum + the prompter's
# temperature-aware micro-season block, `gemini_flash_compatible_with_
# Gemma-prompter.txt:18-24`) -------------------------------------------------
SEASONS = ["Summer", "Spring/Autumn", "Winter"]
# catalog-season prior per material (an item's season is a *catalog
# attribute*, `input.season` in the prompter): warm materials skew Winter,
# light ones Summer
_MATERIAL_SEASON_P = {
    "linen":     (0.70, 0.25, 0.05),
    "cotton":    (0.45, 0.40, 0.15),
    "jersey":    (0.40, 0.40, 0.20),
    "viscose":   (0.40, 0.40, 0.20),
    "silk":      (0.25, 0.55, 0.20),
    "denim":     (0.25, 0.50, 0.25),
    "polyester": (0.30, 0.40, 0.30),
    "wool":      (0.03, 0.35, 0.62),
    "leather":   (0.05, 0.40, 0.55),
}


def season_of_day(day, cycle_days: int = 364):
    """Broad season index (0=Summer, 1=Spring/Autumn, 2=Winter) for a day.
    The year cycles Summer -> Autumn -> Winter -> Spring in equal quarters,
    so Spring/Autumn (index 1) covers two of the four quarters — matching
    the reference's 3-value Season enum."""
    q = (np.asarray(day) % cycle_days) // (cycle_days // 4)
    return np.where(q == 0, 0, np.where(q == 2, 2, 1))


def micro_season(season: str, material: str) -> str:
    """The prompter's temperature-aware micro-season logic
    (`gemini_flash_compatible_with_Gemma-prompter.txt:18-24`), with our
    material list standing in for material.thickness/type:

      Summer:        linen -> high_summer | cotton -> early_summer | summer
      Spring/Autumn: silk -> warm_spring_autumn | wool -> chilly_spring_autumn
                     | spring_autumn
      Winter:        leather/wool (the padding/fur analogues) -> deep_winter
                     | winter
    """
    if season == "Summer":
        return {"linen": "high_summer", "cotton": "early_summer"}.get(
            material, "summer")
    if season == "Winter":
        return "deep_winter" if material in ("leather", "wool") else "winter"
    return {"silk": "warm_spring_autumn",
            "wool": "chilly_spring_autumn"}.get(material, "spring_autumn")


def _persona_id(age: str, gender: str, style: str) -> str:
    return f"{gender}_{age}_{style}"


# -- latent micro-style clusters -------------------------------------------
#
# The 16-persona world caps what any model can learn: every user in a persona
# shares one big pool, so per-user signal is only the repeat path (the "mid
# world plateaus ~5%" finding). Real catalogs have micro-structure: users
# shop a handful of coherent item neighborhoods ("micro-styles"), and those
# neighborhoods co-occur across users — the item-item co-occurrence signal
# sequence models and the GNN actually feed on. Here that structure is
# explicit latent ground truth: items get feature-coherent clusters, users
# subscribe to a few clusters, and a knob-controlled share of basket slots
# draws from the user's subscribed clusters.

def _assign_item_clusters(items: pd.DataFrame, n_clusters: int,
                          rng: np.random.Generator):
    """Feature-coherent latent clusters.

    Within each (gender, style) cell, items sorted by (type, material,
    colour) are chunked into contiguous micro-style clusters — cluster mates
    look alike (content-learnable) *and* co-occur in subscriber histories
    (sequence/graph-learnable). 10% label noise keeps cells from being
    perfectly separable. Returns the per-item cluster-id array.
    """
    n = len(items)
    cluster = np.zeros(n, np.int64)
    cells = items.groupby(["gender", "style"], sort=True).indices
    next_id = 0
    for key in sorted(cells):
        idx = np.asarray(cells[key])
        nc = max(1, round(n_clusters * len(idx) / n))
        sub = items.iloc[idx]
        order = np.lexsort((sub["colour_group_name"].to_numpy(),
                            sub["material"].to_numpy(),
                            sub["product_type_name"].to_numpy()))
        for j, chunk in enumerate(np.array_split(idx[order], nc)):
            cluster[chunk] = next_id + j
        next_id += nc
    noise = rng.random(n) < 0.1
    cluster[noise] = rng.integers(0, next_id, int(noise.sum()))
    return cluster


# fashion style vocabulary for product names (real catalogs' names carry
# fit/style words — H&M: "Skinny Regular Denim", "Oversized Cotton Shirt");
# each micro-style cluster signs its names with a couple of these
_STYLE_WORDS = [
    "skinny", "slim", "oversized", "relaxed", "boxy", "longline", "crop",
    "ribbed_knit", "cable", "chunky", "sheer", "satin", "velvet", "utility",
    "cargo", "biker", "bomber", "trench", "wrap", "peplum", "smocked",
    "tiered", "ruched", "balloon", "puff", "bell", "raglan", "halter",
    "bandeau", "crew", "turtleneck", "mock", "henley", "polo", "distressed",
    "washed", "acid", "coated", "waffle", "terry", "fleece", "quilted",
    "padded", "belted", "tailored", "flare", "bootcut", "paperbag",
    "jogger", "chino", "scallop", "mesh", "lace", "broderie", "jacquard",
    "ombre", "marl", "boucle", "crinkle", "plisse",
]


def _add_style_words(items: pd.DataFrame, rng: np.random.Generator,
                     n_words: int) -> None:
    """Append each cluster's signature style words to its items' names
    (world-v4 knob ``DataConfig.name_style_words``). Makes product TEXT
    carry latent-style signal the way real catalog names do — the regime
    where a pretrained text encoder can out-lift a from-scratch one.
    In-place on ``items``."""
    cluster = items["latent_cluster"].to_numpy()
    n_clusters = int(cluster.max()) + 1
    sig = rng.integers(0, len(_STYLE_WORDS), size=(n_clusters, n_words))
    suffix = [" ".join(_STYLE_WORDS[w] for w in sig[c]) for c in range(n_clusters)]
    items["product_name"] = [
        f"{name} {suffix[c]}" for name, c in zip(items["product_name"], cluster)]


def _cluster_cells(items: pd.DataFrame, cluster: np.ndarray,
                   n_clusters: int) -> np.ndarray:
    """Majority (gender, style) cell per cluster (cells are 0..3 over the
    sorted gender x style grid)."""
    cell_names = [(g, s) for g in sorted(GENDERS) for s in sorted(STYLES)]
    cell_key = {c: i for i, c in enumerate(cell_names)}
    item_cell = np.array([cell_key[(g, s)] for g, s in
                          zip(items["gender"], items["style"])])
    counts = np.bincount(cluster * 4 + item_cell,
                         minlength=n_clusters * 4).reshape(n_clusters, 4)
    return counts.argmax(axis=1)


def _subscribe_users(users: pd.DataFrame, cell_of_cluster: np.ndarray,
                     cluster_pop: np.ndarray, n_clusters: int, per_user: int,
                     rng: np.random.Generator) -> np.ndarray:
    """(num_users, per_user) cluster subscriptions: popularity-weighted with
    a 4:1 preference for clusters of the user's own (gender, style) cell —
    popular clusters get many subscribers, preserving the LogQ skew."""
    cell_names = [(g, s) for g in sorted(GENDERS) for s in sorted(STYLES)]
    cell_key = {c: i for i, c in enumerate(cell_names)}
    subs = np.zeros((len(users), per_user), np.int64)
    user_cell = np.array([cell_key[(g, s)] for g, s in
                          zip(users["gender"], users["style"])])
    for cell_id in range(len(cell_names)):
        rows = np.flatnonzero(user_cell == cell_id)
        if rows.size == 0:
            continue
        w = cluster_pop * np.where(cell_of_cluster == cell_id, 4.0, 1.0)
        p = w / w.sum()
        subs[rows] = rng.choice(n_clusters, size=(rows.size, per_user), p=p)
    return subs


def generate_items(cfg: DataConfig, rng: np.random.Generator) -> pd.DataFrame:
    """Item master with STD fields, price, release day and measurements."""
    n = cfg.num_items
    types = DEFAULT_STD_VOCAB["product_type_name"]
    rows = []
    for i in range(n):
        ptype = types[rng.integers(len(types))]
        gender = GENDERS[rng.integers(2)]
        style = STYLES[rng.integers(2)]
        appear = _STYLE_APPEAR[style][rng.integers(5)]
        colour = DEFAULT_STD_VOCAB["colour_group_name"][rng.integers(30)]
        section = _GENDER_SECTION[gender][rng.integers(len(_GENDER_SECTION[gender]))]
        dept = DEFAULT_STD_VOCAB["department_name"][rng.integers(22)]
        pcv = DEFAULT_STD_VOCAB["perceived_colour_value_name"][rng.integers(7)]
        material = _MATERIALS[rng.integers(len(_MATERIALS))]
        detail = _DETAILS[rng.integers(len(_DETAILS))]
        season = SEASONS[rng.choice(3, p=_MATERIAL_SEASON_P[material])]
        # garment measurements (cm) drive the fake-LLM geometry tiers
        total_len = float(rng.uniform(40, 130))
        chest_w = float(rng.uniform(35, 70))
        waist_w = float(rng.uniform(30, 60))
        hem_w = float(rng.uniform(30, 80))
        rise = float(rng.uniform(18, 35))
        rows.append({
            "item_id": f"it{i:06d}",
            "product_name": f"{colour} {material} {ptype} {detail}",
            "product_type_name": ptype,
            "graphical_appearance_name": appear,
            "colour_group_name": colour,
            "department_name": dept,
            "section_name": section,
            "perceived_colour_value_name": pcv,
            "material": material,
            "detail": detail,
            "season": season,
            "gender": gender,
            "style": style,
            "price": round(float(rng.lognormal(3.0, 0.5)), 2),
            "release_day": int(rng.integers(0, max(cfg.days - 14, 1))),
            "total_length": total_len,
            "chest_width": chest_w,
            "waist_width": waist_w,
            "hem_width": hem_w,
            "rise": rise,
        })
    return pd.DataFrame(rows)


# -- fake LLM -------------------------------------------------------------

def _vertical_balance(total_length: float, ptype: str) -> str:
    """Measurement-ratio geometry tier: garment length class."""
    if ptype in _LOWER or ptype in _FULL:
        return "maxi" if total_length > 100 else ("midi" if total_length > 70 else "mini")
    return "longline" if total_length > 75 else ("regular_length" if total_length > 55 else "cropped")


def _width_flow(chest_w: float, hem_w: float) -> str:
    ratio = hem_w / max(chest_w, 1e-6)
    if ratio > 1.25:
        return "a_line_flare"
    if ratio < 0.85:
        return "tapered"
    return "straight_flow"


def _waist_contour(waist_w: float, chest_w: float) -> str:
    ratio = waist_w / max(chest_w, 1e-6)
    if ratio < 0.8:
        return "cinched_waist"
    if ratio > 1.0:
        return "relaxed_waist"
    return "natural_waist"


def _rise_tier(rise: float) -> str:
    return "high_rise" if rise > 28 else ("mid_rise" if rise > 22 else "low_rise")


def enrich_item(item: dict) -> dict:
    """Deterministic RE-feature generation: the fake Gemini.

    Returns ``{"reinforced_feature_value": {field: [tokens...]}}`` with the
    nine RE fields, including the structural geometry tiers the reference
    prompt specifies as explicit measurement-ratio rules."""
    ptype = item["product_type_name"]
    loc = ("lower_body" if ptype in _LOWER else
           "full_body" if ptype in _FULL else
           "accessory" if ptype in ("hat", "cap", "scarf", "gloves", "belt", "bag",
                                    "earring", "necklace", "sunglasses") else
           "feet" if ptype in ("shoes", "sneakers", "boots", "sandals", "socks", "tights") else
           "upper_body")
    geometry = [
        _vertical_balance(item["total_length"], ptype),
        _width_flow(item["chest_width"], item["hem_width"]),
        _waist_contour(item["waist_width"], item["chest_width"]),
    ]
    if ptype in _LOWER:
        geometry.append(_rise_tier(item["rise"]))
    # contextual synthesis into an industry term, e.g. "cropped_tshirt"
    synthesized = f"{geometry[0]}_{ptype}"
    ctx = "sport" if "sport" in item["section_name"] else (
        "party" if item["graphical_appearance_name"] in ("glitter", "metallic", "neon")
        else "daily")
    # temperature-aware micro-season (prompter logic block `:18-24`):
    # refine the catalog's broad season with the material — rides in CTX
    # (the reference's richer schema has a dedicated `season` key; our
    # 9-field closed schema folds it into the context field)
    ms = micro_season(item.get("season", "Spring/Autumn"), item["material"])
    re_features = {
        "CAT": [ptype, synthesized],
        "MAT": [item["material"]],
        "DET": [item["detail"], item["graphical_appearance_name"]],
        "FIT": geometry,
        "FNC": ["warm" if item["material"] in ("wool", "leather") else "breathable"],
        "SPC": [item["style"]],
        "COL": [item["colour_group_name"], item["perceived_colour_value_name"]],
        "CTX": [ctx, ms],
        "LOC": [loc],
    }
    assert set(re_features) == set(RE_FEATURE_KEYS)
    return {"reinforced_feature_value": re_features}


def generate_users(cfg: DataConfig, rng: np.random.Generator) -> pd.DataFrame:
    rows = []
    for u in range(cfg.num_users):
        age = AGE_BANDS[rng.integers(4)]
        gender = GENDERS[rng.integers(2)]
        style = STYLES[rng.integers(2)]
        rows.append({
            "user_id": f"us{u:06d}",
            "age_group": age,
            "gender": gender,
            "style": style,
            "persona": _persona_id(age, gender, style),
            "club_member_status": ["active", "pre_create", "left"][rng.integers(3)],
            "fashion_news_frequency": ["none", "regularly", "monthly"][rng.integers(3)],
            "fn": int(rng.random() < 0.3),
            "active": int(rng.random() < 0.7),
        })
    return pd.DataFrame(rows)


def generate_transactions(cfg: DataConfig, items: pd.DataFrame, users: pd.DataFrame,
                          rng: np.random.Generator) -> pd.DataFrame:
    """Zipf-popular, persona-biased purchase log over ``cfg.days`` days.

    Realism structure from the persona contract (persona_t.md):
      * every persona concentrates on a preferred ITEM POOL
        (``persona_pool_frac`` of the catalog, ``persona_pool_boost`` x
        likelier) on top of the gender/style affinity;
      * shoppers REPURCHASE: with ``repeat_prob`` a basket slot is drawn
        from the user's own history — the signal sequence models feed on.
    """
    n_items = len(items)
    # global popularity skew (Zipf) — the LogQ source. The exponent is a
    # knob: 0.9 concentrates ~half the recall@100 mass in the global top-100
    # on a 2k catalog (popularity baseline ~48%, drowning personalization);
    # real retail (H&M) is flatter.
    pop = 1.0 / np.arange(1, n_items + 1) ** cfg.pop_zipf
    perm = rng.permutation(n_items)
    base_pop = np.zeros(n_items)
    base_pop[perm] = pop
    item_gender = items["gender"].to_numpy()
    item_style = items["style"].to_numpy()
    release = items["release_day"].to_numpy()
    price = items["price"].to_numpy()
    item_ids = items["item_id"].to_numpy()

    # seasonal drift: per-season item weight multipliers (3 broad seasons;
    # season_boost=1 or no season column -> single shared weight path that
    # reproduces the pre-season random stream bit-exactly)
    seasonal = cfg.season_boost != 1.0 and "season" in items.columns
    if seasonal:
        sea_idx = {s: i for i, s in enumerate(SEASONS)}
        item_season = items["season"].map(sea_idx).to_numpy()
        season_w = [np.where(item_season == s, cfg.season_boost, 1.0)
                    for s in range(3)]
    else:
        season_w = [np.ones(n_items)]
    n_sea = len(season_w)

    pool_size = max(int(n_items * cfg.persona_pool_frac), 1)
    personas = sorted(users["persona"].unique())
    pools = {p: rng.choice(n_items, pool_size, replace=False)
             for p in personas}

    # latent micro-style clusters + per-user subscriptions (see module note)
    if "latent_cluster" in items.columns:
        cluster = items["latent_cluster"].to_numpy()
    else:
        cluster = _assign_item_clusters(
            items, cfg.n_item_clusters or max(n_items // 64, 8), rng)
    n_clusters = int(cluster.max()) + 1
    cell_of_cluster = _cluster_cells(items, cluster, n_clusters)
    cluster_pop = np.bincount(cluster, weights=base_pop, minlength=n_clusters) + 1e-9
    subs = _subscribe_users(users, cell_of_cluster, cluster_pop, n_clusters,
                            cfg.user_clusters, rng)
    # per-cluster release-sorted member lists + popularity cums (one per
    # season), so an availability-filtered within-cluster draw is one
    # searchsorted
    cl_members, cl_rel, cl_cum = [], [], []
    for c in range(n_clusters):
        mem = np.flatnonzero(cluster == c)
        o = np.argsort(release[mem], kind="stable")
        mem = mem[o]
        cl_members.append(mem)
        cl_rel.append(release[mem])
        cl_cum.append([np.cumsum((base_pop * w)[mem], dtype=np.float64)
                       for w in season_w])

    # Availability as a PREFIX of the release-day-sorted catalog: a session
    # at day d may draw from the first n_d items of the sorted order, so one
    # cumulative-weight array per persona turns every basket draw into an
    # O(log n) inverse-CDF searchsorted. (The previous per-session
    # renormalize-the-whole-catalog form was O(n_items) per draw — minutes
    # per 1k users at a 47k-item catalog, unusable at reference scale.)
    # Distribution note vs the loop form: basket slots draw WITH replacement
    # (the old rng.choice(replace=False) could not repeat within a session),
    # so concentrated weights (small persona pools / day-0 catalogs) can put
    # the same item twice in a basket — in-session repeats already existed
    # through the repeat_prob path, this only adds rare extra mass there.
    order = np.argsort(release, kind="stable")
    rel_sorted = release[order]

    frames = []
    for persona, grp in users.groupby("persona", sort=True):
        g0 = grp.iloc[0]
        # taste mask: persona prefers matching gender & style items 4:1,
        # and its own pool by persona_pool_boost
        affinity = np.where(item_gender == g0["gender"], 4.0, 1.0)
        affinity = affinity * np.where(item_style == g0["style"], 2.0, 1.0)
        in_pool = np.zeros(n_items, bool)
        in_pool[pools[persona]] = True
        affinity = affinity * np.where(in_pool, cfg.persona_pool_boost, 1.0)
        cum_s = [np.cumsum((base_pop * affinity * w)[order], dtype=np.float64)
                 for w in season_w]

        G = len(grp)
        n_sess = rng.poisson(8, G).astype(np.int64) + 1
        total_sessions = int(n_sess.sum())
        days = rng.integers(0, cfg.days, size=total_sessions)
        sess_user = np.repeat(np.arange(G), n_sess)
        srt = np.lexsort((days, sess_user))     # day-sorted within each user
        days, sess_user = days[srt], sess_user[srt]
        r = rng.random(total_sessions)
        basket = np.where(r < 0.3, 1,
                          np.where(r < 0.6, 2,
                                   rng.integers(3, 7, total_sessions)))
        draw_sess = np.repeat(np.arange(total_sessions), basket)
        d_day = days[draw_sess]
        d_sea = (season_of_day(d_day, cfg.season_cycle_days) if seasonal
                 else np.zeros(len(d_day), np.int64))
        n_d = np.searchsorted(rel_sorted, d_day, side="right")
        cap = np.empty(len(d_day))
        for s in range(n_sea):
            m = d_sea == s
            cap[m] = np.where(n_d[m] > 0, cum_s[s][np.maximum(n_d[m] - 1, 0)], 0.0)
        valid = cap > 0                          # nothing released yet -> skip
        u_draw = rng.random(valid.sum()) * cap[valid]
        v_sea, v_nd = d_sea[valid], n_d[valid]
        chosen = np.zeros(len(u_draw), np.int64)
        for s in range(n_sea):
            m = v_sea == s
            j = np.searchsorted(cum_s[s], u_draw[m])
            chosen[m] = order[np.minimum(j, np.maximum(v_nd[m] - 1, 0))]
        d_user = sess_user[draw_sess][valid]
        d_day = d_day[valid]
        d_sea = d_sea[valid]

        # with user_pool_prob a slot re-draws from the user's subscribed
        # micro-style clusters (availability-filtered, popularity-weighted);
        # persona-affinity draw stays as the fallback when nothing in the
        # picked cluster has been released yet
        uid_glob = grp.index.to_numpy()
        sel = np.flatnonzero(rng.random(len(chosen)) < cfg.user_pool_prob)
        if sel.size:
            cpick = subs[uid_glob[d_user[sel]],
                         rng.integers(0, subs.shape[1], sel.size)]
            dsel, ssel = d_day[sel], d_sea[sel]
            for c in np.unique(cpick):
                w = np.flatnonzero(cpick == c)
                nd = np.searchsorted(cl_rel[c], dsel[w], side="right")
                for s in range(n_sea):
                    ws = w[ssel[w] == s] if n_sea > 1 else w
                    nds = nd[ssel[w] == s] if n_sea > 1 else nd
                    ccum = cl_cum[c][s]
                    cap = np.where(nds > 0, ccum[np.maximum(nds - 1, 0)], 0.0)
                    ok = cap > 0
                    if not ok.any():
                        continue
                    jj = np.searchsorted(ccum, rng.random(int(ok.sum())) * cap[ok])
                    chosen[sel[ws[ok]]] = cl_members[c][
                        np.minimum(jj, np.maximum(nds[ok] - 1, 0))]

        # repurchase: with repeat_prob a slot re-draws uniformly from the
        # user's OWN earlier purchases (draws are day-ordered per user).
        # Only the ~repeat_prob of flagged slots need the sequential pass;
        # ascending order keeps the chain semantics (a repeat can copy an
        # earlier slot that was itself a repeat).
        K = len(chosen)
        repeat = rng.random(K) < cfg.repeat_prob
        pick = rng.random(K)
        final = chosen.copy()
        starts = np.flatnonzero(np.diff(d_user, prepend=-1))
        rep_idx = np.flatnonzero(repeat)
        rep_start = starts[np.searchsorted(starts, rep_idx, side="right") - 1]
        for k, s in zip(rep_idx.tolist(), rep_start.tolist()):
            if k > s:  # a user's first purchase has no history to repeat
                final[k] = final[s + int(pick[k] * (k - s))]

        uid_arr = grp["user_id"].to_numpy()
        frames.append(pd.DataFrame({
            "user_id": uid_arr[d_user],
            "item_id": item_ids[final],
            "day": d_day.astype(int),
            "price": price[final].astype(float),
            "channel": (rng.random(K) < 0.7).astype(int) + 1,  # 1=store, 2=online
            # session season (reference UserSession.season, `database.py:185`)
            "season": np.asarray(SEASONS)[
                season_of_day(d_day, cfg.season_cycle_days)],
        }))
    df = pd.concat(frames, ignore_index=True)
    return df.sort_values(["day", "user_id"], kind="stable").reset_index(drop=True)


def generate_dataset(cfg: DataConfig):
    """items (enriched), users, transactions — the whole synthetic world.

    ``items.latent_cluster`` is hidden generator ground truth kept for
    diagnostics only (``cluster_oracle_recall``); no feature/ETL path reads
    it."""
    rng = np.random.default_rng(cfg.seed)
    items = generate_items(cfg, rng)
    items["latent_cluster"] = _assign_item_clusters(
        items, cfg.n_item_clusters or max(cfg.num_items // 64, 8), rng)
    if cfg.name_style_words > 0:
        _add_style_words(items, rng, cfg.name_style_words)
    enriched = [enrich_item(r) for r in items.to_dict("records")]
    items["reinforced_feature"] = [e["reinforced_feature_value"] for e in enriched]
    users = generate_users(cfg, rng)
    tx = generate_transactions(cfg, items, users, rng)
    return items, users, tx


def cluster_oracle_recall(items: pd.DataFrame, tx: pd.DataFrame,
                          split_day: int, k: int = 100,
                          max_users: int = 2000) -> dict:
    """Learnability ceiling diagnostic (no training): for each target user,
    rank items by global train popularity *within the latent clusters seen in
    the user's own train history*, then back-fill with global popularity, and
    score Recall@k against the post-split window. A world where this beats
    the popularity baseline by a wide margin has per-user structure a
    sequence/graph model can actually learn."""
    cluster = items["latent_cluster"].to_numpy()
    item_pos = {it: i for i, it in enumerate(items["item_id"])}
    train = tx[tx["day"] < split_day]
    valid = tx[tx["day"] >= split_day]
    pop = np.zeros(len(items))
    vc = train["item_id"].value_counts()
    pop[[item_pos[i] for i in vc.index]] = vc.to_numpy()
    pop_rank = np.argsort(-pop, kind="stable")
    hist = train.groupby("user_id")["item_id"].agg(list)
    target_users = valid["user_id"].unique()
    if len(target_users) > max_users:   # O(N) per user — sample at scale
        target_users = np.random.default_rng(0).choice(
            target_users, max_users, replace=False)
        valid = valid[valid["user_id"].isin(set(target_users))]
    hits_o = hits_p = total = 0
    for uid, g in valid.groupby("user_id"):
        targets = {item_pos[i] for i in dict.fromkeys(g["item_id"])}
        total += len(targets)
        hits_p += len(targets & set(pop_rank[:k].tolist()))
        if uid not in hist.index:
            hits_o += len(targets & set(pop_rank[:k].tolist()))
            continue
        seen_cl = {cluster[item_pos[i]] for i in hist.loc[uid]}
        in_cl = pop_rank[np.isin(cluster[pop_rank], list(seen_cl))]
        cand = np.concatenate([in_cl, pop_rank[~np.isin(cluster[pop_rank],
                                                        list(seen_cl))]])[:k]
        hits_o += len(targets & set(cand.tolist()))
    return {"oracle_recall": hits_o / max(total, 1),
            "popularity_recall": hits_p / max(total, 1),
            "k": k, "target_rows": total}
