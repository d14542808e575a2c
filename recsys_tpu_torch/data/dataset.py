"""Fixed-shape tensorization: items for SimCSE, sequences for SASRec.

TPU-first redesign of the reference's Python DataLoader/collator stack
(SURVEY.md §3.2): ALL tokenization happens once, offline, producing dense
int tensors; the SimCSE two-view corruption becomes pure on-device masking
(see ``ops/augment.py``) instead of per-step dict surgery + 9 tokenizer
calls per item per view (the reference's worst CPU hot loop,
`item_tower.py:465-602`). Per-token *value ids* are stored so value-level
dropout (`_corrupt_data`, reference `item_tower.py:341-394`) can be
reproduced exactly as an array op.

Id convention (everywhere): model item index = 1 + row in the sorted item
master; 0 is PAD. The string-id <-> index map is saved as a sidecar next to
every artifact (see ``train/checkpoint.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from itertools import chain

import numpy as np
import pandas as pd

from recsys_tpu_torch.config import UserTowerConfig, VocabConfig
from recsys_tpu_torch.data import tokenizer as tok
from recsys_tpu_torch.data.vocab import RE_FEATURE_KEYS, StdVocab

# time-delta bucket edges in days (reference `v1_refine_usertower.py:212-214`)
TIME_BUCKET_EDGES = np.array([0, 3, 7, 14, 30, 60, 180, 330, 395])

SIDE_FIELDS = ("product_type_name", "graphical_appearance_name",
               "colour_group_name", "department_name")


def map_each(values, fn, dtype) -> np.ndarray:
    """``fn(v)`` of every value as one array, for a ``fn`` that reads only the
    value's ``str`` and its equality (``IdMap.idx``, a dict lookup): ``fn``
    is called once for each distinct value and once for each missing one.
    Objects that are not all strings go one at a time, since equal values
    of two types (1, 1.0, True) print apart."""
    if not isinstance(values, (np.ndarray, pd.Series, pd.Index)):
        values = np.asarray(list(values), dtype=object)
    if isinstance(values.dtype, np.dtype) and values.dtype.kind == "f":   # 0.0 == -0.0
        bits = np.asarray(values).view(f"i{values.dtype.itemsize}")
        codes, uniques = pd.factorize(bits)
        uniques = uniques.view(values.dtype)
    else:
        codes, uniques = pd.factorize(values)
    if values.dtype == object and not all(isinstance(u, str) for u in uniques):
        return np.fromiter(map(fn, values), dtype, len(values))
    out = np.fromiter(map(fn, uniques), dtype, len(uniques))[codes]
    missing = np.flatnonzero(codes < 0)    # None and NaN print apart
    out[missing] = np.fromiter(map(fn, values.take(missing)), dtype, len(missing))
    return out


@dataclass
class IdMap:
    """String id <-> 1-based model index (0 = PAD)."""

    ids: list[str]

    def __post_init__(self):
        self.to_idx = {str(i): r + 1 for r, i in enumerate(self.ids)}

    def __len__(self):
        return len(self.ids)

    def idx(self, id_: str) -> int:
        return self.to_idx.get(str(id_), 0)

    def idx_array(self, ids) -> np.ndarray:
        return map_each(ids, self.idx, np.int32)


# -- item tensorization (SimCSE / vectorization input) ---------------------

def tokenize_items(items: pd.DataFrame, vocab: StdVocab, cfg: VocabConfig) -> dict:
    """Item master -> dense tensors.

    Returns dict of numpy arrays over N items (sorted by item_id):
      std        (N, F)     STD categorical ids
      re_ids     (N, 9, T)  hashed token ids of RE field values
      re_mask    (N, 9, T)  1 where a real token
      re_value   (N, 9, T)  1-based index of the VALUE each token came from
      txt_ids    (N, Tn)    product-name token ids
      txt_mask   (N, Tn)
      item_ids   list[str]  row order (the id-map source of truth)
    """
    items = items.sort_values("item_id", kind="stable").reset_index(drop=True)
    n = len(items)
    F = vocab.num_fields
    T, Tn = cfg.max_field_tokens, cfg.max_name_tokens
    records = items.to_dict("records")
    std = np.zeros((n, F), dtype=np.int32)
    for r, row in enumerate(records):
        std[r] = vocab.encode_item(row)

    def _re_values(row):
        re_feat = row.get("reinforced_feature")
        if re_feat is None or (hasattr(re_feat, "__len__") and len(re_feat) == 0):
            re_feat = {}
        out = []
        for key in RE_FEATURE_KEYS:
            values = re_feat.get(key)  # may be list OR numpy array (parquet)
            out.append([] if values is None else [str(v) for v in values])
        return out

    from recsys_tpu_torch.data import native_pack
    if native_pack.native_available():
        # native C++ batch packer (bit-identical ids, ~14x the Python loop)
        names = [tagged_name(row) for row in records]
        txt_ids, txt_mask = native_pack.encode_batch(names, Tn, cfg.text_vocab_size)
        cells: list[list[str]] = []
        for row in records:
            cells.extend(_re_values(row))
        flat_ids, flat_mask, flat_val = native_pack.encode_fields(
            cells, T, cfg.text_vocab_size)
        re_ids = flat_ids.reshape(n, len(RE_FEATURE_KEYS), T)
        re_mask = flat_mask.reshape(n, len(RE_FEATURE_KEYS), T)
        re_value = flat_val.reshape(n, len(RE_FEATURE_KEYS), T)
    else:  # pure-Python fallback
        re_ids = np.zeros((n, len(RE_FEATURE_KEYS), T), dtype=np.int32)
        re_mask = np.zeros_like(re_ids)
        re_value = np.zeros_like(re_ids)
        txt_ids = np.zeros((n, Tn), dtype=np.int32)
        txt_mask = np.zeros((n, Tn), dtype=np.int32)
        for r, row in enumerate(records):
            for f, values in enumerate(_re_values(row)):
                pos = 0
                for v_i, value in enumerate(values):
                    for w in tok.normalize(value):
                        if pos >= T:
                            break
                        re_ids[r, f, pos] = tok.token_id(w, cfg.text_vocab_size)
                        re_mask[r, f, pos] = 1
                        re_value[r, f, pos] = v_i + 1
                        pos += 1
            txt_ids[r], txt_mask[r] = tok.encode(tagged_name(row), Tn,
                                                 cfg.text_vocab_size)

    return {
        "std": std, "re_ids": re_ids, "re_mask": re_mask, "re_value": re_value,
        "txt_ids": txt_ids, "txt_mask": txt_mask,
        "item_ids": list(items["item_id"].astype(str)),
    }


def tagged_name(row: dict) -> str:
    """Name tagging with category fallback (reference `train_simcse_from_db`
    name logic, `item_tower.py:930-948`): "name (Category: type)", falling
    back to type+appearance, else a fixed unknown marker."""
    name = str(row.get("product_name") or "").strip()
    ptype = str(row.get("product_type_name") or "").strip()
    if name and ptype:
        return f"{name} (Category: {ptype})"
    if name:
        return name
    if ptype:
        return f"{ptype} {row.get('graphical_appearance_name', '')}"
    return "unknown product"


def slice_item_batch(tensors: dict, idx: np.ndarray) -> dict:
    return {k: v[idx] for k, v in tensors.items() if k != "item_ids"}


# -- SASRec tensorization ---------------------------------------------------

def build_side_info(items: pd.DataFrame, num_buckets: int) -> tuple[np.ndarray, IdMap]:
    """(N+1, num_side_fields) hashed metadata ids aligned to model item
    indexing; row 0 = PAD (reference `load_item_metadata_hashed`,
    `v1_usertower_train.py:220-262`)."""
    items = items.sort_values("item_id", kind="stable").reset_index(drop=True)
    id_map = IdMap(list(items["item_id"].astype(str)))
    side = np.zeros((len(items) + 1, len(SIDE_FIELDS)), dtype=np.int32)
    for f, field in enumerate(SIDE_FIELDS):
        if field not in items.columns:
            continue                       # a missing field hashes to 0
        side[1:, f] = map_each(items[field],
                               lambda v, f=field: tok.hash_bucket(v, num_buckets, salt=f),
                               np.int32)
    return side, id_map


def build_sasrec_tensors(sequences: pd.DataFrame, user_feats: pd.DataFrame,
                         item_map: IdMap, cfg: UserTowerConfig) -> dict:
    """All-user fixed-shape SASRec training tensors from ``etl.make_sequences``'
    frame (see ``sasrec_tensors_from_windows``)."""
    lens = sequences["sequence"].map(len).to_numpy(np.int64)
    items = list(chain.from_iterable(sequences["sequence"]))
    deltas = np.fromiter(chain.from_iterable(sequences["sequence_deltas"]), np.int64,
                         len(items))
    return sasrec_tensors_from_windows(sequences["user_id"].to_numpy(), lens,
                                       item_map.idx_array(items), deltas, user_feats, cfg)


def sasrec_tensors_from_windows(user_ids: np.ndarray, lens: np.ndarray, items: np.ndarray,
                                deltas: np.ndarray, user_feats: pd.DataFrame,
                                cfg: UserTowerConfig) -> dict:
    """All-user fixed-shape SASRec training tensors from the windows of
    ``etl.sequence_windows`` with their items mapped to model indices.

    Drops unknown items (index 0), keeps each user's last L + 1 and
    left-pads so the latest event sits at the last position, with the
    causal shift input = seq[:-1], target = seq[1:] (reference
    `SASRecDataset`, `v1_refine_usertower.py:222-306`). Users with < 2
    known events, or without features, are dropped (nothing to predict).
    """
    L = cfg.max_len
    uf = user_feats.set_index("user_id")
    group = np.repeat(np.arange(len(lens)), lens)
    known = np.flatnonzero(items != 0)
    group = group[known]
    count = np.bincount(group, minlength=len(lens))
    span = np.minimum(count, L + 1)
    keep = (count >= 2) & pd.Index(user_ids, dtype=object).isin(uf.index)
    row = np.cumsum(keep) - 1
    back = np.cumsum(count)[group] - 1 - np.arange(len(known))   # 0 = the user's last
    sel = keep[group] & (back < span[group])
    group, back, known = group[sel], back[sel], known[sel]
    r = row[group]

    n = int(keep.sum())
    inp = np.zeros((n, L), dtype=np.int32)
    tgt = np.zeros((n, L), dtype=np.int32)
    tbk = np.zeros((n, L), dtype=np.int32)
    mask = np.zeros((n, L), dtype=np.int32)  # 1 = real position
    x = back >= 1                            # every event but the last is an input
    inp[r[x], L - back[x]] = items[known[x]]
    tbk[r[x], L - back[x]] = np.digitize(deltas[known[x]], TIME_BUCKET_EDGES[1:])
    mask[r[x], L - back[x]] = 1
    y = back <= span[group] - 2              # every event but the first is a target
    tgt[r[y], L - 1 - back[y]] = items[known[y]]
    user_ids = np.asarray(user_ids)[keep].tolist()

    sel = uf.loc[user_ids]
    from recsys_tpu_torch.data.etl import USER_BUCKET_COLS, USER_CAT_COLS, USER_CONT_COLS
    return {
        "input_ids": inp, "target_ids": tgt, "time_buckets": tbk, "seq_mask": mask,
        "user_buckets": sel[list(USER_BUCKET_COLS)].to_numpy(np.int32),
        "user_cats": sel[list(USER_CAT_COLS)].to_numpy(np.int32),
        "user_cont": sel[list(USER_CONT_COLS)].to_numpy(np.float32),
        "user_ids": user_ids,
    }


def target_index(targets: dict, item_map: IdMap) -> dict:
    """user_id -> the set of its target items' model indices, unknown items
    (index 0) left out; every user of ``targets`` keeps an entry."""
    idx = item_map.idx_array(list(chain.from_iterable(targets.values()))).tolist()
    ends = np.cumsum([len(v) for v in targets.values()], dtype=np.int64).tolist()
    return {u: set(idx[s:e]) - {0} for u, s, e in zip(targets, [0] + ends[:-1], ends)}


def batch_iterator(n: int, batch_size: int, rng: np.random.Generator | None = None,
                   drop_last: bool = True):
    """Shuffled fixed-size index batches (drop_last mirrors the reference's
    contrastive loops, which need full batches for the (B,B) similarity)."""
    order = rng.permutation(n) if rng is not None else np.arange(n)
    end = n - (n % batch_size) if drop_last else n
    for s in range(0, end, batch_size):
        yield order[s:s + batch_size]
