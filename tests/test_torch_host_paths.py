"""The port's vectorized host data paths against the JAX package's loops,
bit for bit, on the CPU: recall over the users with targets, the id
mapping, the purchase windows and validation targets, the stage-2 tensors,
the GNN graph's edge list, and the rerank stages' side data.

The references are the JAX package's functions (``recsys_tpu.eval.recall``,
``data.etl``, ``data.dataset``, ``train.sasrec.prepare_stage2``,
``train.gnn.graph_from_transactions``); the ``_ref_*`` functions are the
loop forms of the three pieces that live only in the port's CLI. The float
results are compared with ``==``, not with a tolerance.
"""

import warnings

import numpy as np
import pandas as pd
import pytest
import torch

from recsys_tpu.config import Config as JaxConfig
from recsys_tpu.config import DataConfig as JaxDataConfig
from recsys_tpu.config import GNNConfig as JaxGNNConfig
from recsys_tpu.config import UserTowerConfig as JaxUserTowerConfig
from recsys_tpu.config import VocabConfig as JaxVocabConfig
from recsys_tpu.data import dataset as JD
from recsys_tpu.data import etl as JE
from recsys_tpu.eval import recall as JR
from recsys_tpu.ops import graph as jax_graph
from recsys_tpu.train import gnn as JG
from recsys_tpu.train import sasrec as JS
from recsys_tpu_torch.config import Config, DataConfig, GNNConfig, UserTowerConfig, VocabConfig
from recsys_tpu_torch.data import etl
from recsys_tpu_torch.data.dataset import (
    SIDE_FIELDS, IdMap, build_sasrec_tensors, build_side_info, target_index)
from recsys_tpu_torch.data.synthetic import generate_dataset
from recsys_tpu_torch.eval import recall as R
from recsys_tpu_torch.ops.graph import build_graph
from recsys_tpu_torch.pipeline import cli
from recsys_tpu_torch.train.gnn import graph_from_transactions, transaction_indices
from recsys_tpu_torch.train.sasrec import prepare_stage2


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# -- the loop forms of the CLI's own pieces -------------------------------------

def _ref_history_means(tx, item_map, mat):
    out = {}
    for uid, g in tx.groupby("user_id"):
        rows = [item_map.idx(i) for i in g["item_id"]]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)   # the mean of no rows
            out[uid] = mat[[r for r in rows if r > 0]].mean(0) if rows else mat[0]
    return out


def _ref_item_column(ifeats, column, item_map, rows):
    out = np.zeros(rows, np.float32)
    for iid, r in zip(item_map.ids, range(1, rows)):
        if iid in ifeats.index:
            out[r] = ifeats.loc[iid, column]
    return out


def _ref_inner_targets(lab_tx, item_map):
    out: dict = {}
    for u, i in zip(lab_tx["user_id"], lab_tx["item_id"]):
        ii = item_map.idx(i)
        if ii > 0:
            out.setdefault(u, set()).add(ii)
    return out


# -- recall -------------------------------------------------------------------

def _recall_case(n_users, width, n_items, seed):
    rng = np.random.default_rng(seed)
    topk = rng.integers(0, n_items, (n_users, width))           # PAD 0 among the entries
    topk[::3, 1] = topk[::3, 0]                                 # a repeated index in a row
    uids = [f"u{r}" for r in range(n_users)]
    targets = {}
    for r, u in enumerate(uids):
        kind = r % 7
        if kind == 0:
            continue                                            # no entry
        if kind == 1:
            targets[u] = set()                                  # an empty set
            continue
        s = set(rng.integers(1, n_items, rng.integers(1, 12)).tolist())
        s |= set(topk[r, rng.integers(0, width, rng.integers(0, 4))].tolist()) - {0}
        targets[u] = s or {1}
    targets["absent"] = {3, 4}                                  # a user not scored
    return topk, uids, targets


@pytest.mark.parametrize("n_users,width,ks,dtype", [
    (50, 12, (3, 5, 12), np.int64),        # k equal to the row width
    (50, 12, (20, 4), np.int64),           # k past the row width, unsorted ks
    (40, 8, (1,), np.int32),
    (9000, 6, (2, 6), np.int64),           # several chunks on the threads
])
def test_recall_matches_the_loop(n_users, width, ks, dtype):
    topk, uids, targets = _recall_case(n_users, width, 40, n_users)
    topk = topk.astype(dtype)
    assert R.recall_at_ks(topk, uids, targets, ks) == JR.recall_at_ks(topk, uids, targets, ks)
    table = R.TargetTable(uids, targets)
    for k in ks:
        ref = JR.recall_per_user(topk, uids, targets, k)
        for got in (R.recall_per_user(topk, uids, targets, k),
                    R.recall_per_user(topk, uids, targets, k, table=table)):
            assert got[1] == ref[1]
            assert got[0].dtype == np.float64 and np.array_equal(got[0], ref[0])
    # one table for many lists, as a sweep scores them
    for shift in (0, 1, 7):
        lists = np.roll(topk, shift, axis=1)
        assert R.recall_at_ks(lists, uids, targets, ks, table=table) == \
            JR.recall_at_ks(lists, uids, targets, ks)
    other = {u: s | {int(topk[r, 0])} - {0} for r, (u, s) in
             enumerate(zip(uids, (targets.get(u, set()) for u in uids)))}
    assert R.recall_at_ks(topk, uids, other, ks) == JR.recall_at_ks(topk, uids, other, ks)
    assert R.recall_at_ks(topk[:, :0], uids, targets, ks) == \
        JR.recall_at_ks(topk[:, :0], uids, targets, ks)


def test_recall_without_users_or_targets():
    empty = np.zeros((0, 5), np.int64)
    for ks in ((5,), (1, 5)):
        assert R.recall_at_ks(empty, [], {"u": {1}}, ks) == JR.recall_at_ks(empty, [], {"u": {1}},
                                                                            ks)
    topk = np.arange(12).reshape(3, 4)
    assert R.recall_at_ks(topk, ["a", "b", "c"], {"a": set()}, (2,)) == \
        {"recall@2": 0.0, "n_eval": 0}
    vals, kept = R.recall_per_user(empty, np.array([], dtype=object), {}, 3)
    assert vals.dtype == np.float64 and len(vals) == 0 and kept == []


# -- id mapping, windows, targets, stage-2 tensors -----------------------------

@pytest.fixture(scope="module")
def world():
    items, users, tx = generate_dataset(DataConfig(num_items=120, num_users=60, days=40,
                                                   seed=3))
    tx = tx.copy()
    last = int(tx["day"].max())
    u0, u1 = tx["user_id"].iloc[0], tx["user_id"].iloc[-1]
    extra = pd.DataFrame({
        "user_id": [u0, u0, u1, u1, "ghost", "ghost", users["user_id"].iloc[5]],
        "item_id": ["unknown_a", "unknown_b", "unknown_c", items["item_id"].iloc[2],
                    items["item_id"].iloc[3], items["item_id"].iloc[4], "unknown_d"],
        "day": [0, last - 9, last - 8, last - 8, 2, 3, last],
    })
    for col in tx.columns.difference(extra.columns):
        extra[col] = tx[col].iloc[0]
    return items, users, pd.concat([tx, extra[tx.columns]], ignore_index=True)


def _with_id_dtype(frames, dtype):
    out = []
    for f in frames:
        f = f.copy()
        for col in ("user_id", "item_id"):
            if col in f.columns:
                f[col] = f[col].astype(dtype)
        out.append(f)
    return out


@pytest.mark.parametrize("dtype", [object, "str"])
def test_idx_array_matches_idx(world, dtype):
    items, _, tx = _with_id_dtype(world, dtype)
    # ids that print as a missing value, a bool, or a float do
    printed = ["None", "nan", "True", "1", "1.0", "0.0", "-0.0", "7"]
    ids_of_map = [*sorted(items["item_id"].astype(str))[::2], *printed]
    item_map, ref_map = IdMap(ids_of_map), JD.IdMap(ids_of_map)
    for ids in (tx["item_id"], tx["item_id"].to_numpy(), list(tx["item_id"]), (),
                ["x", None, float("nan"), 7, "7"], np.array([3, 5, 3]),
                [None, "None", float("nan"), "nan", pd.NA, 1, 1.0, True, "1", None],
                np.array([0.0, -0.0, 1.0, np.nan, 1.0]), np.array([True, False, True]),
                pd.Series([None, "x", None, "None"], dtype=object, index=[5, 3, 9, 0]),
                pd.Series(["a", None, "nan"], dtype="str"), pd.Index(["7", "7", "None"])):
        got = item_map.idx_array(ids)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, ref_map.idx_array(ids))
    assert IdMap(["7", 7, "8"]).idx_array(["7", "8"]).tolist() == \
        JD.IdMap(["7", 7, "8"]).idx_array(["7", "8"]).tolist()  # the last "7" wins


@pytest.mark.parametrize("dtype", [object, "str"])
def test_windows_and_targets_match_the_loops(world, dtype):
    _, _, tx = _with_id_dtype(world, dtype)
    train_tx, valid_tx, _ = etl.time_split(tx, 7)
    for max_len in (1, 4, 50):
        got, ref = etl.make_sequences(train_tx, max_len), JE.make_sequences(train_tx, max_len)
        pd.testing.assert_frame_equal(got, ref, check_exact=True)
        for col in ("sequence", "sequence_deltas"):
            assert [list(map(type, v)) for v in got[col]] == \
                [list(map(type, v)) for v in ref[col]]
    got, ref = etl.make_validation_target(valid_tx), JE.make_validation_target(valid_tx)
    assert got == ref and list(got) == list(ref)
    assert [type(i) for v in got.values() for i in v] == [type(i) for v in ref.values() for i in v]
    assert etl.make_validation_target(valid_tx.iloc[:0]) == {}


@pytest.mark.parametrize("dtype", [object, "str"])
def test_prepare_stage2_matches_the_loops(world, dtype):
    items, users, tx = _with_id_dtype(world, dtype)
    cfg = Config(data=DataConfig(valid_days=7), vocab=VocabConfig(num_hash_buckets=64),
                 user_tower=UserTowerConfig(max_len=4))
    jcfg = JaxConfig(data=JaxDataConfig(valid_days=7), vocab=JaxVocabConfig(num_hash_buckets=64),
                     user_tower=JaxUserTowerConfig(max_len=4))
    got, ref = prepare_stage2(cfg, items, users, tx), JS.prepare_stage2(jcfg, items, users, tx)
    for key, value in ref["tensors"].items():
        if key == "user_ids":
            assert got["tensors"][key] == value
        else:
            assert got["tensors"][key].dtype == value.dtype
            np.testing.assert_array_equal(got["tensors"][key], value, err_msg=key)
    assert got["targets_idx"] == ref["targets_idx"]
    assert list(got["targets_idx"]) == list(ref["targets_idx"])
    assert "ghost" not in got["tensors"]["user_ids"]            # no user features
    # the frame path from etl.make_sequences, at a cut that drops unknown items
    train_tx, _, split_day = etl.time_split(tx, 7)
    user_feats, _ = etl.make_user_features(train_tx, users, split_day)
    item_map = got["item_map"]
    for max_len in (2, 3, 9):
        seqs = etl.make_sequences(train_tx, max_len)
        a = build_sasrec_tensors(seqs, user_feats, item_map, cfg.user_tower)
        b = JD.build_sasrec_tensors(seqs, user_feats, ref["item_map"], jcfg.user_tower)
        assert a["user_ids"] == b["user_ids"]
        for key in ("input_ids", "target_ids", "time_buckets", "seq_mask", "user_cont"):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    empty = build_sasrec_tensors(etl.make_sequences(train_tx.iloc[:0]), user_feats, item_map,
                                 cfg.user_tower)
    assert empty["input_ids"].shape == (0, 4) and empty["user_ids"] == []
    targets = {"a": ["unknown", items["item_id"].iloc[0]], "b": [], "c": ["unknown"]}
    assert target_index(targets, item_map) == \
        {u: {ref["item_map"].idx(i) for i in its} - {0} for u, its in targets.items()}


@pytest.mark.parametrize("dtype", [object, "str"])
def test_side_info_and_logq_match_the_loops(world, dtype):
    items, _, tx = _with_id_dtype(world, dtype)
    items = items.copy()
    field = items[SIDE_FIELDS[0]].astype(object)
    field.iloc[:3] = [None, float("nan"), ""]                   # None, NaN and "" hash apart
    items[SIDE_FIELDS[0]] = field
    items[SIDE_FIELDS[1]] = np.arange(len(items)) % 5           # an integer field
    for frame in (items, items.drop(columns=[SIDE_FIELDS[2]])):  # a missing field
        side, item_map = build_side_info(frame, 64)
        np.testing.assert_array_equal(side, JD.build_side_info(frame, 64)[0])
    train_tx, _, split_day = etl.time_split(tx, 7)
    feats = etl.make_item_features(train_tx, items, split_day)
    order = [*item_map.ids[::2], "unknown"]
    np.testing.assert_array_equal(etl.logq_from_item_features(feats, order),
                                  JE.logq_from_item_features(feats, order))


# -- the GNN graph -------------------------------------------------------------

def test_graph_matches_the_loops(world):
    items, _, tx = world
    tx = tx[~tx["item_id"].str.startswith("unknown")]
    user_ids = sorted(tx["user_id"].unique())
    item_ids = sorted(items["item_id"].astype(str))
    user_map = {u: r for r, u in enumerate(user_ids)}
    item_map = {i: r for r, i in enumerate(item_ids)}
    u, i = transaction_indices(tx, user_map, item_map)
    assert u.dtype == i.dtype == np.int64
    assert u.tolist() == [user_map[v] for v in tx["user_id"]]
    assert i.tolist() == [item_map[v] for v in tx["item_id"]]
    got = graph_from_transactions(tx, user_map, item_map, GNNConfig(svd_rank=3, svd_iters=2),
                                  seed=4)
    ref = JG.graph_from_transactions(tx, user_map, item_map,
                                     JaxGNNConfig(svd_rank=3, svd_iters=2), seed=4)
    for name in ("src", "dst", "weight", "svd_u", "svd_s", "svd_v"):
        a, b = getattr(got, name), getattr(ref, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=name)
    with pytest.raises(KeyError):
        transaction_indices(world[2], user_map, item_map)       # an unknown item


@pytest.mark.parametrize("users,items,n_users,n_items", [
    ([0, 3, 3, 1, 3, 0, 2], [4, 1, 1, 0, 1, 4, 2], 4, 5),       # duplicate pairs
    (np.array([2, 2, 0], np.int32), np.array([7, 3, 3], np.int32), 3, 5),  # past num_items
    ([], [], 2, 2),
])
def test_build_graph_dedups_as_the_row_unique(users, items, n_users, n_items):
    kw = {"svd_rank": 1, "svd_iters": 1, "pad_multiple": 8, "seed": 0}
    if len(users) and max(items) >= n_items:
        kw["svd_rank"] = 0
        n_items = max(items) + 1
    got = build_graph(np.asarray(users), np.asarray(items), n_users, n_items, **kw)
    ref = jax_graph.build_graph(np.asarray(users), np.asarray(items), n_users, n_items, **kw)
    for name in ("src", "dst", "weight"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name), err_msg=name)


# -- the rerank stages' side data ---------------------------------------------

@pytest.mark.parametrize("dtype", [object, "str"])
def test_rerank_side_data_matches_the_loops(world, dtype):
    items, _, tx = _with_id_dtype(world, dtype)
    ids = sorted(items["item_id"].astype(str))
    item_map = IdMap(ids[1::2])                                  # half the items unknown
    mat = np.random.default_rng(0).normal(size=(len(item_map) + 1, 5)).astype(np.float32)
    got, ref = cli.history_means(tx, item_map, mat), _ref_history_means(tx, item_map, mat)
    assert list(got) == list(ref)
    for u in ref:
        assert got[u].dtype == ref[u].dtype
        np.testing.assert_array_equal(got[u], ref[u], err_msg=str(u))
    assert any(np.isnan(v).all() for v in ref.values())        # a user of unknown items only
    ifeats = pd.DataFrame({"item_id": ids[::3], "price": np.linspace(0.5, 3, len(ids[::3])),
                           "pop": np.r_[np.nan, np.arange(len(ids[::3]) - 1.0)]})
    ifeats = ifeats.set_index("item_id")
    for col in ("price", "pop"):
        for rows in (len(item_map) + 1, 5):
            np.testing.assert_array_equal(cli.item_column(ifeats, col, item_map, rows),
                                          _ref_item_column(ifeats, col, item_map, rows))
    lab_idx = item_map.idx_array(tx["item_id"])
    known = lab_idx > 0
    inner = {u: set(its) for u, its in etl.grouped_lists(
        tx["user_id"].to_numpy()[known], lab_idx[known], sort=False).items()}
    ref = _ref_inner_targets(tx, item_map)
    assert inner == ref and list(inner) == list(ref)
