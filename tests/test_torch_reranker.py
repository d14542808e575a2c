"""The reranker stack of the port against the JAX package: DCN / DeepFM
forward with bridged weights, five optimizer steps of each trainer from the
same weights on the same batches, the learning tests of tests/test_reranker.py,
retrieve-then-rerank, and the numpy feature / eval helpers (exact equality).

Both sides are fp32 on the CPU. Forwards are held to 1e-5; parameters after
five Adam steps at lr 3e-3 to 1e-4 (an early Adam update is ~lr * sign(g), so
rounding in g of an entry near zero moves it by more than rounding itself).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import recsys_tpu.data.ranker_features as JRF
import recsys_tpu.eval.rerank_eval as JRE
import recsys_tpu.models.reranker as JM
import recsys_tpu.train.reranker as JR
import recsys_tpu_torch.data.ranker_features as TRF
import recsys_tpu_torch.eval.rerank_eval as TRE
import recsys_tpu_torch.models.reranker as TM
import recsys_tpu_torch.train.reranker as TR
from recsys_tpu import config as JC
from recsys_tpu.data.dataset import IdMap
from recsys_tpu_torch import config as TC
from recsys_tpu_torch.bridge import flax_to_torch, load_flax_params, torch_to_flax

SMALL = dict(deep_hidden=(32, 16), fm_embed_dim=8)
LEARN = dict(epochs=60, batch_size=256, deep_hidden=(32, 16))   # tests/test_reranker.py CFG


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    return (JC.Config(reranker=JC.RerankerConfig(**kw)),
            TC.Config(reranker=TC.RerankerConfig(**kw)))


def _shake(params, seed):
    """Flax starts biases at 0: move every leaf so that a dropped or swapped
    parameter would show."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, 0.05, np.shape(a)).astype(np.float32),
        jax.device_get(params))


def _synthetic_ranking_problem(n=3000, seed=0):
    """Label depends on two_tower_score + price fit -> learnable."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n, 16)).astype(np.float32)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    i = rng.normal(size=(n, 16)).astype(np.float32)
    i /= np.linalg.norm(i, axis=1, keepdims=True)
    um = rng.normal(size=(n, 3)).astype(np.float32)
    im = rng.normal(size=(n, 2)).astype(np.float32)
    X = TRF.build_rank_features(u, i, um, im)
    logit = np.clip(3.0 * X[:, 0] - 1.5 * np.abs(X[:, 9]) + 0.5 * X[:, 7], -60, 60)
    y = (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(np.int32)
    return X, y


# -- models ---------------------------------------------------------------------

def test_dcn_forward_and_score_for_user_match_flax():
    jcfg, tcfg = _cfgs(**SMALL)
    x = np.random.default_rng(0).normal(size=(24, 10)).astype(np.float32)
    jm = JM.DCNRanker(jcfg.reranker)
    params = _shake(jm.init(jax.random.PRNGKey(1), jnp.asarray(x[:2]))["params"], 1)
    assert set(params) == {"CrossNet_0", "MLP_0", "score"}
    tm = load_flax_params(TM.DCNRanker(10, tcfg.reranker), params).eval()
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    np.testing.assert_allclose(tm(torch.as_tensor(x)).detach().numpy(), ref, atol=1e-5, rtol=0)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x[0, :4]), jnp.asarray(x[:, 4:]),
                              method=JM.DCNRanker.score_for_user))
    got = tm.score_for_user(torch.as_tensor(x[0, :4]), torch.as_tensor(x[:, 4:]))
    assert got.shape == (24,)
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("num_dense", [0, 5], ids=["sparse", "with_dense"])
def test_deepfm_forward_matches_flax(num_dense):
    jcfg, tcfg = _cfgs(**SMALL)
    sizes = (7, 11, 5, 13)
    rng = np.random.default_rng(2)
    ids = np.stack([rng.integers(0, s, 30) for s in sizes], 1).astype(np.int32)
    dense = rng.normal(size=(30, num_dense)).astype(np.float32) if num_dense else None
    jm = JM.DeepFM(sizes, jcfg.reranker, num_dense=num_dense)
    jargs = (jnp.asarray(ids),) + ((jnp.asarray(dense),) if num_dense else ())
    params = _shake(jm.init(jax.random.PRNGKey(0), *jargs)["params"], 2)
    assert ("dense_embed" in params) == bool(num_dense) and params["bias"].shape == ()
    tm = load_flax_params(TM.DeepFM(sizes, tcfg.reranker, num_dense=num_dense), params).eval()
    # the dense block is one more field of the FM term and of the deep input
    assert tm.MLP_0.Dense_0.in_features == (len(sizes) + bool(num_dense)) * 8
    targs = (torch.as_tensor(ids),) + ((torch.as_tensor(dense),) if num_dense else ())
    ref = np.asarray(jm.apply({"params": params}, *jargs))
    np.testing.assert_allclose(tm(*targs).detach().numpy(), ref, atol=1e-5, rtol=0)


def test_dropout_follows_the_mode_and_the_trainers_keep_it_off():
    _, tcfg = _cfgs(dropout=0.5, **SMALL)
    m = TM.DCNRanker(10, tcfg.reranker)
    x = torch.randn(64, 10, generator=torch.Generator().manual_seed(0))
    m.eval()
    assert torch.equal(m(x), m(x))
    m.train()
    assert not torch.equal(m(x), m(x))
    X, y = _synthetic_ranking_problem(300)
    cfg = dataclasses.replace(tcfg, reranker=dataclasses.replace(tcfg.reranker, epochs=1))
    _, model, _ = TR.train_dcn(cfg, X, y, device="cpu")
    assert not model.training


@pytest.mark.parametrize("kind", ["dcn", "deepfm"])
def test_bridge_round_trips(kind):
    _, tcfg = _cfgs(**SMALL)
    tm = (TM.DCNRanker(10, tcfg.reranker) if kind == "dcn"
          else TM.DeepFM((4, 6), tcfg.reranker, num_dense=3))
    with torch.no_grad():
        for p in tm.parameters():
            p.add_(torch.randn(p.shape, generator=torch.Generator().manual_seed(1)) * 0.1)
    tree = torch_to_flax(tm)
    if kind == "dcn":
        assert set(tree) == {"CrossNet_0", "MLP_0", "score"}
        assert tree["CrossNet_0"]["cross_2"]["kernel"].shape == (10, 10)
        assert tree["score"]["kernel"].shape == (10 + 16, 1)
    else:
        assert set(tree) == {"fm_embed_0", "fm_first_0", "fm_embed_1", "fm_first_1",
                             "dense_embed", "MLP_0", "bias"}
        assert tree["fm_first_1"]["embedding"].shape == (6, 1) and tree["bias"].shape == ()
        assert tree["MLP_0"]["Dense_2"]["kernel"].shape == (16, 1)
    sd = flax_to_torch(tree)
    assert set(sd) == set(tm.state_dict())
    for k, v in tm.state_dict().items():
        assert torch.equal(sd[k], v), k


# -- five optimizer steps ----------------------------------------------------------

def _assert_params_close(tmodel, jparams, start, atol=1e-4, skip=()):
    got = torch_to_flax(tmodel)
    flat_ref = jax.tree_util.tree_leaves_with_path(jax.device_get(jparams))
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    moved = 0.0
    for (path, ref), (_, first) in zip(flat_ref, jax.tree_util.tree_leaves_with_path(start)):
        if jax.tree_util.keystr(path) in skip:
            continue
        np.testing.assert_allclose(flat_got[path], np.asarray(ref), atol=atol, rtol=0,
                                   err_msg=str(path))
        moved = max(moved, float(np.abs(np.asarray(ref) - np.asarray(first)).max()))
    assert moved > 5e-3            # five Adam steps at lr 3e-3 did move them


@pytest.mark.parametrize("loss", ["bce", "pairwise"])
def test_five_steps_of_train_dcn_match(loss):
    jcfg, tcfg = _cfgs(epochs=1, batch_size=120, loss=loss, **SMALL)
    X, y = _synthetic_ranking_problem(600)
    groups = None
    if loss == "pairwise":
        groups = np.repeat(np.arange(100, dtype=np.int32), 6)
        y = np.zeros((100, 6), np.int32)
        y[np.arange(100), np.random.default_rng(0).integers(0, 6, 100)] = 1
        y = y.reshape(-1)
    jstate, jmodel, jscore = JR.train_dcn(jcfg, X, y, groups=groups)
    assert int(jstate.step) == 5
    Xs = ((X - X.mean(0, keepdims=True)) / (X.std(0, keepdims=True) + 1e-6)).astype(np.float32)
    start = jax.device_get(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(Xs[:2]))["params"])
    tstate, tmodel, tscore = TR.train_dcn(tcfg, X, y, groups=groups, device="cpu",
                                          init_state=flax_to_torch(start))
    assert tstate.step == 5 and len(tstate.step_seconds) == 5 and len(tstate.losses) == 1
    # a shift of every logit cancels in logit - pos: the pairwise gradient of the
    # score bias is exactly zero, and Adam turns each side's rounding noise into
    # steps of ~lr in either direction
    skip = ("['score']['bias']",) if loss == "pairwise" else ()
    _assert_params_close(tmodel, jstate.params, start, skip=skip)
    got, ref = tscore(X[:50]), jscore(X[:50])
    if loss == "pairwise":           # the scores agree up to that one shift of the logits
        shift = np.log(got / (1 - got)) - np.log(ref / (1 - ref))
        assert float(shift.max() - shift.min()) <= 2e-4
    else:
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("with_dense", [False, True], ids=["sparse", "with_dense"])
def test_five_steps_of_train_deepfm_match(with_dense):
    jcfg, tcfg = _cfgs(epochs=1, batch_size=100, **SMALL)
    rng = np.random.default_rng(4)
    sizes = (9, 12, 6)
    ids = np.stack([rng.integers(0, s, 500) for s in sizes], 1).astype(np.int32)
    dense = rng.normal(size=(500, 4)).astype(np.float32) if with_dense else None
    y = ((ids[:, 0] % 3) == (ids[:, 1] % 3)).astype(np.int32)
    jstate, jmodel, jscore = JR.train_deepfm(jcfg, ids, dense, y, sizes)
    assert int(jstate.step) == 5
    init_args = (jnp.asarray(ids[:2]),) + ((jnp.asarray(dense[:2]),) if with_dense else ())
    start = jax.device_get(jmodel.init(jax.random.PRNGKey(0), *init_args)["params"])
    tstate, tmodel, tscore = TR.train_deepfm(tcfg, ids, dense, y, sizes, device="cpu",
                                             init_state=flax_to_torch(start))
    assert tstate.step == 5
    _assert_params_close(tmodel, jstate.params, start)
    np.testing.assert_allclose(tscore(ids[:40], None if dense is None else dense[:40]),
                               jscore(ids[:40], None if dense is None else dense[:40]),
                               atol=1e-4, rtol=0)


def test_pairwise_refuses_ragged_groups():
    _, tcfg = _cfgs(epochs=1, loss="pairwise", **SMALL)
    X, y = _synthetic_ranking_problem(60)
    groups = np.repeat(np.arange(12), 5)
    groups[-1] = 0
    with pytest.raises(ValueError, match="constant group size"):
        TR.train_dcn(tcfg, X, y, groups=groups, device="cpu")


# -- the learning tests of tests/test_reranker.py -----------------------------------

def test_auc_score_is_the_jax_package_s():
    rng = np.random.default_rng(0)
    y = rng.integers(0, 2, 300)
    for scores in (rng.normal(size=300), rng.integers(0, 5, 300).astype(np.float64),
                   np.full(300, 0.5)):
        assert TR.auc_score(y, scores) == JR.auc_score(y, scores)
    assert TR.auc_score(np.ones(4, int), np.arange(4.0)) == 0.5


def test_dcn_ranker_learns():
    _, tcfg = _cfgs(**LEARN)
    X, y = _synthetic_ranking_problem()
    state, model, predict = TR.train_dcn(tcfg, X[:2400], y[:2400], device="cpu")
    assert state.losses[-1] < state.losses[0]
    assert TR.auc_score(y[2400:], predict(X[2400:])) > 0.7


def test_deepfm_learns():
    _, tcfg = _cfgs(**LEARN)
    rng = np.random.default_rng(2)
    n = 4000
    ids = rng.integers(0, 20, size=(n, 3)).astype(np.int32)
    # label: field-0/field-1 interaction pattern
    y = ((ids[:, 0] % 4) == (ids[:, 1] % 4)).astype(np.int32)
    state, model, predict = TR.train_deepfm(tcfg, ids[:3000], None, y[:3000], (20, 20, 20),
                                            device="cpu")
    assert TR.auc_score(y[3000:], predict(ids[3000:])) > 0.8


def test_dcn_pairwise_groupwise_learns():
    _, tcfg = _cfgs(loss="pairwise", **LEARN)
    X, _ = _synthetic_ranking_problem()
    S = 6  # 1 positive + 5 negatives per group, importer layout
    n = (len(X) // S) * S
    X = X[:n]
    groups = np.repeat(np.arange(n // S, dtype=np.int32), S)
    logit = (3.0 * X[:, 0] - 1.5 * np.abs(X[:, 9]) + 0.5 * X[:, 7]).reshape(-1, S)
    y = np.zeros((n // S, S), np.int32)
    y[np.arange(n // S), logit.argmax(1)] = 1
    y = y.reshape(-1)
    split = (int(0.8 * n) // S) * S
    state, model, predict = TR.train_dcn(tcfg, X[:split], y[:split], groups=groups[:split],
                                         device="cpu")
    auc = TR.auc_score(y[split:], predict(X[split:]))
    assert auc > 0.65, auc


def test_rerank_system_end_to_end():
    rng = np.random.default_rng(3)
    N, D = 50, 16
    mat = rng.normal(size=(N + 1, D)).astype(np.float32)
    mat /= np.clip(np.linalg.norm(mat, axis=1, keepdims=True), 1e-9, None)
    mat[0] = 0
    meta = np.abs(rng.normal(size=(N + 1, 2))).astype(np.float32)
    kw = dict(scorer=lambda f: f[:, 0], retrieve_k=20, final_k=5)   # score = dot
    ids, proba = TR.ReRankingSystem(mat, meta, device="cpu", **kw).recommend(
        mat[7], np.zeros(3, np.float32))
    assert ids[0] == 7 and len(ids) == 5  # self retrieval survives rerank
    assert (proba[:-1] >= proba[1:]).all()
    ref_ids, ref_proba = JR.ReRankingSystem(mat, meta, **kw).recommend(
        mat[7], np.zeros(3, np.float32))
    np.testing.assert_array_equal(ids, ref_ids)
    np.testing.assert_allclose(proba, ref_proba, atol=1e-6)


@pytest.mark.parametrize("entry", ["train_dcn", "train_deepfm", "GBDTRanker", "ReRankingSystem",
                                   "cosine_topm"])
def test_entry_points_take_the_card_by_default_and_raise_without_one(entry):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    _, tcfg = _cfgs(epochs=1, **SMALL)
    X, y = _synthetic_ranking_problem(100)
    mat = np.eye(8, dtype=np.float32)
    calls = {
        "train_dcn": lambda: TR.train_dcn(tcfg, X, y),
        "train_deepfm": lambda: TR.train_deepfm(tcfg, np.zeros((100, 2), np.int32), None, y,
                                                (3, 3)),
        "GBDTRanker": lambda: TR.GBDTRanker(),
        "ReRankingSystem": lambda: TR.ReRankingSystem(mat, mat[:, :2], scorer=None),
        "cosine_topm": lambda: TRE.cosine_topm(mat, mat, 3, device=True),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


# -- numpy helpers: equal to the originals ------------------------------------------

def test_rank_features_cross_and_context_equal_the_originals():
    rng = np.random.default_rng(1)
    u, i = (rng.normal(size=(8, 16)).astype(np.float32) for _ in range(2))
    um = rng.normal(size=(8, 3)).astype(np.float32)
    im = rng.normal(size=(8, 2)).astype(np.float32)
    f = TRF.build_rank_features(u, i, um, im)
    assert f.shape == (8, 10) and f.dtype == np.float32
    np.testing.assert_array_equal(f, JRF.build_rank_features(u, i, um, im))
    assert TRF.RANK_FEATURE_NAMES == JRF.RANK_FEATURE_NAMES
    act, vel = rng.random(8), rng.random(8)
    np.testing.assert_array_equal(TRF.cross_features(um, im, act, vel),
                                  JRF.cross_features(um, im, act, vel))
    ctx_args = (np.array([0, 12]), np.array([0, 6]), np.array([10.0, 0.0]),
                np.array([2.0, 0.0]), np.array([1.0, 30.0]), np.array([0, 2]))
    ctx = TRF.context_vector(*ctx_args)
    assert ctx.shape == (2, 20) and ctx[0, 2] == 1.0 and ctx[1, 8] == 1.0
    np.testing.assert_array_equal(ctx, JRF.context_vector(*ctx_args))


def _tower_world():
    rng = np.random.default_rng(0)
    N, D = 50, 16
    item_matrix = np.concatenate([np.zeros((1, D), np.float32),
                                  rng.normal(size=(N, D)).astype(np.float32)])
    m = IdMap([f"i{j}" for j in range(N)])
    user_vecs = {"u1": item_matrix[1:11].mean(0), "u2": item_matrix[20:30].mean(0)}
    tx = pd.DataFrame({"user_id": ["u1", "u1", "u2", "ghost", "u2"],
                       "item_id": ["i0", "i1", "i20", "i3", "nope"]})
    return item_matrix, m, user_vecs, tx


def test_import_interactions_draw_the_same_rows_under_the_same_generator():
    item_matrix, m, user_vecs, tx = _tower_world()
    got = TRF.import_interactions(tx, 50, m, np.random.default_rng(7), neg_per_pos=5)
    ref = JRF.import_interactions(tx, 50, m, np.random.default_rng(7), neg_per_pos=5)
    assert got[2].sum() == 4 and (np.bincount(got[3])[np.unique(got[3])] == 6).all()
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    got = TRF.import_interactions_candidates(tx, user_vecs, item_matrix, m,
                                             np.random.default_rng(7), neg_per_pos=3, top_k=15)
    ref = JRF.import_interactions_candidates(tx, user_vecs, item_matrix, m,
                                             np.random.default_rng(7), neg_per_pos=3, top_k=15)
    assert got[2].sum() == 3 and (np.bincount(got[3]) == 4).all()
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    empty = TRF.import_interactions_candidates(tx[tx["user_id"] == "ghost"], user_vecs,
                                               item_matrix, m, np.random.default_rng(0))
    assert len(empty[0]) == 0


@pytest.fixture(scope="module")
def pool_world():
    rng = np.random.default_rng(5)
    U, N, D, P = 12, 40, 8, 16
    uv = rng.normal(size=(U, D)).astype(np.float32)
    im = rng.normal(size=(N + 1, D)).astype(np.float32)
    im[0] = 0
    tx_u, tx_i = rng.integers(0, U, 150), rng.integers(1, N + 1, 150)
    days = rng.integers(0, 60, 150)
    seen = [np.unique(tx_i[tx_u == r]) for r in range(U)]
    pop = np.argsort(-np.bincount(tx_i, minlength=N + 1))[:6]
    return dict(U=U, N=N, P=P, uv=uv, im=im, tx_u=tx_u, tx_i=tx_i, days=days, seen=seen,
                pop=pop, logq=rng.normal(size=N + 1).astype(np.float32),
                price=rng.random(N + 1).astype(np.float32))


def test_rerank_eval_functions_equal_the_originals(pool_world):
    w = pool_world
    ref_idx = JRE.pair_index(w["tx_u"], w["tx_i"], w["days"], w["N"] + 1)
    got_idx = TRE.pair_index(w["tx_u"], w["tx_i"], w["days"], w["N"] + 1)
    for a, b in zip(got_idx, ref_idx):
        np.testing.assert_array_equal(a, b)
    probe_u, probe_i = np.arange(12).repeat(3), np.tile([1, 5, 9], 12)
    np.testing.assert_array_equal(
        TRE.pair_lookup(got_idx[0], got_idx[1], probe_u, probe_i, w["N"] + 1),
        JRE.pair_lookup(ref_idx[0], ref_idx[1], probe_u, probe_i, w["N"] + 1))
    cos = TRE.cosine_topm(w["uv"], w["im"], 8, device=False)
    np.testing.assert_array_equal(cos, JRE.cosine_topm(w["uv"], w["im"], 8, device=False))
    pools, flags = TRE.build_pools(cos, w["seen"], w["pop"], w["P"])
    ref_pools, ref_flags = JRE.build_pools(cos, w["seen"], w["pop"], w["P"])
    np.testing.assert_array_equal(pools, ref_pools)
    np.testing.assert_array_equal(flags, ref_flags)
    kw = dict(hist_lens=np.bincount(w["tx_u"], minlength=w["U"]),
              user_last_day=np.array([w["days"][w["tx_u"] == r].max(initial=-1)
                                      for r in range(w["U"])]),
              user_price=np.random.default_rng(1).random(w["U"]).astype(np.float32))
    args = (pools, flags, w["uv"], w["im"], w["logq"], *got_idx, 60, w["N"] + 1, w["price"])
    feats = TRE.pool_features(*args, **kw)
    assert feats.shape == (w["U"], w["P"], TRE.NUM_FEATURES == 16 and 16)
    np.testing.assert_array_equal(feats, JRE.pool_features(*args, **kw))
    assert TRE.FEATURE_NAMES == JRE.FEATURE_NAMES

    class Scorer:                              # anything with predict_proba
        def predict_proba(self, X):
            return X[:, 12] + 0.1 * X[:, 2]

    np.testing.assert_array_equal(TRE.rerank_topk(Scorer(), feats, pools, 5),
                                  JRE.rerank_topk(Scorer(), feats, pools, 5))


def test_cosine_topm_device_branch_equals_the_host_branch(pool_world):
    w = pool_world
    host = TRE.cosine_topm(w["uv"], w["im"], 10, device=False)
    dev = TRE.cosine_topm(w["uv"], w["im"], 10, device=True, torch_device="cpu")
    assert dev.dtype == np.int64 and (dev != TRE.PAD).all()
    np.testing.assert_array_equal(dev, host)
    small = TRE.cosine_topm(w["uv"], w["im"], 10)        # few scores: the host form
    np.testing.assert_array_equal(small, host)
    pre = w["im"] / np.clip(np.linalg.norm(w["im"], axis=-1, keepdims=True), 1e-12, None)
    np.testing.assert_array_equal(
        TRE.cosine_topm(w["uv"], pre, 10, device=True, prenormalized=True, torch_device="cpu"),
        host)


def test_rerank_topk_takes_the_port_s_gbdt(pool_world):
    """``rerank_topk`` over a fitted ``GBDTRanker``: PAD never ranks, rows are
    sorted by the model's probability."""
    w = pool_world
    cos = TRE.cosine_topm(w["uv"], w["im"], 8, device=False)
    pools, flags = TRE.build_pools(cos, w["seen"], w["pop"], w["P"])
    idx = TRE.pair_index(w["tx_u"], w["tx_i"], w["days"], w["N"] + 1)
    feats = TRE.pool_features(pools, flags, w["uv"], w["im"], w["logq"], *idx, 60,
                              w["N"] + 1, w["price"])
    X = feats.reshape(-1, 16)
    y = (X[:, 4] > 0).astype(np.int32)                   # "seen" items are the positives
    model = TR.GBDTRanker(iterations=10, early_stopping=0, device="cpu").fit(X, y)
    top = TRE.rerank_topk(model, feats, pools, 4)
    assert top.shape == (w["U"], 4)
    proba = model.predict_proba(X).reshape(w["U"], w["P"])
    for r in range(w["U"]):
        real = top[r][top[r] != TRE.PAD]
        assert set(real) <= set(pools[r][pools[r] != TRE.PAD])
        got = [proba[r][list(pools[r]).index(i)] for i in real]
        assert got == sorted(got, reverse=True)
