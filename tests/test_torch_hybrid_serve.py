"""The serving side of the hybrid slice on the CPU, against the JAX package:
the hybrid user vectorizer's batch, the blend (host and device forms) and the
rerank recipe on the same assets, the asset loader, and the HTTP recipe modes
with the flagged cosine fall-back.

Tolerances: lists exactly (the same scoring on the same float32 inputs); the
vectorizer's batch exactly; asset arrays exactly.
"""

import numpy as np
import pytest
import torch

from recsys_tpu.config import Config as JaxConfig
from recsys_tpu.config import ItemTowerConfig as JaxItemTowerConfig
from recsys_tpu.config import ServeConfig as JaxServeConfig
from recsys_tpu.serve import app as JA
from recsys_tpu.serve import recommend as JR
from recsys_tpu_torch.config import Config, DataConfig, ItemTowerConfig, ServeConfig
from recsys_tpu_torch.eval import rerank_eval as TRE
from recsys_tpu_torch.serve import app as TA
from recsys_tpu_torch.serve import recommend as TR

N, D = 60, 16


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs several workers on few cores: torch's default of one
    thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class LinearScorer:
    """A ranker both packages call the same way: a fixed logistic score of
    the pair features."""

    def __init__(self, seed=0):
        self.w = np.random.default_rng(seed).normal(size=TRE.NUM_FEATURES)

    def predict_proba(self, X):
        return 1.0 / (1.0 + np.exp(-(np.asarray(X, np.float64) @ self.w)))


def _arrays(seed):
    rng = np.random.default_rng(seed)
    ids = [f"p{i}" for i in range(N)]
    mat = rng.normal(size=(N + 1, D)).astype(np.float32)
    mat[0] = 0
    q = rng.dirichlet(np.ones(N))
    logq = np.concatenate([[-20.0], np.log(q)]).astype(np.float32)
    price = np.concatenate([[0.0], rng.uniform(0, 3, N)]).astype(np.float32)
    return ids, mat, logq, price


def _asset_pair(seed=7, ranker=True):
    ids, mat, logq, price = _arrays(seed)
    scorer = LinearScorer(seed) if ranker else None
    return (TR.RecommendAssets(ids, mat, logq, price, scorer, "hybrid", device="cpu"),
            JR.RecommendAssets(ids, mat, logq, price, scorer, "hybrid"))


HISTS = [np.array([1, 2, 3]), np.array([], np.int64), np.array([5, 5, 9, 11, 2, 7, 30, 31, 32]),
         np.array([N])]


@pytest.mark.parametrize("alpha,beta,k", [(0.1, 1.0, 8), (0.0, 0.0, 5), (0.9, 0.3, 16)])
def test_blend_host_device_and_jax_lists_are_equal(alpha, beta, k):
    t, j = _asset_pair(ranker=False)
    uv = np.random.default_rng(1).normal(size=(4, D)).astype(np.float32)
    host = TR.blend_topk(t, uv, HISTS, alpha, beta, k, backend="host")
    dev = TR.blend_topk(t, uv, HISTS, alpha, beta, k, backend="device")
    ref = JR.blend_topk(j, uv, HISTS, alpha, beta, k, backend="host")
    np.testing.assert_array_equal(host, ref)
    np.testing.assert_array_equal(dev, host)
    np.testing.assert_array_equal(TR.blend_topk(t, uv, HISTS, alpha, beta, k, backend="auto"),
                                  host)                  # "auto" on a CPU asset: the host
    with pytest.raises(ValueError, match="blend backend"):
        TR.blend_topk(t, uv, HISTS, alpha, beta, k, backend="tpu")


@pytest.mark.skipif(torch.cuda.is_available(), reason="the default device exists here")
def test_bare_assets_default_to_the_card_and_raise_without_one():
    """Assets built without a ``device`` ask for the card: ``"auto"`` scores
    on it, and on a box without one it raises instead of scoring on the host."""
    ids, mat, logq, price = _arrays(7)
    assets = TR.RecommendAssets(ids, mat, logq, price)
    assert assets.device == "cuda"
    uv = np.random.default_rng(1).normal(size=(2, D)).astype(np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TR.blend_topk(assets, uv, HISTS[:2], 0.1, 1.0, 5, backend="auto")


def test_rerank_serve_topk_equals_jax():
    t, j = _asset_pair()
    uv = np.random.default_rng(2).normal(size=(3, D)).astype(np.float32)
    ev = [(np.array([1, 2, 2]), np.array([10, 20, 25])),
          (np.empty(0, np.int64), np.empty(0, np.int64)), (np.array([5]), np.array([30]))]
    kw = dict(now_day=31, k=8, pool_size=32, m_cos=10, m_pop=5)
    got = TR.rerank_serve_topk(t, uv, ev, **kw)
    np.testing.assert_array_equal(got, JR.rerank_serve_topk(j, uv, ev, **kw))
    assert got.shape == (3, 8) and (got[0] > 0).all()
    np.testing.assert_array_equal(t.pop_ranking(10), j.pop_ranking(10))
    np.testing.assert_array_equal(t.items_norm, j.items_norm)
    np.testing.assert_array_equal(t.pop_norm, j.pop_norm)
    t.ranker = None
    with pytest.raises(ValueError, match="ranker"):
        TR.rerank_serve_topk(t, uv, ev, **kw)


def test_load_recommend_assets_round_trip_equals_jax(tmp_path):
    import pandas as pd

    from recsys_tpu_torch.train.checkpoint import save_array_with_ids
    from recsys_tpu_torch.train.reranker import GBDTRanker

    rng = np.random.default_rng(5)
    root = str(tmp_path)
    ids = [f"it{i:03d}" for i in range(10)]
    mat = rng.normal(size=(11, 4)).astype(np.float32)
    mat[0] = 0
    save_array_with_ids(f"{root}/hybrid_item_matrix", mat, ids)
    pd.DataFrame({"item_id": ids, "raw_probability": np.linspace(0.01, 0.2, 10),
                  "avg_item_price_log": np.linspace(1.0, 2.0, 10)}).to_parquet(
        f"{root}/features_item.parquet")
    cfg = Config(data=DataConfig(root=root))
    ref = JR.load_recommend_assets(JaxConfig(data=cfg.data), "hybrid")  # before the port's
    X = rng.normal(size=(200, TRE.NUM_FEATURES)).astype(np.float32)     # ranker (its format)
    ranker = GBDTRanker(iterations=5, device="cpu").fit(X, (X[:, 0] > 0).astype(np.float32))
    ranker.save(f"{root}/rerank_gbdt_hybrid.pkl")
    a = TR.load_recommend_assets(cfg, "hybrid", device="cpu")
    assert a.item_ids == ref.item_ids == ids and a.vectors == "hybrid"
    for k in ("item_matrix", "logq", "price_log"):
        np.testing.assert_array_equal(getattr(a, k), getattr(ref, k))
    assert a.idx_of("it003") == 4 and a.pid_of(4) == "it003" and a.idx_of("x") == 0
    np.testing.assert_array_equal(a.ranker.predict_proba(X), ranker.predict_proba(X))
    with pytest.raises(FileNotFoundError):
        TR.load_recommend_assets(cfg, "stage2", device="cpu")
    import os

    os.remove(f"{root}/rerank_gbdt_hybrid.pkl")
    assert TR.load_recommend_assets(cfg, "hybrid", device="cpu").ranker is None
    with pytest.raises(FileNotFoundError):
        TR.load_recommend_assets(cfg, "hybrid", require_ranker=True, device="cpu")


def _ctx_pair(assets_pair, mode):
    """The port's and the JAX package's app contexts over the same products
    and the same user (u1: five purchases, p3 twice)."""
    out = []
    for A, cfg, assets in ((TA, Config(item_tower=ItemTowerConfig(dim=D),
                                       serve=ServeConfig(db_path=":memory:", mode=mode)),
                            assets_pair[0]),
                           (JA, JaxConfig(item_tower=JaxItemTowerConfig(dim=D),
                                          serve=JaxServeConfig(db_path=":memory:", mode=mode)),
                            assets_pair[1])):
        ctx = A.build_app_context(cfg)
        ctx.rec_assets = assets
        ctx.store.ingest_products([{"product_id": p, "product_name": f"item {p}",
                                    "feature_data": {"reinforced_feature": {"CAT": ["shirt"]}}}
                                   for p in assets.item_ids])
        while ctx.process_pending()["processed_count"]:
            pass
        events = [{"product_id": f"p{i}", "action_type": 3, "ts": day * 86400.0}
                  for i, day in [(3, 10), (3, 40), (7, 25), (12, 55), (20, 55)]]
        assert ctx.store.insert_manual_data([{"user_id": "u1"}],
                                            [{"user_id": "u1", "events": events}])["ok"]
        assert ctx.refresh_user_vectors()["count"] == 1
        out.append(ctx)
    return out


def test_recipe_modes_equal_jax_and_fall_back_flagged():
    tctx, jctx = _ctx_pair(_asset_pair(), mode="rerank")
    np.testing.assert_allclose(tctx.store.get_user_vector("u1"), jctx.store.get_user_vector("u1"))
    for mode in ("rerank", "blend"):
        got = tctx.recommend_for_user("u1", top_k=10, mode=mode)
        ref = jctx.recommend_for_user("u1", top_k=10, mode=mode)
        assert got == ref and got["mode"] == mode and len(got["results"]) == 10
    assert tctx.recommend_for_user("u1", top_k=5)["mode"] == "rerank"     # the configured mode
    cos = tctx.recommend_for_user("u1", top_k=5, mode="cosine")
    assert "mode" not in cos and "p3" not in [r["product_id"] for r in cos["results"]]
    tctx.rec_assets.ranker = jctx.rec_assets.ranker = None               # no ranker: rerank falls back
    got = tctx.recommend_for_user("u1", top_k=5, mode="rerank")
    assert got == jctx.recommend_for_user("u1", top_k=5, mode="rerank")
    assert got["requested_mode"] == "rerank" and got["mode"] == "cosine" and got["fallback"]
    assert tctx.recommend_for_user("u1", top_k=5, mode="blend")["mode"] == "blend"
    tctx.rec_assets = jctx.rec_assets = None                             # no assets at all
    got = tctx.recommend_for_user("u1", top_k=5, mode="blend")
    assert got == jctx.recommend_for_user("u1", top_k=5, mode="blend")
    assert got["requested_mode"] == "blend" and got["mode"] == "cosine"
    assert tctx.recommend_for_user("nobody", mode="blend")["results"] == []


def test_hybrid_user_vectorizer_builds_the_jax_batch():
    """The port's batch (ids left-padded, newest last, time buckets, mask)
    and GNN rows (the artifact's, zeros for an unseen user) are the JAX
    vectorizer's, whose batch is padded to a power-of-two bucket."""
    tctx, jctx = _ctx_pair(_asset_pair(ranker=False), mode="cosine")
    got, ref = {}, {}

    def t_stub(batch, gnn_user):
        got["batch"] = {k: v.numpy() for k, v in batch.items()}
        got["gnn"] = gnn_user.numpy()
        return torch.ones(batch["input_ids"].shape[0], 8)

    def j_stub(params, batch, gnn_user):
        ref["batch"] = {k: np.asarray(v) for k, v in batch.items()}
        ref["gnn"] = np.asarray(gnn_user)
        return np.ones((batch["input_ids"].shape[0], 8), np.float32)

    item_ids = ["<pad>"] + [f"p{i}" for i in range(N)]
    gnn_user_of = {"u1": np.full(4, 0.5, np.float32)}
    profiles = [{"user_id": "u1"}, {"user_id": "nobody"}]
    t_out = TA.hybrid_user_vectorizer(tctx, tctx.cfg, t_stub, item_ids, gnn_user_of, 4, "cpu")(
        profiles)
    j_out = JA.hybrid_user_vectorizer(jctx, jctx.cfg, {}, j_stub, item_ids, gnn_user_of,
                                      gnn_dim=4)(profiles)
    assert t_out.shape == j_out.shape == (2, 8)
    assert ref["batch"]["input_ids"].shape[0] == 8 and got["batch"]["input_ids"].shape[0] == 2
    for k, v in got["batch"].items():
        np.testing.assert_array_equal(v, ref["batch"][k][:2], err_msg=k)
    np.testing.assert_array_equal(got["gnn"], ref["gnn"][:2])
    L = tctx.cfg.user_tower.max_len
    row = got["batch"]["input_ids"][0]
    assert (row[:L - 5] == 0).all() and (row[L - 5:] > 0).all() and not got["gnn"][1].any()
