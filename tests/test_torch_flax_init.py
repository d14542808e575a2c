"""The port's init against the JAX package's, on the CPU
(``recsys_tpu_torch/models/flax_init.py``).

The primitives against ``jax.random`` and Flax's key folding, then every
model family at a small width: the port's init site (or ``init_from_seed``
with the JAX site's key) against the JAX site's own ``init`` (jitted where the
JAX package jits it). Tolerances, per element: keys and uniform-, zero-, one-
and constant-derived values bit-equal; normal- and truncated-normal-derived
values within 1e-6 x the initializer's std, absolute (an ulp bound fails near
zero, where one ulp of the uniform step is thousands of ulps of the output).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_tpu.config import Config as JaxConfig
from recsys_tpu.config import DataConfig as JaxDataConfig
from recsys_tpu.config import GNNConfig as JaxGNNConfig
from recsys_tpu.config import ItemTowerConfig as JaxItemTowerConfig
from recsys_tpu.config import RerankerConfig as JaxRerankerConfig
from recsys_tpu.config import UserTowerConfig as JaxUserTowerConfig
from recsys_tpu.config import VocabConfig as JaxVocabConfig
from recsys_tpu.data.dataset import tokenize_items
from recsys_tpu.data.synthetic import generate_dataset
from recsys_tpu.data.vocab import StdVocab
from recsys_tpu.models import hybrid_tower as JH
from recsys_tpu.models import lightgcl as JL
from recsys_tpu.models import reranker as JR
from recsys_tpu.models import user_tower as JU
from recsys_tpu.train import sasrec as JS
from recsys_tpu.train import simcse as JSC
from recsys_tpu_torch.bridge import torch_to_flax
from recsys_tpu_torch.config import Config, DataConfig, DistillConfig, GNNConfig
from recsys_tpu_torch.config import ItemTowerConfig, RerankerConfig, UserTowerConfig, VocabConfig
from recsys_tpu_torch.models import flax_init as FI
from recsys_tpu_torch.models import hybrid_tower as TH
from recsys_tpu_torch.models import reranker as TR
from recsys_tpu_torch.models import user_tower as TU
from recsys_tpu_torch.train import gnn as TG
from recsys_tpu_torch.train import hybrid as THT
from recsys_tpu_torch.train import reranker as TRT
from recsys_tpu_torch.train import sasrec as TS
from recsys_tpu_torch.train import simcse as TSC

TOWER = dict(d_model=32, max_len=8, nhead=2, num_layers=1, dropout=0.1)
ITEM = dict(dim=64, text_dim=64, head_hidden=(128,), fusion_layers=1, text_layers=1,
            pretrained_dim=48)
VOCAB = dict(max_field_tokens=8, max_name_tokens=8, text_vocab_size=512)
# leaves drawn from a normal or truncated normal; every other leaf is exact
NORMAL_LEAVES = {"kernel", "embedding", "std_field_embedding", "re_field_embedding",
                 "pos_embedding", "pretrained_embedding", "item_matrix"}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def assert_same_init(port: dict, ref: dict):
    """Same paths and shapes; exact leaves bit-equal, normal-derived leaves
    within 1e-6 x their std."""
    port, ref = _flat(port), _flat(ref)
    assert set(port) == set(ref)
    for path, want in ref.items():
        got = port[path]
        assert got.shape == want.shape, path
        if path.rsplit("/", 1)[-1] in NORMAL_LEAVES and want.size > 1:
            gap = np.abs(got.astype(np.float64) - want).max()
            assert gap <= 1e-6 * want.std(), (path, gap, want.std())
        else:
            np.testing.assert_array_equal(got, want, err_msg=path)


# -- primitives ------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 42, 2**33 + 5])
def test_key_is_prng_key(seed):
    np.testing.assert_array_equal(FI.key(seed), np.asarray(jax.random.PRNGKey(seed)))


def test_split_and_fold_in_match_jax():
    k = jax.random.PRNGKey(42)
    np.testing.assert_array_equal(FI.split(FI.key(42)), np.asarray(jax.random.split(k)))
    np.testing.assert_array_equal(FI.split(FI.key(42), 5), np.asarray(jax.random.split(k, 5)))
    for data in (0, 1, 123456789, 2**32 - 1):
        np.testing.assert_array_equal(FI.fold_in(FI.key(42), data),
                                      np.asarray(jax.random.fold_in(k, data)))


@pytest.mark.parametrize("shape", [(1,), (3, 7, 5), (1001,), (2, 0)])
def test_bits_match_jax(shape):
    np.testing.assert_array_equal(FI.random_bits(FI.key(7), shape),
                                  np.asarray(jax.random.bits(jax.random.PRNGKey(7), shape)))


def test_bits_are_drawn_in_chunks_with_one_counter(monkeypatch):
    want = FI.random_bits(FI.key(3), (5, 41))
    monkeypatch.setattr(FI, "CHUNK", 16)
    np.testing.assert_array_equal(FI.random_bits(FI.key(3), (5, 41)), want)


@pytest.mark.parametrize("bounds", [(0.0, 1.0), (-1.0, 1.0), (-0.3, 0.45), (2.0, 7.5)])
def test_uniform_matches_jax(bounds):
    want = jax.random.uniform(jax.random.PRNGKey(11), (3001,), minval=bounds[0],
                              maxval=bounds[1])
    np.testing.assert_array_equal(FI.uniform(FI.key(11), (3001,), *bounds), np.asarray(want))


def test_normal_matches_jax():
    want = np.asarray(jax.jit(lambda k: jax.random.normal(k, (200_000,)))(
        jax.random.PRNGKey(5)))
    got = FI.normal(FI.key(5), (200_000,))
    assert np.abs(got.astype(np.float64) - want).max() <= 1e-6


def test_truncated_normal_matches_jax():
    want = np.asarray(jax.random.truncated_normal(jax.random.PRNGKey(9), -2.0, 2.0,
                                                  (200_000,)))
    got = FI.truncated_normal(FI.key(9), (200_000,))
    assert np.abs(got.astype(np.float64) - want).max() <= 1e-6 * want.std()
    assert got.min() > -2 and got.max() < 2


def test_erf_constants_are_xla_s():
    sqrt2 = np.float32(np.sqrt(2))
    lo = jax.lax.erf(jnp.float32(-2) / sqrt2)
    hi = jax.lax.erf(jnp.float32(2) / sqrt2)
    assert FI.ERF_LO == np.float32(lo)
    assert FI.ERF_RANGE == np.float32(hi - lo)


def test_fma_rounds_once():
    """a * b is the float32 midpoint 1 + 2^-11 + 2^-24, and c = +-2^-80 is
    lost in the float64 sum: rounded once, the sign of c decides."""
    a = np.float32(1 + 2**-12)
    assert FI.fma(a, a, np.float32(2**-80)) == np.float32(1 + 2**-11 + 2**-23)
    assert FI.fma(a, a, np.float32(-2**-80)) == np.float32(1 + 2**-11)
    assert FI.fma(a, a, np.float32(0)) == np.float32(1 + 2**-11)      # the tie to even


# -- Flax's keys ------------------------------------------------------------------------

class _KeyLeaf(fnn.Module):
    """Parameters whose value is the key Flax gives them."""

    @fnn.compact
    def __call__(self, x):
        self.param("a", lambda k: k)
        self.param("b", lambda k: k)
        return x


class _KeyTree(fnn.Module):
    def setup(self):
        self.first = self.param("first", lambda k: k)
        self.child = _KeyLeaf(name="child")
        self.leaf = _KeyLeaf()
        self.second = self.param("second", lambda k: k)

    def __call__(self, x):
        return self.leaf(self.child(x))


class _KeyRoot(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        return _KeyTree(name="tree")(_KeyLeaf()(x))


def test_param_key_matches_flax_for_nested_paths():
    params = _KeyRoot().init(jax.random.PRNGKey(17), jnp.zeros(()))["params"]
    root = FI.key(17)
    want = {("_KeyLeaf_0",): ("a", "b"), ("tree",): ("first", "second"),
            ("tree", "child"): ("a", "b"), ("tree", "leaf"): ("a", "b")}
    flat = _flat(params)
    assert len(flat) == 8
    for path, names in want.items():
        for counter, name in enumerate(names, start=1):
            np.testing.assert_array_equal(FI.param_key(root, path, counter),
                                          flat["/".join(path + (name,))])


# -- the model families at the JAX package's init sites -----------------------------------

@pytest.fixture(scope="module")
def item_tensors():
    data = JaxDataConfig(num_items=64, num_users=16, days=30, seed=3)
    items, _, _ = generate_dataset(data)
    return tokenize_items(items, StdVocab(), JaxVocabConfig(**VOCAB))


@pytest.mark.parametrize("encoder", ["hash", "pretrained"])
def test_simcse_model_site(encoder, item_tensors):
    jcfg = JaxConfig(vocab=JaxVocabConfig(**VOCAB),
                     item_tower=JaxItemTowerConfig(**ITEM, text_encoder=encoder))
    tcfg = Config(vocab=VocabConfig(**VOCAB),
                  item_tower=ItemTowerConfig(**ITEM, text_encoder=encoder))
    nf = item_tensors["std"].shape[1]
    ref = JSC.init_params(JSC.build_model(jcfg, StdVocab().size, nf), item_tensors,
                          jax.random.PRNGKey(3))
    port = TSC.build_model(tcfg, StdVocab().size, nf, "cpu", seed=3)
    assert_same_init(torch_to_flax(port), jax.device_get(ref))


def _stage2_sample(B=4, L=8, n_pad=40):
    rng = np.random.default_rng(0)
    return {"input_ids": rng.integers(1, n_pad, (B, L)).astype(np.int32),
            "time_buckets": rng.integers(0, 10, (B, L)).astype(np.int32),
            "seq_mask": np.ones((B, L), np.int32),
            "user_buckets": rng.integers(0, 16, (B, 4)).astype(np.int32),
            "user_cats": rng.integers(0, 8, (B, 5)).astype(np.int32),
            "user_cont": rng.normal(size=(B, 4)).astype(np.float32)}


def test_stage2_towers_site():
    """User tower from k1, item tower from k2 of split(PRNGKey(seed))."""
    jcfg = JaxConfig(user_tower=JaxUserTowerConfig(**TOWER))
    tcfg = Config(user_tower=UserTowerConfig(**TOWER))
    ref, _ = JS.init_stage2_params(jcfg, 40, None, jax.random.PRNGKey(5), _stage2_sample())
    port = TS.init_stage2_params(tcfg, 40, None, "cpu", seed=5)
    assert_same_init(torch_to_flax(port), jax.device_get(ref))


def test_stage2_user_tower_with_side_gates():
    S = JaxUserTowerConfig(**TOWER).num_side_fields
    jt = JU.SASRecUserTower(JaxUserTowerConfig(**TOWER), num_id_embeddings=40,
                            enable_side_gates=True)
    b = _stage2_sample()
    k1, _ = jax.random.split(jax.random.PRNGKey(5))
    ref = jax.jit(jt.init)({"params": k1, "dropout": k1}, jnp.zeros((4, 8, 32)),
                           b["input_ids"], b["time_buckets"], jnp.zeros((4, 8, S), jnp.int32),
                           b["seq_mask"], b["user_buckets"], b["user_cats"],
                           b["user_cont"])["params"]
    port = TU.SASRecUserTower(UserTowerConfig(**TOWER), num_id_embeddings=40,
                              enable_side_gates=True)
    FI.init_from_seed(port, FI.split(FI.key(5))[0])
    assert "side_embedding_3" in ref
    assert_same_init(torch_to_flax(port), jax.device_get(ref))


def test_hybrid_tower_site():
    DC, DG, n_pad = 48, 16, 40
    b = _stage2_sample()
    jt = JH.HybridUserTower(JaxUserTowerConfig(**TOWER), num_id_embeddings=n_pad, gnn_dim=DG)
    key = jax.random.PRNGKey(7)
    ref = jax.jit(jt.init)({"params": key, "dropout": key}, jnp.zeros((4, 8, DC)),
                           jnp.zeros((4, 8, DG)), b["input_ids"], b["time_buckets"],
                           b["seq_mask"], jnp.zeros((4, DG)), b["user_buckets"],
                           b["user_cats"], b["user_cont"])["params"]
    cfg = Config(user_tower=UserTowerConfig(**TOWER))
    port = THT.build_hybrid_model(cfg, n_pad, DC, DG, "cpu", seed=7)
    assert_same_init(torch_to_flax(port), jax.device_get(ref))


def test_residual_adapter():
    x = jnp.zeros((2, 24))
    ref = JH.ResidualAdapter(24).init(jax.random.PRNGKey(1), x)["params"]
    port = FI.init_from_seed(TH.ResidualAdapter(24), FI.key(1), jitted=False)
    assert_same_init(torch_to_flax(port), jax.device_get(ref))


def test_lightgcl_site():
    """``train_lightgcl``'s init: xavier tables at odd sizes from PRNGKey(seed)."""
    nu, ni, d = 37, 23, 8
    n = nu + ni
    jm = JL.LightGCL(nu, ni, JaxGNNConfig(emb_dim=d, svd_rank=2))
    src = np.array([0, 1, 2], np.int32)
    args = (src, src + nu, np.ones(3, np.float32))
    ref = jax.jit(jm.init)(jax.random.PRNGKey(11), args, jnp.zeros((n, 2)), jnp.ones(2),
                           jnp.zeros((n, 2)))["params"]
    port = TG.init_lightgcl(nu, ni, Config(data=DataConfig(seed=11),
                                           gnn=GNNConfig(emb_dim=d, svd_rank=2)))
    assert_same_init(torch_to_flax(port), jax.device_get(ref))


def test_magnitude_encoder_site():
    """``train_distill``'s init: ``model.init(PRNGKey(0))``, not jitted."""
    ref = JL.MagnitudeEncoder(16, 32, 12).init(jax.random.PRNGKey(0),
                                               jnp.zeros((1, 16)))["params"]
    port = TG.init_magnitude_encoder(16, DistillConfig(hidden_dim=32, out_dim=12))
    assert_same_init(torch_to_flax(port), jax.device_get(ref))


RERANK = dict(deep_hidden=(32, 16), fm_embed_dim=8)


def test_dcn_site():
    """``train_dcn``'s init: ``model.init(PRNGKey(0))``, not jitted."""
    ref = JR.DCNRanker(JaxRerankerConfig(**RERANK)).init(jax.random.PRNGKey(0),
                                                         jnp.zeros((2, 10)))["params"]
    port = TRT._new_model(lambda: TR.DCNRanker(10, RerankerConfig(**RERANK)),
                          torch.device("cpu"), 0, None)
    assert_same_init(torch_to_flax(port), jax.device_get(ref))


@pytest.mark.parametrize("num_dense", [0, 3])
def test_deepfm_site(num_dense):
    """``train_deepfm``'s init: ``model.init(PRNGKey(0))``, not jitted, so the
    Embed tables' normals take sqrt(2) before their std."""
    sizes = (5, 300, 17)
    jm = JR.DeepFM(sizes, JaxRerankerConfig(**RERANK), num_dense=num_dense)
    args = [jnp.zeros((2, 3), jnp.int32)] + ([jnp.zeros((2, num_dense))] if num_dense else [])
    ref = jm.init(jax.random.PRNGKey(0), *args)["params"]
    port = TRT._new_model(lambda: TR.DeepFM(sizes, RerankerConfig(**RERANK),
                                            num_dense=num_dense),
                          torch.device("cpu"), 0, None)
    assert_same_init(torch_to_flax(port), jax.device_get(ref))


def test_jitted_embed_init_folds_sqrt2_into_the_std():
    sizes = (5, 300, 17)
    jm = JR.DeepFM(sizes, JaxRerankerConfig(**RERANK))
    ref = jax.jit(jm.init)(jax.random.PRNGKey(4), jnp.zeros((2, 3), jnp.int32))["params"]
    port = FI.init_from_seed(TR.DeepFM(sizes, RerankerConfig(**RERANK)), FI.key(4))
    flat_port, flat_ref = _flat(torch_to_flax(port)), _flat(jax.device_get(ref))
    np.testing.assert_array_equal(flat_port["fm_embed_1/embedding"],
                                  flat_ref["fm_embed_1/embedding"])
    assert_same_init(torch_to_flax(port), jax.device_get(ref))


def test_missing_rule_raises():
    class Odd(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.weird = torch.nn.Parameter(torch.zeros(3))

    with pytest.raises(KeyError, match="weird"):
        FI.init_from_seed(Odd(), FI.key(0))


def test_site_inits_do_not_touch_torch_s_global_stream(item_tensors):
    torch.manual_seed(123)
    want = torch.rand(4)
    torch.manual_seed(123)
    TS.init_stage2_params(Config(user_tower=UserTowerConfig(**TOWER)), 40, None, "cpu", seed=1)
    np.testing.assert_array_equal(torch.rand(4).numpy(), want.numpy())


def test_the_card_fixture_holds_here():
    """``chip_smoke.py`` phase 23 on the CPU: the committed fixture of the JAX
    package's inits (``scripts/jax_flax_init_fixture.py``) against the port's
    init sites, every family bit-equal."""
    import importlib.util
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(repo, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    out = smoke.flax_init_phase(torch.device("cpu"))
    families = {k: v for k, v in out.items() if isinstance(v, dict)}
    assert len(families) == 10
    assert all(v["max_gap_over_std"] == 0.0 for v in families.values())
    assert all(v["bit_equal_share"] in (1.0, None) for v in families.values())
