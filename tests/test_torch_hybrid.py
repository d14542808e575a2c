"""The hybrid tower of the port against the JAX one, on the CPU: the
positive-recovery loss, the adapters, the fusion, the tower and its item path
through the bridge, one hybrid step on the JAX step's draws, the optimizer
recipe against optax, the GNN alignment, and the ensemble fusers (host copy
and device form) against the JAX package's host fusers.

Tolerances, each stated where it is used: the loss and its gradients 1e-5 on
fp32 inputs; tower rows at the bf16 bound of tests/test_torch_user_tower.py
(per-row cosine >= 0.999, 2e-2 abs); the step's loss and weights at that
file's step tolerance (2e-2); the optimizer 1e-6 against optax in fp32; the
fusers' lists exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from recsys_tpu.config import UserTowerConfig as JaxUserTowerConfig
from recsys_tpu.config import UserTrainConfig as JaxUserTrainConfig
from recsys_tpu.eval import ensemble as JE
from recsys_tpu.models import hybrid_tower as JH
from recsys_tpu.ops import contrastive as JC
from recsys_tpu.train import hybrid as JTH
from recsys_tpu.train import sasrec as JS
from recsys_tpu.train.state import TrainState as JaxTrainState
from recsys_tpu_torch.bridge import flax_to_torch, torch_to_flax
from recsys_tpu_torch.config import UserTowerConfig, UserTrainConfig
from recsys_tpu_torch.data.synthetic import generate_dataset
from recsys_tpu_torch.eval import ensemble as TE
from recsys_tpu_torch.models import hybrid_tower as TH
from recsys_tpu_torch.ops import contrastive as TC
from recsys_tpu_torch.train import hybrid as TTH
from recsys_tpu_torch.train import sasrec as TS
from recsys_tpu_torch.train.state import TrainState

TOWER = dict(d_model=32, max_len=8, nhead=2, num_layers=2, dropout=0.0)
DC, DG = 24, 16


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs several workers on few cores: torch's default of one
    thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.as_tensor(np.array(x))


def assert_rows_close(got, ref, cos_min=0.999, atol=2e-2):
    got = np.asarray(got, np.float32).reshape(-1, np.shape(ref)[-1])
    ref = np.asarray(ref, np.float32).reshape(-1, np.shape(ref)[-1])
    cos = (got * ref).sum(1) / (np.linalg.norm(got, axis=1) * np.linalg.norm(ref, axis=1))
    assert cos.min() >= cos_min, cos.min()
    np.testing.assert_allclose(got, ref, atol=atol)


# -- the loss -------------------------------------------------------------------------

@pytest.mark.parametrize("lambda_logq", [1.0, 0.3])
def test_corrected_logq_with_recovery_and_grads_match_jax(lambda_logq):
    rng = np.random.default_rng(0)
    B, D = 40, 16
    unit = lambda: (lambda x: x / np.linalg.norm(x, axis=1, keepdims=True))(
        rng.normal(size=(B, D)).astype(np.float32))
    u, it = unit(), unit()
    pos = rng.integers(1, 12, B).astype(np.int32)          # same-item collisions
    logq = rng.uniform(-6, -1, 13).astype(np.float32)
    scale = np.float32(np.log(1 / 0.07) - 0.4)

    def jloss(u_, i_, s_):
        return JC.corrected_logq_with_recovery(u_, i_, pos, logq, s_, lambda_logq=lambda_logq)

    ref, (gu, gi, gs) = jax.value_and_grad(jloss, argnums=(0, 1, 2))(u, it, scale)
    tu, ti, ts = (_t(x).requires_grad_() for x in (u, it, scale))
    got = TC.corrected_logq_with_recovery(tu, ti, _t(pos).long(), _t(logq), ts,
                                          lambda_logq=lambda_logq)
    got.backward()
    assert float(got.detach()) == pytest.approx(float(ref), abs=1e-5)
    for t, g in ((tu, gu), (ti, gi), (ts, gs)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=1e-5)
    assert abs(float(ts.grad)) > 0


# -- the modules, with parameters carried across by the bridge -----------------------

def _init(module, *args, **kw):
    return jax.device_get(module.init(jax.random.PRNGKey(3), *args, **kw)["params"])


def _perturb(params, rng):
    """Move the scalar gates off their init so that both branches count."""
    out = dict(params)
    for k in ("gate", "gate_gnn", "gate_meta", "logit_scale"):
        if k in out:
            out[k] = np.float32(rng.normal())
    return out


def test_parallel_adapter_matches_jax():
    rng = np.random.default_rng(1)
    c = rng.normal(size=(5, 7, DC)).astype(np.float32)
    g = rng.normal(size=(5, 7, DG)).astype(np.float32)
    jm = JH.ParallelAdapter(32)
    params = _init(jm, c, g)
    tm = TH.ParallelAdapter(DC, DG, 32)
    tm.load_state_dict(flax_to_torch(params), strict=True)
    with torch.no_grad():
        got = tm(_t(c), _t(g)).float().numpy()
    assert_rows_close(got, np.asarray(jm.apply({"params": params}, c, g), np.float32))


def test_residual_adapter_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(9, 32)).astype(np.float32)
    jm = JH.ResidualAdapter(32)
    params = _init(jm, x)
    assert params["gate"].shape == () and float(params["gate"]) == 2.0
    params = _perturb(params, rng)
    tm = TH.ResidualAdapter(32)
    assert tm.gate.item() == 2.0
    tm.load_state_dict(flax_to_torch(params), strict=True)
    with torch.no_grad():
        got = tm(_t(x)).numpy()
    assert_rows_close(got, jm.apply({"params": params}, x))
    back = torch_to_flax(tm)
    assert back["gate"].shape == () and float(back["gate"]) == float(params["gate"])


def test_sequence_centric_fusion_matches_jax():
    rng = np.random.default_rng(3)
    seq = rng.normal(size=(6, 32)).astype(np.float32)
    gu = rng.normal(size=(6, DG)).astype(np.float32)
    meta = rng.normal(size=(6, 32)).astype(np.float32)
    jm = JH.SequenceCentricFusion(32)
    params = _init(jm, seq, gu, meta)
    assert float(params["gate_gnn"]) == float(params["gate_meta"]) == -5.0
    params = _perturb(params, rng)
    tm = TH.SequenceCentricFusion(32, DG)
    tm.load_state_dict(flax_to_torch(params), strict=True)
    with torch.no_grad():
        got = tm(_t(seq).bfloat16(), _t(gu), _t(meta).bfloat16()).float().numpy()
    ref = jm.apply({"params": params}, jnp.asarray(seq, jnp.bfloat16), gu,
                   jnp.asarray(meta, jnp.bfloat16))
    assert_rows_close(got, np.asarray(ref, np.float32))


def tower_inputs(B=6, L=8, N=30, seed=0):
    """Left-padded rows of every length from 1 to L, content and GNN vectors,
    static features and per-user GNN vectors (one of them zero)."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((B, L), np.int32)
    for r in range(B):
        mask[r, L - (1 + r * (L - 1) // max(B - 1, 1)):] = 1
    ids = rng.integers(1, N, (B, L)).astype(np.int32) * mask
    gnn_user = rng.normal(size=(B, DG)).astype(np.float32)
    gnn_user[2] = 0.0
    return (rng.normal(size=(B, L, DC)).astype(np.float32),
            rng.normal(size=(B, L, DG)).astype(np.float32), ids,
            rng.integers(0, 10, (B, L)).astype(np.int32) * mask, mask, gnn_user,
            rng.integers(0, 16, (B, 4)).astype(np.int32),
            rng.integers(0, 8, (B, 5)).astype(np.int32),
            rng.normal(size=(B, 4)).astype(np.float32))


@pytest.fixture(scope="module")
def tower_pair():
    N = 30
    jcfg = JaxUserTowerConfig(**TOWER)
    jt = JH.HybridUserTower(jcfg, num_id_embeddings=N, gnn_dim=DG, num_layers=2)
    args = tower_inputs(N=N)
    params = jax.device_get(jt.init({"params": jax.random.PRNGKey(3),
                                     "dropout": jax.random.PRNGKey(4)}, *args)["params"])
    params = _perturb(params, np.random.default_rng(5))
    params["fusion"] = _perturb(params["fusion"], np.random.default_rng(6))
    tt = TH.HybridUserTower(UserTowerConfig(**TOWER), num_id_embeddings=N, content_dim=DC,
                            gnn_dim=DG, num_layers=2)
    tt.load_state_dict(flax_to_torch(params), strict=True)
    return jt, params, tt.eval(), args


def test_hybrid_tree_is_the_jax_one_both_ways(tower_pair):
    _, params, tt, _ = tower_pair
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    names = {"/".join(str(p.key) for p in path) for path, _ in flat}
    for leaf in ("logit_scale", "pos_embedding", "fusion/gate_gnn", "fusion/gate_meta",
                 "item_adapter/LayerNorm_0/scale", "item_adapter/content_proj/kernel",
                 "item_adapter/gnn_proj/kernel", "fusion/gnn_user_proj/kernel",
                 "fusion/meta_proj/kernel", "fusion/out_proj/kernel"):
        assert leaf in names, leaf
    back = torch_to_flax(tt)
    assert {"/".join(str(p.key) for p in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(back)[0]} == names
    for path, leaf in flat:
        node = back
        for p in path:
            node = node[p.key]
        assert np.shape(node) == np.shape(leaf)
        np.testing.assert_array_equal(node, np.asarray(leaf))


def test_defaults_are_the_jax_towers():
    """Class defaults: 4 layers whatever ``user_tower.num_layers`` says, the
    gates' and the scale's inits, GNN dropout 0.3 and signal scale 1."""
    t = TH.HybridUserTower(UserTowerConfig(**TOWER), num_id_embeddings=10, content_dim=DC,
                           gnn_dim=DG)
    j = JH.HybridUserTower(JaxUserTowerConfig(**TOWER), num_id_embeddings=10, gnn_dim=DG)
    assert t.encoder.num_layers == j.num_layers == 4
    assert (t.gnn_dropout, t.gnn_signal_scale) == (j.gnn_dropout, j.gnn_signal_scale)
    assert t.logit_scale.item() == pytest.approx(float(np.log(1 / 0.07)), abs=1e-6)
    assert t.fusion.gate_gnn.item() == t.fusion.gate_meta.item() == -5.0


def test_hybrid_tower_forward_and_adapt_items_match_jax(tower_pair):
    jt, params, tt, args = tower_pair
    ref = np.asarray(jt.apply({"params": params}, *args, deterministic=True))
    targs = [_t(a) for a in args]
    for i in (2, 3, 6, 7):
        targs[i] = targs[i].long()
    with torch.no_grad():
        got = tt(*targs).numpy()
        items = tt.adapt_items(targs[0], targs[1]).float().numpy()
    assert got.shape == ref.shape == (6, 32)
    assert_rows_close(got, ref)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    jitems = jt.apply({"params": params}, args[0], args[1],
                      method=JH.HybridUserTower.adapt_items)
    assert_rows_close(items, np.asarray(jitems, np.float32))


def test_gnn_keep_mask_drops_the_signal_whole(tower_pair):
    """Train mode, dropout 0: a dropped user equals the same user with a zero
    GNN vector; the drawn mask keeps ~70%."""
    _, _, tt, args = tower_pair
    targs = [_t(a) for a in args]
    for i in (2, 3, 6, 7):
        targs[i] = targs[i].long()
    keep = torch.tensor([[True], [False], [True], [False], [True], [True]])
    tt.train()
    try:
        with torch.no_grad():
            dropped = tt(*targs, gnn_keep=keep)
            zeroed = list(targs)
            zeroed[5] = targs[5] * keep
            tt.eval()
            ref = tt(*zeroed)
        np.testing.assert_allclose(dropped.numpy(), ref.numpy(), atol=1e-6)
        tt.train()
        draws = torch.stack([tt(*targs, generator=torch.Generator().manual_seed(s))
                             for s in range(2)])
        assert not torch.equal(draws[0], draws[1])
    finally:
        tt.eval()
    mask = torch.rand((20000, 1), generator=torch.Generator().manual_seed(0)) < 0.7
    assert abs(float(mask.float().mean()) - 0.7) < 0.02


# -- one hybrid step on the JAX step's draws -----------------------------------------

@pytest.fixture(scope="module")
def hybrid_world():
    from recsys_tpu.config import Config as JaxConfig
    from recsys_tpu.config import DataConfig as JaxDataConfig
    from recsys_tpu.config import VocabConfig as JaxVocabConfig
    from recsys_tpu_torch.config import Config, DataConfig, VocabConfig

    data = dict(num_items=59, num_users=40, days=40, seed=2)
    train = dict(batch_size=16, random_cut_prob=0.5, lr=1e-3)
    jcfg = JaxConfig(data=JaxDataConfig(**data), vocab=JaxVocabConfig(num_hash_buckets=50),
                     user_tower=JaxUserTowerConfig(**TOWER),
                     user_train=JaxUserTrainConfig(**train))
    tcfg = Config(data=DataConfig(**data), vocab=VocabConfig(num_hash_buckets=50),
                  user_tower=UserTowerConfig(**TOWER), user_train=UserTrainConfig(**train))
    items, users, tx = generate_dataset(tcfg.data)
    jdata = JS.prepare_stage2(jcfg, items, users, tx)
    tdata = TS.prepare_stage2(tcfg, items, users, tx)
    rng = np.random.default_rng(0)
    n_pad = len(tdata["item_map"]) + 1
    content = rng.normal(0, 0.3, (n_pad, DC)).astype(np.float32)
    content[0] = 0
    gnn_items = rng.normal(0, 0.3, (n_pad, DG)).astype(np.float32)
    gnn_items[0] = 0
    gnn_users = rng.normal(0, 0.3, (len(tdata["tensors"]["user_ids"]), DG)).astype(np.float32)
    return jcfg, tcfg, jdata, tdata, content, gnn_items, gnn_users


def _jax_hybrid(jcfg, jdata, content, gnn_items, B):
    """The JAX trainer's tower (default 4 layers) and its init."""
    model = JH.HybridUserTower(jcfg.user_tower, num_id_embeddings=len(jdata["item_map"]) + 1,
                               gnn_dim=gnn_items.shape[1])
    sample = JS._slice(jdata["tensors"], np.arange(B))
    L = jcfg.user_tower.max_len
    params = model.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)},
                        jnp.zeros((B, L, content.shape[1])), jnp.zeros((B, L, gnn_items.shape[1])),
                        sample["input_ids"], sample["time_buckets"], sample["seq_mask"],
                        jnp.zeros((B, gnn_items.shape[1])), sample["user_buckets"],
                        sample["user_cats"], sample["user_cont"])["params"]
    return model, jax.device_get(params), sample


def test_one_hybrid_step_matches_jax_on_its_draws(hybrid_world):
    """The JAX step's draws (``k_cut, key = split(key)``: the cut from k_cut,
    the GNN keep mask as the tower's first ``make_rng("dropout")`` from key)
    replayed into the port's step, dropout 0, weights bridged: the loss and
    every weight after the AdamW update agree at the step tolerance."""
    jcfg, tcfg, jdata, tdata, content, gnn_items, gnn_users = hybrid_world
    B = 16
    jmodel, params, sample = _jax_hybrid(jcfg, jdata, content, gnn_items, B)
    total = 10
    jstate = JaxTrainState.create(params, JTH.make_hybrid_optimizer(jcfg.user_train, params,
                                                                    total))
    jstep, _, _ = JTH.make_hybrid_step(jcfg, jmodel, content, gnn_items, jdata["logq"])
    key = jax.random.PRNGKey(7)
    jbatch = {k: jnp.asarray(v) for k, v in sample.items() if k != "user_ids"}
    jstate2, jloss = jstep(jstate, jbatch, jnp.asarray(gnn_users[:B]), key)

    k_cut, k_drop = jax.random.split(key)
    k_gate, k_pos = jax.random.split(k_cut)
    gate = np.asarray(jax.random.bernoulli(k_gate, 0.5, (B,)))
    gumbel = jax.random.gumbel(k_pos, sample["seq_mask"].shape)
    cut = np.asarray(jnp.argmax(jnp.where(sample["seq_mask"] > 0, gumbel, -jnp.inf), -1))
    rng_key = jmodel.apply({"params": params}, method=lambda m: m.make_rng("dropout"),
                           rngs={"dropout": k_drop})
    keep = np.asarray(jax.random.bernoulli(rng_key, 0.7, (B, 1)))
    assert 0 < keep.sum() < B and 0 < gate.sum() < B

    model = TTH.build_hybrid_model(tcfg, len(tdata["item_map"]) + 1, DC, DG, "cpu")
    model.load_state_dict(flax_to_torch(params), strict=True)
    opt, sched = TTH.make_hybrid_optimizer(tcfg.user_train, model, total)
    state = TrainState(model, opt, sched)
    step, _, _ = TTH.make_hybrid_step(tcfg, state, content, gnn_items, tdata["logq"])
    batch = TS._slice(TS.tensors_to(tdata["tensors"], "cpu"), np.arange(B))
    aux = step(batch, _t(gnn_users[:B]), torch.Generator().manual_seed(0),
               {"cut": (_t(gate), _t(cut).long()), "gnn_keep": _t(keep)})
    assert float(aux["loss"]) == pytest.approx(float(jloss), abs=2e-2)
    assert state.step == 1
    after = torch_to_flax(model)
    moved = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(jax.device_get(jstate2.params))[0]:
        node = after
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node, np.asarray(leaf), atol=2e-2)
        before = params
        for p in path:
            before = before[p.key]
        moved += int(not np.array_equal(np.asarray(leaf), np.asarray(before)))
    assert moved > 10


def test_align_gnn_matches_jax(hybrid_world):
    _, _, jdata, tdata, _, _, _ = hybrid_world
    rng = np.random.default_rng(3)
    ids = list(tdata["item_map"].ids)[::2] + ["not-an-item"]
    vecs = rng.normal(size=(len(ids), 8)).astype(np.float32)
    np.testing.assert_array_equal(TTH.align_gnn_to_catalog(vecs, ids, tdata["item_map"]),
                                  JTH.align_gnn_to_catalog(vecs, ids, jdata["item_map"]))
    uids = tdata["tensors"]["user_ids"]
    np.testing.assert_array_equal(TTH.align_gnn_users(vecs[:10], uids[:10][::-1], uids),
                                  JTH.align_gnn_users(vecs[:10], uids[:10][::-1], uids))


# -- the optimizer recipe against optax --------------------------------------------------

class Toy(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.item_adapter = torch.nn.Linear(4, 3)
        self.encoder = torch.nn.Linear(3, 3)
        self.logit_scale = torch.nn.Parameter(torch.tensor(2.5))


RECIPES = {
    "const": {},
    "warmup": dict(hybrid_warmup_steps=3),
    "cosine": dict(hybrid_lr=5e-3, hybrid_warmup_steps=2, hybrid_lr_decay="cosine"),
    "cosine_no_warmup": dict(hybrid_lr_decay="cosine"),
    "slow": dict(hybrid_warmup_steps=2, hybrid_slow_modules=("item_adapter", "encoder"),
                 hybrid_slow_scale=0.1),
}


@pytest.mark.parametrize("recipe", list(RECIPES))
def test_hybrid_optimizer_matches_optax(recipe):
    kw = dict(lr=1e-2, weight_decay=0.1, grad_clip=1.0, **RECIPES[recipe])
    jut, tut = JaxUserTrainConfig(**kw), UserTrainConfig(**kw)
    rng = np.random.default_rng(0)
    toy = Toy()
    w1, b1, w2, b2 = (rng.normal(size=s).astype(np.float32) for s in ((3, 4), (3,), (3, 3), (3,)))
    with torch.no_grad():
        for p, v in zip((toy.item_adapter.weight, toy.item_adapter.bias, toy.encoder.weight,
                         toy.encoder.bias), (w1, b1, w2, b2)):
            p.copy_(_t(v))
    params = {"item_adapter": {"weight": w1.T.copy(), "bias": b1},
              "encoder": {"weight": w2.T.copy(), "bias": b2}, "logit_scale": np.array(2.5, np.float32)}
    total = 8
    tx = JTH.make_hybrid_optimizer(jut, params, total)
    opt_state = tx.init(params)
    opt, sched = TTH.make_hybrid_optimizer(tut, toy, total)
    for s in range(total):
        g = np.random.default_rng(100 + s)
        grads = [g.normal(size=x.shape).astype(np.float32) * 3 for x in (w1, b1, w2, b2)]
        gs = np.array(g.normal(), np.float32)
        for p, v in zip((toy.item_adapter.weight, toy.item_adapter.bias, toy.encoder.weight,
                         toy.encoder.bias), grads):
            p.grad = _t(v)
        toy.logit_scale.grad = _t(gs)
        opt.step()
        sched.step()
        jg = {"item_adapter": {"weight": grads[0].T, "bias": grads[1]},
              "encoder": {"weight": grads[2].T, "bias": grads[3]}, "logit_scale": gs}
        updates, opt_state = tx.update(jg, opt_state, params)
        params = optax.apply_updates(params, updates)
        for name, mod in (("item_adapter", toy.item_adapter), ("encoder", toy.encoder)):
            np.testing.assert_allclose(mod.weight.detach().numpy(),
                                       np.asarray(params[name]["weight"]).T, atol=1e-6, rtol=0)
            np.testing.assert_allclose(mod.bias.detach().numpy(),
                                       np.asarray(params[name]["bias"]), atol=1e-6, rtol=0)
        assert toy.logit_scale.item() == pytest.approx(float(params["logit_scale"]), abs=1e-6)
    if recipe in ("warmup", "cosine"):
        assert opt.param_groups[0]["initial_lr"] > 0   # the first update had lr 0


# -- the ensemble fusers ---------------------------------------------------------------------

def _lists(seed, B=33, M=40, n_ids=120, tied=False):
    rng = np.random.default_rng(seed)
    idx_a = rng.integers(0, n_ids, size=(B, M))
    idx_b = rng.integers(0, n_ids, size=(B, M))
    if tied:       # few distinct score values: exact ties across ids and lists
        sc_a = np.sort(rng.integers(0, 9, size=(B, M)).astype(np.float64), 1)[:, ::-1]
        sc_b = np.sort(rng.integers(0, 9, size=(B, M)).astype(np.float64), 1)[:, ::-1]
        sc_a[3] = 4.0                                  # a constant row: min-max range 0
    else:
        sc_a = np.sort(rng.normal(size=(B, M)), 1)[:, ::-1].astype(np.float32)
        sc_b = np.sort(rng.normal(size=(B, M)), 1)[:, ::-1].astype(np.float32)
    return idx_a, sc_a, idx_b, sc_b


@pytest.mark.parametrize("tied", [False, True], ids=["distinct", "tied"])
def test_host_fusers_equal_jax(tied):
    idx_a, sc_a, idx_b, sc_b = _lists(1, n_ids=30 if tied else 120, tied=tied)
    for alpha in (1.0, 0.7, 0.5, 0.0):
        np.testing.assert_array_equal(
            TE.weighted_score_ensemble(idx_a, sc_a, idx_b, sc_b, 12, alpha),
            JE.weighted_score_ensemble(idx_a, sc_a, idx_b, sc_b, 12, alpha))
        np.testing.assert_array_equal(TE.count_mix_ensemble(idx_a, idx_b, 12, alpha),
                                      JE.count_mix_ensemble(idx_a, idx_b, 12, alpha))
    np.testing.assert_array_equal(TE.rrf_ensemble(idx_a, idx_b, 12, 20),
                                  JE.rrf_ensemble(idx_a, idx_b, 12, 20))


@pytest.mark.parametrize("tied,n_ids", [(False, 120), (True, 30), (True, 4)],
                         ids=["distinct", "tied_repeats", "long_groups"])
def test_device_fusers_equal_jax_host_lists(tied, n_ids):
    """The torch fusers (here on the CPU; on the card in chip_smoke.py) give the
    JAX host fusers' lists element for element: exact ties, a constant row,
    repeated ids (groups of 2 to ~20 members with 4 ids), the -1 padding."""
    idx_a, sc_a, idx_b, sc_b = _lists(2, n_ids=n_ids, tied=tied)
    idx = np.concatenate([idx_a, idx_b], 1)
    for alpha in (1.0, 0.7, 0.5, 0.25, 0.0):
        wf = JE.WeightedFuser(idx_a, sc_a, idx_b, sc_b)
        ref = wf.fuse(12, alpha)
        sa, sb = TE._dev_minmax_rows(_t(sc_a)), TE._dev_minmax_rows(_t(sc_b))
        (sum_a, sum_b), first = TE._dev_first_sums(
            _t(idx), [torch.cat([sa, torch.zeros_like(sb)], 1),
                      torch.cat([torch.zeros_like(sa), sb], 1)])
        np.testing.assert_array_equal(first.numpy(), wf.first)
        np.testing.assert_array_equal(sum_a.numpy(), wf.sum_a)
        np.testing.assert_array_equal(sum_b.numpy(), wf.sum_b)
        sc = torch.where(first, alpha * sum_a + (1 - alpha) * sum_b,
                         torch.full_like(sum_a, -np.inf))
        np.testing.assert_array_equal(TE._dev_topk_first(_t(idx), sc, 12).numpy(), ref)
        merged = np.concatenate([idx_a[:, :int(np.ceil(alpha * 12))], idx_b,
                                 idx_a[:, int(np.ceil(alpha * 12)):]], 1)
        np.testing.assert_array_equal(TE._dev_dedup_take(_t(merged), 12).numpy(),
                                      JE.count_mix_ensemble(idx_a, idx_b, 12, alpha))
    assert (JE.count_mix_ensemble(idx_a, idx_b, 12, 0.5) == -1).any() == (n_ids < 12)


@pytest.mark.parametrize("method", ["count_mix", "weighted", "rrf"])
def test_alpha_sweep_device_equals_jax_host(method):
    idx_a, sc_a, idx_b, sc_b = _lists(3, n_ids=40, tied=True)
    uids = [f"u{i}" for i in range(len(idx_a))]
    targets = {u: {int(idx_a[i, 0]), int(idx_b[i, 3]), 7} for i, u in enumerate(uids)}
    kw = dict(ks=(4, 12), alphas=(1.0, 0.5, 0.0))
    ref = JE.alpha_sweep(method, (idx_a, sc_a), (idx_b, sc_b), uids, targets, device=False, **kw)
    host = TE.alpha_sweep(method, (idx_a, sc_a), (idx_b, sc_b), uids, targets, **kw)
    dev = TE._alpha_sweep_device(method, (idx_a, sc_a), (idx_b, sc_b), uids, targets,
                                 kw["ks"], kw["alphas"], 200, chunk=16, device="cpu")
    for got in (host, dev):
        assert got["table"] == ref["table"] and got["best_alpha"] == ref["best_alpha"]


def test_topm_and_ensemble_report_match_jax():
    rng = np.random.default_rng(4)
    uv = rng.normal(size=(50, 16)).astype(np.float32)
    items = rng.normal(size=(70, 16)).astype(np.float32)
    items[0] = 0
    got = TTH.topm_for_model(uv, items, 20, device="cpu", batch_size=16)
    ref = JTH.topm_for_model(uv, items, 20, batch_size=16)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_allclose(got[1], ref[1], atol=1e-5)
    gnn = TTH.topm_for_model(rng.normal(size=(50, 16)).astype(np.float32), items, 20,
                             device="cpu", normalize_items=False)
    uids = [f"u{i}" for i in range(50)]
    targets = {u: {int(got[0][i, 2]), int(gnn[0][i, 5])} for i, u in enumerate(uids)}
    t = TTH.ensemble_report(got, gnn, uids, targets, ks=(5, 20), device="cpu")
    j = JTH.ensemble_report(ref, gnn, uids, targets, ks=(5, 20))
    assert t == j
