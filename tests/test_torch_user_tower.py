"""The stage-2 user tower of the port against the JAX one, on the CPU: the
tower forward, the bridge, the interpretability metrics, the loss family, the
random-cut augmentation and position draws, one whole stage-2 step, the
optimizer against optax, and the dense and all-to-all item lookups.

Tolerances, each stated where it is used: tower rows at the item tower's bf16
bound (per-row cosine >= 0.999, 2e-2 abs; both towers compute in bf16 over
fp32 parameters and round at different places); metrics 1e-6; the losses
1e-5 on the same fp32 inputs; the optimizer 1e-6 against optax in fp32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from recsys_tpu.config import Config as JaxConfig
from recsys_tpu.config import DataConfig as JaxDataConfig
from recsys_tpu.config import UserTowerConfig as JaxUserTowerConfig
from recsys_tpu.config import UserTrainConfig as JaxUserTrainConfig
from recsys_tpu.config import VocabConfig as JaxVocabConfig
from recsys_tpu.models.user_tower import SASRecUserTower as JaxUserTower
from recsys_tpu.ops import augment as JA
from recsys_tpu.ops import contrastive as JC
from recsys_tpu.train import metrics as JM
from recsys_tpu.train import sasrec as JS
from recsys_tpu.train import state as JST
from recsys_tpu_torch.bridge import flax_to_torch, torch_to_flax
from recsys_tpu_torch.config import Config, DataConfig, MeshConfig, UserTowerConfig, UserTrainConfig
from recsys_tpu_torch.config import VocabConfig
from recsys_tpu_torch.data.synthetic import generate_dataset
from recsys_tpu_torch.models.user_tower import SASRecUserTower, Stage2Model
from recsys_tpu_torch.ops import augment as TA
from recsys_tpu_torch.ops import contrastive as TC
from recsys_tpu_torch.parallel.mesh import build_mesh
from recsys_tpu_torch.train import metrics as TM
from recsys_tpu_torch.train import sasrec as TS
from recsys_tpu_torch.train import state as TST

TOWER = dict(d_model=32, max_len=8, nhead=2, num_layers=1, dropout=0.0)
USER_TRAIN = dict(batch_size=16, positions_per_user=2, kernel="xla", random_cut_prob=0.5)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs several workers on few cores: torch's default of one
    thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def configs(**train):
    """The same small stage-2 configuration for both packages."""
    data = dict(num_items=59, num_users=40, days=40, seed=2)   # 60 rows with PAD: even
    tr = {**USER_TRAIN, **train}
    jcfg = JaxConfig(data=JaxDataConfig(**data), vocab=JaxVocabConfig(num_hash_buckets=50),
                     user_tower=JaxUserTowerConfig(**TOWER), user_train=JaxUserTrainConfig(**tr))
    tcfg = Config(data=DataConfig(**data), vocab=VocabConfig(num_hash_buckets=50),
                  user_tower=UserTowerConfig(**TOWER), user_train=UserTrainConfig(**tr))
    return jcfg, tcfg


def assert_rows_close(got, ref, cos_min=0.999, atol=2e-2):
    got = np.asarray(got, np.float32).reshape(-1, np.shape(ref)[-1])
    ref = np.asarray(ref, np.float32).reshape(-1, np.shape(ref)[-1])
    cos = (got * ref).sum(1) / (np.linalg.norm(got, axis=1) * np.linalg.norm(ref, axis=1))
    assert cos.min() >= cos_min, cos.min()
    np.testing.assert_allclose(got, ref, atol=atol)


def tower_batch(B=6, L=8, N=30, seed=0):
    """Left-padded rows of every length from 1 to L, static features."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((B, L), np.int32)
    for r in range(B):
        mask[r, L - (1 + r * (L - 1) // max(B - 1, 1)):] = 1
    ids = rng.integers(1, N, (B, L)).astype(np.int32) * mask
    return {"input_ids": ids, "target_ids": rng.integers(1, N, (B, L)).astype(np.int32) * mask,
            "time_buckets": rng.integers(0, 10, (B, L)).astype(np.int32) * mask,
            "seq_mask": mask, "user_buckets": rng.integers(0, 16, (B, 4)).astype(np.int32),
            "user_cats": rng.integers(0, 8, (B, 5)).astype(np.int32),
            "user_cont": rng.normal(size=(B, 4)).astype(np.float32)}


@pytest.fixture(scope="module")
def tower_pair():
    """A JAX tower's init, bridged into the port's, with nonzero gates."""
    N, D = 30, TOWER["d_model"]
    jcfg = JaxUserTowerConfig(**TOWER)
    jt = JaxUserTower(jcfg, num_id_embeddings=N)
    b = tower_batch(N=N)
    vecs = np.random.default_rng(1).normal(size=(*b["input_ids"].shape, D)).astype(np.float32)
    side = np.zeros((*b["input_ids"].shape, 4), np.int32)
    args = (vecs, b["input_ids"], b["time_buckets"], side, b["seq_mask"], b["user_buckets"],
            b["user_cats"], b["user_cont"])
    # one compiled init: un-jitted, Flax's init runs (and compiles) op by op
    params = jax.device_get(jax.jit(jt.init)(jax.random.PRNGKey(3), *args)["params"])
    params = dict(params)
    rng = np.random.default_rng(4)
    params["seq_gate"] = rng.normal(size=params["seq_gate"].shape).astype(np.float32)
    params["static_gate"] = rng.normal(size=params["static_gate"].shape).astype(np.float32)
    tt = SASRecUserTower(UserTowerConfig(**TOWER), num_id_embeddings=N)
    tt.load_state_dict(flax_to_torch(params), strict=True)
    return jt, params, tt.eval(), args, b


def test_tower_parameter_tree_is_the_jax_one(tower_pair):
    _, params, tt, _, _ = tower_pair
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    names = {"/".join(str(p.key) for p in path) for path, _ in flat}
    assert not any("side_embedding" in n for n in names)
    assert params["seq_gate"].shape == (7,) and params["static_gate"].shape == (10,)
    assert params["static_mlp"]["Dense_0"]["kernel"].shape == (100, 100)
    assert params["static_mlp"]["Dense_1"]["kernel"].shape == (100, TOWER["d_model"])
    back = torch_to_flax(tt)
    back_flat = jax.tree_util.tree_flatten_with_path(back)[0]
    assert {"/".join(str(p.key) for p in path) for path, _ in back_flat} == names
    for path, leaf in flat:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))


def test_stage2_model_bridge_both_ways():
    """{"user": ..., "item": {"item_matrix"}} -> Stage2Model -> the same tree."""
    model = Stage2Model(UserTowerConfig(**TOWER), 30)
    tree = torch_to_flax(model)
    assert set(tree) == {"user", "item"} and set(tree["item"]) == {"item_matrix"}
    again = Stage2Model(UserTowerConfig(**TOWER), 30)
    again.load_state_dict(flax_to_torch(tree), strict=True)
    for a, b in zip(model.state_dict().values(), again.state_dict().values()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("all_timesteps", [True, False])
def test_tower_forward_matches_jax(tower_pair, all_timesteps):
    """Dropout 0, left padding, a row with one real position; both modes."""
    jt, params, tt, args, b = tower_pair
    apply = jax.jit(jt.apply, static_argnames=("all_timesteps", "deterministic"))
    ref = np.asarray(apply({"params": params}, *args, all_timesteps=all_timesteps,
                           deterministic=True))
    t = {k: torch.as_tensor(v) for k, v in b.items()}
    with torch.no_grad():
        got = tt(torch.as_tensor(args[0]), t["input_ids"].long(), t["time_buckets"].long(),
                 t["seq_mask"], t["user_buckets"].long(), t["user_cats"].long(),
                 t["user_cont"], all_timesteps=all_timesteps).numpy()
    assert got.shape == ref.shape
    if all_timesteps:
        # padding rows attend over padding keys only: a uniform softmax in both
        assert_rows_close(got, ref)
        got, ref = got[:, -1], ref[:, -1]
    assert_rows_close(got, ref)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


def test_metrics_match_jax(tower_pair):
    _, params, tt, _, _ = tower_pair
    ref, got = JM.gate_weights(params), TM.gate_weights(tt)
    assert set(got) == set(ref) and "seq_gate[0]" in got and "static_gate[9]" in got
    for k in ref:
        assert got[k] == pytest.approx(ref[k], abs=1e-6)
    ref = JM.static_branch_importance(params, JaxUserTowerConfig(**TOWER))
    got = TM.static_branch_importance(tt, UserTowerConfig(**TOWER))
    assert list(got) == list(ref) == [*(f"bucket{i}" for i in range(4)),
                                      *(f"cat{i}" for i in range(5)), "cont"]
    for k in ref:
        assert got[k] == pytest.approx(ref[k], abs=1e-6)


# -- the loss family -----------------------------------------------------------

@pytest.fixture(scope="module")
def loss_inputs():
    rng = np.random.default_rng(5)
    B, D = 48, 16
    unit = lambda: (lambda x: x / np.linalg.norm(x, axis=1, keepdims=True))(
        rng.normal(size=(B, D)).astype(np.float32))
    return {"u": unit(), "i": unit(), "pos": rng.integers(1, 20, B).astype(np.int32),
            "logq": rng.uniform(-6, -1, 21).astype(np.float32),
            "valid": (rng.random(B) > 0.2).astype(np.int32)}


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.mark.parametrize("valid", [False, True])
def test_duorec_loss_matches_jax(loss_inputs, valid):
    x = loss_inputs
    v = x["valid"] if valid else None
    ref = JC.duorec_loss(x["u"], x["i"], x["pos"], temperature=0.1, lambda_sup=0.3, valid=v)
    got = TC.duorec_loss(_t(x["u"]), _t(x["i"]), _t(x["pos"]), temperature=0.1,
                         lambda_sup=0.3, valid=None if v is None else _t(v))
    assert float(got) == pytest.approx(float(ref), abs=1e-5)


@pytest.mark.parametrize("variant", ["hnm", "margin"])
@pytest.mark.parametrize("top_k_percent,threshold", [(0.1, 0.9), (0.3, 0.2)])
def test_hard_negative_losses_match_jax(loss_inputs, variant, top_k_percent, threshold):
    x = loss_inputs
    kw = dict(temperature=0.1, lambda_logq=0.7, top_k_percent=top_k_percent,
              threshold=threshold)
    args = (x["u"], x["i"], x["pos"], x["logq"])
    targs = tuple(_t(a) for a in args)
    if variant == "hnm":
        ref, rstats = JC.hnm_corrected_loss(*args, **kw)
        got, gstats = TC.hnm_corrected_loss(*targs, **kw)
        assert gstats["hard_k"] == rstats["hard_k"]
        assert float(gstats["hard_sim_mean"]) == pytest.approx(float(rstats["hard_sim_mean"]),
                                                               abs=1e-6)
        assert int(gstats["excluded_too_similar"]) == int(rstats["excluded_too_similar"])
    else:
        ref = JC.full_batch_hard_emphasis_loss(*args, margin=0.05, **kw)
        got = TC.full_batch_hard_emphasis_loss(*targs, margin=0.05, **kw)
    assert float(got) == pytest.approx(float(ref), abs=1e-5)


def test_mixed_hnm_loss_matches_jax_on_its_random_columns(loss_inputs):
    x = loss_inputs
    key = jax.random.PRNGKey(9)
    B = len(x["u"])
    kw = dict(temperature=0.1, lambda_logq=1.0, top_k_percent=0.1, threshold=0.9,
              num_random=20)
    ref, _ = JC.mixed_hnm_loss(x["u"], x["i"], x["pos"], x["logq"], key, **kw)
    cols = np.asarray(jax.random.randint(key, (B, 20), 0, B))   # the JAX function's draw
    got, stats = TC.mixed_hnm_loss(_t(x["u"]), _t(x["i"]), _t(x["pos"]), _t(x["logq"]),
                                   rand_cols=_t(cols), **kw)
    assert float(got) == pytest.approx(float(ref), abs=1e-5) and stats["hard_k"] == 4
    drawn, _ = TC.mixed_hnm_loss(_t(x["u"]), _t(x["i"]), _t(x["pos"]), _t(x["logq"]),
                                 torch.Generator().manual_seed(0), **kw)
    assert np.isfinite(float(drawn))


# -- random draws ----------------------------------------------------------------

def test_random_cut_arithmetic_is_the_jax_one_on_its_draws():
    b = tower_batch(B=64, L=8, seed=3)
    key = jax.random.PRNGKey(11)
    ref = JA.random_cut({k: jnp.asarray(v) for k, v in b.items()}, key, 0.5)
    k_gate, k_pos = jax.random.split(key)                    # the JAX function's draws
    gate = np.asarray(jax.random.bernoulli(k_gate, 0.5, (64,)))
    gumbel = jax.random.gumbel(k_pos, (64, 8))
    cut = np.asarray(jnp.argmax(jnp.where(b["seq_mask"] > 0, gumbel, -jnp.inf), axis=-1))
    got = TA.apply_random_cut({k: _t(v).long() for k, v in b.items()}, _t(gate), _t(cut).long())
    assert 0 < gate.sum() < 64
    for k in TA.SASREC_SEQ_KEYS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))


def test_random_cut_keeps_a_real_position_and_the_left_padding():
    b = {k: _t(v).long() for k, v in tower_batch(B=200, L=8, seed=4).items()}
    out = TA.random_cut(b, 0.5, torch.Generator().manual_seed(0))
    m = out["seq_mask"]
    assert (m.sum(1) >= 1).all() and (m[:, -1] == 1).all()
    # left padding: once a row's real positions start they run to the end
    assert (m[:, 1:] >= m[:, :-1]).all()
    cut_rows = (m.sum(1) < b["seq_mask"].sum(1))
    assert 50 < int(cut_rows.sum()) < 110                    # ~half of the rows may be cut
    # a cut row is a prefix of the history, shifted right
    for r in torch.nonzero(cut_rows).flatten().tolist()[:20]:
        k = int(m[r].sum())
        orig = b["input_ids"][r][b["seq_mask"][r] > 0]
        np.testing.assert_array_equal(out["input_ids"][r, -k:].numpy(), orig[:k].numpy())


def test_sampled_positions_are_uniform_over_the_real_slots():
    """Positions fall on real slots only, with replacement, uniformly (a
    chi-square test over 20,000 draws a row length)."""
    L, n = 8, 20_000
    mask = torch.zeros(4, L, dtype=torch.long)
    for r, k in enumerate((1, 3, 5, 8)):
        mask[r, L - k:] = 1
    pos = TS.sample_positions(mask.repeat(n // 4, 1), 4, torch.Generator().manual_seed(1))
    rows = pos.view(n // 4, 4, 4)
    for r, k in enumerate((1, 3, 5, 8)):
        drawn = rows[:, r].flatten()
        assert (drawn >= L - k).all()
        counts = torch.bincount(drawn - (L - k), minlength=k).double().numpy()
        expected = len(drawn) / k
        chi2 = float(((counts - expected) ** 2 / expected).sum())
        assert chi2 < 25.0, (k, counts)                     # df <= 7: p < 1e-3 above 24.3
    # with replacement: some user draws one slot twice
    assert any(len(set(rows[j, 3].tolist())) < 4 for j in range(50))


# -- one stage-2 step ---------------------------------------------------------------

@pytest.fixture(scope="module")
def stage2_world():
    jcfg, tcfg = configs()
    items, users, tx = generate_dataset(tcfg.data)
    jdata = JS.prepare_stage2(jcfg, items, users, tx)
    tdata = TS.prepare_stage2(tcfg, items, users, tx)
    return jcfg, tcfg, jdata, tdata


@pytest.fixture(scope="module")
def stage2_init(stage2_world):
    """The JAX stage-2 init of a 16-row sample (``init_stage2_params`` reads
    only the tower's config, so every loss variant shares it)."""
    jcfg, _, jdata, _ = stage2_world
    sample = JS._slice(jdata["tensors"], np.arange(16))
    n_pad = len(jdata["item_map"]) + 1
    pretrained = np.random.default_rng(0).normal(size=(n_pad, 32)).astype(np.float32)
    params, models = JS.init_stage2_params(jcfg, n_pad, pretrained, jax.random.PRNGKey(0),
                                           sample)
    return sample, n_pad, params, models


def test_prepare_stage2_matches_jax(stage2_world):
    _, _, jdata, tdata = stage2_world
    for k in TS.BATCH_KEYS:
        np.testing.assert_array_equal(tdata["tensors"][k], jdata["tensors"][k])
    assert tdata["tensors"]["user_ids"] == jdata["tensors"]["user_ids"]
    np.testing.assert_array_equal(tdata["logq"], jdata["logq"])
    np.testing.assert_array_equal(tdata["side"], jdata["side"])
    assert tdata["targets_idx"] == jdata["targets_idx"]


@pytest.mark.parametrize("variant", ["logq", "hnm", "mixed_hnm", "margin"])
def test_one_stage2_step_matches_jax_on_its_draws(stage2_world, stage2_init, variant):
    """The JAX step's own draws (``split(key, 4)``: cut, positions, the
    mixed-HNM columns) replayed into the port's step, dropout 0, weights
    bridged: the loss parts agree at the bf16 bound of the towers, and the
    loss composition on shared fp32 rows to 1e-5."""
    jcfg, tcfg, jdata, tdata = stage2_world
    jcfg = dataclasses.replace(jcfg, user_train=dataclasses.replace(
        jcfg.user_train, loss_variant=variant, top_k_percent=0.1))
    tcfg = dataclasses.replace(tcfg, user_train=dataclasses.replace(
        tcfg.user_train, loss_variant=variant, top_k_percent=0.1))
    B, P = 16, 2
    sample, n_pad, params, models = stage2_init
    jstate = JST.TrainState.create(params, JS.make_stage2_optimizer(jcfg, params, 4))
    jstep, _ = JS.make_stage2_step(jcfg, models, jdata["side"], jdata["logq"])
    key = jax.random.PRNGKey(5)
    _, jaux = jstep(jstate, {k: jnp.asarray(v) for k, v in sample.items()}, key)

    # the JAX step's draws, as ``loss_fn`` makes them
    _, _, kp, kc = jax.random.split(key, 4)
    k_gate, k_pos = jax.random.split(kc)
    gate = np.asarray(jax.random.bernoulli(k_gate, 0.5, (B,)))
    gumbel = jax.random.gumbel(k_pos, sample["seq_mask"].shape)
    cut = np.asarray(jnp.argmax(jnp.where(sample["seq_mask"] > 0, gumbel, -jnp.inf), -1))
    cut_batch = JA.random_cut({k: jnp.asarray(v) for k, v in sample.items()}, kc, 0.5)
    logits = jnp.where(cut_batch["seq_mask"] > 0, 0.0, -1e9)
    positions = np.asarray(jax.random.categorical(kp, logits[:, None, :], axis=-1,
                                                  shape=(B, P)))
    rand_cols = np.asarray(jax.random.randint(jax.random.fold_in(kp, 1),
                                              (B * P, min(100, B * P)), 0, B * P))
    draws = {"cut": (_t(gate), _t(cut).long()), "positions": _t(positions),
             "rand_cols": _t(rand_cols)}

    model = TS.init_stage2_params(tcfg, n_pad, None, "cpu")
    model.load_state_dict(flax_to_torch(jax.device_get(params)), strict=True)
    state = TST.TrainState(model, TS.make_stage2_optimizer(tcfg, model, 4))
    step, _ = TS.make_stage2_step(tcfg, state, tdata["logq"])
    batch = TS._slice(TS.tensors_to(tdata["tensors"], "cpu"), np.arange(B))
    aux = step(batch, torch.Generator().manual_seed(0), draws)
    # the mined variants' main loss is row 0's cross entropy alone (the JAX
    # form's expression), so no mean over rows shrinks the towers' bf16 error
    tol = 5e-2 if variant in ("hnm", "mixed_hnm") else 2e-2
    for part in ("main", "loss"):
        assert float(aux[part]) == pytest.approx(float(jaux[part]), abs=tol), part
    for part, tol in (("cl", 2e-2),):
        assert float(aux[part]) == pytest.approx(float(jaux[part]), abs=tol), part
    assert state.step == 1


def test_loss_composition_on_shared_rows(stage2_world):
    """The same fp32 rows, targets and last-position views into both
    compositions: main + lambda_cl * DuoRec agree to 1e-5."""
    _, tcfg, _, tdata = stage2_world
    ut = tcfg.user_train
    rng = np.random.default_rng(8)
    B, P, D = 16, 2, 32
    unit = lambda n: (lambda x: x / np.linalg.norm(x, axis=1, keepdims=True))(
        rng.normal(size=(n, D)).astype(np.float32))
    rows, tgt, z1, z2 = unit(B * P), unit(B * P), unit(B), unit(B)
    tgt_ids = rng.integers(1, 20, B * P).astype(np.int32)
    last = rng.integers(1, 20, B).astype(np.int32)
    user_rows = np.repeat(np.arange(B), P)
    logq = tdata["logq"]
    ref = (JC.inbatch_logq_loss(rows, tgt, tgt_ids, logq, temperature=ut.temperature,
                                lambda_logq=ut.lambda_logq, user_ids=user_rows)
           + ut.lambda_cl * JC.duorec_loss(z1, z2, last, temperature=ut.temperature,
                                           lambda_sup=ut.lambda_sup))
    got = (TS.main_loss(tcfg, _t(rows), _t(tgt), _t(tgt_ids), _t(logq), _t(user_rows))
           + ut.lambda_cl * TC.duorec_loss(_t(z1), _t(z2), _t(last),
                                           temperature=ut.temperature,
                                           lambda_sup=ut.lambda_sup))
    assert float(got) == pytest.approx(float(ref), abs=1e-5)


# -- the optimizer against optax ------------------------------------------------------

class Toy(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.user = torch.nn.Linear(4, 3)
        self.item = torch.nn.Parameter(torch.zeros(5, 3))


def _optax_tx(grad_clip, freeze_steps, lr=1e-2, wd=0.1, item_scale=0.05):
    labels = {"user": {"weight": "user", "bias": "user"}, "item": "item"}
    groups = {"user": optax.adamw(lr, weight_decay=wd),
              "item": optax.chain(optax.scale_by_schedule(JST.freeze_gate_schedule(freeze_steps)),
                                  optax.adamw(lr * item_scale, weight_decay=wd))}
    tx = optax.multi_transform(groups, labels)
    if grad_clip:
        tx = optax.chain(optax.clip_by_global_norm(grad_clip), tx)
    return JST.with_lr_factor(tx)


def _toy_pair(grad_clip, freeze_steps):
    rng = np.random.default_rng(0)
    w, b, item = (rng.normal(size=s).astype(np.float32) for s in ((3, 4), (3,), (5, 3)))
    toy = Toy()
    with torch.no_grad():
        toy.user.weight.copy_(_t(w)), toy.user.bias.copy_(_t(b)), toy.item.copy_(_t(item))
    opt = TST.grouped_adamw(toy, lambda n: "item" if n.startswith("item") else "user",
                            {"user": 1e-2, "item": 1e-2 * 0.05}, 0.1, grad_clip=grad_clip,
                            freeze_steps={"item": freeze_steps})
    params = {"user": {"weight": w.T.copy(), "bias": b}, "item": item}
    tx = _optax_tx(grad_clip, freeze_steps)
    return toy, opt, params, tx, tx.init(params)


def _grads(scale, step):
    rng = np.random.default_rng(100 + step)
    return (rng.normal(size=(3, 4)).astype(np.float32) * scale,
            rng.normal(size=(3,)).astype(np.float32) * scale,
            rng.normal(size=(5, 3)).astype(np.float32) * scale)


def _run(toy, opt, params, tx, opt_state, steps, scale, factors=None):
    for s in steps:
        gw, gb, gi = _grads(scale, s)
        if factors and s in factors:
            TST.set_lr_factor(opt, factors[s])
            opt_state = JST.set_lr_factor(opt_state, factors[s])
        toy.user.weight.grad, toy.user.bias.grad, toy.item.grad = _t(gw), _t(gb), _t(gi)
        opt.step()
        updates, opt_state = tx.update({"user": {"weight": gw.T, "bias": gb}, "item": gi},
                                       opt_state, params)
        params = optax.apply_updates(params, updates)
        np.testing.assert_allclose(toy.user.weight.detach().numpy(),
                                   np.asarray(params["user"]["weight"]).T, atol=1e-6, rtol=0)
        np.testing.assert_allclose(toy.item.detach().numpy(), np.asarray(params["item"]),
                                   atol=1e-6, rtol=0)
    return params, opt_state


@pytest.mark.parametrize("scale", [0.1, 10.0], ids=["clip_idle", "clip_active"])
def test_optimizer_matches_optax_clip_freeze_unfreeze_and_factor(scale):
    toy, opt, params, tx, opt_state = _toy_pair(grad_clip=1.0, freeze_steps=3)
    item0 = toy.item.detach().clone()
    # frozen: the item matrix moves only by decoupled decay, lr * item scale * wd a step
    _run(toy, opt, params, tx, opt_state, range(1), scale)
    np.testing.assert_allclose(toy.item.detach().numpy(),
                               item0.numpy() * (1 - 1e-2 * 0.05 * 0.1), rtol=1e-6)
    toy, opt, params, tx, opt_state = _toy_pair(grad_clip=1.0, freeze_steps=3)
    params, opt_state = _run(toy, opt, params, tx, opt_state, range(8), scale,
                             factors={5: 0.5, 7: 0.25})
    item_group = next(g for g in opt.param_groups if g["name"] == "item")
    assert item_group["updates"] == 8 and opt.state[toy.item]["step"] == 8   # Adam ticked


def test_clip_is_optax_arithmetic():
    rng = np.random.default_rng(3)
    gs = [rng.normal(size=s).astype(np.float32) * 4 for s in ((3, 4), (7,))]
    ref, _ = optax.clip_by_global_norm(2.0).update(gs, optax.EmptyState())
    ts = [_t(g.copy()) for g in gs]
    norm = TST.clip_by_global_norm_(ts, 2.0)
    assert float(norm) == pytest.approx(float(optax.global_norm(gs)), rel=1e-6)
    for t, r in zip(ts, ref):
        np.testing.assert_allclose(t.numpy(), np.asarray(r), rtol=1e-6)
    small = [_t(g / 100) for g in gs]
    TST.clip_by_global_norm_(small, 2.0)                      # below the limit: untouched
    np.testing.assert_array_equal(small[0].numpy(), gs[0] / 100)


def test_optimizer_resume_carries_factor_gate_and_moments(tmp_path):
    """Four steps, save, restore into a fresh optimizer, four more: the same
    weights as eight steps in one run and as optax (the factor, the gate's
    count and Adam's moments are all in ``state_dict()``)."""
    toy, opt, params, tx, opt_state = _toy_pair(grad_clip=1.0, freeze_steps=5)
    params, opt_state = _run(toy, opt, params, tx, opt_state, range(4), 3.0, factors={2: 0.5})
    torch.save({"model": toy.state_dict(), "optimizer": opt.state_dict()}, tmp_path / "c.pt")
    toy2, opt2, _, _, _ = _toy_pair(grad_clip=1.0, freeze_steps=5)
    payload = torch.load(tmp_path / "c.pt", weights_only=True)
    toy2.load_state_dict(payload["model"])
    opt2.load_state_dict(payload["optimizer"])
    assert all(g["lr_factor"] == 0.5 for g in opt2.param_groups)
    _run(toy2, opt2, params, tx, opt_state, range(4, 8), 3.0)


def test_plateau_scheduler_is_the_jax_one():
    seq = [0.1, 0.2, 0.2, 0.19, 0.3, 0.3, 0.3, 0.3, 0.1, 0.1]
    j, t = JST.PlateauScheduler(0.5, 2), TST.PlateauScheduler(0.5, 2)
    assert [t.update(m) for m in seq] == [j.update(m) for m in seq]
    assert (t.best, t.scale, t.bad) == (j.best, j.scale, j.bad)


# -- the item lookups on a virtual mesh --------------------------------------------------

def test_dense_and_a2a_lookups_give_the_same_step(stage2_world):
    """Row-sharded all-to-all lookups over a 2 x 2 mesh of the CPU: the same
    rows, the same loss and the same gradients as the dense lookup."""
    _, tcfg, _, tdata = stage2_world
    mesh = build_mesh(MeshConfig(num_data=2, num_model=2), ["cpu"] * 4)
    n_pad = len(tdata["item_map"]) + 1
    assert n_pad % 2 == 0
    batch = TS._slice(TS.tensors_to(tdata["tensors"], "cpu"), np.arange(16))
    out = {}
    for lookup in ("dense", "a2a"):
        cfg = dataclasses.replace(tcfg, user_train=dataclasses.replace(tcfg.user_train,
                                                                       lookup=lookup))
        model = TS.init_stage2_params(cfg, n_pad, None, "cpu", seed=0)
        fn = TS.make_item_lookup(cfg, model, mesh)
        ids = batch["input_ids"]
        rows = fn(ids)
        np.testing.assert_array_equal(rows.detach().numpy(),
                                      model.item.item_matrix.detach()[ids].numpy())
        state = TST.TrainState(model, TS.make_stage2_optimizer(cfg, model, 4))
        step, _ = TS.make_stage2_step(cfg, state, tdata["logq"], mesh)
        out[lookup] = (float(step(batch, torch.Generator().manual_seed(3))["loss"]),
                       model.item.item_matrix.detach().clone())
    assert out["a2a"][0] == pytest.approx(out["dense"][0], abs=1e-6)
    np.testing.assert_allclose(out["a2a"][1].numpy(), out["dense"][1].numpy(), atol=1e-7)
