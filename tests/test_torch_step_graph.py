"""The training step as a device program, on the CPU: the optimizer whose
count, gate, lr factor and warm-up live in tensors against the eager
arithmetic it replaces and against optax; ``train/step_graph.StepGraph``'s
eager path against the trainers' step functions and the JAX step; the copies
a replay hands out; the item lookup through ``F.embedding``.

The CUDA graph itself needs the card: ``tests/test_torch_kernel_cuda.py``
and ``chip_smoke.py`` phases 2 and 14 hold a captured step against the eager
one there.

Tolerances: the optimizer 1e-6 abs against optax and against the eager
arithmetic (fp32, the same update in another order of operations); the
runner's eager path bit for bit against the step it wraps (the same
operations); the JAX step at the towers' bf16 bound (2e-2, as
``test_torch_user_tower.py``); the lookup's forward exact and its gradient
1e-6 (sums of the same terms in another order).
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
from recsys_tpu.train import sasrec as JS
from recsys_tpu.train import state as JST
from recsys_tpu_torch.bridge import flax_to_torch
from recsys_tpu_torch.config import (
    Config, DataConfig, ItemTowerConfig, SimCSEConfig, UserTowerConfig, UserTrainConfig,
    VocabConfig)
from recsys_tpu_torch.data.dataset import tokenize_items
from recsys_tpu_torch.data.synthetic import generate_dataset
from recsys_tpu_torch.data.vocab import StdVocab
from recsys_tpu_torch.models.user_tower import SASRecItemTower
from recsys_tpu_torch.ops._build import captured_launches
from recsys_tpu_torch.train import sasrec as TS
from recsys_tpu_torch.train import simcse as TSC
from recsys_tpu_torch.train import state as TST
from recsys_tpu_torch.train.step_graph import StepGraph

TOWER = dict(d_model=32, max_len=8, nhead=2, num_layers=1, dropout=0.0)
USER_TRAIN = dict(batch_size=16, positions_per_user=2, kernel="xla", random_cut_prob=0.5)
ITEM_CFG = Config(
    data=DataConfig(num_items=64, num_users=16, days=30, seed=3),
    vocab=VocabConfig(max_field_tokens=8, max_name_tokens=8, text_vocab_size=512),
    item_tower=ItemTowerConfig(head_hidden=(128,), fusion_layers=1, text_layers=1),
    simcse=SimCSEConfig(batch_size=16, epochs=1, steps_per_epoch_min=1))


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


# -- the optimizer: device tensors against the eager arithmetic and optax -------------------

class Toy(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.user = torch.nn.Linear(4, 3)
        self.item = torch.nn.Parameter(torch.zeros(5, 3))


class EagerGroupedAdamW(torch.optim.AdamW):
    """The arithmetic the device program replaces: ``torch.optim.AdamW`` with
    the freeze gate decided and the lr factor applied on the host."""

    def __init__(self, groups, weight_decay, grad_clip):
        for g in groups:
            g.update(updates=0, lr_factor=1.0)
        super().__init__(groups, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
        self.grad_clip = grad_clip

    @torch.no_grad()
    def step(self, closure=None):
        params = [p for g in self.param_groups for p in g["params"]]
        if self.grad_clip:
            TST.clip_by_global_norm_([p.grad for p in params], self.grad_clip)
        lrs = []
        for g in self.param_groups:
            if g["updates"] < g["freeze_steps"]:
                for p in g["params"]:
                    p.grad.zero_()
            g["updates"] += 1
            lrs.append(g["lr"])
            g["lr"] = g["lr"] * g["lr_factor"]
        super().step()
        for g, lr in zip(self.param_groups, lrs):
            g["lr"] = lr


# each case crosses one of the device decisions: the item group's unfreeze after
# 3 updates; the plateau factor set twice; SimCSE's warm-up (3 of 10 updates)
# then its linear decay
OPT_CASES = {
    "freeze": dict(grad_clip=1.0, freeze=3, factors={}, schedule=None),
    "plateau": dict(grad_clip=1.0, freeze=0, factors={2: 0.5, 5: 0.25}, schedule=None),
    "warmup": dict(grad_clip=None, freeze=0, factors={}, schedule=(10, 0.3)),
}
LRS, WD, STEPS = {"user": 1e-2, "item": 1e-3}, 0.1, 8


def _optax_chain(case):
    def adamw(lr):
        if case["schedule"]:
            lr = JST.warmup_linear_schedule(lr, *case["schedule"])
        return optax.adamw(lr, weight_decay=WD)

    item = adamw(LRS["item"])
    if case["freeze"]:
        item = optax.chain(optax.scale_by_schedule(JST.freeze_gate_schedule(case["freeze"])),
                           item)
    tx = optax.multi_transform({"user": adamw(LRS["user"]), "item": item},
                               {"user": {"weight": "user", "bias": "user"}, "item": "item"})
    if case["grad_clip"]:
        tx = optax.chain(optax.clip_by_global_norm(case["grad_clip"]), tx)
    return JST.with_lr_factor(tx)


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_device_optimizer_is_the_eager_arithmetic_and_optax(case):
    case = OPT_CASES[case]
    rng = np.random.default_rng(0)
    w, b, item = (rng.normal(size=s).astype(np.float32) for s in ((3, 4), (3,), (5, 3)))
    toys = [Toy(), Toy()]
    for toy in toys:
        with torch.no_grad():
            toy.user.weight.copy_(_t(w)), toy.user.bias.copy_(_t(b)), toy.item.copy_(_t(item))
    label = lambda n: "item" if n.startswith("item") else "user"
    dev_opt = TST.grouped_adamw(toys[0], label, LRS, WD, grad_clip=case["grad_clip"],
                                freeze_steps={"item": case["freeze"]})
    eager_opt = EagerGroupedAdamW(
        [{"params": [p for n, p in toys[1].named_parameters() if label(n) == name],
          "lr": lr, "freeze_steps": case["freeze"] if name == "item" else 0}
         for name, lr in LRS.items()], WD, case["grad_clip"])
    scheds = []
    if case["schedule"]:
        total, frac = case["schedule"]
        scheds = [TST.WarmupLinearLR(dev_opt, total, frac),
                  torch.optim.lr_scheduler.LambdaLR(
                      eager_opt, TST.warmup_linear_factor(total, frac))]
        assert all(isinstance(g["lr"], torch.Tensor) for g in dev_opt.param_groups)
    params = {"user": {"weight": w.T.copy(), "bias": b}, "item": item}
    tx = _optax_chain(case)
    opt_state = tx.init(params)
    for s in range(STEPS):
        g = np.random.default_rng(100 + s)
        gw, gb, gi = (g.normal(size=x.shape).astype(np.float32) * 3 for x in (w, b, item))
        if s in case["factors"]:
            TST.set_lr_factor(dev_opt, case["factors"][s])
            for grp in eager_opt.param_groups:
                grp["lr_factor"] = case["factors"][s]
            opt_state = JST.set_lr_factor(opt_state, case["factors"][s])
        for toy, opt in zip(toys, (dev_opt, eager_opt)):
            toy.user.weight.grad, toy.user.bias.grad, toy.item.grad = _t(gw), _t(gb), _t(gi)
            opt.step()
        for sched in scheds:
            sched.step()
        updates, opt_state = tx.update({"user": {"weight": gw.T, "bias": gb}, "item": gi},
                                       opt_state, params)
        params = optax.apply_updates(params, updates)
        for a, e, r in ((toys[0].user.weight, toys[1].user.weight, params["user"]["weight"].T),
                        (toys[0].user.bias, toys[1].user.bias, params["user"]["bias"]),
                        (toys[0].item, toys[1].item, params["item"])):
            np.testing.assert_allclose(a.detach().numpy(), e.detach().numpy(), atol=1e-6, rtol=0)
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(r), atol=1e-6, rtol=0)
    for grp in dev_opt.param_groups:
        assert isinstance(grp["updates"], torch.Tensor) and int(grp["updates"]) == STEPS
        assert float(dev_opt.state[grp["params"][0]]["step"]) == STEPS
    if case["freeze"]:   # the gate opened on the device: the item matrix moved by its updates
        assert not np.allclose(toys[0].item.detach().numpy(), item * (1 - LRS["item"] * WD) ** STEPS)
    # a checkpoint loads into the tensors a captured step reads, in place
    kept = [(grp["updates"], grp["lr_factor"]) for grp in dev_opt.param_groups]
    dev_opt.load_state_dict({**dev_opt.state_dict(), "param_groups": [
        {**grp, "updates": 3, "lr_factor": 0.5} for grp in dev_opt.state_dict()["param_groups"]]})
    for grp, (updates, factor) in zip(dev_opt.param_groups, kept):
        assert grp["updates"] is updates and grp["lr_factor"] is factor
        assert float(updates) == 3 and float(factor) == 0.5


# -- the runner's eager path ---------------------------------------------------------------------

def configs(**train):
    data = dict(num_items=59, num_users=40, days=40, seed=2)
    tr = {**USER_TRAIN, **train}
    jcfg = JaxConfig(data=JaxDataConfig(**data), vocab=JaxVocabConfig(num_hash_buckets=50),
                     user_tower=JaxUserTowerConfig(**TOWER), user_train=JaxUserTrainConfig(**tr))
    tcfg = Config(data=DataConfig(**data), vocab=VocabConfig(num_hash_buckets=50),
                  user_tower=UserTowerConfig(**TOWER), user_train=UserTrainConfig(**tr))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def stage2_world():
    jcfg, tcfg = configs()
    items, users, tx = generate_dataset(tcfg.data)
    return jcfg, tcfg, JS.prepare_stage2(jcfg, items, users, tx), TS.prepare_stage2(
        tcfg, items, users, tx)


def _stage2_trainer(tcfg, tdata, n_pad):
    model = TS.init_stage2_params(tcfg, n_pad, None, "cpu", seed=0)
    state = TST.TrainState(model, TS.make_stage2_optimizer(tcfg, model, 4))
    step, _ = TS.make_stage2_step(tcfg, state, tdata["logq"])
    return model, state, step


def test_runner_is_the_stage2_step_on_fixed_draws(stage2_world):
    """Three steps through the runner and through ``make_stage2_step`` on the
    same rows and draws (the cut, the positions), dropout on, generators of
    one seed: the same losses and parameters, bit for bit, and the count."""
    _, tcfg, _, tdata = stage2_world
    tcfg = dataclasses.replace(tcfg, user_tower=dataclasses.replace(tcfg.user_tower,
                                                                    dropout=0.1))
    n_pad, B, P = len(tdata["item_map"]) + 1, 16, 2
    data = TS.tensors_to(tdata["tensors"], "cpu")
    n = data["input_ids"].shape[0]
    m_run, s_run, step_run = _stage2_trainer(tcfg, tdata, n_pad)
    m_ref, s_ref, step_ref = _stage2_trainer(tcfg, tdata, n_pad)
    runner = StepGraph(step_run, s_run, data, B, torch.Generator().manual_seed(4))
    assert not runner.capture
    gen = torch.Generator().manual_seed(4)
    rng = np.random.default_rng(0)
    for _ in range(3):
        idx = rng.permutation(n)[:B]
        draws = {"cut": (_t(rng.random(B) < 0.5), _t(rng.integers(0, 8, B))),
                 "positions": _t(rng.integers(0, 8, (B, P)))}
        got = runner(idx, draws)
        ref = step_ref(TS._slice(data, idx), gen, draws)
        assert all(torch.equal(got[k], ref[k]) for k in ("loss", "main", "cl"))
    for a, b in zip(m_run.state_dict().values(), m_ref.state_dict().values()):
        assert torch.equal(a, b)
    assert s_run.step == s_ref.step == 3 and runner.replays == 0


def test_runner_is_the_item_step():
    """Three steps through the runner and through ``make_train_step`` with
    the view corruption and dropout on, generators of one seed: the same
    losses, embeddings and parameters, bit for bit."""
    items, _, _ = generate_dataset(ITEM_CFG.data)
    tensors = tokenize_items(items, StdVocab(), ITEM_CFG.vocab)
    data = TSC.item_tensors_to(tensors, "cpu")
    n, bs = tensors["std"].shape[0], ITEM_CFG.simcse.batch_size
    runs = []
    for _ in range(2):
        model = TSC.build_model(ITEM_CFG, StdVocab().size, tensors["std"].shape[1], "cpu",
                                seed=0)
        state = TST.TrainState(model, *TSC.make_optimizer(ITEM_CFG, model, total_steps=10))
        runs.append((model, state, TSC.make_train_step(state, ITEM_CFG)))
    runner = StepGraph(runs[0][2], runs[0][1], data, bs, torch.Generator().manual_seed(1),
                       capture=False)
    gen = torch.Generator().manual_seed(1)
    rng = np.random.default_rng(2)
    for _ in range(3):
        idx = rng.permutation(n)[:bs]
        got = runner(idx)
        ix = torch.as_tensor(idx)
        ref = runs[1][2]({k: v[ix] for k, v in data.items()}, gen)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    for a, b in zip(runs[0][0].state_dict().values(), runs[1][0].state_dict().values()):
        assert torch.equal(a, b)
    assert runs[0][1].step == 3


def test_runner_gives_the_jax_step_on_its_draws(stage2_world):
    """The JAX step's own draws (``split(key, 4)``: cut, positions) replayed
    into the port's step through the runner, weights bridged: the loss parts
    agree at the towers' bf16 bound."""
    from recsys_tpu.ops import augment as JA

    jcfg, tcfg, jdata, tdata = stage2_world
    B, P = 16, 2
    sample = JS._slice(jdata["tensors"], np.arange(B))
    n_pad = len(jdata["item_map"]) + 1
    pretrained = np.random.default_rng(0).normal(size=(n_pad, 32)).astype(np.float32)
    params, models = JS.init_stage2_params(jcfg, n_pad, pretrained, jax.random.PRNGKey(0),
                                           sample)
    jstate = JST.TrainState.create(params, JS.make_stage2_optimizer(jcfg, params, 4))
    jstep, _ = JS.make_stage2_step(jcfg, models, jdata["side"], jdata["logq"])
    key = jax.random.PRNGKey(5)
    _, jaux = jstep(jstate, {k: jnp.asarray(v) for k, v in sample.items()}, key)
    _, _, kp, kc = jax.random.split(key, 4)
    k_gate, k_pos = jax.random.split(kc)
    gate = np.asarray(jax.random.bernoulli(k_gate, 0.5, (B,)))
    gumbel = jax.random.gumbel(k_pos, sample["seq_mask"].shape)
    cut = np.asarray(jnp.argmax(jnp.where(sample["seq_mask"] > 0, gumbel, -jnp.inf), -1))
    cut_batch = JA.random_cut({k: jnp.asarray(v) for k, v in sample.items()}, kc, 0.5)
    logits = jnp.where(cut_batch["seq_mask"] > 0, 0.0, -1e9)
    positions = np.asarray(jax.random.categorical(kp, logits[:, None, :], axis=-1,
                                                  shape=(B, P)))
    draws = {"cut": (_t(gate), _t(cut).long()), "positions": _t(positions)}

    model = TS.init_stage2_params(tcfg, n_pad, None, "cpu")
    model.load_state_dict(flax_to_torch(jax.device_get(params)), strict=True)
    state = TST.TrainState(model, TS.make_stage2_optimizer(tcfg, model, 4))
    step, _ = TS.make_stage2_step(tcfg, state, tdata["logq"])
    runner = StepGraph(step, state, TS.tensors_to(tdata["tensors"], "cpu"), B,
                       torch.Generator().manual_seed(0))
    aux = runner(np.arange(B), draws)
    for part in ("main", "loss", "cl"):
        assert float(aux[part]) == pytest.approx(float(jaux[part]), abs=2e-2), part
    assert state.step == 1


def test_runner_refuses_a_graph_off_the_card():
    data = {"x": torch.zeros(4, 2)}
    with pytest.raises(ValueError, match="CUDA device"):
        StepGraph(lambda batch, gen: None, TST.TrainState(None, None), data, 2, None,
                  capture=True)


class _StubGraph:
    """Stands in for a CUDA graph: each replay writes the step's outputs into
    the same buffers, as a graph does."""

    def __init__(self, outputs):
        self.outputs, self.replays = outputs, 0

    def replay(self):
        self.replays += 1
        for v in self.outputs.values():
            v.fill_(float(self.replays))


def test_replays_hand_out_copies_and_count_their_launches():
    """A loop that keeps each replay's outputs holds distinct tensors, not one
    buffer the next replay overwrites; each replay adds the launches logged
    at the capture to their counts and one to the step count."""
    state = TST.TrainState(None, None)
    runner = StepGraph(lambda batch, gen: None, state, {"x": torch.zeros(4, 2)}, 2, None)
    runner._outputs = {"loss": torch.zeros(()), "main": torch.zeros(())}
    runner.graph = _StubGraph(runner._outputs)
    runner._on_stream = lambda fn: fn()               # no stream off the card
    counts = {"k": 0}
    with captured_launches() as log:
        log.append((counts, "k"))                     # as count_launch logs a captured launch
    runner.launches = log
    kept = [runner._replay() for _ in range(3)]
    assert [float(o["loss"]) for o in kept] == [1.0, 2.0, 3.0]
    assert len({o["loss"].data_ptr() for o in kept} | {runner._outputs["loss"].data_ptr()}) == 4
    assert counts == {"k": 3} and state.step == 3 and runner.replays == 3


# -- the item lookup -------------------------------------------------------------------------------

def test_item_lookup_is_the_index_form_and_jnp_take():
    """``F.embedding`` over ids with repeats (and PAD): the rows of the
    index form exactly; the gradient of both, and of ``jnp.take``'s VJP, the
    same row sums."""
    rng = np.random.default_rng(0)
    table = rng.normal(size=(40, 8)).astype(np.float32)
    ids = rng.integers(0, 40, (6, 9))
    ids[0, :4] = 7                                     # one row many times
    ids[1, :2] = 0                                     # the PAD row
    upstream = rng.normal(size=(6, 9, 8)).astype(np.float32)
    tower = SASRecItemTower(40, 8)
    with torch.no_grad():
        tower.item_matrix.copy_(_t(table))
    rows = tower(torch.as_tensor(ids))
    (rows * _t(upstream)).sum().backward()
    index_table = _t(table).requires_grad_(True)
    index_rows = index_table[torch.as_tensor(ids)]
    (index_rows * _t(upstream)).sum().backward()
    assert torch.equal(rows.detach(), index_rows.detach())
    ref_rows, vjp = jax.vjp(lambda t: jnp.take(t, ids, axis=0), jnp.asarray(table))
    (ref_grad,) = vjp(jnp.asarray(upstream))
    np.testing.assert_array_equal(rows.detach().numpy(), np.asarray(ref_rows))
    np.testing.assert_allclose(tower.item_matrix.grad.numpy(), index_table.grad.numpy(),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(tower.item_matrix.grad.numpy(), np.asarray(ref_grad),
                               atol=1e-6, rtol=0)
