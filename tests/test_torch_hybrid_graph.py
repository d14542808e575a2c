"""The hybrid trainer's step as a device program, on the CPU: its learning-rate
schedule computed on the device against optax's, ``train_hybrid`` through
``StepGraph`` against the step called directly, and a checkpoint of the
``LambdaLR`` recipe (the hybrid trainer's schedule until the step was
captured) resumed by the device schedule.

Tolerances: the schedule 1e-7 against optax (float32 on both sides, the
same order of operations); the runner against the direct step bit for bit
(the same arithmetic on the same rows and draws); the resumed parameters
1e-7 against the ``LambdaLR`` run (its rate a host float set before each
update, the device's a float32 tensor computed there).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from recsys_tpu_torch.config import Config, UserTrainConfig
from recsys_tpu_torch.data.dataset import IdMap, batch_iterator
from recsys_tpu_torch.train import hybrid as H
from recsys_tpu_torch.train.checkpoint import CheckpointStore
from recsys_tpu_torch.train.sasrec import _slice, tensors_to
from recsys_tpu_torch.train.state import DeviceLR, TrainState, grouped_adamw, hybrid_schedule

SCHEDULES = {
    "constant": dict(lr=1e-2),
    "linear_warmup": dict(lr=1e-2, hybrid_warmup_steps=4),
    "warmup_cosine": dict(hybrid_lr=5e-3, hybrid_warmup_steps=3, hybrid_lr_decay="cosine"),
}
N_ITEMS, L, CONTENT, GNN = 30, 6, 16, 8


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class Toy(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.item_adapter = torch.nn.Linear(4, 3)
        self.encoder = torch.nn.Linear(3, 3)


def optax_schedule(ut: UserTrainConfig, total: int):
    """The JAX trainer's schedule (``recsys_tpu/train/hybrid.py:98-107``)."""
    base_lr = ut.hybrid_lr or ut.lr
    if ut.hybrid_warmup_steps > 0 or ut.hybrid_lr_decay == "cosine":
        warmup = min(ut.hybrid_warmup_steps, max(total - 1, 1))
        if ut.hybrid_lr_decay == "cosine":
            return optax.warmup_cosine_decay_schedule(0.0, base_lr, warmup,
                                                      max(total, warmup + 1))
        return optax.linear_schedule(0.0, base_lr, max(warmup, 1))
    return optax.constant_schedule(base_lr)


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_device_schedule_is_optax_at_every_step(name):
    ut = UserTrainConfig(hybrid_slow_modules=("encoder",), hybrid_slow_scale=0.1,
                         **SCHEDULES[name])
    total = 12
    toy = Toy()
    opt, sched = H.make_hybrid_optimizer(ut, toy, total)
    assert isinstance(sched, DeviceLR) and [g["name"] for g in opt.param_groups] == [
        "base", "slow"]
    ref = optax_schedule(ut, total)
    for step in range(total + 3):                 # past the end: the schedule holds
        want = float(ref(jnp.asarray(step)))
        for g in opt.param_groups:
            assert isinstance(g["lr"], torch.Tensor)
            assert float(g["lr"]) == pytest.approx(want, abs=1e-7)
        assert float(hybrid_schedule(ut.hybrid_lr or ut.lr, ut.hybrid_warmup_steps,
                                     ut.hybrid_lr_decay, total)(torch.tensor(step))
                     ) == pytest.approx(want, abs=1e-7)
        for p in toy.parameters():
            p.grad = torch.ones_like(p)
        opt.step()
        # the rate AdamW read: the group's rate times its factor (the slow modules' 0.1)
        for g, lr in zip(opt.param_groups, opt._lrs):
            factor = 0.1 if g["name"] == "slow" else 1.0
            assert float(lr) == pytest.approx(want * factor, abs=1e-7)
        sched.step()


# -- train_hybrid through the step runner ----------------------------------------------

def small_config(**train) -> Config:
    base = Config()
    return dataclasses.replace(
        base, user_tower=dataclasses.replace(base.user_tower, d_model=32, nhead=2, max_len=L),
        user_train=dataclasses.replace(base.user_train, batch_size=8, eval_ks=(5, 20),
                                       hybrid_warmup_steps=2, hybrid_lr_decay="cosine",
                                       hybrid_slow_modules=("item_adapter",),
                                       hybrid_slow_scale=0.5, **train))


def small_world(n: int = 24, seed: int = 0) -> dict:
    """Stage-2 data of ``n`` users over N_ITEMS items (ragged, left-padded
    histories), content and GNN rows, targets for the eval."""
    utc = Config().user_tower
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, L + 1, n)
    mask = (np.arange(L)[None, :] >= L - lengths[:, None]).astype(np.int64)
    rows = {"input_ids": rng.integers(1, N_ITEMS + 1, (n, L)) * mask,
            "target_ids": rng.integers(1, N_ITEMS + 1, (n, L)) * mask,
            "time_buckets": rng.integers(0, utc.num_time_buckets, (n, L)) * mask,
            "seq_mask": mask,
            "user_buckets": rng.integers(0, 10, (n, utc.static_bucket_fields)),
            "user_cats": rng.integers(0, 2, (n, utc.static_cat_fields)),
            "user_cont": rng.normal(0, 1, (n, utc.static_cont_fields)).astype(np.float32)}
    user_ids = [f"u{r}" for r in range(n)]
    content = rng.normal(size=(N_ITEMS + 1, CONTENT)).astype(np.float32)
    content[0] = 0.0
    gnn_items = rng.normal(0, 0.1, (N_ITEMS + 1, GNN)).astype(np.float32)
    gnn_items[0] = 0.0
    return {"data": {"tensors": {**rows, "user_ids": user_ids},
                     "item_map": IdMap([f"i{r}" for r in range(1, N_ITEMS + 1)]),
                     "logq": rng.normal(-3.0, 0.5, N_ITEMS + 1).astype(np.float32),
                     "targets_idx": {u: {int(rng.integers(1, N_ITEMS + 1))}
                                     for u in user_ids[::2]}},
            "content": content, "gnn_items": gnn_items,
            "gnn_users": rng.normal(0, 0.3, (n, GNN)).astype(np.float32)}


def trainer(cfg: Config, world: dict, total: int):
    data = world["data"]
    model = H.build_hybrid_model(cfg, N_ITEMS + 1, CONTENT, GNN, "cpu", seed=cfg.data.seed)
    opt, sched = H.make_hybrid_optimizer(cfg.user_train, model, total)
    state = TrainState(model, opt, sched)
    step, _, _ = H.make_hybrid_step(cfg, state, world["content"], world["gnn_items"],
                                    data["logq"])
    return model, state, step


def test_runner_is_the_step_called_directly():
    """The step through ``hybrid_runner`` (the batch and its GNN rows gathered
    by the runner) against the step on rows gathered by hand, from one state
    and one generator seed: the same losses and parameters, bit for bit, with
    dropout, the random cut and the GNN keep mask drawn from the generator."""
    cfg, world = small_config(), small_world()
    dev = tensors_to(world["data"]["tensors"], "cpu")
    gnn = torch.as_tensor(world["gnn_users"])
    batches = [np.random.default_rng(s).permutation(24)[:8] for s in range(6)]
    (m_run, s_run, step_run), (m_dir, s_dir, step_dir) = (trainer(cfg, world, 6)
                                                          for _ in range(2))
    runner = H.hybrid_runner(step_run, s_run, dev, gnn, 8, torch.Generator().manual_seed(3))
    assert not runner.capture                      # the CPU runs the step eagerly
    gen = torch.Generator().manual_seed(3)
    for idx in batches:
        got = runner(idx)["loss"]
        want = step_dir(_slice(dev, idx), gnn[torch.as_tensor(idx)], gen)["loss"]
        assert torch.equal(got, want)
    assert runner.replays == 0 and s_run.step == s_dir.step == len(batches)
    for (name, a), b in zip(m_run.state_dict().items(), m_dir.state_dict().values()):
        assert torch.equal(a, b), name


def test_train_hybrid_is_its_steps_called_directly(tmp_path):
    """``train_hybrid`` (one epoch, three passes) against its loop written out
    with the step called directly: the epoch's mean loss and the restored
    (best = only) checkpoint's parameters bit for bit; no replay on the CPU."""
    cfg = small_config(epochs=1, hybrid_steps_per_epoch_min=9)
    world = small_world()
    state, history, (model, _, _) = H.train_hybrid(
        cfg, world["data"], world["content"], world["gnn_items"], world["gnn_users"],
        str(tmp_path / "ckpt"), "cpu")
    assert state.step == 9 and state.graph_replays == 0 and len(history) == 1
    ref_model, ref_state, step = trainer(cfg, world, 9)
    dev = tensors_to(world["data"]["tensors"], "cpu")
    gnn = torch.as_tensor(world["gnn_users"])
    rng = np.random.default_rng(cfg.data.seed + 2)
    gen = torch.Generator("cpu").manual_seed(cfg.data.seed)
    losses = [step(_slice(dev, idx), gnn[torch.as_tensor(idx)], gen)["loss"]
              for _ in range(3) for idx in batch_iterator(24, 8, rng)]
    assert ref_state.step == 9
    assert state.losses == [float(torch.stack(losses).mean())]
    for (name, a), b in zip(model.state_dict().items(), ref_model.state_dict().values()):
        assert torch.equal(a, b), name


# -- a checkpoint of the LambdaLR recipe ---------------------------------------------------

def _grads(toy: Toy, seed: int) -> None:
    g = np.random.default_rng(seed)
    for p in toy.parameters():
        p.grad = torch.as_tensor(g.normal(size=tuple(p.shape)).astype(np.float32))


def lambda_lr_recipe(ut: UserTrainConfig, toy: Toy, total: int):
    """The hybrid optimizer as the trainer built it before its step was
    captured: the same groups, the schedule a host ``LambdaLR`` of floats."""
    base_lr = ut.hybrid_lr or ut.lr
    opt = grouped_adamw(toy, lambda n: "slow" if n.split(".")[0] in ut.hybrid_slow_modules
                        else "base", {"base": base_lr, "slow": base_lr}, ut.weight_decay,
                        grad_clip=ut.grad_clip, lr_factors={"slow": ut.hybrid_slow_scale})
    sched = hybrid_schedule(base_lr, ut.hybrid_warmup_steps, ut.hybrid_lr_decay, total)
    return opt, torch.optim.lr_scheduler.LambdaLR(
        opt, lambda s: float(sched(torch.tensor(s))) / base_lr)


def test_a_lambda_lr_checkpoint_resumes(tmp_path):
    """A checkpoint written by the ``LambdaLR`` recipe (its rate a host float
    in the optimizer's groups, its position in the scheduler's state) loads
    into the device schedule: the count, the rate of the next update, and
    five more updates equal to the ``LambdaLR`` run's continuation."""
    ut = UserTrainConfig(hybrid_lr=1e-2, hybrid_warmup_steps=3, hybrid_lr_decay="cosine",
                         hybrid_slow_modules=("encoder",), hybrid_slow_scale=0.1)
    total = 12
    torch.manual_seed(0)
    old = Toy()
    opt, sched = lambda_lr_recipe(ut, old, total)
    for s in range(5):
        _grads(old, s)
        opt.step()
        sched.step()
    store = CheckpointStore(str(tmp_path / "ckpt_hybrid"), maximize=True)
    store.save("ep001", {"model": old.state_dict(), "optimizer": opt.state_dict(),
                         "scheduler": sched.state_dict()}, step=5, metric=0.1,
               extra={"epoch": 1})
    assert isinstance(opt.state_dict()["param_groups"][0]["lr"], float)

    new = Toy()
    new_opt, new_sched = H.make_hybrid_optimizer(ut, new, total)
    lr_tensors = [g["lr"] for g in new_opt.param_groups]
    payload, _ = store.restore_best("cpu")
    new.load_state_dict(payload["model"])
    new_opt.load_state_dict(payload["optimizer"])
    new_sched.load_state_dict(payload["scheduler"])
    want = float(optax_schedule(ut, total)(jnp.asarray(5)))
    for g, lr in zip(new_opt.param_groups, lr_tensors):
        assert g["lr"] is lr                      # the tensor a captured step reads
        assert float(g["updates"]) == 5 and float(lr) == pytest.approx(want, abs=1e-7)
    for s in range(5, 10):
        for toy, o, sc in ((old, opt, sched), (new, new_opt, new_sched)):
            _grads(toy, s)
            o.step()
            sc.step()
    for a, b in zip(old.parameters(), new.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=1e-7, rtol=0)
