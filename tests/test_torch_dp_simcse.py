"""The port's data-parallel stage-1 step against its single-device step and
against the JAX package's global-batch program, on the CPU.

Both packages get the same weights (through the bridge), tower dropout 0 and
the same two views, made with numpy. The JAX loss is one jitted program over
a batch sharded on the data axis of the 8 x 1 virtual CPU mesh, which is what
makes its in-batch negatives global. The port splits the batch over virtual
data shards, gathers the embeddings onto the master's device and takes the
single-device loss on the gathered views.

With the tower computing in fp32 (``fp32_tower``) the sharded and the
single-device step differ only in the order of fp32 sums: loss and summed
gradients are held to 1e-5. On the port's sharded embeddings the JAX loss
program on the data mesh is held to 1e-4. With the tower as it ships, in bf16,
a matrix product rounds differently at another batch size (an embedding moves
by up to 2e-3), so there the sharded loss is held to 1e-3 of the
single-device loss and the summed gradients to 5% of each tensor's norm;
where a shard runs through a copy of the module on another device instead of
the master, with the same split, losses, gradients and updated weights are
held to 1e-6. Against the JAX tower, which is bf16 and rounds at other places,
the loss is held at 1e-2 abs, the bound of ``tests/test_torch_item_tower.py``
for the single-device losses.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from recsys_tpu.config import Config, DataConfig, ItemTowerConfig, SimCSEConfig, VocabConfig
from recsys_tpu.data.dataset import slice_item_batch, tokenize_items
from recsys_tpu.data.synthetic import generate_dataset
from recsys_tpu.data.vocab import StdVocab
from recsys_tpu.ops import contrastive as JC
from recsys_tpu.parallel.mesh import data_sharding, replicated
from recsys_tpu.train.simcse import build_model as jax_build_model
from recsys_tpu.train.simcse import init_params
from recsys_tpu_torch.bridge import load_flax_params
from recsys_tpu_torch.config import MeshConfig
from recsys_tpu_torch.parallel.mesh import build_mesh
from recsys_tpu_torch.train import simcse as TS
from recsys_tpu_torch.train.state import TrainState

CFG = Config(
    data=DataConfig(num_items=64, num_users=16, days=30, seed=3),
    vocab=VocabConfig(max_field_tokens=8, max_name_tokens=8, text_vocab_size=512),
    item_tower=ItemTowerConfig(head_hidden=(128,), fusion_layers=1, text_layers=1,
                               dropout=0.0),
    simcse=SimCSEConfig(batch_size=32, epochs=1, metrics_every=2, steps_per_epoch_min=1,
                        kernel="xla"),
)
INPUTS = ("std", "re_ids", "re_mask", "txt_ids", "txt_mask")
B = 32


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def torch_mesh(num_data, num_model=1, devices=None):
    return build_mesh(MeshConfig(num_data=num_data, num_model=num_model),
                      devices or ["cpu"] * (num_data * num_model))


@pytest.fixture(scope="module")
def item_tensors():
    items, _, _ = generate_dataset(CFG.data)
    return tokenize_items(items, StdVocab(), CFG.vocab)


@pytest.fixture(scope="module")
def views(item_tensors):
    """Two corrupted views of one batch, made with numpy."""
    rng = np.random.default_rng(7)
    b = slice_item_batch(item_tensors, np.arange(B))
    out = []
    for _ in range(2):
        v = dict(b)
        v["re_mask"] = (b["re_mask"] * (rng.random(b["re_mask"].shape) > 0.2)).astype(np.int32)
        out.append(v)
    return out


@pytest.fixture(scope="module")
def jax_side(item_tensors):
    jm = jax_build_model(CFG, StdVocab().size, item_tensors["std"].shape[1])
    return jm, jax.device_get(init_params(jm, item_tensors, jax.random.PRNGKey(1)))


def port_model(jax_side):
    tm = TS.build_model(CFG, StdVocab().size, 6, "cpu")
    load_flax_params(tm, jax_side[1])
    return tm.train()


def as_tensors(view):
    return {k: torch.tensor(v) for k, v in view.items()}


def single_device(jax_side, views):
    tm = port_model(jax_side)
    loss, e1, e2 = TS.loss_on_views(tm, CFG, as_tensors(views[0]), as_tensors(views[1]))
    loss.backward()
    return tm, loss.detach(), e1.detach(), e2.detach()


def sharded(jax_side, views, mesh):
    tm = port_model(jax_side)
    replicas = TS.Replicas(tm, mesh)
    loss, e1, e2 = TS.loss_on_sharded_views(replicas, CFG, as_tensors(views[0]),
                                            as_tensors(views[1]), mesh)
    loss.backward()
    replicas.collect_grads()
    return tm, loss.detach(), e1, e2, replicas


@pytest.mark.parametrize("num_data,num_model", [(4, 2), (8, 1), (2, 1)])
def test_dp_loss_matches_single_device_and_jax(jax_side, views, mesh_dp, num_data, num_model):
    jm, params = jax_side

    @jax.jit
    def jloss(p, v1, v2):
        e1 = jm.apply({"params": p}, *[v1[k] for k in INPUTS], deterministic=True)
        e2 = jm.apply({"params": p}, *[v2[k] for k in INPUTS], deterministic=True)
        return JC.bidirectional_infonce(e1, e2, CFG.simcse.temperature)

    put = lambda v: jax.device_put({k: v[k] for k in INPUTS}, data_sharding(mesh_dp))
    ref = float(jloss(jax.device_put(params, replicated(mesh_dp)), put(views[0]),
                      put(views[1])))
    _, single, s1, s2 = single_device(jax_side, views)
    _, loss, e1, e2, _ = sharded(jax_side, views, torch_mesh(num_data, num_model))
    assert float(loss) == pytest.approx(float(single), abs=1e-3)
    assert float(loss) == pytest.approx(ref, abs=1e-2)
    assert e1.shape == (B, 128) and not e1.requires_grad
    torch.testing.assert_close(e1, s1, rtol=0, atol=2e-2)
    torch.testing.assert_close(e2, s2, rtol=0, atol=2e-2)


@pytest.fixture
def fp32_tower(monkeypatch):
    """The port's tower computing in fp32: every place where it casts to bf16
    casts to fp32 instead, for the test's duration."""
    from recsys_tpu_torch.models import item_tower, layers, text_encoder

    for module in (layers, item_tower, text_encoder):
        if hasattr(module, "BF16"):
            monkeypatch.setattr(module, "BF16", torch.float32)

    def make(jax_side):
        tm = port_model(jax_side)
        for m in tm.modules():
            if hasattr(m, "compute_dtype"):
                m.compute_dtype = torch.float32
        return tm

    return make


@pytest.mark.parametrize("num_data,devices", [(2, None), (4, None), (8, None),
                                              (4, ["cpu", "cpu:0", "cpu", "cpu:0"])])
def test_dp_fp32_loss_and_grads_match_single_device_and_jax(jax_side, views, mesh_dp,
                                                            fp32_tower, num_data, devices):
    """No bf16 in the way: the sharded loss and every summed gradient equal
    the single-device ones to 1e-5, and the JAX global-batch loss program, on
    the port's sharded embeddings laid over the data mesh, gives the port's
    loss to 1e-4."""
    ref_model = fp32_tower(jax_side)
    ref_loss, _, _ = TS.loss_on_views(ref_model, CFG, as_tensors(views[0]),
                                       as_tensors(views[1]))
    ref_loss.backward()

    mesh = torch_mesh(num_data, 1, devices)
    tm = fp32_tower(jax_side)
    replicas = TS.Replicas(tm, mesh)
    loss, e1, e2 = TS.loss_on_sharded_views(replicas, CFG, as_tensors(views[0]),
                                            as_tensors(views[1]), mesh)
    loss.backward()
    replicas.collect_grads()
    assert float(loss.detach()) == pytest.approx(float(ref_loss.detach()), abs=1e-5)
    checked = 0
    for (name, p), r in zip(tm.named_parameters(), ref_model.parameters()):
        if r.grad is None:
            assert p.grad is None, name
            continue
        torch.testing.assert_close(p.grad, r.grad, rtol=0, atol=1e-5, msg=name)
        checked += 1
    assert checked > 20

    jloss = jax.jit(lambda a, b: JC.bidirectional_infonce(a, b, CFG.simcse.temperature))
    put = lambda e: jax.device_put(e.numpy(), data_sharding(mesh_dp))
    assert float(jloss(put(e1), put(e2))) == pytest.approx(float(loss.detach()), abs=1e-4)


TWO_DEVICES = ["cpu", "cpu:0", "cpu", "cpu:0"]


def test_dp_summed_grads_match_single_device(jax_side, views):
    """``cpu`` and ``cpu:0`` are two names to the mesh: the shards on the
    second run through a copy of the module, whose gradients are added onto
    the master's, as for a shard on another card."""
    ref_model, _, _, _ = single_device(jax_side, views)
    one, loss_one, _, _, _ = sharded(jax_side, views, torch_mesh(4))
    two, loss_two, _, _, replicas = sharded(jax_side, views, torch_mesh(4, 1, TWO_DEVICES))
    assert len(replicas.copies) == 1
    assert [m is two for m in replicas.models] == [True, False, True, False]
    assert float(loss_two) == pytest.approx(float(loss_one), abs=1e-6)
    scale = max(float(r.grad.norm()) for r in ref_model.parameters() if r.grad is not None)
    for (name, p), q, r in zip(one.named_parameters(), two.parameters(),
                               ref_model.parameters()):
        if r.grad is None:
            assert p.grad is None and q.grad is None, name
            continue
        torch.testing.assert_close(q.grad, p.grad, rtol=0, atol=1e-6, msg=name)
        # bf16 rounding at another batch size; a gradient that is ~0 is all noise
        bound = 0.05 * max(float(r.grad.norm()), 1e-2 * scale)
        assert float((p.grad - r.grad).norm()) <= bound, name
    for replica in replicas.copies.values():
        assert all(q.grad is None for q in replica.parameters())


def test_dp_step_updates_like_the_single_device_step(jax_side, item_tensors):
    """Three optimizer steps (the first has learning rate 0) with the random
    view corruption on and the same generator seed. Shards on a second device
    (a copy of the module) change nothing, which holds only if the copy's
    gradients reach the master and the copy is refreshed after every step;
    the single-device step differs by the bf16 rounding at another batch
    size."""
    cfg = dataclasses.replace(CFG, simcse=dataclasses.replace(CFG.simcse, lr=1e-3,
                                                              text_encoder_lr=1e-3))
    batch = {k: v[:B] for k, v in TS.item_tensors_to(item_tensors, "cpu").items()}
    runs = []
    for mesh in (None, torch_mesh(4), torch_mesh(4, 1, TWO_DEVICES)):
        tm = port_model(jax_side)
        opt, sched = TS.make_optimizer(cfg, tm, total_steps=8)
        state = TrainState(tm, opt, sched)
        step = (TS.make_train_step(state, cfg) if mesh is None
                else TS.make_data_parallel_step(state, cfg, mesh))
        gen = torch.Generator().manual_seed(5)
        runs.append(([float(step(batch, gen)[0]) for _ in range(3)], tm))
        assert state.step == 3
    (ref_losses, _), (losses, model), (losses_two, model_two) = runs
    assert losses == pytest.approx(ref_losses, abs=2e-3)
    assert losses[2] < losses[1]
    assert losses_two == pytest.approx(losses, abs=1e-6)
    for (name, p), q in zip(model.named_parameters(), model_two.parameters()):
        torch.testing.assert_close(q, p, rtol=0, atol=1e-6, msg=name)


def test_train_simcse_and_materialize_with_a_mesh(item_tensors, tmp_path):
    """The trainer on 4 data shards learns; ``materialize_item_vectors`` with
    the mesh writes the same matrix as without (64 items in batches of 24: the
    tail of 16 divides, a batch of 30 needs the pad)."""
    mesh = torch_mesh(4, 2)
    state = TS.train_simcse(CFG, item_tensors, str(tmp_path), device="cpu", mesh=mesh)
    assert state.step == 2 and all(np.isfinite(state.losses))
    for bs in (24, 30):
        ref = TS.materialize_item_vectors(CFG, state.model, item_tensors,
                                          str(tmp_path / "ref"), batch_size=bs)
        got = TS.materialize_item_vectors(CFG, state.model, item_tensors,
                                          str(tmp_path / "sharded"), batch_size=bs, mesh=mesh)
        assert got.shape == (65, 128)
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-2)   # bf16 at another batch size
    with pytest.raises(ValueError, match="does not divide"):
        TS.train_simcse(dataclasses.replace(CFG, simcse=dataclasses.replace(
            CFG.simcse, batch_size=30)), item_tensors, str(tmp_path), device="cpu", mesh=mesh)
