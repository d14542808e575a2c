"""The port's mesh and collectives against the JAX package's, on the CPU.

The JAX functions run under ``smap`` on the 8-device virtual CPU mesh of
``tests/conftest.py`` (``mesh8``: 4 x 2, ``mesh_dp``: 8 x 1); the port's run
on a mesh of eight virtual shards laid over ``"cpu"``. Inputs are made with
numpy from a seed and handed to both. Gathers and lookups move values and are
held exactly; top-k values at rtol 1e-6 with equal indices, as
``tests/test_parallel.py`` holds the JAX functions against the dense top-k.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from recsys_tpu.parallel import collectives as JC
from recsys_tpu.parallel.mesh import pad_to_multiple as jax_pad_to_multiple
from recsys_tpu.parallel.mesh import smap
from recsys_tpu_torch.config import MeshConfig
from recsys_tpu_torch.parallel import collectives as TC
from recsys_tpu_torch.parallel import mesh as TM


def torch_mesh(num_data=4, num_model=2):
    return TM.build_mesh(MeshConfig(num_data=num_data, num_model=num_model),
                         ["cpu"] * (num_data * num_model))


def split(x, n, dim=0):
    return list(torch.tensor(np.asarray(x)).chunk(n, dim=dim))


@pytest.fixture(params=["model", "data"])
def axis_case(request, mesh8, mesh_dp):
    """(JAX mesh, axis name, shard count): model axis of 4 x 2, data axis of 8 x 1."""
    return (mesh8, "model", 2) if request.param == "model" else (mesh_dp, "data", 8)


# -- mesh ------------------------------------------------------------------

def test_mesh_shape_and_groups(mesh8):
    mesh = TM.build_mesh(MeshConfig(num_data=4, num_model=2),
                         [f"cuda:{i}" for i in range(8)])
    assert mesh.shape == {"data": 4, "model": 2} == dict(mesh8.shape)
    assert mesh.axis_names == tuple(mesh8.axis_names)
    # the same grid as the JAX mesh: device i at (i // 2, i % 2)
    ids = np.vectorize(lambda d: d.id)(mesh8.devices)
    assert [[d.index for d in row] for row in mesh.devices] == ids.tolist()
    # a ring along `data` steps by the model axis's size; one along `model` by 1
    assert [[d.index for d in ring] for ring in mesh.groups("data")] == \
        [[0, 2, 4, 6], [1, 3, 5, 7]]
    assert [[d.index for d in ring] for ring in mesh.groups("model")] == \
        [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert mesh.axis_devices("data") == mesh.groups("data")[0]


def test_build_mesh_rules():
    eight = ["cpu"] * 8
    assert TM.build_mesh(MeshConfig(num_data=-1, num_model=2), eight).shape == \
        {"data": 4, "model": 2}
    assert TM.build_mesh(MeshConfig(), eight).shape == {"data": 8, "model": 1}
    # fewer than given: the first num_data * num_model, as the JAX function
    assert TM.build_mesh(MeshConfig(num_data=3, num_model=1), eight).shape == \
        {"data": 3, "model": 1}
    with pytest.raises(ValueError, match="not divisible"):
        TM.build_mesh(MeshConfig(num_model=3), eight)
    with pytest.raises(ValueError, match="needs 16 devices"):
        TM.build_mesh(MeshConfig(num_data=8, num_model=2), eight)
    with pytest.raises(ValueError, match="device grid"):
        TM.Mesh(["cpu", "cpu"])


@pytest.mark.parametrize("shape,multiple,axis", [((5, 2), 4, 0), ((8, 3), 4, 0),
                                                 ((3, 7), 5, 1), ((37,), 2, 0)])
def test_pad_to_multiple_matches_jax(shape, multiple, axis):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    got, n = TM.pad_to_multiple(x, multiple, axis=axis, fill=0.5)
    ref, n_ref = jax_pad_to_multiple(x, multiple, axis=axis, fill=0.5)
    assert n == n_ref == shape[axis] and got.shape[axis] % multiple == 0
    np.testing.assert_array_equal(got, ref)


def test_shard_helpers():
    mesh = torch_mesh()
    x = np.arange(32, dtype=np.float32).reshape(8, 4)
    rows = TM.shard_rows(mesh, x)
    assert len(rows) == 2 and torch.equal(torch.cat(rows), torch.tensor(x))
    parts = TM.shard_batch(mesh, {"a": x, "b": torch.arange(8)})
    assert len(parts) == 4 and parts[3]["b"].tolist() == [6, 7]
    assert torch.equal(torch.cat([p["a"] for p in parts]), torch.tensor(x))
    assert torch.equal(torch.cat(TM.shard_batch(mesh, x)), torch.tensor(x))
    copies = TM.replicate(mesh, x, "data")
    assert len(copies) == 4 and all(c is copies[0] for c in copies)   # one device, one tensor
    with pytest.raises(ValueError, match="cannot shard"):
        TM.shard_batch(mesh, x[:7])
    with pytest.raises(ValueError, match="cannot shard"):
        TM.shard_rows(mesh, np.float32(1.0))


# -- gathers ---------------------------------------------------------------

def test_gather_global_negatives_matches_jax(mesh_dp):
    B, D = 16, 8
    x = np.random.default_rng(0).normal(size=(B, D)).astype(np.float32)
    f = smap(lambda e: JC.gather_global_negatives(e, "data"), mesh_dp,
             P("data", None), out_specs=P(None, None))
    ref = np.asarray(f(jnp.asarray(x)))
    got = TC.gather_global_negatives(split(x, 8))
    assert len(got) == 8
    for g in got:
        np.testing.assert_array_equal(g.numpy(), ref)
    np.testing.assert_array_equal(ref, x)
    assert TC.local_index_offset(3, 16) == 48


def test_gather_global_negatives_grad_matches_jax(mesh_dp):
    """Each shard scores its rows against the gathered matrix; the gradient of
    a shard's rows comes back from every shard that used them (the gather's
    transpose, a reduce-scatter)."""
    B, D, S = 16, 8, 8
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, D)).astype(np.float32)
    c = rng.normal(size=(B, B)).astype(np.float32)

    def jloss(xx):
        f = smap(lambda e: e @ JC.gather_global_negatives(e, "data").T, mesh_dp,
                 P("data", None), out_specs=P("data", None))
        return jnp.sum(jnp.sin(f(xx)) * c)

    ref_loss, ref_grad = jax.value_and_grad(jloss)(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    shards = list(xt.chunk(S))
    gathered = TC.gather_global_negatives(shards)
    scores = torch.cat([e @ g.T for e, g in zip(shards, gathered)])
    loss = (torch.sin(scores) * torch.tensor(c)).sum()
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(ref_loss), rel=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_grad), rtol=1e-5, atol=1e-5)


# -- sharded top-k ---------------------------------------------------------

@pytest.mark.parametrize("fn", ["sharded_topk", "sharded_topk_ring_merge"])
@pytest.mark.parametrize("k", [10, 40])
def test_sharded_topk_matches_jax_and_dense(axis_case, fn, k):
    """k = 40 exceeds a shard's 8 columns on the 8-shard axis (k_local < k)."""
    jmesh, axis, S = axis_case
    B, N = 4, 64
    scores = np.random.default_rng(k).normal(size=(B, N)).astype(np.float32)
    f = smap(lambda s: getattr(JC, fn)(s, k, axis), jmesh, P(None, axis),
             out_specs=(P(None, None), P(None, None)))
    ref_vals, ref_idx = (np.asarray(a) for a in f(jnp.asarray(scores)))
    out = getattr(TC, fn)(split(scores, S, dim=1), k)
    assert len(out) == S
    dense_vals, dense_idx = torch.topk(torch.tensor(scores), k)
    for vals, idx in out:                       # replicated: the same on every shard
        np.testing.assert_allclose(vals.numpy(), ref_vals, rtol=1e-6)
        np.testing.assert_array_equal(idx.numpy(), ref_idx)
        np.testing.assert_allclose(vals.numpy(), dense_vals.numpy(), rtol=1e-6)
        np.testing.assert_array_equal(idx.numpy(), dense_idx.numpy())


def test_sharded_topk_ring_merge_tie_determinism(mesh_dp):
    """Tied scores at the k boundary: every shard keeps the same set although
    each folds the ring in another rotation order, and that set is the dense
    order value descending, index ascending, as the JAX function's."""
    B, N, k, S = 2, 64, 8, 8
    scores = np.random.default_rng(3).integers(0, 4, size=(B, N)).astype(np.float32)
    f = smap(lambda s: tuple(v[None] for v in JC.sharded_topk_ring_merge(s, k, "data")),
             mesh_dp, P(None, "data"),
             out_specs=(P("data", None, None), P("data", None, None)))
    ref_vals, ref_idx = (np.asarray(a) for a in f(jnp.asarray(scores)))
    out = TC.sharded_topk_ring_merge(split(scores, S, dim=1), k)
    order = np.lexsort((np.broadcast_to(np.arange(N), (B, N)), -scores), axis=-1)[:, :k]
    for d, (vals, idx) in enumerate(out):
        np.testing.assert_array_equal(idx.numpy(), ref_idx[d])
        np.testing.assert_array_equal(vals.numpy(), ref_vals[d])
        np.testing.assert_array_equal(idx.numpy(), order)
        np.testing.assert_array_equal(vals.numpy(), np.take_along_axis(scores, order, -1))


# -- row-sharded lookups ---------------------------------------------------

def test_rowsharded_lookup_matches_jax(mesh8):
    V, D = 32, 8
    table = np.arange(V * D, dtype=np.float32).reshape(V, D)
    ids = np.array([0, 5, 17, 31, 2, 16])
    f = smap(lambda t, i: JC.rowsharded_lookup(t, i, "model"), mesh8,
             (P("model", None), P(None,)), out_specs=P(None, None))
    ref = np.asarray(f(jnp.asarray(table), jnp.asarray(ids)))
    got = TC.rowsharded_lookup(split(table, 2), torch.tensor(ids))
    assert len(got) == 2
    for g in got:
        np.testing.assert_array_equal(g.numpy(), ref)
    np.testing.assert_array_equal(ref, table[ids])
    # one copy of the ids per shard is the same call
    per_shard = TC.rowsharded_lookup(split(table, 2), [torch.tensor(ids)] * 2)
    assert torch.equal(per_shard[0], got[0])


def test_rowsharded_lookup_grad(mesh8):
    """The sum's transpose sends each row's gradient to the shard that owns
    the row: the expected table of tests/test_parallel.py, and jax.grad's."""
    V, D = 16, 4
    ids = [1, 9, 9, 15]

    def jloss(t):
        f = smap(lambda tt, ii: JC.rowsharded_lookup(tt, ii, "model"), mesh8,
                 (P("model", None), P(None,)), out_specs=P(None, None))
        return jnp.sum(f(t, jnp.asarray(ids)) ** 2)

    ref = np.asarray(jax.grad(jloss)(jnp.ones((V, D), jnp.float32)))
    table = torch.ones(V, D, requires_grad=True)
    out = TC.rowsharded_lookup(list(table.chunk(2)), torch.tensor(ids))
    (out[0] ** 2).sum().backward()
    expected = np.zeros((V, D), np.float32)
    for i in ids:
        expected[i] += 2.0
    np.testing.assert_array_equal(table.grad.numpy(), expected)
    np.testing.assert_array_equal(ref, expected)


def test_rowsharded_lookup_a2a_matches_jax(mesh8):
    V, D = 32, 8
    table = np.arange(V * D, dtype=np.float32).reshape(V, D)
    ids = np.array([0, 5, 17, 31, 2, 16, 9, 30])
    f = smap(lambda t, i: JC.rowsharded_lookup_a2a(t, i, "model"), mesh8,
             (P("model", None), P("model",)), out_specs=P("model", None))
    ref = np.asarray(f(jnp.asarray(table), jnp.asarray(ids)))
    got = TC.rowsharded_lookup_a2a(split(table, 2), split(ids, 2))
    assert [tuple(g.shape) for g in got] == [(4, D), (4, D)]     # each shard its own slice
    np.testing.assert_array_equal(torch.cat(got).numpy(), ref)
    np.testing.assert_array_equal(ref, table[ids])


def test_rowsharded_lookup_a2a_grad_goes_to_the_owner():
    V, D = 16, 4
    ids = torch.tensor([1, 9, 9, 15, 0, 8])
    table = torch.ones(V, D, requires_grad=True)
    out = TC.rowsharded_lookup_a2a(list(table.chunk(2)), list(ids.chunk(2)))
    (torch.cat(out) ** 2).sum().backward()
    expected = np.zeros((V, D), np.float32)
    for i in ids.tolist():
        expected[i] += 2.0
    np.testing.assert_array_equal(table.grad.numpy(), expected)
