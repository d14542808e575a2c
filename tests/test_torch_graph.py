"""The port's graph construction and plain propagation forms against the
JAX package's, on the same numpy inputs.

``build_graph`` is a copy and must give equal arrays. The propagation forms
sum the same fp32 terms in another order than XLA's segment_sum: atol 1e-5,
the JAX suite's own bound for this comparison (tests/test_spmm.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import recsys_tpu.ops.graph as JG
import recsys_tpu_torch.ops.graph as TG

ATOL = 1e-5


@pytest.fixture(scope="module")
def interactions():
    rng = np.random.default_rng(0)
    return rng.integers(0, 700, 8000), rng.integers(0, 500, 8000), 700, 500


@pytest.fixture(scope="module")
def graphs(interactions):
    u, i, nu, ni = interactions
    kw = dict(svd_rank=3, svd_iters=2, pad_multiple=128, seed=4)
    return JG.build_graph(u, i, nu, ni, **kw), TG.build_graph(u, i, nu, ni, **kw)


@pytest.mark.parametrize("field", ["src", "dst", "weight", "svd_u", "svd_s", "svd_v"])
def test_build_graph_arrays_are_equal(graphs, field):
    ref, got = graphs
    assert (got.num_users, got.num_items, got.num_nodes) == (700, 500, 1200)
    a, b = getattr(got, field), getattr(ref, field)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


def test_build_graph_pads_with_weight_zero_self_loops(graphs):
    _, g = graphs
    assert len(g.src) % 128 == 0
    pad = g.weight == 0
    assert pad.any() and (g.src[pad] == 0).all() and (g.dst[pad] == 0).all()


@pytest.mark.parametrize("dim", [64, 32])
def test_propagate_matches_jax(graphs, dim):
    _, g = graphs
    x = np.random.default_rng(1).normal(size=(g.num_nodes, dim)).astype(np.float32)
    ref = JG.propagate(jnp.asarray(x), jnp.asarray(g.src), jnp.asarray(g.dst),
                       jnp.asarray(g.weight), g.num_nodes)
    got = TG.propagate(torch.as_tensor(x), torch.as_tensor(g.src), torch.as_tensor(g.dst),
                       torch.as_tensor(g.weight), g.num_nodes)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("edge_chunk", [512, 4_194_304])
def test_propagate_chunked_matches_jax(graphs, edge_chunk):
    """edge_chunk=512 runs the chunked branch (with a ragged last chunk), the
    default the single-shot one."""
    _, g = graphs
    assert len(g.src) % 512 != 0 or edge_chunk != 512 or len(g.src) > 512
    x = np.random.default_rng(2).normal(size=(g.num_nodes, 16)).astype(np.float32)
    ref = JG.propagate_chunked(x, g.src, g.dst, g.weight, g.num_nodes, edge_chunk=edge_chunk)
    got = TG.propagate_chunked(torch.as_tensor(x), g.src, g.dst, g.weight, g.num_nodes,
                               edge_chunk=edge_chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    one_shot = TG.propagate(torch.as_tensor(x), torch.as_tensor(g.src),
                            torch.as_tensor(g.dst), torch.as_tensor(g.weight), g.num_nodes)
    np.testing.assert_allclose(got.numpy(), one_shot.numpy(), atol=ATOL, rtol=0)


def test_svd_propagate_matches_jax(graphs):
    _, g = graphs
    x = np.random.default_rng(3).normal(size=(g.num_nodes, 64)).astype(np.float32)
    ref = JG.svd_propagate(jnp.asarray(x), jnp.asarray(g.svd_u), jnp.asarray(g.svd_s),
                           jnp.asarray(g.svd_v))
    got = TG.svd_propagate(torch.as_tensor(x), torch.as_tensor(g.svd_u),
                           torch.as_tensor(g.svd_s), torch.as_tensor(g.svd_v))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_propagate_is_differentiable_like_jax(graphs):
    import jax

    _, g = graphs
    rng = np.random.default_rng(5)
    x = rng.normal(size=(g.num_nodes, 8)).astype(np.float32)
    c = rng.normal(size=(g.num_nodes, 8)).astype(np.float32)
    ref = jax.grad(lambda xx: jnp.sum(JG.propagate(
        xx, jnp.asarray(g.src), jnp.asarray(g.dst), jnp.asarray(g.weight),
        g.num_nodes) * c))(jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_(True)
    out = TG.propagate(xt, torch.as_tensor(g.src), torch.as_tensor(g.dst),
                       torch.as_tensor(g.weight), g.num_nodes)
    (got,) = torch.autograd.grad((out * torch.as_tensor(c)).sum(), xt)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
