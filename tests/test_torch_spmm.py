"""Kernel K2's plain form, layout and autograd function on the CPU, against
the JAX package's ``propagate`` and its block-SpMM Pallas kernel.

The JAX kernel runs as its own tests run it on the CPU: in interpret mode,
"f32" precision. All three sum the same fp32 products in different orders;
atol 1e-5 is the JAX suite's bound (tests/test_spmm.py:32). The graph is that
suite's: 700 users, 500 items, ~8000 pairs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_tpu.ops.graph import build_graph as jax_build_graph
from recsys_tpu.ops.graph import propagate as jax_propagate
from recsys_tpu.ops.pallas_spmm import block_graph
from recsys_tpu.ops.pallas_spmm import spmm as jax_spmm
from recsys_tpu_torch.ops import spmm as S

ATOL = 1e-5


@pytest.fixture(scope="module")
def graph():
    rng = np.random.default_rng(0)
    nu, ni = 700, 500
    e = np.unique(np.stack([rng.integers(0, nu, 8000),
                            rng.integers(0, ni, 8000)], 1), axis=0)
    return jax_build_graph(e[:, 0], e[:, 1], nu, ni, svd_rank=3, pad_multiple=128)


def _x(graph, dim, seed):
    return np.random.default_rng(seed).normal(size=(graph.num_nodes, dim)).astype(np.float32)


def _jax_blocked(graph, pack):
    blocked = block_graph(graph.src, graph.dst, graph.weight, graph.num_nodes,
                          block_n=256, chunk_e=1024, pack=pack)
    return blocked.meta, blocked.device_arrays()


@pytest.mark.parametrize("max_segment", [256, 8])
@pytest.mark.parametrize("dim", [64, 32])
def test_spmm_plain_matches_jax_propagate(graph, dim, max_segment):
    layout = S.csr_graph(graph.src, graph.dst, graph.weight, graph.num_nodes,
                         max_segment=max_segment, device="cpu")
    x = _x(graph, dim, 1)
    ref = jax_propagate(jnp.asarray(x), jnp.asarray(graph.src), jnp.asarray(graph.dst),
                        jnp.asarray(graph.weight), graph.num_nodes)
    np.testing.assert_allclose(S.spmm_plain(layout, torch.as_tensor(x)).numpy(),
                               np.asarray(ref), atol=ATOL, rtol=0)
    np.testing.assert_allclose(S.spmm(layout, torch.as_tensor(x)).numpy(),
                               np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("pack", [1, 2])
@pytest.mark.parametrize("dim", [64, 32])
def test_spmm_plain_matches_the_jax_kernel(graph, dim, pack):
    layout = S.csr_graph(graph.src, graph.dst, graph.weight, graph.num_nodes, device="cpu")
    x = _x(graph, dim, 2)
    meta, arrays = _jax_blocked(graph, pack)
    ref = jax_spmm(meta, arrays, jnp.asarray(x), "f32")
    np.testing.assert_allclose(S.spmm_plain(layout, torch.as_tensor(x)).numpy(),
                               np.asarray(ref)[: graph.num_nodes], atol=ATOL, rtol=0)


@pytest.mark.parametrize("pack", [1, 2])
def test_spmm_gradient_matches_jax_grad_of_the_kernel(graph, pack):
    """The CPU path of ``Spmm``: its backward is the same product on the
    cotangent, as the JAX kernel's custom VJP."""
    layout = S.csr_graph(graph.src, graph.dst, graph.weight, graph.num_nodes, device="cpu")
    x, g = _x(graph, 64, 3), _x(graph, 64, 4)
    meta, arrays = _jax_blocked(graph, pack)
    ref = jax.grad(lambda xx: jnp.sum(jax_spmm(meta, arrays, xx, "f32") * g))(jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_(True)
    (got,) = torch.autograd.grad((S.spmm(layout, xt) * torch.as_tensor(g)).sum(), xt)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    # and autograd through the plain form agrees with the hand-written backward
    xp = torch.as_tensor(x).requires_grad_(True)
    (plain,) = torch.autograd.grad((S.spmm_plain(layout, xp) * torch.as_tensor(g)).sum(), xp)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=ATOL, rtol=0)


def test_spmm_second_order_use_in_a_two_layer_stack(graph):
    """Two stacked products, as the LightGCL forward uses them."""
    layout = S.csr_graph(graph.src, graph.dst, graph.weight, graph.num_nodes, device="cpu")
    x = _x(graph, 32, 5)
    args = tuple(jnp.asarray(a) for a in (graph.src, graph.dst, graph.weight))

    def jax_loss(xx):
        h = jax_propagate(xx, *args, graph.num_nodes)
        return jnp.sum(jax_propagate(h, *args, graph.num_nodes) ** 2)

    ref = jax.grad(jax_loss)(jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_(True)
    (got,) = torch.autograd.grad((S.spmm(layout, S.spmm(layout, xt)) ** 2).sum(), xt)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("max_segment", [256, 16, 1])
def test_layout_keeps_every_nonzero_edge_once(graph, max_segment):
    layout = S.csr_graph(graph.src, graph.dst, graph.weight, graph.num_nodes,
                         max_segment=max_segment, device="cpu")
    keep = graph.weight != 0
    assert (~keep).any()                                 # the graph carries padding
    assert layout.num_edges == int(keep.sum())           # and the layout drops it
    triples = lambda s, d, w: sorted(zip(s.tolist(), d.tolist(), w.tolist()))
    assert (triples(layout.col.numpy(), layout.row.numpy(), layout.val.numpy())
            == triples(graph.src[keep], graph.dst[keep], graph.weight[keep]))
    rowptr = layout.rowptr.numpy()
    assert rowptr[0] == 0 and rowptr[-1] == layout.num_edges
    np.testing.assert_array_equal(np.diff(rowptr),
                                  np.bincount(graph.dst[keep], minlength=graph.num_nodes))
    assert (np.diff(layout.row.numpy()) >= 0).all()      # sorted by destination

    # the segments tile the edge list; a row is either one direct segment or a
    # run of partial slots that its hub entry sums, in order
    seg_ptr, seg_out = layout.seg_ptr.numpy(), layout.seg_out.numpy()
    assert seg_ptr[0] == 0 and seg_ptr[-1] == layout.num_edges
    lengths = np.diff(seg_ptr)
    assert (lengths >= 0).all() and lengths.max() <= max_segment
    direct = seg_out[seg_out >= 0]
    hub_row, hub_ptr = layout.hub_row.numpy(), layout.hub_ptr.numpy()
    assert sorted(direct.tolist() + hub_row.tolist()) == list(range(graph.num_nodes))
    slots = -(seg_out[seg_out < 0] + 1)
    np.testing.assert_array_equal(slots, np.arange(layout.num_partials))
    assert hub_ptr[0] == 0 and hub_ptr[-1] == layout.num_partials
    for s in np.flatnonzero(seg_out < 0):
        h = np.searchsorted(hub_ptr, -(seg_out[s] + 1), side="right") - 1
        assert (layout.row.numpy()[seg_ptr[s]:seg_ptr[s + 1]] == hub_row[h]).all()


def test_isolated_nodes_get_zero_rows():
    # nodes 2 and 5 have no edges; node 0 only carries weight-0 padding
    src = np.array([1, 3, 3, 4, 0, 0])
    dst = np.array([3, 1, 4, 3, 0, 0])
    w = np.array([0.5, 0.5, 0.25, 0.25, 0.0, 0.0], np.float32)
    layout = S.csr_graph(src, dst, w, 6, device="cpu")
    x = torch.arange(12, dtype=torch.float32).reshape(6, 2) + 1.0
    out = S.spmm(layout, x)
    assert torch.equal(out[[0, 2, 5]], torch.zeros(3, 2))
    assert torch.equal(out[3], 0.5 * x[1] + 0.25 * x[4])
    assert layout.num_edges == 4 and layout.num_segments == 6 and layout.num_hubs == 0


def test_asymmetric_edge_list_is_refused(graph):
    with pytest.raises(ValueError, match="not symmetric"):
        S.csr_graph([0, 1], [1, 2], [1.0, 1.0], 3, device="cpu")
    keep = graph.weight != 0
    w = graph.weight[keep].copy()
    w[0] *= 2.0                                          # one direction heavier
    with pytest.raises(ValueError, match="not symmetric"):
        S.csr_graph(graph.src[keep], graph.dst[keep], w, graph.num_nodes, device="cpu")
    with pytest.raises(ValueError, match="outside"):
        S.csr_graph([0, 7], [7, 0], [1.0, 1.0], 3, device="cpu")


def test_duplicate_pairs_sum(graph):
    """A pair listed twice (interactions not deduped) counts twice."""
    src, dst = np.array([0, 1, 0, 1]), np.array([1, 0, 1, 0])
    w = np.array([0.5, 0.5, 0.25, 0.25], np.float32)
    out = S.spmm(S.csr_graph(src, dst, w, 2, device="cpu"), torch.tensor([[1.0], [10.0]]))
    assert out.tolist() == [[7.5], [0.75]]


def test_wrapper_checks_its_input(graph):
    layout = S.csr_graph(graph.src, graph.dst, graph.weight, graph.num_nodes, device="cpu")
    x = torch.zeros(graph.num_nodes, 8)
    with pytest.raises(ValueError, match="rows"):
        S.spmm(layout, x[:-1])
    with pytest.raises(RuntimeError, match="CUDA"):
        S.spmm_cuda(layout, x)
    assert S.spmm(layout, x.double()).dtype == torch.float32
    assert S.LAUNCHES == {"spmm_csr": 0, "spmm_hub_reduce": 0}  # no kernel on the CPU
