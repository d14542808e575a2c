"""Kernel K2's plain form, layout and autograd function on the CPU, against
the JAX package's ``propagate`` and its block-SpMM Pallas kernel.

The JAX kernel runs as its own tests run it on the CPU: in interpret mode.
In "f32" precision all three sum the same fp32 products in different orders;
atol 1e-5 is the JAX suite's bound (tests/test_spmm.py:32). The graph is that
suite's: 700 users, 500 items, ~8000 pairs.

In "bf16" precision (the trainer's mode) both packages round ``x`` to bf16.
The port then multiplies by the fp32 weight and sums in fp32; the JAX kernel
also rounds the weights to bf16 and keeps its running sums in bf16. Each of
those roundings is a relative 2^-8 (bf16 keeps 8 significant bits) of a
partial sum that is at most ``sum_e |w_e| |x_e|`` for the row, and a row sees a
few of them (one for the weight, one per add of a chunk's product), so the
two are held to ``BF16_ROUNDINGS * 2^-8`` of that row sum, entry by entry.
Measured on this graph: 5.0e-3 of the row sum at most (1.3 roundings), 3.7e-3
abs where max |out| is 1.36.
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
BF16_ROUNDINGS = 4   # see the module docstring: 4 * 2^-8 = 2^-6 of a row's sum of |terms|


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
    """Its ``LAUNCHES`` check replaces the earlier one, which also named the
    separate hub kernel."""
    layout = S.csr_graph(graph.src, graph.dst, graph.weight, graph.num_nodes, device="cpu")
    x = torch.zeros(graph.num_nodes, 8)
    with pytest.raises(ValueError, match="rows"):
        S.spmm(layout, x[:-1])
    with pytest.raises(RuntimeError, match="CUDA"):
        S.spmm_cuda(layout, x)
    assert S.spmm(layout, x.double()).dtype == torch.float32
    # no kernel on the CPU; one kernel on the card (the hub pass has no launch of its own)
    assert S.LAUNCHES == {"spmm_csr": 0}


# -- the "bf16" mode -------------------------------------------------------------

def _row_abs_sums(layout, x):
    """sum_e |w_e| |x_e| per output entry: the scale of a row's rounding errors."""
    return S.spmm_plain(layout, torch.as_tensor(np.abs(x)), "f32").numpy()


@pytest.mark.parametrize("pack", [1, 2])
@pytest.mark.parametrize("dim", [64, 32])
def test_spmm_plain_bf16_matches_the_jax_kernel_in_its_bf16_mode(graph, dim, pack):
    layout = S.csr_graph(graph.src, graph.dst, graph.weight, graph.num_nodes, device="cpu")
    x = _x(graph, dim, 6)
    meta, arrays = _jax_blocked(graph, pack)
    ref = np.asarray(jax_spmm(meta, arrays, jnp.asarray(x), "bf16"))[: graph.num_nodes]
    got = S.spmm_plain(layout, torch.as_tensor(x), "bf16").numpy()
    bound = BF16_ROUNDINGS * 2.0 ** -8 * _row_abs_sums(layout, x)
    assert (np.abs(got - ref) <= bound + 1e-7).all()
    assert np.abs(got - ref).max() > 1e-4                # the two do round differently
    # fp32 sums: the port's mode is the closer of the two to the exact product
    exact = S.spmm_plain(layout, torch.as_tensor(x).double(), "f32").numpy()
    assert np.abs(got - exact).max() < np.abs(ref - exact).max()
    # and through the autograd function
    np.testing.assert_array_equal(S.spmm(layout, torch.as_tensor(x), "bf16").numpy(), got)


@pytest.mark.parametrize("pack", [1, 2])
def test_spmm_bf16_gradient_matches_jax_grad_of_the_kernel(graph, pack):
    """The backward is the same product in the same mode on the cotangent, as
    the JAX kernel's custom VJP (``_spmm_bwd`` passes its precision on)."""
    layout = S.csr_graph(graph.src, graph.dst, graph.weight, graph.num_nodes, device="cpu")
    x, g = _x(graph, 64, 7), _x(graph, 64, 8)
    meta, arrays = _jax_blocked(graph, pack)
    ref = jax.grad(lambda xx: jnp.sum(jax_spmm(meta, arrays, xx, "bf16") * g))(jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_(True)
    (got,) = torch.autograd.grad((S.spmm(layout, xt, "bf16") * torch.as_tensor(g)).sum(), xt)
    bound = BF16_ROUNDINGS * 2.0 ** -8 * _row_abs_sums(layout, g)
    assert (np.abs(got.numpy() - np.asarray(ref)) <= bound + 1e-7).all()
    # exactly the plain bf16 product of g: the cotangent is rounded, x plays no part
    np.testing.assert_array_equal(got.numpy(),
                                  S.spmm_plain(layout, torch.as_tensor(g), "bf16").numpy())
    assert not np.array_equal(got.numpy(), S.spmm_plain(layout, torch.as_tensor(g)).numpy())


@pytest.mark.parametrize("dim", [64, 32, 128])
def test_spmm_plain_bf16_is_the_f32_product_of_the_rounded_input(graph, dim):
    layout = S.csr_graph(graph.src, graph.dst, graph.weight, graph.num_nodes, device="cpu")
    x = torch.as_tensor(_x(graph, dim, 9))
    rounded = x.bfloat16().float()
    assert not torch.equal(rounded, x)
    got = S.spmm_plain(layout, x, "bf16")
    np.testing.assert_allclose(got.numpy(), S.spmm_plain(layout, rounded, "f32").numpy(),
                               atol=ATOL, rtol=0)
    assert got.dtype == torch.float32
    # what the mode costs against the exact mode: 2^-8 of the row's sum of |terms|
    diff = (got - S.spmm_plain(layout, x, "f32")).abs().numpy()
    assert (diff <= 2.0 ** -8 * _row_abs_sums(layout, x.numpy()) + 1e-6).all()
    assert diff.max() > 1e-4
    # a double input is rounded the same way and summed in double
    np.testing.assert_allclose(S.spmm_plain(layout, x.double(), "bf16").numpy(), got.numpy(),
                               atol=ATOL, rtol=0)


def test_spmm_precision_is_checked(graph):
    layout = S.csr_graph(graph.src, graph.dst, graph.weight, graph.num_nodes, device="cpu")
    x = torch.zeros(graph.num_nodes, 8)
    for fn in (S.spmm, S.spmm_plain, S.spmm_cuda):
        for bad in ("fp32", "f16", "", None):
            with pytest.raises(ValueError, match="precision"):
                fn(layout, x, bad)
    assert S.PRECISIONS == ("bf16", "f32")
    # the default is the exact mode
    y = torch.as_tensor(_x(graph, 8, 10))
    assert torch.equal(S.spmm(layout, y), S.spmm(layout, y, "f32"))
    assert torch.equal(S.spmm_plain(layout, y), S.spmm_plain(layout, y, "f32"))


@pytest.mark.parametrize("max_segment", [256, 16, 1])
def test_layout_orders_segments_longest_first(graph, max_segment):
    """The order the kernel's warps take the segments in: every hub row's
    segment first, longest first, equal lengths by hub (segment count largest
    first, then row order), each hub's in segment order; then the other rows'
    segments longest first, ties in row order. Replaces this test's earlier
    check of one longest-first order over all segments, hub or not."""
    layout = S.csr_graph(graph.src, graph.dst, graph.weight, graph.num_nodes,
                         max_segment=max_segment, device="cpu")
    order = layout.seg_order.numpy()
    assert order.dtype == np.int32
    assert sorted(order.tolist()) == list(range(layout.num_segments))   # every segment once
    lengths = np.diff(layout.seg_ptr.numpy())
    seg_out = layout.seg_out.numpy()
    P = layout.num_partials
    head, tail = order[:P], order[P:]
    assert (seg_out[head] < 0).all() and (seg_out[tail] >= 0).all()     # the hubs' first
    # the head: longest first, then larger hubs, then segment order
    hub = layout.slot_hub.numpy()[-(seg_out[head] + 1)]
    size = np.diff(layout.hub_ptr.numpy())[hub]
    key = np.stack([-lengths[head], -size, head], 1)
    assert all(tuple(a) < tuple(b) for a, b in zip(key[:-1], key[1:]))
    # the tail: longest first, equal lengths in row order
    tail_lengths = lengths[tail]
    assert (np.diff(tail_lengths) <= 0).all()
    ties = np.diff(tail_lengths) == 0
    assert (np.diff(tail)[ties] > 0).all()
    if max_segment < 256:
        assert layout.num_hubs > 0 and lengths[head[0]] == max_segment
