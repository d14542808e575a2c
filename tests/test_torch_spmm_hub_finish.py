"""How kernel K2 finishes a hub row inside its one launch, in numpy.

``csrc/spmm.cu`` cuts a row of more than ``max_segment`` edges (a hub) into
segments; each segment's warp writes a partial row, counts its arrival in
the hub's counter, and the warp that arrives last adds the hub's partial
rows in segment order, from 0, in float32, writes the hub's row of ``out``
and resets the counter. This file repeats that in numpy: each segment's sum
in float32, taken in the layout's ``seg_order`` (and in shuffled orders:
which warp arrives last must not change the bits); the counters; each hub's
finish in segment order. The result is held against the JAX package's
``propagate`` and against ``spmm_plain`` at 1e-5 abs (the JAX suite's bound,
tests/test_spmm.py:32: all three sum the same fp32 products in other
orders), and ``hub_finish_plain`` is held bit for bit against the numpy
finish. The graph is that suite's: 700 users, 500 items, ~8000 pairs; at
``max_segment`` 8 and 1 it has hub rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_tpu.ops.graph import build_graph as jax_build_graph
from recsys_tpu.ops.graph import propagate as jax_propagate
from recsys_tpu_torch.ops import spmm as S

ATOL = 1e-5


@pytest.fixture(scope="module")
def graph():
    rng = np.random.default_rng(0)
    nu, ni = 700, 500
    e = np.unique(np.stack([rng.integers(0, nu, 8000),
                            rng.integers(0, ni, 8000)], 1), axis=0)
    return jax_build_graph(e[:, 0], e[:, 1], nu, ni, svd_rank=3, pad_multiple=128)


def _layout(graph, max_segment):
    return S.csr_graph(graph.src, graph.dst, graph.weight, graph.num_nodes,
                       max_segment=max_segment, device="cpu")


def _x(graph, dim, seed):
    return np.random.default_rng(seed).normal(size=(graph.num_nodes, dim)).astype(np.float32)


def run_kernel(layout, x, arrival):
    """The kernel's launch in numpy, its warps arriving in the order
    ``arrival`` (indices into ``seg_order``). Returns (out, partial, counts
    left in the counters, the finish of every hub as the last warp took it)."""
    seg_ptr, seg_out = layout.seg_ptr.numpy(), layout.seg_out.numpy()
    col, val = layout.col.numpy(), layout.val.numpy()
    slot_hub, hub_ptr = layout.slot_hub.numpy(), layout.hub_ptr.numpy()
    hub_row, order = layout.hub_row.numpy(), layout.seg_order.numpy()
    out = np.full((layout.num_nodes, x.shape[1]), np.nan, np.float32)
    partial = np.full((layout.num_partials, x.shape[1]), np.nan, np.float32)
    counts = np.zeros(layout.num_hubs, np.int64)
    finished = {}
    for i in arrival:
        s = order[i]
        e0, e1 = seg_ptr[s], seg_ptr[s + 1]
        row = (val[e0:e1, None] * x[col[e0:e1]]).sum(0, dtype=np.float32)
        if seg_out[s] >= 0:
            out[seg_out[s]] = row
            continue
        slot = -(seg_out[s] + 1)
        partial[slot] = row
        h = slot_hub[slot]
        counts[h] += 1
        first, nseg = hub_ptr[h], hub_ptr[h + 1] - hub_ptr[h]
        if counts[h] == nseg:                            # the last to arrive
            counts[h] = 0
            acc = np.zeros(x.shape[1], np.float32)
            for k in range(nseg):                        # segment order, from 0
                acc = acc + partial[first + k]
            out[hub_row[h]] = finished[h] = acc
    return out, partial, counts, finished


@pytest.mark.parametrize("dim", [64, 32])
@pytest.mark.parametrize("max_segment", [8, 1])
def test_folded_finish_matches_jax_propagate_and_the_plain_form(graph, max_segment, dim):
    layout = _layout(graph, max_segment)
    assert layout.num_hubs > 0
    x = _x(graph, dim, 1)
    out, partial, counts, finished = run_kernel(layout, x, range(layout.num_segments))
    assert not np.isnan(out).any() and not np.isnan(partial).any()
    assert (counts == 0).all() and len(finished) == layout.num_hubs
    ref = jax_propagate(jnp.asarray(x), jnp.asarray(graph.src), jnp.asarray(graph.dst),
                        jnp.asarray(graph.weight), graph.num_nodes)
    np.testing.assert_allclose(out, np.asarray(ref), atol=ATOL, rtol=0)
    np.testing.assert_allclose(out, S.spmm_plain(layout, torch.as_tensor(x)).numpy(),
                               atol=ATOL, rtol=0)
    # the plain finish of these partial rows gives the same bits
    plain = S.hub_finish_plain(layout, torch.as_tensor(partial)).numpy()
    assert plain.dtype == np.float32 and plain.shape == (layout.num_hubs, dim)
    np.testing.assert_array_equal(plain, np.stack([finished[h]
                                                   for h in range(layout.num_hubs)]))
    np.testing.assert_array_equal(plain, out[layout.hub_row.numpy()])


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("max_segment", [8, 1])
def test_the_warp_that_arrives_last_does_not_change_the_bits(graph, max_segment, seed):
    layout = _layout(graph, max_segment)
    x = _x(graph, 32, 2)
    base, _, _, _ = run_kernel(layout, x, range(layout.num_segments))
    arrival = np.random.default_rng(seed).permutation(layout.num_segments)
    out, partial, counts, _ = run_kernel(layout, x, arrival)
    assert (counts == 0).all()
    np.testing.assert_array_equal(out, base)
    np.testing.assert_array_equal(S.hub_finish_plain(layout, torch.as_tensor(partial)).numpy(),
                                  out[layout.hub_row.numpy()])


@pytest.mark.parametrize("max_segment", [256, 16, 8, 1])
def test_layout_contract_of_the_folded_finish(graph, max_segment):
    """Every hub segment before every other segment; ``slot_hub`` agrees with
    ``hub_ptr``; every segment once in ``seg_order``; a hub's slots are its
    segments in row order."""
    layout = _layout(graph, max_segment)
    order, seg_out = layout.seg_order.numpy(), layout.seg_out.numpy()
    assert sorted(order.tolist()) == list(range(layout.num_segments))
    is_hub = seg_out[order] < 0
    P = layout.num_partials
    assert is_hub[:P].all() and not is_hub[P:].any()
    slot_hub, hub_ptr = layout.slot_hub.numpy(), layout.hub_ptr.numpy()
    assert slot_hub.dtype == np.int32 and slot_hub.shape == (P,)
    np.testing.assert_array_equal(slot_hub, np.repeat(np.arange(layout.num_hubs),
                                                      np.diff(hub_ptr)))
    assert (np.diff(hub_ptr) >= 2).all()                 # a hub has two segments or more
    seg_ptr, row = layout.seg_ptr.numpy(), layout.row.numpy()
    hub_segs = np.flatnonzero(seg_out < 0)
    slots = -(seg_out[hub_segs] + 1)
    np.testing.assert_array_equal(slots, np.arange(P))   # slots in segment order
    for s, slot in zip(hub_segs, slots):
        assert (row[seg_ptr[s]:seg_ptr[s + 1]] == layout.hub_row.numpy()[slot_hub[slot]]).all()
    if max_segment == 256:
        assert layout.num_hubs == 0 and P == 0


def test_hub_finish_plain_without_hubs(graph):
    layout = _layout(graph, 256)
    got = S.hub_finish_plain(layout, torch.zeros(0, 16))
    assert got.shape == (0, 16) and got.dtype == torch.float32


def test_launch_csr_checks_its_buffers(graph):
    """The uncounted launch entry refuses buffers of the wrong shape, type or
    layout before any pointer reaches the kernel."""
    layout = _layout(graph, 8)
    N, P = layout.num_nodes, layout.num_partials
    x = torch.zeros(N, 32)
    for bad in ((x, torch.zeros(N, 32), torch.zeros(P + 1, 32)),
                (x, torch.zeros(N, 16), torch.zeros(P, 32)),
                (x.double(), torch.zeros(N, 32), torch.zeros(P, 32)),
                (x[:-1], torch.zeros(N - 1, 32), torch.zeros(P, 32)),
                (x, torch.zeros(32, N).t(), torch.zeros(P, 32))):
        with pytest.raises(ValueError, match="launch_csr"):
            S.launch_csr(layout, *bad, 0)
    assert S.LAUNCHES == {"spmm_csr": 0}
