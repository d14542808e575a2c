"""Kernel K2's layout and plain product on a graph with the H&M world's
skew, on the CPU, against the JAX package's propagation.

``bench.py``'s synthetic graph draws item ids as ``items * rng**2.5``; the
H&M world's item degrees follow its own popularity, where a few items are
bought by a large share of the users. Here one item holds over 10% of the
edges (a hub row cut into many warp segments) beside the ``rng**2.5`` tail.
Both packages build the graph from the same interactions; the port's CSR
layout and its plain product (``spmm_plain``, and ``spmm`` on a CPU tensor)
are held against ``recsys_tpu.ops.graph.propagate`` forward and backward
within 1e-5 in f32 (the JAX suite's bound, tests/test_spmm.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_tpu.ops.graph import build_graph as jax_build_graph
from recsys_tpu.ops.graph import propagate as jax_propagate
from recsys_tpu_torch.ops import spmm as S
from recsys_tpu_torch.ops.graph import build_graph

ATOL = 1e-5
USERS, ITEMS, PAIRS, HUB_SHARE = 2000, 300, 6000, 0.15


@pytest.fixture(scope="module")
def skewed():
    rng = np.random.default_rng(0)
    u = rng.integers(0, USERS, PAIRS)
    i = (ITEMS * rng.random(PAIRS) ** 2.5).astype(np.int64)
    hub = rng.random(PAIRS) < HUB_SHARE          # the best seller
    i[hub] = ITEMS - 1
    port = build_graph(u, i, USERS, ITEMS, svd_rank=3, pad_multiple=128)
    ref = jax_build_graph(u, i, USERS, ITEMS, svd_rank=3, pad_multiple=128)
    return port, ref


def test_the_graph_is_skewed_and_equal_in_both_packages(skewed):
    port, ref = skewed
    for name in ("src", "dst", "weight"):
        np.testing.assert_array_equal(np.asarray(getattr(port, name)),
                                      np.asarray(getattr(ref, name)))
    live = np.asarray(port.weight) != 0
    degree = np.bincount(np.asarray(port.dst)[live], minlength=port.num_nodes)
    assert degree.max() > 0.10 * live.sum() / 2 and degree.argmax() == USERS + ITEMS - 1


@pytest.mark.parametrize("max_segment", [256, 16])
@pytest.mark.parametrize("dim", [64, 32])
def test_layout_and_plain_product_match_jax(skewed, dim, max_segment):
    port, ref = skewed
    layout = S.csr_graph(port.src, port.dst, port.weight, port.num_nodes,
                         max_segment=max_segment, device="cpu")
    hub = USERS + ITEMS - 1
    assert hub in layout.hub_row.tolist() and layout.num_hubs >= 1
    # the hub's segments cover its edges in order, each at most max_segment long
    h = layout.hub_row.tolist().index(hub)
    slots = range(int(layout.hub_ptr[h]), int(layout.hub_ptr[h + 1]))
    segs = [int(s) for s in torch.nonzero(layout.seg_out < 0).flatten()
            if -int(layout.seg_out[s]) - 1 in slots]
    lengths = [int(layout.seg_ptr[s + 1] - layout.seg_ptr[s]) for s in segs]
    assert sum(lengths) == int(layout.rowptr[hub + 1] - layout.rowptr[hub])
    assert max(lengths) <= max_segment and len(segs) > 1

    x = np.random.default_rng(dim).normal(size=(port.num_nodes, dim)).astype(np.float32)
    g = np.random.default_rng(dim + 1).normal(size=(port.num_nodes, dim)).astype(np.float32)
    args = (jnp.asarray(ref.src), jnp.asarray(ref.dst), jnp.asarray(ref.weight), ref.num_nodes)
    want, vjp = jax.vjp(lambda v: jax_propagate(v, *args), jnp.asarray(x))
    (want_grad,) = vjp(jnp.asarray(g))
    np.testing.assert_allclose(S.spmm_plain(layout, torch.as_tensor(x)).numpy(),
                               np.asarray(want), atol=ATOL, rtol=0)
    xt = torch.as_tensor(x).requires_grad_(True)
    out = S.spmm(layout, xt)
    out.backward(torch.as_tensor(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_grad), atol=ATOL, rtol=0)
