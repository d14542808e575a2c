"""The port's ring all-gather and ring top-k against the JAX package's, on the CPU.

The JAX ``ring_all_gather`` runs its Pallas kernel under the TPU interpreter on
the 8-device virtual CPU mesh, exactly as ``tests/test_parallel.py`` runs it.
The port's wrapper, given CPU shards, runs ``ring_all_gather_plain``: the hop
schedule of the CUDA kernel as a loop of ``copy_`` between neighbours. Both
move values and are held bit for bit against each other and against
``np.concatenate``. The kernel itself runs only on the card
(``tests/test_torch_kernel_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from recsys_tpu.config import MeshConfig as JaxMeshConfig
from recsys_tpu.parallel import pallas_ring as JR
from recsys_tpu.parallel.mesh import build_mesh as jax_build_mesh
from recsys_tpu.parallel.mesh import smap
from recsys_tpu_torch.parallel import ring as TR

# (shards, model axis of the JAX mesh): 4 x 2 is the strided case, where the
# ring's logical neighbours step by 2 over the devices
RINGS = [(2, 1), (3, 1), (4, 1), (4, 2), (8, 1)]


def jax_ring_mesh(S, num_model):
    return jax_build_mesh(JaxMeshConfig(num_data=S, num_model=num_model),
                          jax.devices()[:S * num_model])


@pytest.mark.parametrize("bidirectional", [False, True], ids=["one_way", "both_ways"])
@pytest.mark.parametrize("S,num_model", RINGS)
def test_ring_all_gather_matches_jax(S, num_model, bidirectional):
    rows, cols = 3, 4
    x = np.random.default_rng(S).normal(size=(S * rows, cols)).astype(np.float32)
    f = smap(lambda e: JR.ring_all_gather(e, "data", bidirectional=bidirectional),
             jax_ring_mesh(S, num_model), P("data", None), out_specs=P(None, None))
    ref = np.asarray(f(jnp.asarray(x)))
    TR.reset_launch_counts()
    shards = list(torch.tensor(x).chunk(S))
    out = TR.ring_all_gather(shards, bidirectional)
    assert TR.LAUNCHES == {"ring_uni": 0, "ring_bidi": 0}      # CPU shards: no kernel
    assert len(out) == S
    for o in out:
        assert o.numpy().tobytes() == ref.tobytes() == x.tobytes()
    for a, b in zip(out, TR.ring_all_gather_plain(shards, bidirectional)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bidirectional", [False, True], ids=["one_way", "both_ways"])
@pytest.mark.parametrize("S", [2, 3, 4, 5, 8])
def test_ring_schedule(S, bidirectional):
    """Neighbours only; S-1 hops one way, ceil((S-1)/2) both ways; a chunk is
    sent on by the rank that received it one hop earlier; every place of every
    output is written exactly once."""
    shards = [torch.full((2, 3), float(r)) for r in range(S)]
    record = []
    out = TR.ring_all_gather_plain(shards, bidirectional, record=record)
    assert record == TR.hop_schedule(S, bidirectional)
    both = bidirectional and S > 2
    hops = (S - 1 + 1) // 2 if both else S - 1
    assert {hop for hop, *_ in record} == set(range(hops))
    holds = {(r, r): -1 for r in range(S)}          # (rank, chunk) -> hop it arrived at
    for hop, src, dst, chunk in record:
        assert (dst - src) % S in ((1, S - 1) if both else (1,)), (src, dst)
        assert holds.get((src, chunk)) == hop - 1, "not forwarded one hop after arrival"
        assert (dst, chunk) not in holds, "a place written twice"
        holds[(dst, chunk)] = hop
    assert len(holds) == S * S
    if both:                                          # the clockwise way carries the odd hop
        cw = sum(1 for _, src, dst, _ in record if (dst - src) % S == 1)
        assert cw == S * (S // 2) and len(record) - cw == S * ((S - 1) // 2)
    for o in out:
        assert torch.equal(o, torch.cat(shards))


def test_ring_all_gather_edge_cases():
    x = torch.arange(6.0).reshape(2, 3)
    assert TR.ring_all_gather([x])[0] is x                       # S = 1: the input
    assert TR.hop_schedule(2, True) == TR.hop_schedule(2, False)   # S <= 2: one way
    with pytest.raises(ValueError, match="rank-2"):
        TR.ring_all_gather([x[0], x[0]])
    with pytest.raises(ValueError, match="differ"):
        TR.ring_all_gather([x, x[:1]])
    with pytest.raises(ValueError, match="differ"):
        TR.ring_all_gather([x, x.double()])
    # bytes, not types: any element type, and the outputs carry no gradient
    for dtype in (torch.bfloat16, torch.int32, torch.uint8):
        shards = [(torch.arange(12).reshape(4, 3) + r).to(dtype) for r in range(3)]
        assert torch.equal(TR.ring_all_gather(shards, True)[1], torch.cat(shards))
    grad_in = [x.clone().requires_grad_(True), x.clone().requires_grad_(True)]
    assert not TR.ring_all_gather(grad_in)[0].requires_grad


@pytest.mark.parametrize("bidirectional", [False, True], ids=["one_way", "both_ways"])
def test_ring_sharded_topk_matches_jax_and_dense(mesh_dp, bidirectional):
    B, N, k, S = 4, 64, 10, 8
    scores = np.random.default_rng(int(bidirectional)).normal(size=(B, N)).astype(np.float32)
    f = smap(lambda s: JR.ring_sharded_topk(s, k, "data", bidirectional=bidirectional),
             mesh_dp, P(None, "data"), out_specs=(P(None, None), P(None, None)))
    ref_vals, ref_idx = (np.asarray(a) for a in f(jnp.asarray(scores)))
    out = TR.ring_sharded_topk(list(torch.tensor(scores).chunk(S, dim=1)), k, bidirectional)
    dense_vals, dense_idx = torch.topk(torch.tensor(scores), k)
    assert len(out) == S
    for vals, idx in out:
        assert idx.dtype == torch.int64
        np.testing.assert_allclose(vals.numpy(), ref_vals, rtol=1e-6)
        np.testing.assert_array_equal(idx.numpy(), ref_idx)
        np.testing.assert_allclose(vals.numpy(), dense_vals.numpy(), rtol=1e-6)
        np.testing.assert_array_equal(idx.numpy(), dense_idx.numpy())


def test_ring_sharded_topk_k_above_a_shard():
    """k larger than a shard's columns: every shard sends all it has."""
    scores = torch.tensor(np.random.default_rng(5).normal(size=(3, 24)).astype(np.float32))
    dense_vals, dense_idx = torch.topk(scores, 10)
    for vals, idx in TR.ring_sharded_topk(list(scores.chunk(4, dim=1)), 10, True):
        assert torch.equal(vals, dense_vals) and torch.equal(idx, dense_idx)


def test_ring_sharded_topk_index_bit_cast(monkeypatch):
    """The int32 indices ride the fp32 buffer as bits, not as values: an odd
    index above 2**24, which no fp32 value holds, comes back whole."""
    stride = 2 ** 24 + 1
    assert int(np.float32(stride)) != stride
    monkeypatch.setattr(TR, "local_index_offset", lambda i, n_local: i * stride)
    scores = torch.tensor(np.random.default_rng(6).normal(size=(2, 12)).astype(np.float32))
    shards = list(scores.chunk(3, dim=1))
    dense_vals, dense_idx = torch.topk(scores, 5)
    expected = (dense_idx // 4) * stride + dense_idx % 4
    assert int(expected.max()) > 2 ** 24
    for vals, idx in TR.ring_sharded_topk(shards, 5):
        assert torch.equal(vals, dense_vals) and torch.equal(idx, expected)
