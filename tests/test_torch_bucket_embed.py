"""``models/layers.BucketEmbed``, the time buckets' table of the stage-2 and
hybrid towers, on the CPU: the same rows as ``Embed`` bit for bit, its
gradient (the ids' one-hot product with the rows' gradients, summed in a
fixed order) against a float64 sum and against ``nn.Embedding``'s, and both
towers built with it under the parameter names the bridge maps.

Tolerance: 1e-3 abs against the float64 sum, for sums of ~3,840 terms of
unit size in float32 (the order of 3,840 x 2^-24 x the sum's size of ~60).
The card test (``tests/test_torch_kernel_cuda.py``) holds that two runs give
the same bits there.
"""

import numpy as np
import pytest
import torch

from recsys_tpu_torch.config import UserTowerConfig
from recsys_tpu_torch.models.hybrid_tower import HybridUserTower
from recsys_tpu_torch.models.layers import BF16, BucketEmbed, Embed
from recsys_tpu_torch.models.user_tower import SASRecUserTower


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tables():
    torch.manual_seed(0)
    bucket = BucketEmbed(10, 128)
    plain = Embed(10, 128)
    plain.load_state_dict(bucket.state_dict())
    return bucket, plain


def test_rows_and_gradient_of_the_time_buckets_table():
    bucket, plain = _tables()
    rng = np.random.default_rng(0)
    ids = torch.as_tensor(rng.integers(0, 10, (768, 50)))
    g = torch.as_tensor(rng.normal(size=(768, 50, 128)).astype(np.float32))
    out, ref_out = bucket(ids), plain(ids)
    assert out.dtype == BF16 and torch.equal(out, ref_out)
    out.float().backward(g)
    ref_out.float().backward(g)
    g16 = g.to(BF16).double().reshape(-1, 128)            # the rows' gradient, as it arrives
    want = torch.zeros(10, 128, dtype=torch.float64).index_add_(0, ids.reshape(-1), g16)
    torch.testing.assert_close(bucket.weight.grad.double(), want, atol=1e-3, rtol=0)
    torch.testing.assert_close(bucket.weight.grad, plain.weight.grad, atol=1e-3, rtol=0)
    first = bucket.weight.grad.clone()
    bucket.weight.grad = None
    bucket(ids).float().backward(g)
    assert torch.equal(bucket.weight.grad, first)


def test_an_id_out_of_the_table_gets_no_gradient_row():
    bucket, _ = _tables()
    ids = torch.tensor([[0, 0, 9], [9, 3, 0]])
    bucket(ids).float().sum().backward()
    rows = bucket.weight.grad.abs().sum(1)
    assert set(torch.nonzero(rows).flatten().tolist()) == {0, 3, 9}


def test_both_towers_use_it_under_the_same_names():
    cfg = UserTowerConfig(d_model=32, nhead=2, max_len=6, num_layers=1)
    for tower in (SASRecUserTower(cfg, 40), HybridUserTower(cfg, 40, content_dim=16, gnn_dim=8)):
        assert type(tower.time_embedding) is BucketEmbed
        assert tower.state_dict()["time_embedding.weight"].shape == (cfg.num_time_buckets, 32)
