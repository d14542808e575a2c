"""The port's ``entry()`` against ``__graft_entry__.entry()`` on the CPU.

Both build the item tower on the same tiny config and batch; the port's
model gets the JAX function's parameters through ``bridge.py``. The inputs are
held equal exactly; the forward at the item tower's tolerances
(``tests/test_torch_item_tower.py``: per-row cosine >= 0.999 and 2e-2 abs,
both towers computing in bf16 over fp32 parameters).
"""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from recsys_tpu_torch import entry as T
from recsys_tpu_torch.bridge import load_flax_params
from test_torch_item_tower import assert_rows_close


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_entry_matches_the_jax_entry():
    jfn, jargs = graft.entry()
    fn, args = T.entry("cpu")
    model, *inputs = args
    assert len(inputs) == len(jargs) - 1 == 5
    for got, ref in zip(inputs, jargs[1:]):
        assert got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    ref = np.asarray(jax.jit(jfn)(*jargs), np.float32)
    out = fn(*args)
    assert out.shape == ref.shape == (16, 128) and torch.isfinite(out).all()
    load_flax_params(model, jax.device_get(jargs[0]))
    assert_rows_close(fn(*args).float().numpy(), ref)


def test_entry_asks_for_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError):
        T.entry()
