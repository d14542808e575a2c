"""The int8 catalog (``ops/quant.py``) against the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through ``recsys_tpu.ops.quant``
and ``recsys_tpu_torch.ops.quant``. Tolerances:

* ``q``: equal except in at most 1e-4 of the entries, each by one: a row
  norm one ulp apart between ``jnp.linalg.norm`` and ``torch.linalg.norm``
  can move a value that sits on a rounding boundary;
* ``col_scale``: rtol 1e-6 (the same per-column max over those rows);
* ``int8_topk``: the ids exactly, ties included (the catalog holds duplicate
  rows, and equal int32 sums come back lowest index first in both), the
  values within 1e-6, absolute or relative (alpha times the same integer;
  the two alphas may lie one ulp apart, which is 2e-6 on the scores of about
  25 that unnormalized queries at D = 600 reach).
"""

import numpy as np
import pytest
import torch

from recsys_tpu.ops import quant as JQ
from recsys_tpu_torch.bridge import quantized_from_jax
from recsys_tpu_torch.ops import quant as TQ
from recsys_tpu_torch.ops.topk import stable_topk


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs several workers on few cores: torch's default of one
    thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _catalog(seed: int, n: int = 400, d: int = 32, dups: int = 40):
    """(n+1, d) items with PAD row 0 and `dups` duplicated rows, and queries,
    some of them equal to catalog rows."""
    rng = np.random.default_rng(seed)
    items = rng.normal(size=(n + 1, d)).astype(np.float32)
    items[0] = 0
    items[n - dups + 1:] = items[1:dups + 1]
    u = rng.normal(size=(24, d)).astype(np.float32)
    u[:6] = items[[1, 2, 3, n, 17, 18]]
    return items, u


def _assert_q_close(jq, tq):
    diff = np.asarray(jq).astype(np.int32) - tq.cpu().numpy().astype(np.int32)
    assert np.abs(diff).max() <= 1
    assert (diff != 0).mean() <= 1e-4


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("seed,d", [(0, 32), (1, 16), (2, 8)])
def test_quantize_matches_jax(seed, d, normalize):
    items, _ = _catalog(seed, d=d)
    jq = JQ.quantize_items_int8(items, normalize=normalize)
    tq = TQ.quantize_items_int8(items, normalize=normalize, device="cpu")
    assert tq.q.dtype == torch.int8 and tq.q.shape == items.shape
    _assert_q_close(jq.q, tq.q)
    np.testing.assert_allclose(tq.col_scale.numpy(), np.asarray(jq.col_scale), rtol=1e-6)


@pytest.mark.parametrize("k", [1, 10, 60])
@pytest.mark.parametrize("seed,d", [(0, 32), (3, 16), (4, 8), (11, 600)],
                         ids=["d32", "d16", "d8", "d600_float_key"])
def test_int8_topk_matches_jax_with_ties(seed, d, k):
    """d = 600 is past the width where the int32 sums order as the float
    scores do (127^2 * d >= 2^23): the top-k is then taken of the scores."""
    items, u = _catalog(seed, d=d)
    jv, ji = JQ.int8_topk(u, JQ.quantize_items_int8(items), k)
    tv, ti = TQ.int8_topk(u, TQ.quantize_items_int8(items, device="cpu"), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=1e-6)
    assert (ti.numpy() != 0).all()


def test_ties_come_back_lowest_index_first():
    """Every catalog row twice: each pair of equal sums in index order."""
    rng = np.random.default_rng(5)
    base = rng.normal(size=(30, 8)).astype(np.float32)
    items = np.concatenate([np.zeros((1, 8), np.float32), base, base])
    _, ti = TQ.int8_topk(base[:4], TQ.quantize_items_int8(items, device="cpu"), 2)
    np.testing.assert_array_equal(ti.numpy(), np.arange(1, 5)[:, None] + np.array([0, 30]))
    _, ji = JQ.int8_topk(base[:4], JQ.quantize_items_int8(items), 2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_int8_topk_equals_its_plain_form():
    items, u = _catalog(6)
    qi = TQ.quantize_items_int8(items, device="cpu")
    tv, ti = TQ.int8_topk(u, qi, 25)
    pv, pi, acc = TQ.int8_topk_plain(u, qi, 25)
    np.testing.assert_array_equal(ti.numpy(), pi.numpy())
    np.testing.assert_array_equal(tv.numpy(), pv.numpy())
    uq, _ = TQ._quantize_queries(torch.as_tensor(u), qi.col_scale)
    assert torch.equal(TQ.int8_accumulate(uq, qi).long(), acc)


def test_quantization_recall_matches_jax():
    # no duplicate rows: the exact top-k (``torch.topk``) orders ties its own way
    items, u = _catalog(7, d=16, dups=0)
    assert TQ.quantization_recall(items, u, k=20, device="cpu") == \
        JQ.quantization_recall(items, u, k=20)


def test_approx_method_is_refused():
    """Only a method that neither package names is refused: ``"approx"`` is
    ``jax.lax.approx_max_k``'s answer (tests/test_torch_approx_topk.py), here
    where every column is a bin, the JAX package's top-k."""
    items, u = _catalog(8)
    qi = TQ.quantize_items_int8(items, device="cpu")
    with pytest.raises(ValueError, match="approximate"):
        TQ.int8_topk(u, qi, 5, method="approximate")
    tv, ti = TQ.int8_topk(u, qi, 5, method="approx", recall_target=1.0)
    jv, ji = JQ.int8_topk(u, JQ.quantize_items_int8(items), 5, method="approx",
                          recall_target=1.0)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=1e-6)


def test_catalog_quantized_by_jax_searched_in_the_port():
    items, u = _catalog(9)
    jq = JQ.quantize_items_int8(items)
    carried = quantized_from_jax(np.asarray(jq.q), np.asarray(jq.col_scale), device="cpu")
    tv, ti = TQ.int8_topk(u, carried, 30)
    jv, ji = JQ.int8_topk(u, jq, 30)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-6)
    # and the other way: the port's arrays in the JAX structure
    tq = TQ.quantize_items_int8(items, device="cpu")
    back = JQ.QuantizedItems(tq.q.numpy(), tq.col_scale.numpy())
    np.testing.assert_array_equal(np.asarray(JQ.int8_topk(u, back, 30)[1]),
                                  TQ.int8_topk(u, tq, 30)[1].numpy())


def test_quantize_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        TQ.quantize_items_int8(np.ones((3, 4), np.float32))


def test_stable_topk_orders_ties_and_minus_inf_as_lax_top_k():
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(10)
    x = rng.integers(-3, 3, (6, 40)).astype(np.float32)
    x[:, ::7] = -np.inf
    jv, ji = jax.lax.top_k(jnp.asarray(x), 25)
    tv, ti = stable_topk(torch.as_tensor(x), 25)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    xi = x.copy()
    xi[~np.isfinite(xi)] = -(2 ** 31)
    tv, ti = stable_topk(torch.as_tensor(xi.astype(np.int32)), 25)
    jv, ji = jax.lax.top_k(jnp.asarray(xi.astype(np.int32)), 25)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
