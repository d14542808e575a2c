"""The accuracy argument of kernel K1's tensor-core products, in numpy.

``csrc/diag_ce.cu`` multiplies fp32 operands on tensor cores that read 19
bits of each (TF32: 10 mantissa bits). It splits every operand into
``hi = x rounded to 19 bits`` and ``lo = x - hi cut to 19 bits`` and sums
``lo_a hi_b + hi_a lo_b + hi_a hi_b`` in fp32. A product of two such values is
exact in fp32 (11 x 11 significant bits), so the kernel's arithmetic is
reproduced here by fp32 matrix products of the split parts, with the split
written exactly as the kernel writes it (integer add and mask). Held against
the fp64 product at the kernel's shapes and 1 / tau:

  * the three-term logits are within the loss tolerance of the JAX suite
    (1e-4, tests/test_pallas.py) by a wide margin, and as good as a plain fp32
    product is;
  * one TF32 term alone is not (which is why the kernel splits);
  * the second product of the backward (dlogits times rows, per-row upstream
    gradients of size ~1) is within the gradient tolerance (1e-5) of fp64
    relative to its scale.
"""

import numpy as np
import pytest

TF32_MASK = np.uint32(0xFFFFE000)
LOSS_TOL, GRAD_TOL = 1e-4, 1e-5


def split(x: np.ndarray):
    """``(hi, lo)`` as ``split()`` of csrc/diag_ce.cu computes them."""
    assert x.dtype == np.float32
    bits = x.view(np.uint32)
    hi = ((bits + np.uint32(0x1000)) & TF32_MASK).view(np.float32)
    lo = ((x - hi).view(np.uint32) & TF32_MASK).view(np.float32)
    return hi, lo


def product_3xtf32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``a @ b.T`` the way the kernel sums it: the small terms first, fp32."""
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    acc = a_lo @ b_hi.T
    acc = acc + a_hi @ b_lo.T
    return acc + a_hi @ b_hi.T


def unit_rows(rng, B, D):
    x = rng.normal(size=(B, D)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def test_split_is_exact_up_to_two_to_the_minus_21():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(size=4096), rng.normal(size=4096) * 1e-6,
                        rng.normal(size=4096) * 1e6, [0.0, 1.0, -1.0, 2.0 ** -100]]
                       ).astype(np.float32)
    hi, lo = split(x)
    for part in (hi, lo):                      # 19 bits each: the low 13 are clear
        assert not (part.view(np.uint32) & ~TF32_MASK).any()
    assert (np.abs(x - hi) <= 2.0 ** -11 * np.abs(x) * (1 + 2.0 ** -10)).all()   # hi is rounded, not cut
    err = np.abs(x.astype(np.float64) - hi.astype(np.float64) - lo.astype(np.float64))
    assert (err <= 2.0 ** -21 * np.abs(x)).all()
    assert err.max() > 0                       # and it is a real rounding, not an identity


@pytest.mark.parametrize("B,D,tau", [(192, 128, 0.08), (768, 128, 0.1), (200, 64, 0.1),
                                     (200, 256, 0.1), (3072, 128, 0.1)])
def test_three_terms_reproduce_the_fp32_logits_within_the_loss_tolerance(B, D, tau):
    rng = np.random.default_rng(B + D)
    q, k = unit_rows(rng, B, D), unit_rows(rng, B, D)
    exact = (q.astype(np.float64) @ k.astype(np.float64).T) / tau
    got = product_3xtf32(q, k).astype(np.float64) / tau
    fp32 = (q @ k.T).astype(np.float64) / tau
    one_term = (split(q)[0] @ split(k)[0].T).astype(np.float64) / tau
    err, fp32_err = np.abs(got - exact).max(), np.abs(fp32 - exact).max()
    assert err <= LOSS_TOL / 20                 # 5e-6 on a logit of up to 12.5
    assert err <= 4 * fp32_err + 1e-7           # no worse than fp32 by more than its own noise
    assert np.abs(one_term - exact).max() > err * 50   # plain TF32 is far off ...
    # ... and misses the tolerance where the per-row loss (a logit and an lse of them) is formed
    loss = lambda z: np.log(np.exp(z - z.max(1, keepdims=True)).sum(1)) + z.max(1) - np.diag(z)
    assert np.abs(loss(got) - loss(exact)).max() <= LOSS_TOL / 10
    assert np.abs(loss(one_term) - loss(exact)).max() > LOSS_TOL


@pytest.mark.parametrize("B,D", [(192, 128), (333, 64)])
def test_three_terms_carry_the_second_product_of_the_backward(B, D):
    """dq = dlogits @ k with dlogits = (P - I) * g / tau, g of size ~1 per row."""
    rng = np.random.default_rng(B)
    q, k = unit_rows(rng, B, D), unit_rows(rng, B, D)
    tau = 0.1
    logits = (q.astype(np.float64) @ k.astype(np.float64).T) / tau
    p = np.exp(logits - logits.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    g = rng.normal(size=B)
    dlogits = ((p - np.eye(B)) * (g / tau)[:, None]).astype(np.float32)
    exact = dlogits.astype(np.float64) @ k.astype(np.float64)
    got = product_3xtf32(dlogits, np.ascontiguousarray(k.T)).astype(np.float64)
    one_term = (split(dlogits)[0] @ split(np.ascontiguousarray(k.T))[0].T).astype(np.float64)
    scale = np.abs(exact).max()
    assert scale > 0.5                           # entries of size ~1: the hard case
    assert np.abs(got - exact).max() <= GRAD_TOL * scale
    assert np.abs(one_term - exact).max() > GRAD_TOL * scale   # one term would not do
    # with the mean-loss gradient (g = 1 / B) the absolute tolerance itself holds
    small = product_3xtf32((dlogits / B).astype(np.float32), np.ascontiguousarray(k.T))
    assert np.abs(small - exact / B).max() <= GRAD_TOL / 100
