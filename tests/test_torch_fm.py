"""The FM second-order term of the port against the JAX package.

On the CPU the port's wrapper (``fused_fm_interaction``) runs its plain form
and the backward formula written out beside the kernel; both are held here
against ``recsys_tpu.ops.fm`` (1e-6 of the sums a row's result is the
difference of: the same fp32 sums in another order),
against the Pallas kernel in interpret mode (rtol 1e-4 / atol 1e-3, the JAX
suite's bound in tests/test_pallas.py) and against ``jax.grad`` (1e-5). The
CUDA kernels themselves are held against the same plain forms on the card, in
tests/test_torch_kernel_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import recsys_tpu.ops.fm as JF
from recsys_tpu.ops.pallas_fm import fused_fm_interaction as pallas_fm
from recsys_tpu_torch.ops import fm as TF
from recsys_tpu_torch.ops import fm_kernel as FK
from recsys_tpu_torch.ops import select_fm

SHAPES = [(200, 12, 16), (7, 3, 8), (64, 6, 8), (33, 20, 16), (5, 1, 1)]


def _v(shape, seed=5):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close_to_1e6_of_the_sums(got, ref, v):
    """A row's term is the difference of two sums of F*K squares; fp32 rounding
    scales with those sums, not with their difference."""
    scale = (v.sum(1) ** 2 + (v ** 2).sum(1))
    scale = scale.sum(-1) if got.ndim == 1 else scale
    assert np.all(np.abs(got - ref) <= 1e-6 * scale + 1e-6)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_forms_match_the_jax_forms(shape):
    v = _v(shape)
    got = TF.fm_interaction(torch.as_tensor(v)).numpy()
    _close_to_1e6_of_the_sums(got, np.asarray(JF.fm_interaction(jnp.asarray(v))), v)
    vec = TF.fm_interaction_vector(torch.as_tensor(v))
    assert vec.shape == (shape[0], shape[2])
    _close_to_1e6_of_the_sums(vec.numpy(),
                              np.asarray(JF.fm_interaction_vector(jnp.asarray(v))), v)
    # DeepFM sums the vector over K: that is the (B,) term the kernel computes
    _close_to_1e6_of_the_sums(vec.sum(-1).numpy(), got, v)


def test_identity_matches_explicit_pairs():
    v = _v((4, 6, 8), seed=0)
    expected = np.zeros(4)
    for b in range(4):
        for i in range(6):
            for j in range(i + 1, 6):
                expected[b] += v[b, i] @ v[b, j]
    got = FK.fused_fm_interaction(torch.as_tensor(v)).numpy()
    np.testing.assert_allclose(got, expected, rtol=1e-4)


@pytest.mark.parametrize("shape", [(200, 12, 16), (130, 3, 8)])
def test_wrapper_matches_the_pallas_kernel_in_interpret_mode(shape):
    v = _v(shape)
    ref = np.asarray(pallas_fm(jnp.asarray(v)))          # interpret mode on the CPU
    got = FK.fused_fm_interaction(torch.as_tensor(v))
    assert got.dtype == torch.float32 and got.shape == (shape[0],)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
def test_low_precision_inputs_are_summed_in_fp32(dtype):
    v = torch.as_tensor(_v((50, 12, 16))).to(dtype)
    jdt = jnp.bfloat16 if dtype is torch.bfloat16 else jnp.float16
    ref = np.asarray(JF.fm_interaction(jnp.asarray(v.float().numpy()).astype(jdt)))
    got = FK.fused_fm_interaction(v)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("shape", SHAPES)
def test_gradient_matches_jax_grad(shape):
    v = _v(shape, seed=9)
    g = np.random.default_rng(1).normal(size=shape[0]).astype(np.float32)
    ref = np.asarray(jax.grad(lambda x: jnp.sum(JF.fm_interaction(x) * g))(jnp.asarray(v)))
    x = torch.as_tensor(v).requires_grad_(True)
    (FK.fused_fm_interaction(x) * torch.as_tensor(g)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_written_out_backward_is_autograd_of_the_plain_form(dtype):
    v = torch.as_tensor(_v((40, 6, 8), seed=3)).to(dtype)
    g = torch.as_tensor(np.random.default_rng(2).normal(size=40).astype(np.float32))
    x = v.clone().requires_grad_(True)
    (TF.fm_interaction(x) * g).sum().backward()
    got = FK.fm_bwd_plain(v, g)
    assert got.dtype == dtype and got.shape == v.shape
    tol = 1e-6 if dtype is torch.float32 else 2.0 ** -7
    torch.testing.assert_close(got.float(), x.grad.float(), rtol=tol, atol=1e-5)


def test_select_fm_dispatch(monkeypatch):
    v = torch.as_tensor(_v((8, 3, 4)))
    with pytest.raises(RuntimeError, match="CUDA"):
        select_fm("pallas")(v)
    with pytest.raises(ValueError, match="unknown"):
        select_fm("triton")(v)

    def boom(*a, **k):
        raise AssertionError("kernel wrapper reached for a CPU tensor")

    monkeypatch.setattr(FK, "fused_fm_interaction", boom)
    for mode in ("auto", "xla"):
        assert torch.equal(select_fm(mode)(v), TF.fm_interaction(v))


def test_kernel_wrappers_refuse_cpu_tensors_and_count_no_launch():
    v = torch.as_tensor(_v((8, 3, 4)))
    FK.reset_launch_counts()
    FK.fused_fm_interaction(v.requires_grad_(True)).sum().backward()
    assert FK.LAUNCHES == {"fm_fwd": 0, "fm_bwd": 0}     # the CPU path launches nothing
    with pytest.raises(RuntimeError, match="CUDA"):
        FK.fm_fwd_cuda(v.detach())
    with pytest.raises(RuntimeError, match="CUDA"):
        FK.fm_bwd_cuda(v.detach(), torch.zeros(8))
    with pytest.raises(ValueError, match="B, F, K"):
        FK.fused_fm_interaction(torch.zeros(4, 4))
