"""Kernel K1 (csrc/diag_ce.cu) against its plain PyTorch form, on the card.

Needs an NVIDIA GPU and nvcc; skips elsewhere. This file imports no JAX, so
on the GPU machine it runs without the JAX test harness:

    python -m pytest --noconftest -q tests/test_torch_kernel_cuda.py

Tolerances are the JAX suite's for the Pallas kernel
(tests/test_pallas.py): loss 1e-4 abs, grads 1e-5 abs. Both sides are fp32
with TF32 off; the kernel sums in another order than cuBLAS.
"""

import numpy as np
import pytest
import torch

from recsys_tpu_torch.ops import contrastive_kernel as K
from recsys_tpu_torch.ops.contrastive import bidirectional_infonce, inbatch_logq_loss

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel K1 has no CPU build)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _unit(rng, B, D):
    x = rng.normal(size=(B, D)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _logq_problem(B, D, seed, device):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, device=device)
    return {"u": t(_unit(rng, B, D)), "i": t(_unit(rng, B, D)),
            "pos": t(rng.integers(1, max(B // 4, 2), B)),
            "uid": t(rng.integers(0, max(B // 3, 2), B)),
            "logq": t(rng.uniform(-8, -1, B).astype(np.float32)),
            "valid": t((rng.random(B) > 0.1).astype(np.int32))}


def _grads(fn, a, b):
    a = a.clone().requires_grad_(True)
    b = b.clone().requires_grad_(True)
    loss = fn(a, b)
    ga, gb = torch.autograd.grad(loss, (a, b))
    return loss.detach(), ga, gb


@pytest.mark.parametrize("B", [200, 768, 8192])
def test_kernel_logq_matches_plain(device, B):
    p = _logq_problem(B, 128, B, device)
    kw = dict(temperature=0.1, user_ids=p["uid"], valid=p["valid"])
    ref = _grads(lambda a, b: inbatch_logq_loss(a, b, p["pos"], p["logq"], **kw),
                 p["u"], p["i"])
    K.reset_launch_counts()
    got = _grads(lambda a, b: K.fused_inbatch_logq_loss(a, b, p["pos"], p["logq"], **kw),
                 p["u"], p["i"])
    torch.cuda.synchronize()
    assert K.LAUNCHES == {"diag_ce_fwd": 1, "diag_ce_bwd_dq": 1, "diag_ce_bwd_dk": 1}
    assert abs(float(got[0]) - float(ref[0])) <= 1e-4
    for g, r in zip(got[1:], ref[1:]):
        assert float((g - r).abs().max()) <= 1e-5


@pytest.mark.parametrize("B", [192, 8192])
def test_kernel_infonce_matches_plain(device, B):
    rng = np.random.default_rng(B)
    a = torch.as_tensor(_unit(rng, B, 128), device=device)
    b = torch.as_tensor(_unit(rng, B, 128), device=device)
    ref = _grads(lambda x, y: bidirectional_infonce(x, y, 0.08), a, b)
    got = _grads(lambda x, y: K.fused_bidirectional_infonce(x, y, 0.08), a, b)
    assert abs(float(got[0]) - float(ref[0])) <= 1e-4
    for g, r in zip(got[1:], ref[1:]):
        assert float((g - r).abs().max()) <= 1e-5


def test_kernel_per_row_outputs(device):
    """Per-row loss and both gradients under a random upstream gradient."""
    B, D = 333, 64
    p = _logq_problem(B, D, 7, device)
    corr = p["logq"][p["pos"]]
    args = (corr, p["pos"].int(), p["uid"].int(), p["valid"])
    g = torch.randn(B, device=device, generator=torch.Generator(device).manual_seed(0))
    ref = _grads(lambda a, b: (K.fused_diag_ce_reference(a, b, *args, 0.1) * g).sum(),
                 p["u"], p["i"])
    got = _grads(lambda a, b: (K.fused_diag_ce(a, b, *args, 0.1) * g).sum(),
                 p["u"], p["i"])
    assert abs(float(got[0]) - float(ref[0])) <= 1e-3  # a sum of 333 rows
    for x, r in zip(got[1:], ref[1:]):
        assert float((x - r).abs().max()) <= 1e-4  # per-row g ~ N(0, 1), not 1/B


def test_kernel_rejects_bad_inputs(device):
    q = torch.randn(8, 4, device=device)
    ids = torch.arange(8, device=device, dtype=torch.int32)
    with pytest.raises(ValueError):
        K.diag_ce_fwd_cuda(q.double(), q, torch.zeros(8, device=device), ids, ids, ids, 0.1)
    with pytest.raises(ValueError):
        K.diag_ce_fwd_cuda(q, q.t().contiguous().t(), torch.zeros(8, device=device),
                           ids, ids, ids, 0.1)
