"""The fused contrastive cross-entropy (kernel K1) and its wrappers.

Counterpart of ``recsys_tpu/ops/pallas_contrastive.py``. ``fused_diag_ce``
returns per-row ``-log softmax(logits)_ii`` with

    logits_ij = (q_i . k_j) / tau - corr_j
    masked    same item (pos_j == pos_i), same user (usr_j == usr_i) or
              invalid column (valid_j == 0), never on the diagonal

On CUDA tensors the forward and both halves of the backward are the
hand-written kernels in ``csrc/diag_ce.cu`` (sm_90a), built with ``nvcc``
into ``csrc/build/`` on first use and called through ``ctypes``. On CPU
tensors the same autograd function runs the plain PyTorch math of those
kernels. A CUDA tensor never takes the plain path: the kernel launches or
the call raises.

``fused_diag_ce_reference`` is the plain form with the same signature,
differentiated by autograd; it is the oracle the kernel is held against.
"""

from __future__ import annotations

import ctypes

import torch

from recsys_tpu_torch.ops._build import KernelLibrary, raise_on_error as _raise_on_error
from recsys_tpu_torch.ops.contrastive import NEG

# launches per kernel; each wrapper adds one where it launches, nowhere else
LAUNCHES = {"diag_ce_fwd": 0, "diag_ce_bwd_dq": 0, "diag_ce_bwd_dk": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.diag_ce_max_dim.restype = i32
    lib.diag_ce_max_dim.argtypes = []
    lib.diag_ce_fwd.restype = i32
    lib.diag_ce_fwd.argtypes = [ptr] * 6 + [i32, i32, f32, ptr, ptr, ptr]
    for name in ("diag_ce_bwd_dq", "diag_ce_bwd_dk"):
        fn = getattr(lib, name)
        fn.restype = i32
        fn.argtypes = [ptr] * 8 + [i32, i32, f32, ptr, ptr]


LIBRARY = KernelLibrary("diag_ce.cu", _bind)
BUILD_INFO = LIBRARY.info
load_library = LIBRARY.load


def _check_cuda_inputs(q, k, corr, pos, usr, valid):
    if not q.is_cuda:
        raise RuntimeError("the diag_ce kernel takes CUDA tensors only")
    B, D = q.shape
    for name, t, dtype, shape in (
            ("q", q, torch.float32, (B, D)), ("k", k, torch.float32, (B, D)),
            ("corr", corr, torch.float32, (B,)), ("pos", pos, torch.int32, (B,)),
            ("usr", usr, torch.int32, (B,)), ("valid", valid, torch.int32, (B,))):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name}: want contiguous {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if B < 1:
        raise ValueError("empty batch")
    max_d = load_library().diag_ce_max_dim()
    if D > max_d:
        raise ValueError(f"embedding width {D} > {max_d}, the kernel's limit")


def diag_ce_fwd_cuda(q, k, corr, pos, usr, valid, temperature: float):
    """Kernel forward: (loss, lse), both (B,) fp32."""
    _check_cuda_inputs(q, k, corr, pos, usr, valid)
    lib = load_library()
    B, D = q.shape
    loss = torch.empty(B, dtype=torch.float32, device=q.device)
    lse = torch.empty(B, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.diag_ce_fwd(q.data_ptr(), k.data_ptr(), corr.data_ptr(),
                           pos.data_ptr(), usr.data_ptr(), valid.data_ptr(),
                           B, D, 1.0 / temperature, loss.data_ptr(),
                           lse.data_ptr(), stream)
    _raise_on_error(code, "diag_ce_fwd")
    LAUNCHES["diag_ce_fwd"] += 1
    return loss, lse


def _diag_ce_bwd_cuda(name, q, k, corr, pos, usr, valid, lse, g, temperature):
    _check_cuda_inputs(q, k, corr, pos, usr, valid)
    B, D = q.shape
    for arg, t in (("lse", lse), ("g", g)):
        if t.device != q.device or t.dtype != torch.float32 \
                or tuple(t.shape) != (B,) or not t.is_contiguous():
            raise ValueError(f"{arg}: want contiguous float32 ({B},) on {q.device}")
    out = torch.empty_like(q)
    code = getattr(load_library(), name)(
        q.data_ptr(), k.data_ptr(), corr.data_ptr(), pos.data_ptr(), usr.data_ptr(),
        valid.data_ptr(), lse.data_ptr(), g.data_ptr(), B, D, 1.0 / temperature,
        out.data_ptr(), torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on_error(code, name)
    LAUNCHES[name] += 1
    return out


def diag_ce_bwd_dq_cuda(q, k, corr, pos, usr, valid, lse, g, temperature: float):
    """Kernel backward, query side: dq (B, D) fp32."""
    return _diag_ce_bwd_cuda("diag_ce_bwd_dq", q, k, corr, pos, usr, valid, lse, g,
                             temperature)


def diag_ce_bwd_dk_cuda(q, k, corr, pos, usr, valid, lse, g, temperature: float):
    """Kernel backward, key side: dk (B, D) fp32, summed over rows in-block."""
    return _diag_ce_bwd_cuda("diag_ce_bwd_dk", q, k, corr, pos, usr, valid, lse, g,
                             temperature)


# -- plain PyTorch forms ------------------------------------------------------

def _masked_logits(q, k, corr, pos, usr, valid, temperature):
    logits = q.float() @ k.float().T / temperature - corr.float()[None, :]
    eye = torch.eye(q.shape[0], dtype=torch.bool, device=q.device)
    forbid = ((pos[None, :] == pos[:, None]) | (usr[None, :] == usr[:, None])
              | (valid[None, :] == 0)) & ~eye
    return torch.where(forbid, torch.full_like(logits, NEG), logits), forbid


def fused_diag_ce_reference(q, k, corr, pos, usr, valid, temperature: float):
    """Plain form of ``fused_diag_ce`` (same signature), for autograd."""
    logits, _ = _masked_logits(q, k, corr, pos, usr, valid, temperature)
    return torch.logsumexp(logits, dim=1) - torch.diagonal(logits)


def diag_ce_fwd_plain(q, k, corr, pos, usr, valid, temperature):
    """What the forward kernel computes, in plain PyTorch: (loss, lse)."""
    logits, _ = _masked_logits(q, k, corr, pos, usr, valid, temperature)
    lse = torch.logsumexp(logits, dim=1)
    return lse - torch.diagonal(logits), lse


def _dlogits_plain(q, k, corr, pos, usr, valid, lse, g, temperature):
    logits, forbid = _masked_logits(q, k, corr, pos, usr, valid, temperature)
    eye = torch.eye(q.shape[0], dtype=q.dtype, device=q.device)
    dlogits = (torch.exp(logits - lse[:, None]) - eye) * (g[:, None] / temperature)
    return dlogits.masked_fill(forbid, 0.0)


def diag_ce_bwd_dq_plain(q, k, corr, pos, usr, valid, lse, g, temperature):
    """What the dq kernel computes, in plain PyTorch."""
    return _dlogits_plain(q, k, corr, pos, usr, valid, lse, g, temperature) @ k


def diag_ce_bwd_dk_plain(q, k, corr, pos, usr, valid, lse, g, temperature):
    """What the dk kernel computes, in plain PyTorch."""
    return _dlogits_plain(q, k, corr, pos, usr, valid, lse, g, temperature).T @ q


class DiagCE(torch.autograd.Function):
    """Per-row diagonal cross entropy; kernels on CUDA, plain math on CPU."""

    @staticmethod
    def forward(ctx, q, k, corr, pos, usr, valid, temperature):
        fwd = diag_ce_fwd_cuda if q.is_cuda else diag_ce_fwd_plain
        loss, lse = fwd(q, k, corr, pos, usr, valid, temperature)
        ctx.save_for_backward(q, k, corr, pos, usr, valid, lse)
        ctx.temperature = temperature
        return loss

    @staticmethod
    def backward(ctx, g):
        q, k, corr, pos, usr, valid, lse = ctx.saved_tensors
        g = g.float().contiguous()
        if q.is_cuda:
            bwd_dq, bwd_dk = diag_ce_bwd_dq_cuda, diag_ce_bwd_dk_cuda
        else:
            bwd_dq, bwd_dk = diag_ce_bwd_dq_plain, diag_ce_bwd_dk_plain
        args = (q, k, corr, pos, usr, valid, lse, g, ctx.temperature)
        return bwd_dq(*args), bwd_dk(*args), None, None, None, None, None


def fused_diag_ce(q, k, corr, pos_ids, user_ids, valid, temperature: float):
    """(B,) per-row loss; see the module docstring."""
    i32 = torch.int32
    return DiagCE.apply(q.float().contiguous(), k.float().contiguous(),
                        corr.float().contiguous(), pos_ids.to(i32).contiguous(),
                        user_ids.to(i32).contiguous(), valid.to(i32).contiguous(),
                        float(temperature))


# -- user-facing wrappers -------------------------------------------------------

def fused_inbatch_logq_loss(user_emb, item_emb, pos_item_ids, log_q, *,
                            temperature: float = 0.1, lambda_logq: float = 1.0,
                            user_ids=None, valid=None):
    """Kernel twin of ops/contrastive.inbatch_logq_loss."""
    B, dev = user_emb.shape[0], user_emb.device
    corr = lambda_logq * log_q.float()[pos_item_ids]
    if user_ids is None:
        user_ids = torch.arange(B, dtype=torch.int32, device=dev)
    valid_arr = (torch.ones(B, dtype=torch.int32, device=dev) if valid is None
                 else valid.to(torch.int32))
    rows = fused_diag_ce(user_emb, item_emb, corr, pos_item_ids, user_ids,
                         valid_arr, temperature)
    w = valid_arr.float()
    return (rows * w).sum() / w.sum().clamp(min=1.0)


def fused_bidirectional_infonce(emb1, emb2, temperature: float = 0.08):
    """Kernel twin of ops/contrastive.bidirectional_infonce."""
    B, dev = emb1.shape[0], emb1.device
    zero_corr = torch.zeros(B, dtype=torch.float32, device=dev)
    uniq = -torch.arange(B, dtype=torch.int32, device=dev) - 500_000
    valid = torch.ones(B, dtype=torch.int32, device=dev)
    f = fused_diag_ce(emb1, emb2, zero_corr, uniq, uniq, valid, temperature).mean()
    b = fused_diag_ce(emb2, emb1, zero_corr, uniq, uniq, valid, temperature).mean()
    return 0.5 * (f + b)
