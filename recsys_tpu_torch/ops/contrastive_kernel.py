"""The fused contrastive cross-entropy (kernel K1) and its wrappers.

Counterpart of ``recsys_tpu/ops/pallas_contrastive.py``. ``fused_diag_ce``
returns per-row ``-log softmax(logits)_ii`` with

    logits_ij = clip((q_i . k_j) / tau - corr_j, -clamp, clamp)
    masked    same item (pos_j == pos_i), same user (usr_j == usr_i) or
              invalid column (valid_j == 0), never on the diagonal

The clamp (default none, ``math.inf``) is LightGCL's SSL logit clamp; its
gradient is zero where it cuts, as ``jnp.clip``'s. A call without it takes
the kernels' instances built without the clamp.

On CUDA tensors the forward and both halves of the backward are the
hand-written kernels in ``csrc/diag_ce.cu`` (sm_90a), built with ``nvcc``
into ``csrc/build/`` on first use and called through ``ctypes``. A call is
one cooperative launch in three phases (q and k split into TF32 planes, the
products, the merge of partial results), in a workspace the wrapper
allocates once per device, stream and shape and reuses. The wrapper binds
the C functions once and skips the device switch when q's device is already
current. The launch counts follow ``ops/_build.count_launch``: a launch
captured into a CUDA graph counts once each replay. On CPU tensors the same
autograd function runs the plain PyTorch math of those kernels. A CUDA
tensor never takes the plain path: the kernel launches or the call raises.

``fused_diag_ce_reference`` is the plain form with the same signature,
differentiated by autograd; it is the oracle the kernel is held against.
"""

from __future__ import annotations

import ctypes
import math

import torch

from recsys_tpu_torch.ops._build import KernelLibrary, count_launch, raise_on_error
from recsys_tpu_torch.ops.contrastive import NEG

# launches per kernel; each wrapper adds one where it launches (a captured
# launch one a replay), nowhere else
LAUNCHES = {"diag_ce_fwd": 0, "diag_ce_bwd_dq": 0, "diag_ce_bwd_dk": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.diag_ce_max_dim.restype = i32
    lib.diag_ce_max_dim.argtypes = []
    lib.diag_ce_workspace_bytes.restype = ctypes.c_size_t
    lib.diag_ce_workspace_bytes.argtypes = [i32, i32, i32]
    lib.diag_ce_fwd.restype = i32
    lib.diag_ce_fwd.argtypes = [ptr] * 6 + [i32, i32, f32, f32, ptr, ptr, ptr, ptr]
    for name in ("diag_ce_bwd_dq", "diag_ce_bwd_dk"):
        fn = getattr(lib, name)
        fn.restype = i32
        fn.argtypes = [ptr] * 8 + [i32, i32, f32, f32, ptr, ptr, ptr]


LIBRARY = KernelLibrary("diag_ce.cu", _bind)
BUILD_INFO = LIBRARY.info
load_library = LIBRARY.load
_MODE = {"diag_ce_fwd": 0, "diag_ce_bwd_dq": 1, "diag_ce_bwd_dk": 2}  # as csrc/diag_ce.cu
_FNS: dict = {}  # name -> bound C function, and "max_dim", once the library is loaded
# (device index, stream, B, D) -> workspace: kernels on one stream run in order,
# so the three kernels share one workspace a shape and reuse it call after call
_WORKSPACE: dict = {}
# the current stream's handle without building a Stream object (CUDA builds of torch)
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _kernels() -> dict:
    if not _FNS:
        lib = load_library()
        _FNS.update({name: getattr(lib, name) for name in _MODE})
        _FNS["workspace_bytes"] = lib.diag_ce_workspace_bytes
        _FNS["max_dim"] = lib.diag_ce_max_dim()
    return _FNS


def _workspace(device: torch.device, stream: int, B: int, D: int) -> torch.Tensor:
    key = (device.index, stream, B, D)
    ws = _WORKSPACE.get(key)
    if ws is None:
        n_bytes = max(_FNS["workspace_bytes"](B, D, mode) for mode in _MODE.values())
        ws = _WORKSPACE[key] = torch.empty(n_bytes, dtype=torch.uint8, device=device)
    return ws


def _launch(name: str, q: torch.Tensor, *args) -> tuple:
    """``fn(*args, workspace, *outputs, stream)`` on q's device and its
    current stream."""
    index = q.device.index
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return _launch(name, q, *args)
    B, D = q.shape
    stream = (_RAW_STREAM(index) if _RAW_STREAM is not None
              else torch.cuda.current_stream(q.device).cuda_stream)
    ws = _workspace(q.device, stream, B, D)
    outs = ((torch.empty(B, dtype=torch.float32, device=q.device),
             torch.empty(B, dtype=torch.float32, device=q.device))
            if name == "diag_ce_fwd" else (torch.empty_like(q),))
    code = _FNS[name](*args, ws.data_ptr(), *(o.data_ptr() for o in outs), stream)
    raise_on_error(code, name)
    count_launch(LAUNCHES, name)
    return outs


def _input_error(q, k, corr, pos, usr, valid) -> Exception:
    if not q.is_cuda:
        return RuntimeError("the diag_ce kernel takes CUDA tensors only")
    if q.dim() != 2:
        return ValueError(f"q: want (B, D), got {tuple(q.shape)}")
    B, D = q.shape
    for name, t, dtype, shape in (
            ("q", q, torch.float32, (B, D)), ("k", k, torch.float32, (B, D)),
            ("corr", corr, torch.float32, (B,)), ("pos", pos, torch.int32, (B,)),
            ("usr", usr, torch.int32, (B,)), ("valid", valid, torch.int32, (B,))):
        if t.device != q.device:
            return ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            return ValueError(f"{name}: want contiguous {dtype} {shape}, got "
                              f"{t.dtype} {tuple(t.shape)}")
    if B < 1:
        return ValueError("empty batch")
    return ValueError(f"embedding width {D} > {_FNS['max_dim']}, the kernel's limit")


def _checked(q, k, corr, pos, usr, valid, *rows) -> tuple[int, int]:
    """(B, D) of inputs the kernels take; raises on any other. ``rows`` are
    further (B,) float32 inputs (lse, g)."""
    if q.is_cuda and q.dim() == 2:
        _kernels()
        B, D = q.shape
        dev, f32, i32 = q.device, torch.float32, torch.int32
        if (1 <= B and D <= _FNS["max_dim"] and q.dtype == f32 and k.dtype == f32
                and k.shape == q.shape and k.device == dev
                and q.is_contiguous() and k.is_contiguous()
                and all(t.dtype == dt and t.shape == (B,) and t.device == dev and t.is_contiguous()
                        for t, dt in ((corr, f32), (pos, i32), (usr, i32), (valid, i32)))):
            for t in rows:
                if (t.device != dev or t.dtype != f32 or t.shape != (B,)
                        or not t.is_contiguous()):
                    raise ValueError(f"lse, g: want contiguous float32 ({B},) on {dev}")
            return B, D
    raise _input_error(q, k, corr, pos, usr, valid)


def diag_ce_fwd_cuda(q, k, corr, pos, usr, valid, temperature: float,
                     clamp: float = math.inf):
    """Kernel forward: (loss, lse), both (B,) fp32."""
    B, D = _checked(q, k, corr, pos, usr, valid)
    return _launch("diag_ce_fwd", q, q.data_ptr(), k.data_ptr(), corr.data_ptr(),
                   pos.data_ptr(), usr.data_ptr(), valid.data_ptr(), B, D,
                   1.0 / temperature, clamp)


def _diag_ce_bwd_cuda(name, q, k, corr, pos, usr, valid, lse, g, temperature, clamp):
    B, D = _checked(q, k, corr, pos, usr, valid, lse, g)
    return _launch(name, q, q.data_ptr(), k.data_ptr(), corr.data_ptr(), pos.data_ptr(),
                   usr.data_ptr(), valid.data_ptr(), lse.data_ptr(), g.data_ptr(), B, D,
                   1.0 / temperature, clamp)[0]


def diag_ce_bwd_dq_cuda(q, k, corr, pos, usr, valid, lse, g, temperature: float,
                        clamp: float = math.inf):
    """Kernel backward, query side: dq (B, D) fp32."""
    return _diag_ce_bwd_cuda("diag_ce_bwd_dq", q, k, corr, pos, usr, valid, lse, g,
                             temperature, clamp)


def diag_ce_bwd_dk_cuda(q, k, corr, pos, usr, valid, lse, g, temperature: float,
                        clamp: float = math.inf):
    """Kernel backward, key side: dk (B, D) fp32, partial sums merged in a fixed order."""
    return _diag_ce_bwd_cuda("diag_ce_bwd_dk", q, k, corr, pos, usr, valid, lse, g,
                             temperature, clamp)


# -- plain PyTorch forms ------------------------------------------------------

def _masked_logits(q, k, corr, pos, usr, valid, temperature, clamp=math.inf):
    """(masked logits, the entries whose gradient is zero): forbidden
    entries, and those the clamp cut."""
    logits = q.float() @ k.float().T / temperature - corr.float()[None, :]
    eye = torch.eye(q.shape[0], dtype=torch.bool, device=q.device)
    forbid = ((pos[None, :] == pos[:, None]) | (usr[None, :] == usr[:, None])
              | (valid[None, :] == 0)) & ~eye
    zero_grad = forbid
    if clamp != math.inf:
        zero_grad = forbid | ~((logits >= -clamp) & (logits <= clamp))
        logits = torch.clamp(logits, -clamp, clamp)
    return torch.where(forbid, torch.full_like(logits, NEG), logits), zero_grad


def fused_diag_ce_reference(q, k, corr, pos, usr, valid, temperature: float,
                            clamp: float = math.inf):
    """Plain form of ``fused_diag_ce`` (same signature), for autograd."""
    logits, _ = _masked_logits(q, k, corr, pos, usr, valid, temperature, clamp)
    return torch.logsumexp(logits, dim=1) - torch.diagonal(logits)


def diag_ce_fwd_plain(q, k, corr, pos, usr, valid, temperature, clamp=math.inf):
    """What the forward kernel computes, in plain PyTorch: (loss, lse)."""
    logits, _ = _masked_logits(q, k, corr, pos, usr, valid, temperature, clamp)
    lse = torch.logsumexp(logits, dim=1)
    return lse - torch.diagonal(logits), lse


def _dlogits_plain(q, k, corr, pos, usr, valid, lse, g, temperature, clamp):
    logits, zero_grad = _masked_logits(q, k, corr, pos, usr, valid, temperature, clamp)
    eye = torch.eye(q.shape[0], dtype=q.dtype, device=q.device)
    dlogits = (torch.exp(logits - lse[:, None]) - eye) * (g[:, None] / temperature)
    return dlogits.masked_fill(zero_grad, 0.0)


def diag_ce_bwd_dq_plain(q, k, corr, pos, usr, valid, lse, g, temperature, clamp=math.inf):
    """What the dq kernel computes, in plain PyTorch."""
    return _dlogits_plain(q, k, corr, pos, usr, valid, lse, g, temperature, clamp) @ k


def diag_ce_bwd_dk_plain(q, k, corr, pos, usr, valid, lse, g, temperature, clamp=math.inf):
    """What the dk kernel computes, in plain PyTorch."""
    return _dlogits_plain(q, k, corr, pos, usr, valid, lse, g, temperature, clamp).T @ q


class DiagCE(torch.autograd.Function):
    """Per-row diagonal cross entropy; kernels on CUDA, plain math on CPU."""

    @staticmethod
    def forward(ctx, q, k, corr, pos, usr, valid, temperature, clamp=math.inf):
        fwd = diag_ce_fwd_cuda if q.is_cuda else diag_ce_fwd_plain
        loss, lse = fwd(q, k, corr, pos, usr, valid, temperature, clamp)
        ctx.save_for_backward(q, k, corr, pos, usr, valid, lse)
        ctx.temperature, ctx.clamp = temperature, clamp
        return loss

    @staticmethod
    def backward(ctx, g):
        q, k, corr, pos, usr, valid, lse = ctx.saved_tensors
        g = g.float().contiguous()
        if q.is_cuda:
            bwd_dq, bwd_dk = diag_ce_bwd_dq_cuda, diag_ce_bwd_dk_cuda
        else:
            bwd_dq, bwd_dk = diag_ce_bwd_dq_plain, diag_ce_bwd_dk_plain
        args = (q, k, corr, pos, usr, valid, lse, g, ctx.temperature, ctx.clamp)
        return bwd_dq(*args), bwd_dk(*args), None, None, None, None, None, None


def fused_diag_ce(q, k, corr, pos_ids, user_ids, valid, temperature: float,
                  clamp: float = math.inf):
    """(B,) per-row loss; see the module docstring."""
    i32 = torch.int32
    return DiagCE.apply(q.float().contiguous(), k.float().contiguous(),
                        corr.float().contiguous(), pos_ids.to(i32).contiguous(),
                        user_ids.to(i32).contiguous(), valid.to(i32).contiguous(),
                        float(temperature), float(clamp))


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
