"""Fused FM second-order interaction (kernel K3) and its wrappers.

Counterpart of ``recsys_tpu/ops/pallas_fm.py``. ``fused_fm_interaction(v)``
maps field embeddings (B, F, K) to the (B,) second-order term

    out_b = 0.5 * sum_k ((sum_f v_bfk)^2 - sum_f v_bfk^2)

in fp32 and is differentiable: ``dv_bfk = g_b * (sum_f v_bfk - v_bfk)``, in
v's type. On CUDA tensors both directions are the hand-written kernels in
``csrc/fm.cu`` (sm_90a), built with ``nvcc`` into ``csrc/build/`` at first use
and called through ``ctypes``; neither stores the (B, K) sums. The input
picks one of two kernels of the source: 16-byte vector loads where K and the
alignment allow them, one warp a row for the rest; ``kernel_of`` says which a
call takes. The wrapper binds the C functions once and skips the device
switch when v's device is already current. On CPU tensors
the same autograd function runs ``ops/fm.fm_interaction`` and the backward
formula written out in ``fm_bwd_plain``. A CUDA tensor never takes the plain
path: the kernel launches or the call raises.
"""

from __future__ import annotations

import ctypes

import torch

from recsys_tpu_torch.ops._build import KernelLibrary, count_launch, raise_on_error
from recsys_tpu_torch.ops.fm import fm_interaction

# launches per kernel; each wrapper adds one where it launches, nowhere else
LAUNCHES = {"fm_fwd": 0, "fm_bwd": 0}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}  # as csrc/fm.cu


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fm_fwd.restype = i32
    lib.fm_fwd.argtypes = [ptr, ptr, i32, i32, i32, i32, ptr]
    lib.fm_bwd.restype = i32
    lib.fm_bwd.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, ptr]
    lib.fm_takes_vector.restype = i32
    lib.fm_takes_vector.argtypes = [ptr, ptr, i32, i32]


LIBRARY = KernelLibrary("fm.cu", _bind)
BUILD_INFO = LIBRARY.info
load_library = LIBRARY.load
_FNS: tuple = ()   # (fm_fwd, fm_bwd), bound once the library is loaded
# the current stream's handle without building a Stream object (CUDA builds of torch)
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _kernels() -> tuple:
    global _FNS
    if not _FNS:
        lib = load_library()
        _FNS = (lib.fm_fwd, lib.fm_bwd)
    return _FNS


def _launch(fn, v: torch.Tensor, *args) -> int:
    """``fn(*args, stream)`` on v's device and its current stream."""
    index = v.device.index
    if index == torch.cuda.current_device():
        stream = (_RAW_STREAM(index) if _RAW_STREAM is not None
                  else torch.cuda.current_stream(v.device).cuda_stream)
        return fn(*args, stream)
    with torch.cuda.device(index):
        return fn(*args, torch.cuda.current_stream(v.device).cuda_stream)


def _input_error(v: torch.Tensor) -> Exception:
    if not v.is_cuda:
        return RuntimeError("the FM kernel takes CUDA tensors only")
    if v.dtype not in _DTYPE_CODE:
        return ValueError(f"v: want float32, bfloat16 or float16, got {v.dtype}")
    if v.dim() == 3 and v.shape[0] >= 2**31 - 8:
        return ValueError("the kernel indexes rows in 32 bits")
    return ValueError("v: want a contiguous (B, F, K) tensor with F, K >= 1, got "
                      f"{tuple(v.shape)}")


def _checked(v: torch.Tensor) -> tuple[int, int, int, int]:
    """(B, F, K, dtype code) of a tensor the kernels take; raises on any other."""
    code = _DTYPE_CODE.get(v.dtype)
    if code is None or not v.is_cuda or v.dim() != 3 or not v.is_contiguous():
        raise _input_error(v)
    B, F, K = v.shape
    if F < 1 or K < 1 or B >= 2**31 - 8:
        raise _input_error(v)
    return B, F, K, code


def fm_fwd_cuda(v: torch.Tensor) -> torch.Tensor:
    """The forward kernel: (B, F, K) on the card -> (B,) fp32, deterministic."""
    B, F, K, code = _checked(v)
    out = torch.empty(B, dtype=torch.float32, device=v.device)
    if B == 0:
        return out
    raise_on_error(_launch(_kernels()[0], v, v.data_ptr(), out.data_ptr(), B, F, K, code),
                   "fm_fwd")
    count_launch(LAUNCHES, "fm_fwd")
    return out


def fm_bwd_cuda(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The backward kernel: v (B, F, K), g (B,) fp32 -> dv of v's shape and type."""
    B, F, K, code = _checked(v)
    if (g.device != v.device or g.dtype != torch.float32 or g.shape != (B,)
            or not g.is_contiguous()):
        raise ValueError(f"g: want a contiguous float32 ({B},) tensor on {v.device}, got "
                         f"{g.dtype} {tuple(g.shape)} on {g.device}")
    dv = torch.empty_like(v)
    if B == 0:
        return dv
    raise_on_error(_launch(_kernels()[1], v, v.data_ptr(), g.data_ptr(), dv.data_ptr(),
                           B, F, K, code), "fm_bwd")
    count_launch(LAUNCHES, "fm_bwd")
    return dv


def kernel_of(v: torch.Tensor, dv: torch.Tensor | None = None) -> str:
    """The kernel a forward call on ``v`` (a backward one writing ``dv``)
    takes, launching nothing: "vector" where K holds a power-of-two number of
    16-byte vectors, up to 32, and the bases are 16-byte aligned, else
    "direct"."""
    _, _, K, _ = _checked(v)
    takes = load_library().fm_takes_vector(v.data_ptr(), 0 if dv is None else dv.data_ptr(),
                                           K, v.element_size())
    return "vector" if takes else "direct"


def fm_bwd_plain(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The gradient written out in plain PyTorch: fp32 inside, v's type out."""
    x = v.float()
    return (g.float()[:, None, None] * (x.sum(dim=1, keepdim=True) - x)).to(v.dtype)


class FusedFM(torch.autograd.Function):
    """The FM term; kernels on CUDA, plain math on CPU. Only ``v`` is saved:
    the backward kernel recomputes the field sums."""

    @staticmethod
    def forward(ctx, v):
        ctx.save_for_backward(v)
        return fm_fwd_cuda(v) if v.is_cuda else fm_interaction(v)

    @staticmethod
    def backward(ctx, g):
        (v,) = ctx.saved_tensors
        g = g.float().contiguous()
        return fm_bwd_cuda(v, g) if v.is_cuda else fm_bwd_plain(v, g)


def fused_fm_interaction(v: torch.Tensor) -> torch.Tensor:
    """(B, F, K) -> (B,) fp32 FM second-order term, differentiable in ``v``;
    see the module docstring."""
    if v.dim() != 3:
        raise ValueError(f"v: want (B, F, K), got {tuple(v.shape)}")
    return FusedFM.apply(v.contiguous())
