"""The approximate top-k (``jax.lax.approx_max_k``) and its two kernels.

Counterpart of ``jax.lax.approx_max_k(scores, k, recall_target)`` as the JAX
package calls it: on fp32 scores (``recsys_tpu/eval/recall.py:71``) and on
the int8 catalog's dequantized scores (``recsys_tpu/ops/quant.py:74``). It
is XLA's TPU primitive, not a Pallas kernel. On the TPU, XLA fuses a partial
reduce into the product that makes the scores: each of O bins keeps its
maximum, and only the O winners are sorted (on the CPU, XLA returns the
exact top-k). The port computes the TPU's answer on every device:

1. ``approx_bins(n, k, recall_target) -> (O, log2_reduction)``: XLA's bin
   count for a rank-2 operand, whose lanes are tiled by 128.
2. Column 0 (the PAD row) scores -inf, and the row is padded with -inf to
   O * 2^log2_reduction columns. Bin j holds the columns j, j + O, j + 2O,
   ...; it keeps its maximum and the lowest column that holds it
   (``bin_max_plain``).
3. The top-k of the O winners, largest first, equal values lowest column
   first (``select_topk``). Where O = n, this is the exact top-k.

The kernels (``csrc/approx_topk.cu``, sm_90a, built with ``nvcc`` into
``csrc/build/`` at first use and called through ``ctypes``) fuse step 2
into the product, and neither writes the (B, n) scores:
``approx_scan_f32`` from fp32 queries and items, with the prior (a
register-blocked FFMA tile); ``approx_scan_int8`` from int8 queries and
catalog on the tensor cores (``wgmma`` fed by TMA), binning the scores
dequantized with the rows' alpha. Where a catalog gives the card too few
blocks, a call splits the slices over parts that a second launch merges,
into a workspace the wrapper allocates; a call is counted once. Their plain forms
(``approx_scan_f32_plain``, ``approx_scan_int8_plain``) write the scores
out, then bin them. ``approx_topk_f32`` / ``approx_topk_int8`` run the
kernel on CUDA tensors and the plain form on CPU tensors; a CUDA tensor never
takes the plain form: the kernel launches or the call raises.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from recsys_tpu_torch.ops._build import KernelLibrary, count_launch, raise_on_error
from recsys_tpu_torch.ops.topk import topk_by_id

# launches per kernel; each wrapper adds one where it launches, nowhere else
LAUNCHES = {"approx_scan_f32": 0, "approx_scan_int8": 0}
LANES = 128   # the TPU's lane tiling of a rank-2 operand, which XLA's bin count follows
# the kernel's grid: 128 queries a block, at most 65,535 blocks of them
_MAX_QUERIES = 128 * 65535


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.approx_scan_f32, lib.approx_scan_int8):
        fn.restype = i32
        fn.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, ptr, ptr, ptr, ptr, ptr]
    lib.approx_scan_parts.restype = i32
    lib.approx_scan_parts.argtypes = [i32] * 6
    lib.approx_scan_blocks_per_sm.restype = i32
    lib.approx_scan_blocks_per_sm.argtypes = [i32, i32]


LIBRARY = KernelLibrary("approx_topk.cu", _bind)
BUILD_INFO = LIBRARY.info
load_library = LIBRARY.load


def approx_bins(n: int, k: int, recall_target: float = 0.95) -> tuple[int, int]:
    """XLA's ``ApproxTopKReductionOutputSize`` for a (B, n) operand: the bin
    count O and log2 of the slices a bin spans. With r the target as the
    float32 XLA takes: n <= 128 keeps every column; k = 1 takes one tile of
    128 bins; r >= 1 keeps every column; else m = min(max(int((1 - k) /
    ln r), 128), n), red = floor(log2(n // m)), and O = ceil(ceil(n / 128) /
    2^red) * 128 (every column where red = 0). Raises where JAX does: k < 1,
    k > n, r outside (0, 1]."""
    if k < 1:
        raise ValueError(f"k must be positive, got {k}")
    if k > n:
        raise ValueError(f"k must be at most the size of the reduced dimension {n}, got {k}")
    r = float(np.float32(recall_target))
    if not 0.0 < r <= 1.0:
        raise ValueError(f"recall_target should range in (0, 1], got {recall_target}")
    if n <= LANES:
        return n, 0
    if k == 1:
        return LANES, (-(-n // LANES) - 1).bit_length()
    if r >= 1.0:
        return n, 0
    m = min(max(int((1 - k) / math.log(r)), LANES), n)
    red = (n // m).bit_length() - 1
    if red == 0:
        return n, 0
    return -(-(-(-n // LANES)) // (1 << red)) * LANES, red


def bin_max_plain(scores: torch.Tensor, bins: int, log2_reduction: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, n) float32 scores, the PAD column already at -inf -> (vals, cols
    int32) (B, bins): each bin's maximum and the lowest column that holds
    it."""
    B, n = scores.shape
    width = bins << log2_reduction
    if width < n:
        raise ValueError(f"{bins} bins x 2^{log2_reduction} slices hold fewer than {n} columns")
    padded = scores.new_full((B, width), -math.inf)
    padded[:, :n] = scores
    # torch.max over a dimension returns the first maximal position: the lowest slice
    vals, t = padded.view(B, 1 << log2_reduction, bins).max(dim=1)
    cols = t * bins + torch.arange(bins, device=scores.device)
    return vals, cols.to(torch.int32)


def select_topk(vals: torch.Tensor, cols: torch.Tensor, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The top-k of the bins' winners: (vals, ids int64) (B, k), largest
    first, equal values lowest column first."""
    if k > vals.shape[-1]:
        raise ValueError(f"k = {k} is more than the {vals.shape[-1]} bins that the "
                         "recall target leaves")
    top, ids = topk_by_id(vals, cols, k)
    return top, ids.long()


# -- the plain forms of the kernels -------------------------------------------------

def approx_scan_f32_plain(u: torch.Tensor, items: torch.Tensor, prior: torch.Tensor | None,
                          bins: int, log2_reduction: int):
    """``approx_scan_f32`` written out: the (B, n) scores ``u @ items.T``
    (+ prior), PAD at -inf, then ``bin_max_plain``."""
    scores = u @ items.T
    if prior is not None:
        scores = scores + prior[None, :]
    scores[:, 0] = -math.inf
    return bin_max_plain(scores, bins, log2_reduction)


def approx_scan_int8_plain(uq: torch.Tensor, q: torch.Tensor, alpha: torch.Tensor, bins: int,
                           log2_reduction: int):
    """``approx_scan_int8`` written out: the exact int32 sums (a float64
    product, exact below 2^53), dequantized ``float(acc) * alpha`` (alpha
    (B,)), PAD at -inf, binned."""
    acc = (uq.double() @ q.double().T).to(torch.int32)
    scores = acc.float() * alpha[:, None]
    scores[:, 0] = -math.inf
    return bin_max_plain(scores, bins, log2_reduction)


# -- the kernels' wrappers ---------------------------------------------------------

def _checked_scan(name: str, queries: torch.Tensor, items: torch.Tensor, dtype: torch.dtype,
                  bins: int, log2_reduction: int) -> tuple[int, int, int]:
    """(B, n, D) of a scan the kernel takes; raises on any other."""
    if not (queries.is_cuda and items.is_cuda):
        raise RuntimeError(f"{name} takes CUDA tensors only")
    if queries.device != items.device:
        raise ValueError(f"{name}: queries on {queries.device}, items on {items.device}")
    for label, t in (("queries", queries), ("items", items)):
        if t.dtype != dtype or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be a contiguous 2-D {dtype} tensor, got "
                             f"{t.dtype} {tuple(t.shape)}")
    (B, D), (n, d) = queries.shape, items.shape
    if D != d or D < 1 or n < 1:
        raise ValueError(f"{name}: queries (B, {D}) against items ({n}, {d})")
    if bins < 1 or log2_reduction < 0 or (bins << log2_reduction) < n:
        raise ValueError(f"{name}: {bins} bins x 2^{log2_reduction} slices do not hold "
                         f"{n} columns")
    if (bins << log2_reduction) >= 2**31 or B > _MAX_QUERIES:
        raise ValueError(f"{name}: {B} queries x {bins << log2_reduction} columns is past "
                         "what the kernel indexes")
    return B, n, D


def _side(name: str, label: str, t: torch.Tensor | None, size: int, device) -> int | None:
    if t is None:
        return None
    if (t.device != device or t.dtype != torch.float32 or t.shape != (size,)
            or not t.is_contiguous()):
        raise ValueError(f"{name}: {label} must be a contiguous float32 ({size},) tensor on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    return t.data_ptr()


def _launch(name: str, int8_mode: int, device: torch.device, a: int, b: int, side: int | None,
            B: int, n: int, D: int, bins: int, slices: int, vals: torch.Tensor,
            cols: torch.Tensor) -> None:
    """One call of kernel ``name``: its parts (``approx_scan_parts``), the
    workspace of a split call, the launches; raises on an error code."""
    lib = load_library()
    with torch.cuda.device(device):
        parts = lib.approx_scan_parts(int8_mode, B, n, D, bins, slices)
        if parts < 1:
            raise_on_error(-parts, name)
        ws_val = ws_col = None
        if parts > 1:
            ws_val = torch.empty((parts, B, bins), dtype=torch.float32, device=device)
            ws_col = torch.empty((parts, B, bins), dtype=torch.int32, device=device)
        code = getattr(lib, name)(
            a, b, side, B, n, D, bins, slices, parts,
            None if ws_val is None else ws_val.data_ptr(),
            None if ws_col is None else ws_col.data_ptr(), vals.data_ptr(), cols.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    raise_on_error(code, name)


def blocks_per_sm(device: torch.device | str = "cuda", D: int = 128) -> dict:
    """Blocks of each scan that fit on one SM at width D (registers and
    shared memory; the CUDA occupancy calculator)."""
    lib = load_library()
    with torch.cuda.device(torch.device(device)):
        return {"approx_scan_f32": lib.approx_scan_blocks_per_sm(0, D),
                "approx_scan_int8": lib.approx_scan_blocks_per_sm(1, D)}


def approx_scan_f32_cuda(u: torch.Tensor, items: torch.Tensor, prior: torch.Tensor | None,
                         bins: int, log2_reduction: int):
    """The fp32 kernel: u (B, D), items (n, D), prior (n,) or None, all fp32
    on the card -> (vals fp32, cols int32) (B, bins), one count a call (a
    split call adds the merge's launch)."""
    B, n, D = _checked_scan("approx_scan_f32", u, items, torch.float32, bins, log2_reduction)
    p = _side("approx_scan_f32", "prior", prior, n, u.device)
    vals = torch.empty((B, bins), dtype=torch.float32, device=u.device)
    cols = torch.empty((B, bins), dtype=torch.int32, device=u.device)
    if B == 0:
        return vals, cols
    _launch("approx_scan_f32", 0, u.device, u.data_ptr(), items.data_ptr(), p, B, n, D, bins,
            1 << log2_reduction, vals, cols)
    count_launch(LAUNCHES, "approx_scan_f32")
    return vals, cols


def approx_scan_int8_cuda(uq: torch.Tensor, q: torch.Tensor, alpha: torch.Tensor, bins: int,
                          log2_reduction: int):
    """The int8 kernel: uq (B, D), q (n, D) int8 and alpha (B,) fp32 on the
    card -> (vals fp32, cols int32) (B, bins), the bins of the dequantized
    scores. One count a call, as ``approx_scan_f32_cuda``."""
    B, n, D = _checked_scan("approx_scan_int8", uq, q, torch.int8, bins, log2_reduction)
    if alpha is None:
        raise ValueError("approx_scan_int8: alpha is required")
    a = _side("approx_scan_int8", "alpha", alpha, B, uq.device)
    vals = torch.empty((B, bins), dtype=torch.float32, device=uq.device)
    cols = torch.empty((B, bins), dtype=torch.int32, device=uq.device)
    if B == 0:
        return vals, cols
    _launch("approx_scan_int8", 1, uq.device, uq.data_ptr(), q.data_ptr(), a, B, n, D, bins,
            1 << log2_reduction, vals, cols)
    count_launch(LAUNCHES, "approx_scan_int8")
    return vals, cols


# -- the two callers' paths ----------------------------------------------------------

def approx_topk_f32(u: torch.Tensor, items: torch.Tensor, prior: torch.Tensor | None, k: int,
                    recall_target: float = 0.95):
    """The approximate top-k of ``u @ items.T`` (+ prior) with the PAD row
    excluded: (vals, ids int64) (B, k). The kernel on CUDA tensors, the
    plain form on CPU ones."""
    bins, red = approx_bins(items.shape[0], k, recall_target)
    if items.is_cuda:
        prior = None if prior is None else prior.float().contiguous()
        scan = approx_scan_f32_cuda(u.float().contiguous(), items.float().contiguous(), prior,
                                    bins, red)
    else:
        scan = approx_scan_f32_plain(u.float(), items.float(),
                                     None if prior is None else prior.float(), bins, red)
    return select_topk(*scan, k)


def approx_topk_int8(uq: torch.Tensor, q: torch.Tensor, alpha: torch.Tensor, k: int,
                     recall_target: float = 0.95):
    """The approximate top-k of the int8 product dequantized by the rows'
    alpha (B,), PAD excluded: (vals, ids int64) (B, k). The kernel on CUDA
    tensors, the plain form on CPU ones."""
    bins, red = approx_bins(q.shape[0], k, recall_target)
    scan = approx_scan_int8_cuda if q.is_cuda else approx_scan_int8_plain
    return select_topk(*scan(uq.contiguous(), q, alpha.contiguous(), bins, red), k)
