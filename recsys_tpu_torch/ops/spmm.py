"""Sparse propagation ``A_norm @ x`` (kernel K2) and its wrappers.

Counterpart of ``recsys_tpu/ops/pallas_spmm.py``. ``spmm(layout, x, precision)``
returns ``out[d] = sum_{e: dst[e] = d} w[e] * x[src[e]]`` in fp32 for the
symmetric normalized user-item adjacency, with zero rows for nodes without
edges, and never builds the (E, D) message array.

``precision`` names the JAX kernel's two modes. ``"f32"`` (the default here)
reads ``x`` in fp32. ``"bf16"``, the mode the trainer asks for as the JAX
trainer does, rounds ``x`` to bf16 first (one elementwise pass; the kernel
then gathers rows of half the bytes) and multiplies by the fp32 weight and
sums in fp32. The JAX kernel sums that mode in bf16, so the port is the more
exact of the two. The backward runs in the forward's mode.

``csr_graph`` is the one-time host layout (the counterpart of
``block_graph``): weight-0 padding edges are dropped, the kept edges are
sorted by destination into CSR, and rows longer than ``max_segment`` edges
are cut into segments so that no warp walks a hub row alone (see the note
in ``csrc/spmm.cu``); ``seg_order`` hands the kernel the hub rows' segments
first (longest first, largest hub first), then the other rows longest first.
It refuses a matrix that is not symmetric, because the backward is the same
product on the incoming gradient.

On CUDA tensors the forward and the backward are the hand-written kernel in
``csrc/spmm.cu`` (sm_90a), one launch a call, built with ``nvcc`` into
``csrc/build/`` at first use and called through ``ctypes``. A hub row is
finished inside that launch by the warp of its segments that arrives last, in
segment order; its arrivals are counted in an (H,) int32 workspace that the
layout keeps for each (device, stream) and that every launch leaves at zero,
so that calls on two streams never share counters and a CUDA graph can
capture and replay the call. On CPU tensors the same autograd function
runs ``spmm_plain``, the same sum (and, in ``"bf16"``, the same rounding of
``x``) written with ``index_select`` and ``index_add_``. A CUDA tensor never
takes the plain path: the kernel launches or the call raises.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import numpy as np
import torch

from recsys_tpu_torch.device import resolve_device
from recsys_tpu_torch.ops._build import KernelLibrary, count_launch, raise_on_error

# launches per kernel; each wrapper adds one where it launches, nowhere else
LAUNCHES = {"spmm_csr": 0}
MAX_SEGMENT = 256  # edges one warp walks; longer rows are cut (csrc/spmm.cu)
PRECISIONS = ("bf16", "f32")


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.spmm_supports_dim.restype = i32
    lib.spmm_supports_dim.argtypes = [i32]
    lib.spmm_csr.restype = i32
    lib.spmm_csr.argtypes = [ptr] * 6 + [i32] + [ptr] * 6 + [i32, i32, ptr]


LIBRARY = KernelLibrary("spmm.cu", _bind)
BUILD_INFO = LIBRARY.info
load_library = LIBRARY.load


# -- host layout --------------------------------------------------------------

@dataclass
class CsrGraph:
    """Device-resident CSR of the kept edges plus the warp segments.

    ``rowptr``/``row``/``col``/``val`` are the matrix (``row`` is each edge's
    destination, for the plain form). Segment ``s`` covers the edges
    ``seg_ptr[s]:seg_ptr[s + 1]``; ``seg_out[s] >= 0`` is the output row it
    owns alone, otherwise ``-(slot + 1)`` names its partial-sum slot. Hub
    row ``hub_row[h]`` is the sum of the slots ``hub_ptr[h]:hub_ptr[h + 1]``
    in that order, and ``slot_hub[slot]`` is the hub ``h`` a slot belongs to.
    ``seg_order`` is the order in which the kernel's warps take the segments:
    the hub rows' segments first, longest first, equal lengths by hub
    (segment count largest first, then row order) in segment order; then the
    other rows' segments longest first (ties in row order). ``hub_count``
    holds the kernel's arrival counters, one (H,) int32 tensor for each
    (device index, stream).
    """

    num_nodes: int
    rowptr: torch.Tensor    # (N + 1,) int32
    row: torch.Tensor       # (E,) int32
    col: torch.Tensor       # (E,) int32
    val: torch.Tensor       # (E,) float32
    seg_ptr: torch.Tensor   # (S + 1,) int32
    seg_out: torch.Tensor   # (S,) int32
    seg_order: torch.Tensor # (S,) int32
    hub_row: torch.Tensor   # (H,) int32
    hub_ptr: torch.Tensor   # (H + 1,) int32
    slot_hub: torch.Tensor  # (P,) int32
    hub_count: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def num_edges(self) -> int:
        return self.col.shape[0]

    @property
    def num_segments(self) -> int:
        return self.seg_out.shape[0]

    @property
    def num_hubs(self) -> int:
        return self.hub_row.shape[0]

    @property
    def num_partials(self) -> int:
        return self.num_segments - (self.num_nodes - self.num_hubs)

    @property
    def device(self) -> torch.device:
        return self.col.device


def _symmetric_order(src, dst, weight, num_nodes: int):
    """The edge order by (dst, src), and whether A^T == A: under symmetry
    the k-th edge by (dst, src) is the transpose of the k-th by (src, dst).
    Duplicate pairs of unequal weight tie in a stable sort, so a failed
    comparison is retried with the weight as a third key."""
    key_dst, key_src = dst * num_nodes + src, src * num_nodes + dst

    def orders(by_weight):
        for key in (key_dst, key_src):
            if by_weight is None:
                yield torch.sort(key, stable=True).indices
            else:  # stable sort of a weight-sorted list: (key, weight) order
                yield by_weight[torch.sort(key[by_weight], stable=True).indices]

    for by_weight in (None, torch.sort(weight, stable=True).indices):
        by_dst, by_src = orders(by_weight)
        if (torch.equal(key_dst[by_dst], key_src[by_src])
                and torch.equal(weight[by_dst], weight[by_src])):
            return by_dst, True
    return by_dst, False


def csr_graph(src, dst, weight, num_nodes: int, max_segment: int = MAX_SEGMENT,
              device: torch.device | str = "cuda") -> CsrGraph:
    """COO edge list (arrays or tensors) -> :class:`CsrGraph` on ``device``.
    Done once per graph; the sorts run on ``device``."""
    device = resolve_device(device)
    src, dst, weight = (a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a))
                        for a in (src, dst, weight))
    if not (src.shape == dst.shape == weight.shape and src.dim() == 1):
        raise ValueError("src, dst and weight must be 1-d arrays of one length")
    if max_segment < 1:
        raise ValueError(f"max_segment must be >= 1, got {max_segment}")
    src, dst = src.to(device, torch.int64), dst.to(device, torch.int64)
    weight = weight.to(device, torch.float32)
    keep = weight != 0
    src, dst, weight = src[keep], dst[keep], weight[keep]
    E = src.shape[0]
    if E and (int(torch.minimum(src.min(), dst.min())) < 0
              or int(torch.maximum(src.max(), dst.max())) >= num_nodes):
        raise ValueError(f"edge endpoint outside [0, {num_nodes})")
    if E >= 2**31 - 32 or num_nodes >= 2**31 - 1:
        raise ValueError("the kernel indexes edges and nodes in 32 bits")

    by_dst, symmetric = _symmetric_order(src, dst, weight, num_nodes)
    if not symmetric:
        raise ValueError("the adjacency is not symmetric: the backward of spmm "
                         "is the same product and needs A^T == A")
    row, col, val = dst[by_dst], src[by_dst], weight[by_dst]
    counts = torch.bincount(row, minlength=num_nodes)
    zero = torch.zeros(1, dtype=torch.int64, device=device)
    rowptr = torch.cat([zero, counts.cumsum(0)])

    # every row gets ceil(count / max_segment) segments, an empty row one
    segs_per_row = torch.clamp(-(-counts // max_segment), min=1)
    seg_row = torch.repeat_interleave(torch.arange(num_nodes, device=device), segs_per_row)
    first_seg = torch.cat([zero, segs_per_row.cumsum(0)])
    seg_in_row = torch.arange(seg_row.shape[0], device=device) - first_seg[seg_row]
    seg_start = rowptr[seg_row] + seg_in_row * max_segment
    seg_ptr = torch.cat([seg_start, torch.full_like(zero, E)])
    is_hub_seg = segs_per_row[seg_row] > 1
    seg_out = seg_row.clone()
    seg_out[is_hub_seg] = -(torch.arange(int(is_hub_seg.sum()), device=device) + 1)
    hub_row = torch.nonzero(segs_per_row > 1).flatten()
    hub_segs = segs_per_row[hub_row]
    hub_ptr = torch.cat([zero, hub_segs.cumsum(0)])
    slot_hub = torch.repeat_interleave(torch.arange(hub_row.shape[0], device=device), hub_segs)
    lengths = seg_ptr.diff()
    seg_order = torch.cat([_hub_segments_first(lengths, segs_per_row[seg_row], is_hub_seg),
                           _longest_first(lengths, ~is_hub_seg)])

    i32 = torch.int32
    return CsrGraph(num_nodes=int(num_nodes), rowptr=rowptr.to(i32), row=row.to(i32),
                    col=col.to(i32), val=val.contiguous(), seg_ptr=seg_ptr.to(i32),
                    seg_out=seg_out.to(i32), seg_order=seg_order.to(i32),
                    hub_row=hub_row.to(i32), hub_ptr=hub_ptr.to(i32),
                    slot_hub=slot_hub.to(i32))


def _hub_segments_first(lengths, row_segs, is_hub_seg):
    """The hub rows' segments, longest first; ties (the full-length ones) by
    hub, largest hub first, each hub's in segment order. So the walks that
    finish the hubs start early in the grid, and a block of 8 warps holds
    segments of one length, as in the rest of the order (a short warp beside
    long ones would leave its slot idle until the block retires)."""
    index = torch.nonzero(is_hub_seg).flatten()
    index = index[torch.sort(row_segs[index], descending=True, stable=True).indices]
    return index[torch.sort(lengths[index], descending=True, stable=True).indices]


def _longest_first(lengths, keep):
    """The segments where ``keep``, longest first, ties in segment (= row) order."""
    index = torch.nonzero(keep).flatten()
    return index[torch.sort(lengths[index], descending=True, stable=True).indices]


# -- the product ----------------------------------------------------------------

def _check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")


def _check_input(layout: CsrGraph, x: torch.Tensor) -> None:
    if x.device != layout.device:
        raise ValueError(f"x is on {x.device}, the graph layout on {layout.device}")
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x: want a contiguous float32 matrix, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if x.shape[0] != layout.num_nodes:
        raise ValueError(f"x has {x.shape[0]} rows, the graph {layout.num_nodes} nodes")


def hub_counters(layout: CsrGraph, stream: int) -> torch.Tensor:
    """The (H,) int32 arrival counters of launches on ``stream`` (a raw
    stream handle): made zero once, and left at zero by every launch."""
    key = (layout.device.index, stream)
    counters = layout.hub_count.get(key)
    if counters is None:
        counters = layout.hub_count[key] = torch.zeros(
            max(layout.num_hubs, 1), dtype=torch.int32, device=layout.device)
    return counters


def launch_csr(layout: CsrGraph, src: torch.Tensor, out: torch.Tensor,
               partial: torch.Tensor, stream: int) -> None:
    """One launch of the kernel on ``stream``: ``out = A @ src`` with ``src``
    the (N, D) fp32 or bf16 rows it gathers and ``partial`` the (P, D) fp32
    rows of the hub segments. Not counted in ``LAUNCHES``: ``spmm_cuda``
    counts its own. A failed launch drops the stream's counters, so that the
    next launch starts from zeros, and raises."""
    N, D = src.shape
    if not (src.dtype in (torch.float32, torch.bfloat16) and N == layout.num_nodes
            and out.shape == src.shape and partial.shape == (layout.num_partials, D)
            and out.dtype == partial.dtype == torch.float32
            and all(t.is_contiguous() and t.device == layout.device
                    for t in (src, out, partial))):
        raise ValueError("launch_csr: want contiguous src (N, D) fp32 or bf16, out (N, D) "
                         "and partial (P, D) fp32 on the layout's device")
    counters = hub_counters(layout, stream)
    code = load_library().spmm_csr(
        layout.seg_order.data_ptr(), layout.seg_ptr.data_ptr(), layout.seg_out.data_ptr(),
        layout.col.data_ptr(), layout.val.data_ptr(), src.data_ptr(),
        int(src.dtype == torch.bfloat16), out.data_ptr(), partial.data_ptr(),
        layout.slot_hub.data_ptr(), layout.hub_ptr.data_ptr(), layout.hub_row.data_ptr(),
        counters.data_ptr(), layout.num_segments, D, stream)
    if code != 0:
        layout.hub_count.pop((layout.device.index, stream), None)
    raise_on_error(code, "spmm_csr")


def spmm_cuda(layout: CsrGraph, x: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """The kernel: (N, D) fp32 on the card -> (N, D) fp32, deterministic, one
    launch. In ``"bf16"`` the kernel gathers from a bf16 copy of ``x`` made
    here first."""
    _check_precision(precision)
    if not x.is_cuda:
        raise RuntimeError("the spmm kernel takes CUDA tensors only")
    _check_input(layout, x)
    lib = load_library()
    D = x.shape[1]
    if not lib.spmm_supports_dim(D):
        raise ValueError(f"embedding width {D}: the spmm kernel takes 32, 64 or 128 "
                         "(gnn.propagation=segment_sum runs any width)")
    out = torch.empty_like(x)
    partial = torch.empty((layout.num_partials, D), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        src = x.to(torch.bfloat16) if precision == "bf16" else x
        launch_csr(layout, src, out, partial, stream)
        count_launch(LAUNCHES, "spmm_csr")
    return out


def hub_finish_plain(layout: CsrGraph, partial: torch.Tensor) -> torch.Tensor:
    """The hub rows from the kernel's partial rows: (P, D) fp32 -> (H, D) fp32,
    row h the sum of the slots ``hub_ptr[h]:hub_ptr[h + 1]`` in slot order,
    from 0, in float32, as the kernel's finishing warp adds them."""
    ptr = layout.hub_ptr.long()
    counts, by_size = torch.sort(ptr.diff(), descending=True)
    first = ptr[:-1][by_size]
    sizes = counts.cpu().numpy()
    acc = torch.zeros((layout.num_hubs, partial.shape[1]), dtype=torch.float32,
                      device=partial.device)
    for k in range(int(sizes[0]) if layout.num_hubs else 0):
        live = int(np.searchsorted(-sizes, -k, side="left"))   # hubs of more than k slots
        acc[:live] += partial[first[:live] + k].float()
    out = torch.empty_like(acc)
    out[by_size] = acc
    return out


def spmm_plain(layout: CsrGraph, x: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """The same sum in plain PyTorch (any float dtype, either device). In
    ``"bf16"`` the values of ``x`` are rounded to bf16 first; the weights and
    the sum stay in ``x``'s type, as in the kernel."""
    _check_precision(precision)
    if precision == "bf16":
        x = x.to(torch.bfloat16).to(x.dtype)
    msgs = x.index_select(0, layout.col) * layout.val.to(x.dtype)[:, None]
    out = torch.zeros((layout.num_nodes, x.shape[1]), dtype=x.dtype, device=x.device)
    return out.index_add_(0, layout.row, msgs)


class Spmm(torch.autograd.Function):
    """``A @ x``; kernels on CUDA, plain math on CPU. ``A`` is symmetric, so
    the backward is the same product, in the same mode, on the incoming
    gradient."""

    @staticmethod
    def forward(ctx, x, layout, precision):
        ctx.layout, ctx.precision = layout, precision
        return (spmm_cuda if x.is_cuda else spmm_plain)(layout, x, precision)

    @staticmethod
    def backward(ctx, g):
        g = g.float().contiguous()
        grad = (spmm_cuda if g.is_cuda else spmm_plain)(ctx.layout, g, ctx.precision)
        return grad, None, None


def spmm(layout: CsrGraph, x: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """(N, D) -> (N, D) fp32, differentiable in ``x``; ``precision`` is
    ``"f32"`` or ``"bf16"``. See the module docstring."""
    x = x.float().contiguous()
    _check_input(layout, x)
    return Spmm.apply(x, layout, precision)
