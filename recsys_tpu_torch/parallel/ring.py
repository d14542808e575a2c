"""Ring all-gather (kernel K4) and the ring form of the sharded top-k.

Counterpart of ``recsys_tpu/parallel/pallas_ring.py``. ``ring_all_gather``
takes the S shards ``(rows, cols)`` of one axis group and gives every rank the
tiled gather ``(S*rows, cols)``, moved only between ring neighbours: S-1 hops
one way, ceil((S-1)/2) both ways. It equals
``collectives.all_gather(shards, tiled=True)`` to the bit and, like the TPU
kernel, is forward only: nothing is differentiated through it.

On CUDA shards the moves are made by the hand-written kernel in
``csrc/ring.cu`` (sm_90a), built with ``nvcc`` into ``csrc/build/`` at first use
and called through ``ctypes``: one launch serves all S ranks, each with its own
buffers, a rank reaching its neighbour's output through a pointer as it would
reach a peer card's mapped memory. The ranks of a group must lie on one card
(virtual ranks); a group that spans several cards raises, since launching the
kernel once a card over peer-mapped memory is not written yet. On CPU shards
``ring_all_gather_plain`` runs the same hop schedule as a Python loop of
``copy_`` between neighbours. A CUDA shard never takes the plain path: the
kernel launches or the call raises.

The launch does not synchronise. A spin inside the kernel that runs out of its
budget writes an error word; ``check_errors()`` (after a synchronise) raises on
it. Like the TPU kernels this is a staged surface: ``eval/recall.topk_scores``
merges through ``collectives.sharded_topk``; ``ring_sharded_topk`` is the same
function on the ring.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from recsys_tpu_torch.ops._build import KernelLibrary, raise_on_error
from recsys_tpu_torch.ops.topk import stable_topk
from recsys_tpu_torch.parallel.collectives import local_index_offset

# launches per kernel; the wrapper adds one where it launches, nowhere else
LAUNCHES = {"ring_uni": 0, "ring_bidi": 0}
MAX_BLOCKS = 64           # blocks a rank and direction; the flags are sized for it
MIN_SLICE_BYTES = 4096    # a smaller chunk takes fewer blocks
SPIN_SECONDS = 2.0        # budget of one wait inside the kernel


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ring_all_gather.restype = i32
    lib.ring_all_gather.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i64, i32, i32, i32,
                                    ctypes.c_uint, i64, ptr]
    for fn in (lib.ring_max_resident_blocks, lib.ring_clock_khz):
        fn.restype, fn.argtypes = i32, [i32]
    lib.ring_max_ranks.restype, lib.ring_max_ranks.argtypes = i32, []


LIBRARY = KernelLibrary("ring.cu", _bind)
BUILD_INFO = LIBRARY.info
load_library = LIBRARY.load


def hop_schedule(S: int, bidirectional: bool = False) -> list[tuple[int, int, int, int]]:
    """The moves ``(hop, src_rank, dst_rank, chunk)`` of one gather, in hop
    order. Clockwise, rank r sends chunk (r - hop) mod S to r + 1; counter-
    clockwise (both ways only) chunk (r + hop) mod S to r - 1. With S <= 2 both
    ways is one way. Every rank's own chunk is a local copy and no move."""
    both = bidirectional and S > 2
    hops_cw, hops_ccw = (S // 2, (S - 1) // 2) if both else (S - 1, 0)
    moves = []
    for hop in range(hops_cw):
        for r in range(S):
            moves.append((hop, r, (r + 1) % S, (r - hop) % S))
            if hop < hops_ccw:
                moves.append((hop, r, (r - 1) % S, (r + hop) % S))
    return moves


def _check_shards(shards: Sequence[torch.Tensor]) -> None:
    first = shards[0]
    if first.dim() != 2:
        raise ValueError(f"ring_all_gather expects rank-2 shards, got {tuple(first.shape)}")
    for s in shards:
        if s.shape != first.shape or s.dtype != first.dtype:
            raise ValueError("ring_all_gather: shards differ in shape or type: "
                             f"{tuple(s.shape)} {s.dtype} vs {tuple(first.shape)} {first.dtype}")


def ring_all_gather_plain(shards: Sequence[torch.Tensor], bidirectional: bool = False,
                          record: list | None = None) -> list[torch.Tensor]:
    """The kernel's hop schedule as a loop of ``copy_`` between neighbours. A
    chunk is forwarded from the place where it arrived one hop earlier.
    ``record`` collects the moves ``(hop, src_rank, dst_rank, chunk)``."""
    S = len(shards)
    if S == 1:
        return [shards[0]]
    _check_shards(shards)
    rows, cols = shards[0].shape
    outs = [torch.empty((S * rows, cols), dtype=s.dtype, device=s.device) for s in shards]

    def place(r: int, chunk: int) -> torch.Tensor:
        return outs[r][chunk * rows:(chunk + 1) * rows]

    for r, s in enumerate(shards):
        place(r, r).copy_(s.detach())
    for hop, src, dst, chunk in hop_schedule(S, bidirectional):
        place(dst, chunk).copy_(shards[src].detach() if hop == 0 else place(src, chunk))
        if record is not None:
            record.append((hop, src, dst, chunk))
    return outs


class _Group:
    """What the kernel needs beyond the tensors, made once per (card, S,
    stream): the arrival flags of every rank, the error word, the epoch."""

    def __init__(self, device: torch.device, S: int):
        lib = load_library()
        if S > lib.ring_max_ranks():
            raise ValueError(f"ring_all_gather: at most {lib.ring_max_ranks()} ranks, got {S}")
        self.flags = torch.zeros((S, 2, S - 1, MAX_BLOCKS), dtype=torch.int32, device=device)
        self.err = torch.zeros(4, dtype=torch.int32, device=device)
        self.flag_ptrs = (ctypes.c_void_p * S)(*(self.flags[r].data_ptr() for r in range(S)))
        self.epoch = 0
        index = device.index if device.index is not None else torch.cuda.current_device()
        self.resident_blocks = lib.ring_max_resident_blocks(index)
        khz = lib.ring_clock_khz(index)
        if self.resident_blocks <= 0 or khz <= 0:
            raise RuntimeError(f"ring kernel: occupancy {self.resident_blocks}, clock {khz} kHz")
        self.clock_hz = khz * 1e3


_GROUPS: dict[tuple, _Group] = {}


def blocks_per_rank(chunk_bytes: int, S: int, directions: int, resident_blocks: int) -> int:
    """Blocks a rank and direction: enough to fill the card, no more than the
    chunk has slices for, and never more than fit on the card at once (a block
    spins on its neighbour's block, which must be running). Raises when not
    even one block a rank fits."""
    fit = resident_blocks // (S * directions)
    if fit < 1:
        raise RuntimeError(f"ring_all_gather: {S} ranks x {directions} directions need "
                           f"{S * directions} blocks resident at once; the card holds "
                           f"{resident_blocks}")
    return max(1, min(MAX_BLOCKS, fit, chunk_bytes // MIN_SLICE_BYTES))


def _launch(shards: Sequence[torch.Tensor], bidirectional: bool = False,
            first: int = 0, count: int | None = None,
            spin_seconds: float = SPIN_SECONDS) -> list[torch.Tensor]:
    """One launch of the kernel for the ranks ``first .. first + count - 1``
    of the S: all of them by default, as one card holds them all (a launch per
    card would serve its own). Ranks that no launch serves never send, so
    their neighbours' waits run out of ``spin_seconds`` and ``check_errors()``
    raises: that is how the tests reach the time-out."""
    S = len(shards)
    _check_shards(shards)
    device = shards[0].device
    if not all(s.is_cuda for s in shards):
        raise RuntimeError("the ring kernel takes CUDA tensors only")
    if any(s.device != device for s in shards):
        raise NotImplementedError(
            "ring_all_gather: the group spans more than one card "
            f"({sorted({str(s.device) for s in shards})}); launching the kernel once a "
            "card over peer-mapped memory is not written yet")
    if S < 2 or not all(s.is_contiguous() for s in shards):
        raise ValueError("ring_all_gather_cuda: want two or more contiguous shards")
    rows, cols = shards[0].shape
    outs = [torch.empty((S * rows, cols), dtype=s.dtype, device=device) for s in shards]
    chunk_bytes = rows * cols * shards[0].element_size()
    if chunk_bytes == 0:
        return outs
    both = bidirectional and S > 2
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        key = (device.index, S, stream)
        group = _GROUPS.get(key)
        if group is None:
            group = _GROUPS[key] = _Group(device, S)
        blocks = blocks_per_rank(chunk_bytes, S, 2 if both else 1, group.resident_blocks)
        if group.epoch == 2**31 - 1:     # the kernel compares epochs in 32 signed bits
            group.flags.zero_()
            group.epoch = 0
        group.epoch += 1
        out_ptrs = (ctypes.c_void_p * S)(*(o.data_ptr() for o in outs))
        local_ptrs = (ctypes.c_void_p * S)(*(s.data_ptr() for s in shards))
        code = load_library().ring_all_gather(
            out_ptrs, local_ptrs, group.flag_ptrs, group.err.data_ptr(), S, first,
            S if count is None else count, chunk_bytes, blocks, MAX_BLOCKS, int(both),
            group.epoch, int(spin_seconds * group.clock_hz), stream)
    raise_on_error(code, "ring_all_gather")
    LAUNCHES["ring_bidi" if both else "ring_uni"] += 1
    return outs


def ring_all_gather_cuda(shards: Sequence[torch.Tensor], bidirectional: bool = False
                         ) -> list[torch.Tensor]:
    """The kernel: S >= 2 contiguous CUDA shards on one card -> S outputs."""
    return _launch(shards, bidirectional)


def check_errors() -> None:
    """Raise if a wait inside any launch so far ran out of its budget. Reads
    the error words, so it waits for the card; call it after a synchronise."""
    for (index, S, _stream), group in _GROUPS.items():
        code, rank, hop, direction = group.err.tolist()
        if code:
            group.err.zero_()
            raise RuntimeError(
                f"ring_all_gather on cuda:{index}, S={S}: rank {rank} waited in vain for "
                f"hop {hop} ({'left' if direction else 'right'}ward) and gave up; "
                "the outputs of that call are not whole")


def ring_all_gather(shards: Sequence[torch.Tensor], bidirectional: bool = False
                    ) -> list[torch.Tensor]:
    """Tiled all-gather of the S shards ``(rows, cols)`` of one axis group ->
    ``(S*rows, cols)`` for every rank, moved as neighbour hops.
    ``bidirectional`` splits the traffic over both ring directions. S = 1
    returns the input. The outputs carry no gradient."""
    if len(shards) == 1:
        return [shards[0]]
    if all(s.device.type == "cpu" for s in shards):
        return ring_all_gather_plain(shards, bidirectional)
    return ring_all_gather_cuda([s.detach().contiguous() for s in shards], bidirectional)


def ring_sharded_topk(scores_shards: Sequence[torch.Tensor], k: int,
                      bidirectional: bool = False
                      ) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Distributed top-k over a column-sharded (B, N) score matrix with the
    candidate exchange on the ring. Same contract as
    ``collectives.sharded_topk``: ``(values, global indices)``, each (B, k),
    for every shard. Per-shard top-k first; then the candidate sets, values
    and int32 indices packed into one fp32 buffer by a bit cast so that one
    gather moves both, ride the ring and merge. Both top-ks are
    ``stable_topk``: equal scores come back lowest global index first, as
    ``jax.lax.top_k`` gives them (a shard's candidates are in that order, and
    the shards' blocks follow one another in the order of their indices)."""
    S = len(scores_shards)
    packed = []
    for i, scores in enumerate(scores_shards):
        n_local = scores.shape[-1]
        k_local = min(k, n_local)
        vals, idx = stable_topk(scores, k_local)
        idx = (idx + local_index_offset(i, n_local)).to(torch.int32)
        buf = torch.empty((vals.shape[0], 2 * k_local), dtype=torch.float32,
                          device=scores.device)
        buf[:, :k_local] = vals
        buf[:, k_local:] = idx.view(torch.float32)
        packed.append(buf)
    out = []
    for gathered in ring_all_gather(packed, bidirectional):        # (S*B, 2*k_local)
        B = gathered.shape[0] // S
        gathered = gathered.view(S, B, 2 * k_local)
        all_vals = gathered[..., :k_local].movedim(0, 1).reshape(B, -1)
        all_idx = gathered[..., k_local:].view(torch.int32).movedim(0, 1).reshape(B, -1)
        top_vals, pos = stable_topk(all_vals, min(k, all_vals.shape[-1]))
        out.append((top_vals, torch.gather(all_idx, -1, pos).long()))
    return out
