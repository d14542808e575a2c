"""K2's segment kernel with parts of its hub finish taken out, to see what the
finish costs inside the launch and where.

    python3 scripts/torch_k2_ablation.py

Needs one NVIDIA GPU and nvcc. Writes variants of
``recsys_tpu_torch/csrc/spmm.cu`` into its build directory (gitignored):
``nofinish`` stores the partial rows and stops (no fence, no count, no walk),
``nowalk`` counts but does not add the partial rows up; ``fences`` orders the
arrival by a relaxed ``atomicAdd`` between two ``fence.acq_rel``, ``scfence``
between two ``__threadfence()`` (fence.sc), instead of the kernel's one
``atom.acq_rel``. ``nofinish`` and
``nowalk`` leave the hub rows wrong: they are timed, not checked. ``full``
(the source as it is) also runs with the segments in two other orders:
``longest_first`` (one longest-first order over all segments, hub or not)
and ``hubs_together`` (every hub's segments together, remainder included,
hubs by segment count largest first, then the rest longest first). Each
version runs in a process of its own, in turns (full, nofinish, nowalk,
fences, scfence, longest_first, hubs_together, full), and prints one JSON
line: the kernel's device time (``torch.profiler``) in both modes at the
reference-scale graph of ``chip_smoke.py`` (22.6M edges, D = 64) and, where
the values are meant to be right, whether the hub rows equal
``hub_finish_plain`` bit for bit. The first line names the card and its
power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "recsys_tpu_torch", "csrc", "spmm.cu")
OUT_DIR = os.path.join(ROOT, "recsys_tpu_torch", "csrc", "build", "ablation")

STORED = ("  target = __shfl_sync(kFull, target, 0);\n"
          "  if (target >= 0) return;  // the whole warp: target is the segment's\n")
WALK = "  hub_finish<D>(partial + (int64_t)first * D, nseg, out + (int64_t)hub_row[h] * D, lane);\n"
ARRIVAL = "    last = arrive(hub_count + h) == nseg - 1;\n"
FENCED = """    FENCE;
    last = atomicAdd(hub_count + h, 1) == nseg - 1;
    if (last) FENCE;
"""
ORDERS = ("longest_first", "hubs_together")
CHECKED = ("full", "fences", "scfence") + ORDERS


def variants() -> dict[str, str]:
    src = open(SOURCE).read()
    if STORED not in src or WALK not in src or ARRIVAL not in src:
        sys.exit("torch_k2_ablation: the kernel's source no longer has the cut points")
    return {"full": src, **{name: src for name in ORDERS},
            "nofinish": src.replace(STORED, "  return;\n"),
            "nowalk": src.replace(WALK, ""),
            "fences": src.replace(ARRIVAL, FENCED.replace(
                "FENCE", 'asm volatile("fence.acq_rel.gpu;" ::: "memory")')),
            "scfence": src.replace(ARRIVAL, FENCED.replace("FENCE", "__threadfence()"))}


def other_order(layout, name: str):
    """``seg_order`` of the order ``name`` (see the module docstring)."""
    import numpy as np
    import torch

    lengths = layout.seg_ptr.diff().cpu().numpy()
    if name == "longest_first":
        order = np.argsort(-lengths, kind="stable")
    else:
        seg_out = layout.seg_out.cpu().numpy()
        hub_segs, rest = np.flatnonzero(seg_out < 0), np.flatnonzero(seg_out >= 0)
        hub = layout.slot_hub.cpu().numpy()[-(seg_out[hub_segs] + 1)]
        size = np.diff(layout.hub_ptr.cpu().numpy())[hub]
        order = np.concatenate([hub_segs[np.lexsort((hub_segs, hub, -size))],
                                rest[np.argsort(-lengths[rest], kind="stable")]])
    return torch.as_tensor(order.astype(np.int32), device=layout.device)


def time_one(name: str) -> None:
    import torch

    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from pathlib import Path

    from recsys_tpu_torch.ops import spmm as S
    from torch_kernel_bench import device_ms, reference_graph

    if not torch.cuda.is_available():
        sys.exit("torch_k2_ablation: needs a CUDA device")
    S.LIBRARY.source = Path(OUT_DIR, f"spmm_{name}.cu")
    src, dst, w, n = reference_graph()
    layout = S.csr_graph(src, dst, w, n, device="cuda")
    if name in ORDERS:
        layout.seg_order = other_order(layout, name)
    x = torch.randn(n, 64, device="cuda", generator=torch.Generator("cuda").manual_seed(1))
    out = torch.empty_like(x)
    partial = torch.empty((layout.num_partials, 64), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    row = {"variant": name}
    for mode in S.PRECISIONS:
        src_x = x.bfloat16() if mode == "bf16" else x
        launch = lambda: S.launch_csr(layout, src_x, out, partial, stream)  # noqa: E731
        row[f"{mode}_device_ms"] = device_ms(launch, 50, "spmm_segments_kernel")
        if name in CHECKED:
            launch()
            torch.cuda.synchronize()
            row[f"{mode}_hub_rows_bit_equal"] = torch.equal(
                out[layout.hub_row.long()], S.hub_finish_plain(layout, partial))
    print(json.dumps(row), flush=True)


def main() -> None:
    if len(sys.argv) == 2:
        time_one(sys.argv[1])
        return
    os.makedirs(OUT_DIR, exist_ok=True)
    for name, text in variants().items():
        with open(os.path.join(OUT_DIR, f"spmm_{name}.cu"), "w") as f:
            f.write(text)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(json.dumps({"card": smi.stdout.strip()}), flush=True)
    for name in ("full", "nofinish", "nowalk", "fences", "scfence", *ORDERS, "full"):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), name])
        if proc.returncode != 0:
            sys.exit(proc.returncode)


if __name__ == "__main__":
    main()
