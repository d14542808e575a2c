"""Where one stage-2 training step of the PyTorch port spends its time.

    python3 scripts/torch_stage2_profile.py [--steps 10] [--warmup 3] [--out DIR]
        [--items 47000] [--mode eager|captured|both]

Needs one NVIDIA GPU. Builds the stage-2 trainer at ``bench.py``'s shape the
way ``chip_smoke.py`` phase 14 does (default widths, batches of 768 users x 50
positions over a 47,000-item catalog, from a seed; ``--items 105000`` is the
H&M catalog) and runs its step through ``train/step_graph.StepGraph``, eager
and captured as one CUDA graph (``--mode``), ``warmup + 2 * steps`` times
each:

  * the first ``--steps`` steps after the warm-up run unprofiled; their
    times are CUDA-event step times (``train/state.StepTimer``);
  * the next ``--steps`` steps run under ``torch.profiler``. Printed: the
    device time per step by kind of kernel (K1, matrix products, attention
    softmax, embedding and index backward, the optimizer, the rest) and by
    kernel name (largest first), the launches per step, and the share of the
    steps' wall time in which the device was busy (the rest is the card
    waiting for the host), and the host's launch calls per step (kernels one
    by one, or one graph).

Prints the card's name and power limit first. With ``--out`` the chrome
traces go there as ``stage2_step_trace_{mode}.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from collections import defaultdict

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (the reference step and the card line)
from recsys_tpu_torch.train.state import StepTimer  # noqa: E402

# kind of a kernel, by the first pattern its name holds
KINDS = (("K1 (diag_ce)", ("diag_ce",)),
         ("matrix products", ("gemm", "cutlass", "xmma", "sm90_", "cublas", "splitk")),
         ("softmax", ("softmax",)),
         ("embedding / index backward", ("embedding", "index_put", "indexing_backward",
                                         "scatter", "sort", "radix", "gather")),
         ("optimizer", ("multi_tensor_apply", "foreach", "adam")),
         ("layer norm", ("layer_norm", "layernorm")),
         ("reductions", ("reduce",)))


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, patterns in KINDS:
        if any(p in low for p in patterns):
            return kind
    return "elementwise and other"


def profile_mode(mode: str, args, device) -> None:
    from torch.profiler import ProfilerActivity, profile

    world = chip_smoke.reference_stage2_world(items=args.items)
    runner = chip_smoke.stage2_trainer(world, device, capture=mode == "captured")["runner"]
    n = chip_smoke.STAGE2_B * chip_smoke.STAGE2_BATCHES
    batches = iter(chip_smoke.batch_indices(n, chip_smoke.STAGE2_B,
                                            args.warmup + 2 * args.steps, seed=3))
    for _ in range(args.warmup):
        runner(next(batches))
    timer = StepTimer(device)
    for _ in range(args.steps):
        runner(next(batches))
        timer.mark()
    step_ms = [1e3 * t for t in timer.seconds()]
    unprofiled = statistics.median(step_ms)
    print(json.dumps({"mode": mode, "items": args.items, "steps": args.steps,
                      "warmup": args.warmup, "step_ms_median": unprofiled,
                      "step_ms": step_ms}), flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            runner(next(batches))
        torch.cuda.synchronize()
        profiled = 1e3 * (time.perf_counter() - t0) / args.steps

    by_name: dict = defaultdict(lambda: [0.0, 0])
    host_launches = 0
    for ev in prof.events():
        if getattr(ev, "is_user_annotation", False):
            continue      # a span on the device's timeline (Optimizer.step), not a kernel
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_name[ev.name][0] += ev.device_time_total / 1e3   # us -> ms
            by_name[ev.name][1] += 1
        elif ev.name.startswith(chip_smoke.HOST_LAUNCH_CALLS):
            host_launches += 1
    busy = sum(v[0] for v in by_name.values()) / args.steps
    launches = sum(v[1] for v in by_name.values()) / args.steps
    by_kind: dict = defaultdict(lambda: [0.0, 0])
    for name, (ms, n) in by_name.items():
        by_kind[kind_of(name)][0] += ms / args.steps
        by_kind[kind_of(name)][1] += n / args.steps
    print(json.dumps({"mode": mode, "items": args.items,
                      "device_busy_ms_per_step": busy, "launches_per_step": launches,
                      "host_launch_calls_per_step": host_launches / args.steps,
                      "profiled_step_ms": profiled,
                      "device_busy_share_of_profiled_step": busy / profiled,
                      "device_busy_share_of_unprofiled_step": busy / unprofiled,
                      "by_kind_ms_per_step": {k: round(v[0], 4) for k, v in sorted(
                          by_kind.items(), key=lambda kv: -kv[1][0])},
                      "by_kind_launches_per_step": {k: v[1] for k, v in by_kind.items()}}),
          flush=True)
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:30]:
        print(f"{mode:8s} {ms / args.steps:9.3f} ms/step  {n / args.steps:7.1f} launches/step  "
              f"{name[:100]}", flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.out, f"stage2_step_trace_{mode}.json"))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--warmup", type=int, default=3)
    parser.add_argument("--items", type=int, default=chip_smoke.STAGE2_ITEMS)
    parser.add_argument("--mode", choices=("eager", "captured", "both"), default="both")
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(chip_smoke.card_line(), flush=True)
    device = torch.device("cuda")
    for mode in (("eager", "captured") if args.mode == "both" else (args.mode,)):
        profile_mode(mode, args, device)


if __name__ == "__main__":
    main()
