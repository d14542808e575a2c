"""Where a training step of the PyTorch port's neural rerankers spends its time.

    python3 scripts/torch_reranker_profile.py [--rows 96000] [--out DIR]
                                              [--mode eager|captured|both]

Needs one NVIDIA GPU. Makes a reranker problem from a seed at the full width
``chip_smoke.py`` phase 9 drives (19 sparse fields of the default world's
sizes + 10 dense features, K = 16, deep (128, 64), batch 2048) and runs
``train_deepfm`` and ``train_dcn`` themselves, twice each for each mode
(``both``, the default: eager, then captured, the step a CUDA graph replay
after the trainer's two warm-up steps):

  * two epochs unprofiled: the step time is the trainer's own CUDA-event
    median over the second epoch;
  * one epoch under ``torch.profiler``. Printed: device time per step by
    kernel name (largest first), the launches per step, and the share of the
    unprofiled step in which the device was busy (the rest is the card
    waiting for the host).

For DeepFM the scorer then takes 131,072 rows in one call under the profiler,
which gives kernel K3's device time at the scoring shape beside its time at
the training shape. Prints the card's name and power limit first. With
``--out`` the chrome traces go there.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
from collections import defaultdict

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (the card line and the full-width shapes)
from recsys_tpu_torch.config import load_config  # noqa: E402
from recsys_tpu_torch.ops import fm_kernel as FM  # noqa: E402
from recsys_tpu_torch.train.reranker import train_dcn, train_deepfm  # noqa: E402

FIELD_SIZES = (2001, 1001, 39, 11, 31, 23, 10, 8, 10, 10, 4, 3, 3, 5, 3, 3, 17, 4, 4)


def device_events(prof) -> dict:
    """Device time and count by kernel or copy name. An annotation that the
    profiler mirrors onto the device (``Optimizer.step#Adam.step``) spans
    kernels already counted; it carries the name of a host-side event, which
    no kernel or copy does, and is left out."""
    events = list(prof.events())
    host_names = {ev.name for ev in events
                  if ev.device_type != torch.autograd.DeviceType.CUDA}
    by_name: dict = defaultdict(lambda: [0.0, 0])
    for ev in events:
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.name not in host_names:
            by_name[ev.name][0] += ev.device_time_total / 1e3   # us -> ms
            by_name[ev.name][1] += 1
    return by_name


def report(label: str, by_name: dict, steps: int, unprofiled_ms: float | None) -> None:
    busy = sum(v[0] for v in by_name.values()) / steps
    out = {"what": label, "per": steps, "device_busy_ms": busy,
           "launches": sum(v[1] for v in by_name.values()) / steps}
    if unprofiled_ms is not None:
        out.update({"unprofiled_step_ms_median": unprofiled_ms,
                    "device_busy_share_of_unprofiled_step": busy / unprofiled_ms})
    print(json.dumps(out), flush=True)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    for name, (ms, n) in ranked[:14] + [kv for kv in ranked[14:] if "fm_" in kv[0]]:
        print(f"{ms / steps:9.4f} ms  {n / steps:7.1f} launches  {name[:100]}", flush=True)


def profile_run(label: str, mode: str, run, args):
    """Two epochs of ``run`` unprofiled, then one under the profiler; returns
    the scorer of the profiled run."""
    from torch.profiler import ProfilerActivity, profile

    capture = mode == "captured"
    state, _, _ = run(load_config(None, {"reranker": {"epochs": 2}}), capture)
    per_epoch = state.step // 2
    unprofiled = statistics.median(1e3 * t for t in state.step_seconds[per_epoch:])
    FM.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, _, scorer = run(load_config(None, {"reranker": {"epochs": 1}}), capture)
        torch.cuda.synchronize()
    print(json.dumps({"what": label, "mode": mode, "steps": state.step,
                      "graph_replays": state.graph_replays,
                      "k3_launches": dict(FM.LAUNCHES)}), flush=True)
    report(f"{label} ({mode}): one step", device_events(prof), state.step, unprofiled)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.out, f"{label}_{mode}_trace.json"))
    return scorer


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--rows", type=int, default=96000)
    parser.add_argument("--out", default=None)
    parser.add_argument("--mode", choices=("eager", "captured", "both"), default="both")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(chip_smoke.card_line(), flush=True)
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(0)
    n = args.rows
    ids = np.stack([rng.integers(0, s, n) for s in FIELD_SIZES], 1).astype(np.int32)
    dense = rng.normal(size=(n, 10)).astype(np.float32)
    y = (rng.random(n) < 1 / (1 + np.exp(-(dense[:, 0] + (ids[:, 2] % 3 == ids[:, 13] % 3))))
         ).astype(np.int32)
    if len(FIELD_SIZES) + 1 != chip_smoke.FM_FIELDS:
        sys.exit("not the full-width field count")
    runs = {"train_deepfm": lambda cfg, capture: train_deepfm(cfg, ids, dense, y, FIELD_SIZES,
                                                              capture=capture),
            "train_dcn": lambda cfg, capture: train_dcn(cfg, dense, y, capture=capture)}
    modes = ("eager", "captured") if args.mode == "both" else (args.mode,)
    for label, run in runs.items():
        for mode in modes:
            scorer = profile_run(label, mode, run, args)
        if label == "train_deepfm":
            pick = rng.integers(0, n, chip_smoke.FM_SCORE_B)
            scorer(ids[pick[:256]], dense[pick[:256]])
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                scorer(ids[pick], dense[pick])
                torch.cuda.synchronize()
            report(f"DeepFM scorer: one call of {len(pick)} rows", device_events(prof), 1, None)


if __name__ == "__main__":
    main()
