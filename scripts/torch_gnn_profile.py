"""Where one LightGCL training step of the PyTorch port spends its time.

    python3 scripts/torch_gnn_profile.py [--steps 10] [--warmup 5] [--out DIR]
                                         [--mode eager|captured|both] [--hm-root DIR]

Needs one NVIDIA GPU. Builds the reference-scale graph of ``chip_smoke.py``
(200,000 users, 47,000 items, 11.3M interactions) from a seed and runs
``train_lightgcl`` itself at the default width (batch 8192, two layers, K2
propagation) for ``warmup + 2 * steps`` steps, host batch sampling included,
once for each mode (``both``, the default: eager, then captured, the step a
CUDA graph replay after the trainer's two warm-up steps):

  * the first ``--steps`` steps after the warm-up run unprofiled; their times
    are the trainer's own CUDA-event step times;
  * the next ``--steps`` steps run under ``torch.profiler``, switched on and
    off by the trainer's step hook. Printed: device time per step by kernel
    name (largest first), the launches per step, K1's (the SSL losses) and
    K2's (the propagation) device time a step and their shares of the busy
    time, and the share of those steps' wall time in which the device was
    busy (the rest is the card waiting for the host).

``--hm-root DIR`` takes instead the graph ``train-gnn`` builds from the world
in that data root (the H&M world of ``scripts/torch_quality_hm.py``), with its
training edges and its config.

Prints the card's name and power limit first. With ``--out`` the chrome
traces go there as ``gnn_step_trace_{mode}.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time
from collections import defaultdict

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (the graph recipe and the card line)
from recsys_tpu_torch.config import load_config  # noqa: E402
from recsys_tpu_torch.ops import contrastive_kernel as K  # noqa: E402
from recsys_tpu_torch.ops import spmm as S  # noqa: E402
from recsys_tpu_torch.train.gnn import train_lightgcl  # noqa: E402


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--warmup", type=int, default=5)
    parser.add_argument("--out", default=None)
    parser.add_argument("--mode", choices=("eager", "captured", "both"), default="both")
    parser.add_argument("--hm-root", dest="hm_root", default=None,
                        help="take the graph train-gnn builds from the world in this data root")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(chip_smoke.card_line(), flush=True)
    first, last = args.warmup + args.steps, args.warmup + 2 * args.steps
    if args.hm_root:
        cfg, graph, edges_u, edges_i = world_graph(args.hm_root, last)
    else:
        cfg = load_config(None, {"gnn": {"epochs": 1, "steps_per_epoch_max": last}})
        graph, edges_u, edges_i = chip_smoke.reference_scale_graph(seed=0)
    for mode in (("eager", "captured") if args.mode == "both" else (args.mode,)):
        profile_mode(mode, cfg, graph, edges_u, edges_i, args, first, last)


def world_graph(root: str, steps: int):
    """(cfg, graph, edges_u, edges_i) as ``train-gnn`` builds them from the
    world in data root ``root``, the config cut to one epoch of ``steps``."""
    import dataclasses

    from recsys_tpu_torch.data.etl import time_split
    from recsys_tpu_torch.pipeline import cli
    from recsys_tpu_torch.train.gnn import graph_from_transactions, transaction_indices

    t0 = time.perf_counter()
    cfg = cli.config_from_args(cli.parse_args(["train-gnn", "--set", f"data.root={root}"]))
    cfg = dataclasses.replace(cfg, gnn=dataclasses.replace(cfg.gnn, epochs=1,
                                                           steps_per_epoch_max=steps))
    items, _, tx = cli._load_world(cfg)
    train_tx, _, _ = time_split(tx, cfg.data.valid_days)
    user_map = {u: r for r, u in enumerate(sorted(train_tx["user_id"].unique()))}
    item_map = {i: r for r, i in enumerate(sorted(items["item_id"].astype(str)))}
    edges_u, edges_i = transaction_indices(train_tx, user_map, item_map)
    graph = graph_from_transactions(train_tx, user_map, item_map, cfg.gnn, cfg.data.seed)
    print(json.dumps({"graph": "hm", "root": root, **cli.graph_stats(graph),
                      "edges": int(len(edges_u)), "seconds": time.perf_counter() - t0}),
          flush=True)
    return cfg, graph, edges_u, edges_i


def profile_mode(mode: str, cfg, graph, edges_u, edges_i, args, first: int, last: int) -> None:
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    wall = {}

    def hook(step: int) -> None:
        if step == first:
            torch.cuda.synchronize()
            prof.start()
            wall["start"] = time.perf_counter()
        elif step == last:
            torch.cuda.synchronize()
            wall["stop"] = time.perf_counter()
            prof.stop()

    S.reset_launch_counts()
    K.reset_launch_counts()
    with tempfile.TemporaryDirectory() as workdir:
        state, _ = train_lightgcl(cfg, graph, edges_u, edges_i, workdir, step_hook=hook,
                                  capture=mode == "captured")
    step_ms = [1e3 * t for t in state.step_seconds]
    unprofiled = statistics.median(step_ms[args.warmup:first])
    print(json.dumps({"mode": mode, "steps": args.steps, "warmup": args.warmup,
                      "graph_replays": state.graph_replays,
                      "step_ms_median": unprofiled, "step_ms": step_ms[args.warmup:first],
                      "k2_launches_per_step": {k: v / last for k, v in S.LAUNCHES.items()},
                      "k1_launches_per_step": {k: v / last for k, v in K.LAUNCHES.items()}}),
          flush=True)

    by_name: dict = defaultdict(lambda: [0.0, 0])
    host_launches = 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_name[ev.name][0] += ev.device_time_total / 1e3   # us -> ms
            by_name[ev.name][1] += 1
        elif ev.name.startswith(chip_smoke.HOST_LAUNCH_CALLS):
            host_launches += 1
    busy = sum(v[0] for v in by_name.values()) / args.steps
    launches = sum(v[1] for v in by_name.values()) / args.steps
    profiled = 1e3 * (wall["stop"] - wall["start"]) / args.steps
    k1 = sum(v[0] for k, v in by_name.items() if "diag_ce" in k) / args.steps
    k2 = sum(v[0] for k, v in by_name.items() if "spmm_segments" in k) / args.steps
    print(json.dumps({"mode": mode, "device_busy_ms_per_step": busy,
                      "k1_device_ms_per_step": k1, "k1_share_of_busy": k1 / busy,
                      "k2_device_ms_per_step": k2, "k2_share_of_busy": k2 / busy,
                      "launches_per_step": launches,
                      "host_launch_calls_per_step": host_launches / args.steps,
                      "profiled_step_ms": profiled,
                      "profiled_step_ms_by_events": statistics.median(step_ms[first:last]),
                      "device_busy_share_of_profiled_step": busy / profiled,
                      "device_busy_share_of_unprofiled_step": busy / unprofiled}),
          flush=True)
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:25]:
        print(f"{ms / args.steps:9.3f} ms/step  {n / args.steps:7.1f} launches/step  "
              f"{name[:110]}", flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.out, f"gnn_step_trace_{mode}.json"))


if __name__ == "__main__":
    main()
