"""The hybrid trainer's step timed on the card for one or more trees of the
port, in turns.

    python3 scripts/torch_hybrid_step_turns.py [--steps 20] ROOT [ROOT ...]

Each ROOT is a directory holding a ``recsys_tpu_torch`` package: this
checkout, or a ``git archive`` of another commit unpacked somewhere. Each
ROOT runs in a process of its own, one after another in the order given
(parent, change, change, parent compares two trees on one card). A run
builds the hybrid step at ``chip_smoke.py`` phase 16's shape (default
widths, 768 users x 50 positions over a 47,000-item catalog, content 128 +
GNN 64, 4 layers, from a seed), takes two warm-up steps, times ``--steps``
steps with CUDA events and counts the kernels of three more under
``torch.profiler``. Needs one NVIDIA GPU. Prints the card's name and power
limit, then one JSON line a run: the tree, the median and every step's
milliseconds, the kernels a step.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

B, L, N, D, GNN_DIM = 768, 50, 47_000, 128, 64


def one_run(root: str, steps: int) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    from recsys_tpu_torch.config import Config
    from recsys_tpu_torch.train import hybrid as H
    from recsys_tpu_torch.train.sasrec import tensors_to
    from recsys_tpu_torch.train.state import TrainState

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    cfg = Config()
    utc = cfg.user_tower
    rng = np.random.default_rng(0)
    batch = tensors_to({
        "input_ids": rng.integers(1, N + 1, (B, L)), "target_ids": rng.integers(1, N + 1, (B, L)),
        "time_buckets": rng.integers(0, utc.num_time_buckets, (B, L)),
        "seq_mask": np.ones((B, L), np.int64),
        "user_buckets": rng.integers(0, 10, (B, utc.static_bucket_fields)),
        "user_cats": rng.integers(0, 2, (B, utc.static_cat_fields)),
        "user_cont": rng.normal(0, 1, (B, utc.static_cont_fields)).astype(np.float32)}, device)
    logq = rng.normal(-8.0, 1.0, N + 1).astype(np.float32)
    content = rng.normal(size=(N + 1, D)).astype(np.float32)
    content /= np.linalg.norm(content, axis=1, keepdims=True)
    content[0] = 0.0
    gnn_items = rng.normal(0, 0.1, (N + 1, GNN_DIM)).astype(np.float32)
    gnn_items[0] = 0.0
    model = H.build_hybrid_model(cfg, N + 1, D, GNN_DIM, device, seed=0)
    opt, sched = H.make_hybrid_optimizer(cfg.user_train, model, 1000)
    step, _uv, _im = H.make_hybrid_step(cfg, TrainState(model, opt, sched), content,
                                        gnn_items, logq)
    gnn_users = torch.as_tensor(rng.normal(0, 0.1, (B, GNN_DIM)).astype(np.float32),
                                device=device)
    gen = torch.Generator(device).manual_seed(0)
    for _ in range(2):
        step(batch, gnn_users, gen)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    events[0].record()
    losses = []
    for i in range(steps):
        losses.append(step(batch, gnn_users, gen)["loss"])
        events[i + 1].record()
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step(batch, gnn_users, gen)
        torch.cuda.synchronize()
    kernels = sum(1 for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    return {"root": root, "step_ms_median": float(np.median(ms)), "step_ms": ms,
            "kernels_per_step": kernels / 3, "loss_last": float(losses[-1])}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one_run(args.roots[0], args.steps)), flush=True)
        return
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    for root in args.roots:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        "--steps", str(args.steps), root], check=True)


if __name__ == "__main__":
    main()
