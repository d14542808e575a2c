"""Metric logging, tracing + contrastive-health metrics.

Counterpart of ``recsys_tpu/train/metrics.py``: the same JSONL records
(``run``, ``kind``, ``step``, ``t`` and the metrics), a verbosity-leveled
print logger, an optional wandb sink, a ``torch.profiler`` trace context,
the SimCSE alignment / uniformity metrics, and the user tower's
interpretability metrics (feature-gate values, static-branch attribution)
under the JAX package's keys.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

from typing import Mapping

import numpy as np
import torch
from torch import nn

from recsys_tpu_torch.device import resolve_device


class MetricWriter:
    """Append-only JSONL metric log: one record per call."""

    def __init__(self, path: str, run: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self.run = run
        self._f = open(path, "a", buffering=1)

    def write(self, kind: str, step: int, **metrics) -> None:
        rec = {"run": self.run, "kind": kind, "step": int(step), "t": time.time()}
        for k, v in metrics.items():
            if isinstance(v, torch.Tensor) and v.ndim == 0:
                v = v.item()
            rec[k] = v
        self._f.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        self._f.close()


class SmartLogger:
    """Verbosity-leveled print logger: level 0 silent, 1 milestones, 2 chatty."""

    def __init__(self, level: int = 1):
        self.level = level

    def log(self, msg: str, level: int = 1) -> None:
        if level <= self.level:
            print(msg, flush=True)


def maybe_wandb_writer(project: str, run: str, config=None):
    """Optional wandb sink: a callable(step, **metrics) that logs to wandb
    when the package is importable, else a no-op (``MetricWriter``'s JSONL is
    the primary sink either way)."""
    try:
        import wandb  # noqa: PLC0415
    except ImportError:
        return lambda step, **metrics: None
    wandb.init(project=project, name=run, config=config or {})
    return lambda step, **metrics: wandb.log(metrics, step=step)


@contextlib.contextmanager
def profile_trace(out_dir: str, device: torch.device | str = "cuda"):
    """``torch.profiler`` trace of the block, written under ``out_dir`` as a
    Chrome trace (``*.pt.trace.json``, which TensorBoard's profiler plugin
    and Perfetto open). On a CUDA device it records the card's kernels as
    well as the host; ``device="cuda"`` without a card raises. Usage:
    ``with profile_trace("artifacts/trace"): ...``; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    device = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    tensorboard_trace_handler(out_dir)(prof)


def alignment(emb_a: torch.Tensor, emb_b: torch.Tensor) -> torch.Tensor:
    """Mean squared distance between positive pairs (lower is better).
    Inputs are L2-normalized (B, D)."""
    return ((emb_a - emb_b) ** 2).sum(-1).mean()


def uniformity(emb: torch.Tensor) -> torch.Tensor:
    """log E[exp(-2 ||x_i - x_j||^2)] over distinct pairs (more negative is
    better)."""
    sq = (emb ** 2).sum(-1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * emb @ emb.T
    n = emb.shape[0]
    mask = 1.0 - torch.eye(n, dtype=emb.dtype, device=emb.device)
    mean = (torch.exp(-2.0 * d2) * mask).sum() / (n * (n - 1))
    return torch.log(mean + 1e-12)


def gate_weights(model: nn.Module, path_filter: str = "gate") -> dict[str, float]:
    """Sigmoid feature-gate values: every 1-d parameter of at most 16 entries
    whose '/'-joined path holds ``path_filter``, as ``{"seq_gate[0]": ...}``."""
    out: dict[str, float] = {}
    for name, p in model.named_parameters():
        path = name.replace(".", "/")
        if path_filter in path and p.ndim == 1 and p.numel() <= 16:
            for i, v in enumerate(torch.sigmoid(p.detach().float()).tolist()):
                out[f"{path}[{i}]"] = float(v)
    return out


def meta_feature_importance(kernel, slices: Mapping[str, slice]) -> dict[str, float]:
    """First-layer |weight|-norm attribution over named input-row groups.
    ``kernel`` is laid out (in_dim, out_dim), as a Flax Dense kernel; pass a
    torch ``Linear.weight`` transposed. Returns shares summing to ~1."""
    w = np.abs(np.asarray(kernel, dtype=np.float32))
    means = {name: float(w[sl].mean()) for name, sl in slices.items()}
    total = sum(means.values()) + 1e-9
    return {k: v / total for k, v in means.items()}


def static_branch_importance(user_tower: nn.Module, tower_cfg) -> dict[str, float]:
    """Feature-group attribution for the SASRec static branch: the static
    MLP's first layer sliced by (bucket embs | categorical embs | continuous
    projection), in the tower's concat order."""
    kernel = user_tower.static_mlp.Dense_0.weight.detach().float().cpu().numpy().T
    c = tower_cfg
    slices: dict[str, slice] = {}
    off = 0
    for i in range(c.static_bucket_fields):
        slices[f"bucket{i}"] = slice(off, off + c.bucket_emb_dim)
        off += c.bucket_emb_dim
    for i in range(c.static_cat_fields):
        slices[f"cat{i}"] = slice(off, off + c.cat_emb_dim)
        off += c.cat_emb_dim
    slices["cont"] = slice(off, off + c.cont_proj_dim)
    return meta_feature_importance(kernel, slices)
