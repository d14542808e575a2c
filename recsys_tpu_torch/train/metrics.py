"""Metric logging + contrastive-health metrics.

Counterpart of ``recsys_tpu/train/metrics.py``: the same JSONL records
(``run``, ``kind``, ``step``, ``t`` and the metrics), and the SimCSE
alignment / uniformity metrics.
"""

from __future__ import annotations

import json
import os
import time

import torch


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
