"""Train-state plumbing: AdamW parameter groups and the warmup schedule.

Counterpart of ``recsys_tpu/train/state.py``. optax ``adamw`` and
``torch.optim.AdamW`` apply the same update (betas 0.9/0.999, eps 1e-8,
decoupled decay on every parameter of a group), and the ``LambdaLR`` factor
below equals ``warmup_linear_schedule``: the learning rate is 0 at the first
update, as in optax. The freeze gate, plateau scheduler and lr factor are
not ported yet.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

import torch
from torch import nn


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler | None = None
    step: int = 0
    losses: list[float] = field(default_factory=list)         # per step
    step_seconds: list[float] = field(default_factory=list)   # see StepTimer


class StepTimer:
    """Per-step times of a training loop: CUDA events on the card, read at the
    end so that no step waits for the host; the host clock on the CPU.
    ``mark()`` after every step, ``seconds()`` once the loop is done."""

    def __init__(self, device: torch.device):
        self.device, self.marks = device, []
        self.mark()

    def mark(self) -> None:
        if self.device.type == "cuda":
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self.marks.append(event)
        else:
            self.marks.append(time.perf_counter())

    def seconds(self) -> list[float]:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            return [a.elapsed_time(b) / 1e3 for a, b in zip(self.marks, self.marks[1:])]
        return [b - a for a, b in zip(self.marks, self.marks[1:])]


def warmup_linear_factor(total_steps: int, warmup_frac: float = 0.1
                         ) -> Callable[[int], float]:
    """Multiplier of the base lr: 0 -> 1 over the warmup, then 1 -> 0."""
    warmup = max(int(total_steps * warmup_frac), 1)
    decay = max(total_steps - warmup, 1)

    def factor(step: int) -> float:
        if step < warmup:
            return step / warmup
        return max(1.0 - (step - warmup) / decay, 0.0)

    return factor


def grouped_adamw(model: nn.Module, label_fn: Callable[[str], str],
                  lrs: dict[str, float], weight_decay: float
                  ) -> torch.optim.AdamW:
    """One AdamW parameter group per label, in the order of ``lrs``."""
    groups: dict[str, list] = {name: [] for name in lrs}
    for name, p in model.named_parameters():
        groups[label_fn(name)].append(p)
    return torch.optim.AdamW(
        [{"params": ps, "lr": lrs[name], "name": name}
         for name, ps in groups.items() if ps],
        betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
