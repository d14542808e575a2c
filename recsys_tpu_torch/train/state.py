"""Train-state plumbing: AdamW parameter groups, gradient clipping, the
freeze gate, the lr factor, the plateau scheduler, the warmup schedule and the
hybrid trainer's schedule.

Counterpart of ``recsys_tpu/train/state.py``. optax ``adamw`` and
``torch.optim.AdamW`` apply the same update (betas 0.9/0.999, eps 1e-8,
decoupled decay on every parameter of a group), and the ``LambdaLR`` factor
below equals ``warmup_linear_schedule``: the learning rate is 0 at the first
update, as in optax. ``GroupedAdamW`` is the optax chain the JAX trainers
build around those groups:

    clip_by_global_norm(grad_clip)            over every gradient, all groups
    -> multi_transform({group: [freeze gate] -> adamw(lr_group)})
    -> scale(lr factor)                        (``with_lr_factor``)

  * the clip is optax's arithmetic: when the global norm is at least
    ``grad_clip`` every gradient is scaled by ``grad_clip / norm``, with no
    epsilon (``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6``);
  * the freeze gate of a group multiplies its gradients by 0 during its first
    ``freeze_steps`` updates. The gradients are zeroed, not dropped: Adam's
    count still ticks (bias correction after the unfreeze is the JAX
    package's) and the decoupled decay still shrinks the weights;
  * the lr factor multiplies every group's whole update, decay included,
    which is the same as multiplying the group's learning rate. It sits in
    every param group, so it is saved with ``state_dict()`` and restored by
    ``load_state_dict()``, as the JAX factor is saved with the optimizer state.

The hybrid trainer's recipe is the chain ``clip_by_global_norm -> adamw(sched)
-> masked(scale(s))`` over the top-level modules in ``hybrid_slow_modules``:
the masked scale multiplies the whole AdamW update of those modules, decay
included, which is a group ``lr_factor`` of ``s``; ``hybrid_schedule`` is
``sched`` (optax's constant, linear-warmup or warmup-cosine schedule, counted
from 0).

A parameter that took no part in the loss has no gradient in PyTorch; optax
sees a zero gradient there and still decays the weight, so the optimizer
gives such a parameter a zero gradient before it steps.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable, Iterable

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


def hybrid_schedule(base_lr: float, warmup_steps: int, decay: str,
                    total_steps: int) -> Callable[[int], float]:
    """The hybrid trainer's learning rate at update ``step`` (0-based):
    constant ``base_lr``; or, with warmup steps or ``decay="cosine"``, optax's
    ``linear_schedule(0, base_lr, max(w, 1))`` or
    ``warmup_cosine_decay_schedule(0, base_lr, w, max(total_steps, w + 1))``
    with ``w = min(warmup_steps, max(total_steps - 1, 1))``."""
    if warmup_steps <= 0 and decay != "cosine":
        return lambda step: base_lr
    warmup = min(warmup_steps, max(total_steps - 1, 1))
    if decay != "cosine":
        span = max(warmup, 1)
        return lambda step: base_lr - base_lr * (1.0 - min(step, span) / span)
    decay_steps = max(total_steps, warmup + 1) - warmup

    def sched(step: int) -> float:
        if step < warmup:
            return base_lr - base_lr * (1.0 - step / warmup)
        count = min(step - warmup, decay_steps)
        return base_lr * 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))

    return sched


def freeze_gate_schedule(freeze_steps: int) -> Callable[[int], float]:
    """1.0 from update ``freeze_steps`` on (0-based), else 0.0: the gate a
    group's gradients are multiplied by before its AdamW."""
    def sched(step: int) -> float:
        return 1.0 if step >= freeze_steps else 0.0

    return sched


@torch.no_grad()
def clip_by_global_norm_(grads: Iterable[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax ``clip_by_global_norm`` in place: the global L2 norm over all
    ``grads``; when it is not below ``max_norm`` every gradient is scaled by
    ``max_norm / norm`` (no epsilon). The choice is made on the device, so
    the host does not wait for the step. Returns the norm before clipping."""
    grads = list(grads)
    norm = torch.nn.utils.get_total_norm(grads, 2.0)
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


class GroupedAdamW(torch.optim.AdamW):
    """AdamW over named parameter groups behind a global-norm clip, per-group
    freeze gates and an lr factor (see the module docstring)."""

    def __init__(self, groups: list[dict], weight_decay: float,
                 grad_clip: float | None = None):
        for g in groups:
            g.setdefault("freeze_steps", 0)
            g.setdefault("updates", 0)
            g.setdefault("lr_factor", 1.0)
        super().__init__(groups, betas=(0.9, 0.999), eps=1e-8,
                         weight_decay=weight_decay)
        self.grad_clip = grad_clip

    @torch.no_grad()
    def step(self, closure=None):
        params = [p for g in self.param_groups for p in g["params"]]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.grad_clip:
            clip_by_global_norm_([p.grad for p in params], self.grad_clip)
        lrs = []
        for g in self.param_groups:
            if freeze_gate_schedule(g["freeze_steps"])(g["updates"]) == 0.0:
                for p in g["params"]:
                    p.grad.zero_()
            g["updates"] += 1
            lrs.append(g["lr"])
            g["lr"] = g["lr"] * g["lr_factor"]
        try:
            return super().step(closure)
        finally:
            for g, lr in zip(self.param_groups, lrs):
                g["lr"] = lr


def grouped_adamw(model: nn.Module, label_fn: Callable[[str], str],
                  lrs: dict[str, float], weight_decay: float,
                  grad_clip: float | None = None,
                  freeze_steps: dict[str, int] | None = None,
                  lr_factors: dict[str, float] | None = None) -> GroupedAdamW:
    """One AdamW parameter group per label, in the order of ``lrs``; an
    optional global-norm clip over all of them, a freeze gate and an lr
    factor per label."""
    groups: dict[str, list] = {name: [] for name in lrs}
    for name, p in model.named_parameters():
        groups[label_fn(name)].append(p)
    freeze_steps, lr_factors = freeze_steps or {}, lr_factors or {}
    return GroupedAdamW(
        [{"params": ps, "lr": lrs[name], "name": name,
          "freeze_steps": freeze_steps.get(name, 0),
          "lr_factor": lr_factors.get(name, 1.0)}
         for name, ps in groups.items() if ps],
        weight_decay=weight_decay, grad_clip=grad_clip)


def set_lr_factor(optimizer: torch.optim.Optimizer, factor: float) -> None:
    """Set the update scale of a ``GroupedAdamW`` (``with_lr_factor``'s
    injected scale): it multiplies every group's whole update from the next
    step on."""
    for g in optimizer.param_groups:
        g["lr_factor"] = float(factor)


class PlateauScheduler:
    """Host-side metric watcher: multiplies the lr factor by ``factor`` after
    ``patience`` epochs without improvement."""

    def __init__(self, factor: float = 0.5, patience: int = 2, maximize: bool = True,
                 min_scale: float = 1e-3):
        self.factor, self.patience, self.maximize = factor, patience, maximize
        self.min_scale = min_scale
        self.best: float | None = None
        self.bad = 0
        self.scale = 1.0

    def update(self, metric: float) -> float:
        improved = self.best is None or (
            (metric > self.best) if self.maximize else (metric < self.best))
        if improved:
            self.best, self.bad = metric, 0
        else:
            self.bad += 1
            if self.bad >= self.patience:
                self.scale = max(self.scale * self.factor, self.min_scale)
                self.bad = 0
        return self.scale
