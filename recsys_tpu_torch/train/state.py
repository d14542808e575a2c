"""Train-state plumbing: AdamW parameter groups, gradient clipping, the
freeze gate, the lr factor, the plateau scheduler, the warmup schedule and the
hybrid trainer's schedule.

Counterpart of ``recsys_tpu/train/state.py``. optax ``adamw`` and
``torch.optim.AdamW`` apply the same update (betas 0.9/0.999, eps 1e-8,
decoupled decay on every parameter of a group). ``GroupedAdamW`` is the optax
chain the JAX trainers build around those groups:

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
    which is the same as multiplying the group's learning rate.

The optimizer decides nothing on the host, as the JAX step is one compiled
program: a group's update count (``"updates"``) and its lr factor are
tensors on the group's device, the gate is computed there from the count,
AdamW takes the group's learning rate times its factor as a device tensor,
and ``set_lr_factor`` writes into the factor's tensor. On the card AdamW
runs fused (one multi-tensor kernel, its count on the device) and
``capturable``, so one CUDA graph of a step replays every update right
(``train/step_graph.py``). ``load_state_dict`` writes a checkpoint's count
and factor (host numbers or tensors) into the tensors in place.

A learning-rate schedule is ``DeviceLR``: each group's ``lr`` is a tensor
that its ``step()`` recomputes on the device from the group's count, so a
replayed step decides nothing on the host. SimCSE's linear warmup and decay
(``warmup_linear_factor``, optax's ``warmup_linear_schedule``: the learning
rate is 0 at the first update) is ``WarmupLinearLR``.

The hybrid trainer's recipe is the chain ``clip_by_global_norm -> adamw(sched)
-> masked(scale(s))`` over the top-level modules in ``hybrid_slow_modules``:
the masked scale multiplies the whole AdamW update of those modules, decay
included, which is a group ``lr_factor`` of ``s``; ``hybrid_schedule`` is
``sched`` (optax's constant, linear-warmup or warmup-cosine schedule, counted
from 0), computed on the device by a ``DeviceLR``.

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
    scheduler: torch.optim.lr_scheduler.LRScheduler | DeviceLR | None = None
    step: int = 0
    losses: list[float] = field(default_factory=list)         # per step
    step_seconds: list[float] = field(default_factory=list)   # see StepTimer
    graph_replays: int = 0                                    # steps run as a CUDA graph replay


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
    """Multiplier of the base lr: 0 -> 1 over the warmup, then 1 -> 0. Takes
    an int, or a count tensor (the factor is then a tensor on its device)."""
    warmup = max(int(total_steps * warmup_frac), 1)
    decay = max(total_steps - warmup, 1)

    def factor(step):
        if isinstance(step, torch.Tensor):
            step = step.float()
            return torch.where(step < warmup, step / warmup,
                               (1.0 - (step - warmup) / decay).clamp(min=0.0))
        if step < warmup:
            return step / warmup
        return max(1.0 - (step - warmup) / decay, 0.0)

    return factor


def hybrid_schedule(base_lr: float, warmup_steps: int, decay: str,
                    total_steps: int) -> Callable[[torch.Tensor], torch.Tensor]:
    """The hybrid trainer's learning rate at the update count ``step`` (a
    tensor, 0-based), as a float32 tensor on its device, in optax's order of
    operations: constant ``base_lr``; or, with warmup steps or
    ``decay="cosine"``, optax's ``linear_schedule(0, base_lr, max(w, 1))`` or
    ``warmup_cosine_decay_schedule(0, base_lr, w, max(total_steps, w + 1))``
    with ``w = min(warmup_steps, max(total_steps - 1, 1))``."""
    if warmup_steps <= 0 and decay != "cosine":
        return lambda step: torch.full_like(step, base_lr, dtype=torch.float32)
    warmup = min(warmup_steps, max(total_steps - 1, 1))
    if decay != "cosine":
        span = max(warmup, 1)
        return lambda step: base_lr - base_lr * (1.0 - step.float().clamp(0, span) / span)
    decay_steps = max(total_steps, warmup + 1) - warmup

    def sched(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = base_lr - base_lr * (1.0 - step / max(warmup, 1))
        count = (step - warmup).clamp(0, decay_steps)
        cos = base_lr * (0.5 * (1.0 + torch.cos(math.pi * count / decay_steps)))
        return torch.where(step < warmup, warm, cos)

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
    freeze gates and an lr factor, computed on the parameters' device (see
    the module docstring)."""

    def __init__(self, groups: list[dict], weight_decay: float,
                 grad_clip: float | None = None):
        for g in groups:
            g.setdefault("freeze_steps", 0)
            g.setdefault("updates", 0)
            g.setdefault("lr_factor", 1.0)
        on_card = groups[0]["params"][0].device.type == "cuda"
        super().__init__(groups, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay,
                         capturable=on_card, fused=on_card)
        self.grad_clip = grad_clip
        self._lrs = []       # each group's lr times its factor, the tensor AdamW reads
        for g in self.param_groups:
            device = g["params"][0].device
            g["updates"] = torch.tensor(float(g["updates"]), device=device)
            g["lr_factor"] = torch.tensor(float(g["lr_factor"]), device=device)
            self._lrs.append(torch.zeros((), device=device))

    @torch.no_grad()
    def step(self, closure=None):
        params = [p for g in self.param_groups for p in g["params"]]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.grad_clip:
            clip_by_global_norm_([p.grad for p in params], self.grad_clip)
        lrs = [g["lr"] for g in self.param_groups]
        for g, lr in zip(self.param_groups, self._lrs):
            if g["freeze_steps"] > 0:
                torch._foreach_mul_([p.grad for p in g["params"]],
                                    (g["updates"] >= g["freeze_steps"]).float())
            g["updates"].add_(1)
            torch.mul(g["lr_factor"], g["lr"], out=lr)
            g["lr"] = lr
        try:
            return super().step(closure)
        finally:
            for g, lr in zip(self.param_groups, lrs):
                g["lr"] = lr

    def load_state_dict(self, state_dict: dict) -> None:
        """The checkpoint's groups and moments, with this optimizer's
        device choices (fused, capturable; a checkpoint from the CPU has
        neither) and its count, factor and (under a ``DeviceLR``) lr
        tensors, which a captured step reads, filled in place (a ``LambdaLR``
        checkpoint's lr is a host float)."""
        device_keys = ("capturable", "fused", "foreach")
        mine = [{k: g[k] for k in ("updates", "lr_factor", *device_keys)}
                for g in self.param_groups]
        for g, m in zip(self.param_groups, mine):
            if isinstance(g["lr"], torch.Tensor):   # a DeviceLR's, which a captured step reads
                m["lr"] = g["lr"]
        super().load_state_dict({**state_dict, "param_groups": [
            {**g, **{k: m[k] for k in device_keys}}
            for g, m in zip(state_dict["param_groups"], mine)]})
        for g, m in zip(self.param_groups, mine):
            for key in ("updates", "lr_factor", "lr"):
                if key in m:
                    m[key].fill_(float(g[key]))
            g.update(m)


class DeviceLR:
    """A learning-rate schedule as a device program: every group's ``lr``
    becomes a tensor on its device, and ``step()``, called after each
    optimizer step as ``LambdaLR.step`` is, sets it to ``initial_lr *
    factor(updates)`` from the group's update count, on the device
    (``factor`` takes the count tensor). The schedule's position is the
    optimizer's count, so its own state is empty, and ``load_state_dict``
    takes any scheduler's state, ``LambdaLR``'s included: the optimizer's
    checkpoint holds the count."""

    def __init__(self, optimizer: GroupedAdamW, factor: Callable):
        self.optimizer, self.factor = optimizer, factor
        for g in optimizer.param_groups:
            g.setdefault("initial_lr", float(g["lr"]))
            g["lr"] = torch.zeros((), device=g["updates"].device)
        self.step()

    def step(self) -> None:
        for g in self.optimizer.param_groups:
            g["lr"].copy_(g["initial_lr"] * self.factor(g["updates"]))

    def state_dict(self) -> dict:
        return {}

    def load_state_dict(self, state_dict: dict) -> None:
        self.step()


class WarmupLinearLR(DeviceLR):
    """``warmup_linear_factor`` as a ``DeviceLR``."""

    def __init__(self, optimizer: GroupedAdamW, total_steps: int, warmup_frac: float = 0.1):
        super().__init__(optimizer, warmup_linear_factor(total_steps, warmup_frac))


def grouped_adamw(model: nn.Module, label_fn: Callable[[str], str],
                  lrs: dict[str, float], weight_decay: float,
                  grad_clip: float | None = None,
                  freeze_steps: dict[str, int] | None = None,
                  lr_factors: dict[str, float] | None = None) -> GroupedAdamW:
    """One AdamW parameter group per label, in the order of ``lrs``; an
    optional global-norm clip over all of them, a freeze gate and an lr
    factor per label. A parameter that takes no gradient (``requires_grad``
    off: the pretrained text table) is in no group, so neither an update nor
    weight decay reaches it (optax's ``set_to_zero`` group in the JAX
    package)."""
    groups: dict[str, list] = {name: [] for name in lrs}
    for name, p in model.named_parameters():
        if p.requires_grad:
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
    step on. Written into the factor's tensor, which a captured step reads."""
    for g in optimizer.param_groups:
        g["lr_factor"].fill_(float(factor))


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
