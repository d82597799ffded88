"""Learning-rate schedules, the optimizer factory and the plateau scaler.

Counterpart of ``rtdm_tpu/train/schedules.py``, with optax's chain
replaced by ``torch.optim`` and the steps around it that optax does:

- ``onecycle_schedule`` is torch's OneCycleLR as the JAX function writes
  it, ``cosine_schedule`` optax's ``cosine_decay_schedule``; both compute
  in fp32 as the JAX functions do. ``make_schedule`` picks one, or a
  constant for 'reduce' (the plateau scaler rescales it).
- ``make_optimizer`` returns an ``Optimizer``, which builds the torch
  optimizer for a model (``init``) and makes one update (``step``):
  'adam' is ``torch.optim.Adam`` (classic L2 added to the gradient),
  'adamw' ``AdamW`` (decoupled), 'sgd' ``SGD(momentum, nesterov=True)``
  with L2. Weight decay goes in a parameter group of the conv and dense
  kernels only (the parameters of two or more dimensions; BatchNorm's
  ``weight`` and every bias are left out, as the JAX mask keeps only
  leaves named ``kernel``).
- The JAX package's adamw decays no parameter at all: ``inject_hyperparams``
  takes its callable mask for a schedule, evaluates it on the step count,
  and the mask is False for every leaf. The port keeps the reference's
  function: its AdamW runs with weight decay 0 (held against optax in
  ``tests/test_torch_schedules.py``).
- The gradients are clipped by their global norm as optax does it: where
  the norm reaches ``max_norm`` each is ``(g / norm) * max_norm``, with no
  ``1e-6`` (torch's ``clip_grad_norm_`` adds one, which moves every
  clipped step).
- The learning rate of update k is written into every group before the
  update: ``schedule(k)`` for a schedule, the groups' own value for a
  constant (which ``aider_train._set_lr`` rescales), as optax's
  ``inject_hyperparams`` counts. ``current_lr`` reads it back.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch
from torch import nn

ScheduleT = Union[float, Callable[[int], float]]
_F = np.float32


def kernel_only_mask(model: nn.Module) -> Dict[str, bool]:
    """Weight-decay mask by parameter name: True only for conv and dense
    kernels (two or more dimensions); biases and BatchNorm's scale and
    shift are left out, whatever their name."""
    return {name: p.dim() >= 2 for name, p in model.named_parameters()}


def onecycle_schedule(peak_lr: float, total_steps: int,
                      pct_start: float = 0.1,
                      div_factor: float = 25.0,
                      final_div_factor: float = 1e4) -> Callable[[int], float]:
    """torch's OneCycleLR (cosine anneal) as the JAX package writes it:
    phase 1 ends at float(pct_start * total) - 1 (at least 1e-3), the
    floor is peak / (div * final_div), both phases anneal with
    end + (start - end) / 2 * (1 + cos(pi * pct)); in fp32."""
    total_steps = max(total_steps, 2)
    initial = peak_lr / div_factor
    min_lr = initial / final_div_factor
    phase1_end = max(float(pct_start * total_steps) - 1.0, 1e-3)
    phase2_end = float(total_steps - 1)
    span2 = max(phase2_end - phase1_end, 1e-9)

    def schedule(step: int) -> float:
        s = _F(min(float(step), phase2_end))
        if s <= _F(phase1_end):
            pct = np.clip(s / _F(phase1_end), _F(0), _F(1))
            start, end = peak_lr, (initial - peak_lr) / 2.0
        else:
            pct = np.clip((s - _F(phase1_end)) / _F(span2), _F(0), _F(1))
            start, end = min_lr, (peak_lr - min_lr) / 2.0
        return float(_F(start) + _F(end) * (_F(1) + np.cos(_F(math.pi)
                                                           * pct)))

    return schedule


def cosine_schedule(lr: float, total_steps: int, min_lr: float = 1e-6
                    ) -> Callable[[int], float]:
    """optax's ``cosine_decay_schedule(lr, max(total_steps, 1),
    alpha=min_lr / lr)``, in fp32."""
    decay_steps = float(max(total_steps, 1))
    alpha = min_lr / max(lr, 1e-12)

    def schedule(step: int) -> float:
        count = _F(min(float(step), decay_steps))
        decay = _F(0.5) * (_F(1) + np.cos(_F(math.pi) * count
                                          / _F(decay_steps)))
        return float(_F(lr) * (_F(1 - alpha) * decay + _F(alpha)))

    return schedule


def make_schedule(name: str, lr: float, total_steps: int,
                  warmup_ratio: float = 0.1,
                  min_lr: float = 1e-6) -> ScheduleT:
    name = name.lower()
    if name == "onecycle":
        return onecycle_schedule(lr, total_steps, pct_start=warmup_ratio)
    if name == "cosine":
        return cosine_schedule(lr, total_steps, min_lr)
    if name in ("reduce", "constant", "none"):
        # 'reduce' keeps a constant schedule; the plateau scaler rescales it
        return lr
    raise ValueError(f"unknown scheduler '{name}'")


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32 (optax's
    ``global_norm``)."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


class Optimizer:
    """What ``make_optimizer`` returns: builds the torch optimizer for a
    model and makes each update as the JAX package's optax chain does
    (clip, then the optimizer at the learning rate of the update's count)."""

    def __init__(self, name: str, learning_rate: ScheduleT,
                 weight_decay: float = 0.01, momentum: float = 0.9,
                 grad_clip: Optional[float] = 1.0,
                 decay_kernels_only: bool = True):
        self.name = name.lower()
        if self.name not in ("adam", "adamw", "sgd"):
            raise ValueError(f"unknown optimizer '{name}'")
        self.learning_rate = learning_rate
        # the reference's adamw decays nothing (module docstring)
        self.weight_decay = 0.0 if self.name == "adamw" else weight_decay
        self.momentum = momentum
        self.grad_clip = grad_clip if grad_clip and grad_clip > 0 else None
        self.decay_kernels_only = decay_kernels_only

    def lr_at(self, count: int, current: float) -> float:
        """The learning rate of update ``count``: the schedule's, or for a
        constant the groups' ``current`` one."""
        if callable(self.learning_rate):
            return self.learning_rate(count)
        return current

    def init(self, model: nn.Module) -> torch.optim.Optimizer:
        """The torch optimizer over ``model``'s parameters: group 0 the
        decayed ones (the conv and dense kernels, or all without
        ``decay_kernels_only``), group 1 the rest, at the rate of update 0."""
        mask = kernel_only_mask(model)
        decayed = {n: mask[n] or not self.decay_kernels_only for n in mask}
        decay = [p for n, p in model.named_parameters() if decayed[n]]
        rest = [p for n, p in model.named_parameters() if not decayed[n]]
        groups = [{"params": decay, "weight_decay": self.weight_decay},
                  {"params": rest, "weight_decay": 0.0}]
        lr = (self.learning_rate(0) if callable(self.learning_rate)
              else float(self.learning_rate))
        if self.name == "sgd":
            return torch.optim.SGD(groups, lr=lr, momentum=self.momentum,
                                   nesterov=True)
        cls = torch.optim.Adam if self.name == "adam" else torch.optim.AdamW
        return cls(groups, lr=lr, betas=(0.9, 0.999), eps=1e-8)

    def clip(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """Clip ``grads`` in place by their global norm as optax does;
        returns the norm before the clip (no host sync)."""
        norm = global_norm(grads)
        if self.grad_clip is not None:
            keep = norm < self.grad_clip
            for g in grads:
                g.copy_(torch.where(keep, g, (g / norm.to(g.dtype))
                                    * self.grad_clip))
        return norm

    def step(self, optimizer: torch.optim.Optimizer, count: int
             ) -> torch.Tensor:
        """One update from the gradients in ``.grad``: clip, write the
        learning rate of update ``count`` into every group, step. Returns
        the gradients' global norm before the clip."""
        grads = [p.grad for g in optimizer.param_groups for p in g["params"]
                 if p.grad is not None]
        norm = self.clip(grads)
        lr = self.lr_at(count, optimizer.param_groups[0]["lr"])
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.step()
        return norm


def make_optimizer(name: str,
                   learning_rate: ScheduleT,
                   weight_decay: float = 0.01,
                   momentum: float = 0.9,
                   grad_clip: Optional[float] = 1.0,
                   decay_kernels_only: bool = True) -> Optimizer:
    return Optimizer(name, learning_rate, weight_decay, momentum, grad_clip,
                     decay_kernels_only)


class PlateauScaler:
    """Host-side ReduceLROnPlateau: scales the learning rate on
    stagnation (factor 0.1, relative threshold, the floor min_lr as a scale
    of base_lr)."""

    def __init__(self, factor: float = 0.1, patience: int = 10,
                 min_lr: float = 1e-7, base_lr: float = 1.0,
                 threshold: float = 1e-4):
        self.factor = factor
        self.patience = patience
        self.min_scale = min_lr / max(base_lr, 1e-30)
        self.threshold = threshold
        self.best = float("inf")
        self.stale = 0
        self.scale = 1.0

    def update(self, metric: float) -> float:
        """Feed the epoch's val loss; returns the current lr scale."""
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.stale = 0
        else:
            self.stale += 1
            if self.stale > self.patience:
                self.scale = max(self.scale * self.factor, self.min_scale)
                self.stale = 0
        return self.scale
