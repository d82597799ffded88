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


def clip_by_global_norm(grads: List[torch.Tensor],
                        max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` in place: where the global norm
    reaches ``max_norm`` each gradient becomes ``(g / norm) * max_norm``
    (no ``1e-6``); returns the norm before the clip (no host sync)."""
    norm = global_norm(grads)
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm))
    return norm


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
        if self.grad_clip is None:
            return global_norm(grads)
        return clip_by_global_norm(grads, self.grad_clip)

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


# ---------------------------------------------------------------------------
# YOLO training (cli/yolo_train.py): optax's schedules in fp32, and the two
# optimizer families of the JAX trainer


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Callable[[int], float]:
    """optax's ``cosine_decay_schedule(init_value, decay_steps, alpha)``,
    in fp32."""
    steps = _F(float(decay_steps))

    def schedule(step: int) -> float:
        count = min(_F(step), steps)
        decay = _F(0.5) * (_F(1) + np.cos(_F(math.pi) * count / steps))
        return float(_F(init_value) * (_F(1 - alpha) * decay + _F(alpha)))

    return schedule


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Callable[[int], float]:
    """optax's ``linear_schedule``, in fp32."""
    steps = _F(transition_steps)

    def schedule(step: int) -> float:
        frac = _F(1) - np.clip(_F(step), _F(0), steps) / steps
        return float(_F(init_value - end_value) * frac + _F(end_value))

    return schedule


def join_schedules(schedules, boundaries) -> Callable[[int], float]:
    """optax's ``join_schedules``: schedule i + 1 from boundary i on, fed
    the steps since that boundary."""
    def schedule(step: int) -> float:
        out = schedules[0](step)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if step >= boundary:
                out = sched(step - boundary)
        return out

    return schedule


def warmup(step: int, nw: int, y0: float, y1: float) -> float:
    """The v5 warm-up blend ``(1 - w) y0 + w y1``, ``w = clip(step / nw,
    0, 1)``, in fp32 (yolov5/train.py:281-290)."""
    w = np.clip(_F(step) / _F(nw), _F(0), _F(1))
    return float((_F(1) - w) * _F(y0) + w * _F(y1))


class YoloOptimizer:
    """One update of a detector's parameters as the JAX ``yolo_train``'s
    optax chain makes it: the gradients of every parameter clipped by
    their global norm (optax's clip, no ``1e-6``), then a torch optimizer
    over parameter groups, each group's learning rate (and SGD momentum)
    written in before update k from ``hyper(k)``; k counts this
    optimizer's own updates (``count``), as an optax state does.

    ``groups`` is a list of (names, weight_decay); ``hyper(k)`` returns one
    (lr, momentum or None) per group. Parameters in no group get no update
    (the prebias optimizer's frozen rest), but their gradients count in the
    norm."""

    def __init__(self, model: nn.Module, kind: str, groups, hyper,
                 momentum: float = 0.0, nesterov: bool = True,
                 max_norm: float = 10.0):
        self.model, self.kind, self.hyper = model, kind, hyper
        self.max_norm = max_norm
        self.count = 0
        named = dict(model.named_parameters())
        torch_groups = [{"params": [named[n] for n in names],
                         "weight_decay": wd} for names, wd in groups]
        lr0 = [h[0] for h in hyper(0)]
        for g, lr in zip(torch_groups, lr0):
            g["lr"] = lr
        if kind == "sgd":
            self.optimizer = torch.optim.SGD(
                torch_groups, lr=lr0[0], momentum=momentum,
                nesterov=nesterov)
        elif kind in ("adam", "adamw"):
            cls = torch.optim.Adam if kind == "adam" else torch.optim.AdamW
            self.optimizer = cls(torch_groups, lr=lr0[0], betas=(0.9, 0.999),
                                 eps=1e-8)
        else:
            raise ValueError(f"unknown optimizer '{kind}'")

    def clip(self) -> torch.Tensor:
        """Clip every parameter's gradient in place by their global norm;
        returns the norm before the clip (no host sync)."""
        return clip_by_global_norm([p.grad for p in self.model.parameters()
                                    if p.grad is not None], self.max_norm)

    def step(self) -> torch.Tensor:
        """The next update, from the gradients in ``.grad``; returns their
        global norm before the clip."""
        norm = self.clip()
        for group, (lr, mom) in zip(self.optimizer.param_groups,
                                    self.hyper(self.count)):
            group["lr"] = lr
            if mom is not None:
                group["momentum"] = mom
        self.optimizer.step()
        self.count += 1
        return norm

    def state_dict(self) -> Dict[str, object]:
        return {"optimizer": self.optimizer.state_dict(),
                "count": self.count}

    def load_state_dict(self, state) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        self.count = int(state["count"])


def make_yolo_optimizer(model: nn.Module, v5: bool, optimizer: str,
                        lr0: float, momentum: float, weight_decay: float,
                        total_steps: int, lrf: Optional[float] = None,
                        burn_in: int = 200, linear_lr: bool = False,
                        hyp: Optional[Dict[str, float]] = None,
                        steps_per_epoch: int = 1) -> YoloOptimizer:
    """The JAX ``yolo_train``'s optimizer (rtdm_tpu/cli/yolo_train.py:
    366-450) for ``model``:

    - darknet (v3): burn-in, ``linear(0 -> lr0)`` over ``burn_in`` steps,
      joined to a cosine to lr0 * 10^lrf (lrf -4 by default); 'sgd' is
      nesterov SGD with L2 decay of the kernels; 'adam' is optax's
      ``adamw`` with its kernel mask, so the kernels decay (decoupled).
    - v5: biases follow a warm-up lr that falls from ``warmup_bias_lr``
      to the base schedule (a cosine to lr0 * lrf, lrf 0.2 or the hyp's, or
      10^--lrf; or linear with ``linear_lr``), every other parameter one
      that rises from 0, over ``nw = max(round(warmup_epochs * steps), 1000)``
      steps capped at total // 2; SGD's momentum ramps from
      ``warmup_momentum``; the kernels decay by L2 in the gradient (also
      before 'adam').
    """
    hyp = hyp or {}
    mask = kernel_only_mask(model)
    names = [n for n, _ in model.named_parameters()]
    kernels = [n for n in names if mask[n]]
    if not v5:
        cosine = cosine_decay_schedule(
            lr0, max(total_steps - burn_in, 1),
            alpha=10.0 ** (lrf if lrf is not None else -4.0))
        schedule = join_schedules(
            [linear_schedule(0.0, lr0, max(burn_in, 1)), cosine],
            [max(burn_in, 1)])
        groups = [(kernels, weight_decay),
                  ([n for n in names if not mask[n]], 0.0)]
        kind = "sgd" if optimizer == "sgd" else "adamw"
        return YoloOptimizer(
            model, kind, groups,
            lambda k: [(schedule(k), None)] * 2, momentum=momentum)

    nw = int(max(round(hyp.get("warmup_epochs", 3.0) * steps_per_epoch),
                 1000))
    nw = max(min(nw, total_steps // 2), 1)
    v5_lrf = 10.0 ** lrf if lrf is not None else float(hyp.get("lrf", 0.2))
    if linear_lr:
        def base(step):
            x = np.clip(_F(step) / _F(total_steps), _F(0), _F(1))
            return float(_F(lr0) * ((_F(1) - x) * _F(1.0 - v5_lrf)
                                    + _F(v5_lrf)))
    else:
        base = cosine_decay_schedule(lr0, total_steps, alpha=v5_lrf)
    warm_bias = float(hyp.get("warmup_bias_lr", 0.1))
    warm_mom = float(hyp.get("warmup_momentum", 0.8))
    biases = [n for n in names if n.rsplit(".", 1)[-1] == "bias"]
    groups = [(kernels, weight_decay),
              ([n for n in names if not mask[n] and n not in biases], 0.0),
              (biases, 0.0)]
    sgd = optimizer == "sgd"

    def hyper(k):
        b = base(k)
        mom = warmup(k, nw, warm_mom, momentum) if sgd else None
        rest = (warmup(k, nw, 0.0, b), mom)
        return [rest, rest, (warmup(k, nw, warm_bias, b), mom)]

    return YoloOptimizer(model, "sgd" if sgd else "adam", groups, hyper,
                         momentum=momentum)


def make_prebias_optimizer(model: nn.Module, head_biases) -> YoloOptimizer:
    """The prebias optimizer: the clip over every gradient, then SGD(0.01,
    momentum 0.9, no nesterov) on the detection heads' biases only; every
    other parameter stays as it is."""
    return YoloOptimizer(model, "sgd", [(list(head_biases), 0.0)],
                         lambda k: [(0.01, None)], momentum=0.9,
                         nesterov=False)
