"""Classifier trainer: the train step, the eval step and a thin holder.

Counterpart of ``rtdm_tpu/train/trainer.py``:

- ``TrainState`` holds the model (the fp32 masters), the torch optimizer,
  the count of updates made (``step``) and ``version``, which grows
  whenever the weights change (an update, a restore).
- ``make_train_step`` gives ``step(state, images, labels, seed)``: the batch
  is split into ``grad_accum_steps`` contiguous microbatches (JAX's
  ``reshape((a, -1))``), each runs forward and backward in training mode
  (batch-statistic BatchNorm, the running statistics chaining from
  microbatch to microbatch; dropout from a generator), with the
  parameters cast to the policy's compute dtype inside the forward
  (``core/precision.py::Policy``), optionally mixed (mixup or cutmix, a
  fair coin between them when both are on; the loss is
  lam * L(y) + (1 - lam) * L(y[perm])); the gradients and the loss are
  averaged over the microbatches, then one clip and one update
  (``train/schedules.py::Optimizer``). Metrics: ``loss``, ``accuracy`` and
  ``grad_norm`` (the global norm before the clip), as device tensors.
  The draws of update k's microbatch i come from ``[seed, k, i]``, as the
  JAX step folds the step into its key: a resumed run draws as the
  uninterrupted one would.
- ``make_eval_step`` gives ``step(state, images, labels, valid)``: the model
  at inference in the policy's compute dtype (a copy of the current
  weights with the parameters cast, BatchNorm statistics in fp32, as the
  JAX eval casts params), so each ACFF block launches the fp32 or bf16
  kernel; rows from ``valid`` on are padding and count for nothing. It
  returns ``correct``, ``count``, the confusion counts (a bincount) and,
  with a loss, ``loss_sum`` from ``reduction='none'``.
- An fp32 policy runs its steps with TF32 off, a bf16 one with it on
  (``core/precision.py::tf32``): cuDNN's default would make fp32 training
  TF32 training.

With a ``mesh`` (``core/mesh.py``) both steps are data-parallel with the
numerics of JAX's GSPMD step: the one-process step on the global batch, up
to the order of the sums. Every rank is handed the global batch. Each
microbatch is mixed whole (the partner rows may be another rank's), then
each rank takes its rows; the dropout masks are the rows' slices of the
global mask and BatchNorm takes the global batch's statistics
(``models/layers.py::set_mesh``; ``sync_bn=False`` normalizes each rank's
rows by their own, the DDP form, and keeps rank 0's running statistics on
every rank, as DDP's ``broadcast_buffers`` does); each rank's loss is its
rows' sum over the global batch's denominator, so the gradients summed
over the ranks (one all-reduce after the microbatches) are the global
mean's, which the optimizer then clips by their global norm. The eval
step runs each rank's rows through the kernels and sums the counts over
the ranks. Parameters and optimizer state stay replicated: every rank
applies the same update. Without a mesh both steps run the same code on
one rank that holds every row, with no collective.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from rtdm_tpu_torch.core.mesh import Mesh, RowShard, data_sharding
from rtdm_tpu_torch.core.precision import DEFAULT_POLICY, Policy, tf32
from rtdm_tpu_torch.models.acff import clear_packed_arguments
from rtdm_tpu_torch.models.layers import set_dropout_generator, set_mesh
from rtdm_tpu_torch.parallel.comms import (all_reduce_grads,
                                           broadcast_buffers, psum_along)
from rtdm_tpu_torch.train.batch_augment import (cutmix_apply, draw_cutmix,
                                                draw_mixup, mixup_apply)
from rtdm_tpu_torch.train.schedules import Optimizer


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    version: int = 0

    def weights_changed(self) -> None:
        """Record that the weights changed: the eval step copies them anew
        and every ACFF block packs its kernel's arguments anew."""
        self.version += 1
        clear_packed_arguments(self.model)


def create_train_state(model: nn.Module, tx: Optimizer) -> TrainState:
    return TrainState(model=model, optimizer=tx.init(model))


def _tf32_for(policy: Policy) -> bool:
    return policy.compute_dtype != torch.float32


def _draw_generators(seed: int, step: int, i: int, device: torch.device
                     ) -> Tuple[np.random.Generator, torch.Generator]:
    """The host generator (mixing draws) and the device one (dropout
    masks) of update ``step``'s microbatch ``i``."""
    rng = np.random.default_rng([seed, step, i])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(2 ** 63)))
    return rng, gen


def make_train_step(tx: Optimizer,
                    loss_fn: Callable,
                    policy: Policy = DEFAULT_POLICY,
                    grad_accum_steps: int = 1,
                    mixup_alpha: float = 0.0,
                    cutmix_alpha: float = 0.0,
                    mesh: Optional[Mesh] = None,
                    sync_bn: bool = True):
    """Build ``step(state, images, labels, seed) -> (state, metrics)``;
    images are normalized fp32 NHWC on the model's device, labels int
    (under ``mesh``: the global batch on every rank). ``loss_fn`` takes
    ``reduction``; its ``denominator(labels)`` (the losses of
    ``train/losses.py`` have one; else the row count) is what its mean
    divides by: the loss is the rank's rows' sum over the global
    microbatch's denominator, one rank's rows being all of them without a
    mesh."""
    shard = data_sharding(mesh) if mesh is not None else RowShard(0, 1)
    denominator = getattr(loss_fn, "denominator",
                          lambda labels: labels.shape[0])

    def maybe_mix(rng: np.random.Generator, images: torch.Tensor):
        """-> (images, perm, lam); identity when mixing is off."""
        b, h, w, _ = images.shape
        use_mixup = mixup_alpha > 0 and (cutmix_alpha <= 0
                                         or rng.random() < 0.5)
        if use_mixup:
            lam, perm = draw_mixup(rng, b, mixup_alpha)
            return mixup_apply(images, perm, lam), perm, lam
        if cutmix_alpha > 0:
            perm, box = draw_cutmix(rng, b, h, w, cutmix_alpha)
            mixed, lam = cutmix_apply(images, perm, box)
            return mixed, perm, lam
        return images, np.arange(b), 1.0

    def shard_loss(logits32, labels, rows):
        """This rank's share of the global microbatch's mean loss."""
        return (loss_fn(logits32, labels[rows], reduction="sum")
                / denominator(labels))

    def microbatch(state, params, images, labels, seed, i):
        rng, gen = _draw_generators(seed, state.step, i, images.device)
        images, perm, lam = maybe_mix(rng, images)
        set_dropout_generator(state.model, gen)
        perm = torch.as_tensor(perm, device=labels.device)
        rows = shard.rows(images.shape[0])
        logits = torch.func.functional_call(
            state.model, policy.cast_to_compute(params),
            (images[rows].to(policy.compute_dtype),))
        logits32 = logits.float()
        loss = (lam * shard_loss(logits32, labels, rows)
                + (1.0 - lam) * shard_loss(logits32, labels[perm], rows))
        loss.backward()
        correct = (logits.argmax(-1) == labels[rows]).float().sum()
        sums = torch.stack([loss.detach(), correct])
        if mesh is not None:
            sums = psum_along(sums, mesh)
        loss, correct = sums.unbind()
        return loss, correct / labels.shape[0]

    def step(state: TrainState, images: torch.Tensor, labels: torch.Tensor,
             seed: int) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        a = max(grad_accum_steps, 1)
        if images.shape[0] % a:
            raise ValueError(f"batch {images.shape[0]} does not split into "
                             f"{a} microbatches")
        model = state.model.train()
        set_mesh(model, mesh, sync_bn)
        params = dict(model.named_parameters())
        state.optimizer.zero_grad(set_to_none=True)
        with tf32(_tf32_for(policy)):
            parts = [microbatch(state, params, x, y, seed, i)
                     for i, (x, y) in enumerate(zip(images.chunk(a),
                                                    labels.chunk(a)))]
            if mesh is not None:
                all_reduce_grads(list(params.values()), mesh)
            if a > 1:
                for p in params.values():
                    if p.grad is not None:
                        p.grad.div_(a)
            grad_norm = tx.step(state.optimizer, state.step)
            if mesh is not None and not sync_bn:
                broadcast_buffers(model, mesh)
        set_dropout_generator(model, None)
        state.step += 1
        state.weights_changed()
        loss = sum(p[0] for p in parts) / a
        acc = sum(p[1] for p in parts) / a
        return state, {"loss": loss, "accuracy": acc, "grad_norm": grad_norm}

    return step


def make_eval_step(model: nn.Module, policy: Policy = DEFAULT_POLICY,
                   loss_fn: Optional[Callable] = None,
                   num_classes: int = 5, mesh: Optional[Mesh] = None):
    """Build ``step(state, images, labels, valid) -> metrics`` over a
    compute-dtype copy of ``model``'s architecture (kept in eval mode and
    loaded from the state whenever its ``version`` moved). Under ``mesh``
    each rank evaluates its rows of the global batch and the counts and
    the loss sum are summed over the ranks."""
    shard = data_sharding(mesh) if mesh is not None else RowShard(0, 1)
    eval_model = copy.deepcopy(model).eval().requires_grad_(False)
    for p in eval_model.parameters():
        p.data = p.data.to(policy.compute_dtype)
    synced = [None]

    @torch.no_grad()
    def step(state: TrainState, images: torch.Tensor, labels: torch.Tensor,
             valid: int) -> Dict[str, torch.Tensor]:
        key = (id(state.model), state.version)
        if synced[0] != key:
            eval_model.load_state_dict(state.model.state_dict())
            synced[0] = key
        mask = torch.arange(labels.shape[0], device=labels.device) < valid
        images, labels, mask = shard(images), shard(labels), shard(mask)
        with tf32(_tf32_for(policy)):
            logits = eval_model(images.to(policy.compute_dtype),
                                apply_softmax=False).float()
        preds = logits.argmax(-1)
        out = {
            "correct": ((preds == labels) & mask).sum(),
            "count": torch.tensor(int(valid)),
            "confusion": confusion_counts(labels, preds, num_classes, mask),
        }
        if loss_fn is not None:
            per_ex = loss_fn(logits, labels, reduction="none")
            out["loss_sum"] = torch.where(mask, per_ex,
                                          torch.zeros_like(per_ex)).sum()
        if mesh is not None:
            out.update(psum_along({k: v for k, v in out.items()
                                   if k != "count"}, mesh))
        return out

    step.model = eval_model
    return step


def confusion_counts(labels: torch.Tensor, preds: torch.Tensor, n: int,
                     mask: torch.Tensor) -> torch.Tensor:
    """n x n confusion counts, rows = true class; masked rows drop (they
    go to an extra bin that is cut off, so no host sync)."""
    idx = torch.where(mask, labels.long() * n + preds,
                      torch.full_like(preds, n * n))
    return torch.bincount(idx, minlength=n * n + 1)[:n * n].reshape(n, n)


class Trainer:
    """Holds the train and eval steps of one model; the epoch loop, metrics,
    plateau scaling, early stopping and checkpoints are composed in
    ``cli/aider_train.py``."""

    def __init__(self, model, tx, loss_fn, policy=DEFAULT_POLICY,
                 grad_accum_steps=1, mesh=None, num_classes=5,
                 eval_loss_fn=None, mixup_alpha=0.0, cutmix_alpha=0.0,
                 sync_bn=True):
        self.model = model
        self.tx = tx
        self.mesh = mesh
        self.train_step = make_train_step(tx, loss_fn, policy,
                                          grad_accum_steps,
                                          mixup_alpha=mixup_alpha,
                                          cutmix_alpha=cutmix_alpha,
                                          mesh=mesh, sync_bn=sync_bn)
        self.eval_step = make_eval_step(model, policy,
                                        eval_loss_fn or loss_fn, num_classes,
                                        mesh)

    def init_state(self) -> TrainState:
        return create_train_state(self.model, self.tx)
