"""Explicit per-rank programs: the DDP-form train step and the spatially
sharded conv.

Counterpart of ``rtdm_tpu/parallel/shard.py``:

1. ``make_shard_map_train_step``: the classifier train step written as each
   rank's own program with its collectives placed by hand. Each rank takes
   its rows of the global batch, draws its dropout masks from the step's
   seed folded with its rank (independent streams, the DDP form: unlike
   the data-parallel ``train/trainer.py`` step, whose masks are slices of
   one global mask), takes the mean loss of its rows, and the gradients
   and the loss are averaged over the ranks; BatchNorm is synced only if
   the caller synced the model's over the mesh
   (``models/layers.py::set_bn_group``, the JAX ``bn_axis``), else each
   rank normalizes by its own rows and rank 0's running statistics are
   copied to every rank (DDP's ``broadcast_buffers``). Parameters and
   optimizer state stay replicated. With dropout off it computes the
   data-parallel step.

2. ``spatial_shard_conv``: a SAME conv over frames whose rows are split over
   a ``spatial`` axis. Each rank swaps ``kH // 2`` halo rows with its
   neighbours (``dist.batch_isend_irecv``; the first and last rank pad with
   zeros), then runs the port's conv on the haloed block.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from rtdm_tpu_torch.core.mesh import Mesh, data_sharding
from rtdm_tpu_torch.ops.convpool import conv2d
from rtdm_tpu_torch.parallel.comms import (all_reduce_grads,
                                           broadcast_buffers, pmean_along,
                                           via_host)


def make_shard_map_train_step(tx, loss_fn: Callable, mesh: Mesh,
                              axis: str = "data"):
    """``step(state, images, labels, seed) -> (state, loss)``: images and
    labels are the global batch on the mesh's device (fp32); ``state`` a
    ``train/trainer.py::TrainState`` whose model runs in fp32."""
    from rtdm_tpu_torch.models.layers import BatchNorm, set_dropout_generator
    shard = data_sharding(mesh, axis)
    index = mesh.axis_index(axis)

    def bn_synced(model):
        return all(m.group is not None for m in model.modules()
                   if isinstance(m, BatchNorm))

    def step(state, images, labels, seed: int):
        model = state.model.train()
        synced = bn_synced(model)
        x, y = shard(images), shard(labels)
        gen = torch.Generator(device=x.device)
        gen.manual_seed(int(np.random.default_rng(
            [seed, state.step, index]).integers(2 ** 63)))
        state.optimizer.zero_grad(set_to_none=True)
        set_dropout_generator(model, gen)
        try:
            logits = model(x, apply_softmax=False)
            loss = loss_fn(logits.float(), y)
            loss.backward()
        finally:
            set_dropout_generator(model, None)
        all_reduce_grads(list(model.parameters()), mesh, axis, mean=True)
        tx.step(state.optimizer, state.step)
        if not synced:
            broadcast_buffers(model, mesh, axis)
        state.step += 1
        state.weights_changed()
        return state, pmean_along(loss.detach(), mesh, axis)

    return step


def _exchange(block: torch.Tensor, up: Optional[int], down: Optional[int],
              halo: int, group) -> tuple:
    """(the ``halo`` rows above ``block``, the ``halo`` rows below it): the
    bottom rows of rank ``up`` and the top rows of rank ``down`` (global
    ranks), zeros where there is no neighbour."""
    n, _, w, c = block.shape
    staged = block.is_cuda and via_host(group)
    dev = "cpu" if staged else block.device
    top = torch.zeros((n, halo, w, c), dtype=block.dtype, device=dev)
    bottom = torch.zeros_like(top)
    ops = []
    if up is not None:
        ops += [dist.P2POp(dist.isend, block[:, :halo].contiguous().to(dev),
                           up, group),
                dist.P2POp(dist.irecv, top, up, group)]
    if down is not None:
        ops += [dist.P2POp(dist.isend, block[:, -halo:].contiguous().to(dev),
                           down, group),
                dist.P2POp(dist.irecv, bottom, down, group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return top.to(block.device), bottom.to(block.device)


def spatial_shard_conv(x_local: torch.Tensor, kernel: torch.Tensor,
                       mesh: Mesh, axis: str = "spatial",
                       bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SAME conv of this rank's rows of an H-sharded NHWC tensor.

    x_local: (N, H / n, W, C), rank i's block of rows; kernel: OIHW with
    odd kH. Returns this rank's rows of ``conv2d(x, kernel, bias,
    padding=(kH // 2, kW // 2))`` of the whole x: the halo follows kH, the
    horizontal padding kW."""
    kh, kw = kernel.shape[2], kernel.shape[3]
    halo = kh // 2
    pad_w = kw // 2
    group = mesh.groups[axis]
    if halo == 0 or group is None:
        # a 1-row kernel exchanges nothing; one rank pads its own rows
        return conv2d(x_local, kernel, bias, 1, (halo, pad_w))
    if x_local.shape[1] < halo:
        raise ValueError(f"a block of {x_local.shape[1]} rows cannot carry "
                         f"a halo of {halo}")
    line, i = mesh.lines[axis], mesh.axis_index(axis)
    up = line[i - 1] if i > 0 else None
    down = line[i + 1] if i + 1 < len(line) else None
    top, bottom = _exchange(x_local, up, down, halo, group)
    padded = torch.cat([top, x_local, bottom], 1)
    return conv2d(padded, kernel, bias, 1, (0, pad_w))
