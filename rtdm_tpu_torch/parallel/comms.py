"""Collectives over a mesh axis.

Counterpart of ``rtdm_tpu/parallel/comms.py``. JAX names the axis inside a
``shard_map`` body; here each call takes the ``Mesh`` and the axis name and
runs the collective over the process group of this rank's line along the
axis (the identity where the axis has one rank or there is no group). The
collectives are NCCL's on the card and gloo's on the CPU.

gloo is a host transport: a CUDA tensor goes through host memory on its
way (gloo's own CUDA all-reduce stages it so too), which lets ranks that
share one card run over gloo. NCCL takes it on the card.

``psum_along`` and ``pmean_along`` carry gradients: the backward of an
all-reduce sum all-reduces the incoming gradient, so that a rank's inputs
get the terms of every rank's loss (BatchNorm's global statistics need
this; a plain ``dist.all_reduce`` would leave each rank only its own).
"""

from __future__ import annotations

from typing import Any, Callable, List

import numpy as np
import torch
import torch.distributed as dist

from rtdm_tpu_torch.core.mesh import Mesh, data_sharding


def _map(tree: Any, fn: Callable) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def via_host(group) -> bool:
    """Whether ``group``'s backend moves tensors through host memory."""
    return dist.get_backend(group) == "gloo"


def _all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` over ``group`` in place."""
    if x.is_cuda and via_host(group):
        host = x.cpu()
        dist.all_reduce(host, group=group)
        x.copy_(host)
    else:
        dist.all_reduce(x, group=group)
    return x


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce_(grad.contiguous().clone(), ctx.group), None


def psum_along(tree: Any, mesh: Mesh, axis_name: str = "data") -> Any:
    """All-reduce sum of every tensor of ``tree`` along ``axis_name``
    (differentiable)."""
    group = mesh.groups[axis_name]
    if group is None:
        return tree
    return _map(tree, lambda x: _AllReduceSum.apply(x, group))


def pmean_along(tree: Any, mesh: Mesh, axis_name: str = "data") -> Any:
    """All-reduce mean along ``axis_name`` (differentiable)."""
    n = mesh.shape[axis_name]
    return _map(psum_along(tree, mesh, axis_name), lambda x: x / n)


def pmean_grads(grads: Any, mesh: Mesh, axis_name: str = "data") -> Any:
    """Average gradients across replicas (the DDP all-reduce)."""
    return pmean_along(grads, mesh, axis_name)


def all_reduce_grads(params: List[torch.Tensor], mesh: Mesh,
                     axis_name: str = "data", mean: bool = False) -> None:
    """Sum (or average) the ``.grad`` of the parameters over the axis in
    place, as one flat all-reduce. Every rank runs the same graph, so the
    parameters without a gradient (left as they are) are the same on all."""
    group = mesh.groups[axis_name]
    grads = [p.grad for p in params if p.grad is not None]
    if group is None or not grads:
        return
    dtype = grads[0].dtype
    if any(g.dtype != dtype for g in grads):
        dtype = torch.float32
    flat = torch.cat([g.reshape(-1).to(dtype) for g in grads])
    _all_reduce_(flat, group)
    if mean:
        flat /= mesh.shape[axis_name]
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def all_gather_along(x: torch.Tensor, mesh: Mesh, axis_name: str = "data",
                     axis: int = 0) -> torch.Tensor:
    """Every rank's ``x`` along ``axis_name``, concatenated in rank order
    along ``axis`` (tiled)."""
    group = mesh.groups[axis_name]
    if group is None:
        return x
    src = x.contiguous()
    if src.is_cuda and via_host(group):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(mesh.shape[axis_name])]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, axis).to(x.device)


def broadcast_from(x: torch.Tensor, mesh: Mesh, axis_name: str = "data",
                   src: int = 0) -> torch.Tensor:
    """Rank ``src`` of the axis's value on every rank of it."""
    group = mesh.groups[axis_name]
    if group is None:
        return x
    out = x.detach().clone().contiguous()
    host = out.cpu() if out.is_cuda and via_host(group) else out
    dist.broadcast(host, mesh.lines[axis_name][src], group=group)
    if host is not out:
        out.copy_(host)
    return out


def broadcast_buffers(module: torch.nn.Module, mesh: Mesh,
                      axis_name: str = "data", src: int = 0) -> None:
    """Copy rank ``src``'s buffers (BatchNorm's running statistics) of
    ``module`` into every rank's, as one flat broadcast: torch DDP's
    ``broadcast_buffers``, which keeps a model whose BatchNorm is not
    synced replicated."""
    bufs = [b for b in module.buffers() if b.is_floating_point()]
    if mesh.groups[axis_name] is None or not bufs:
        return
    flat = broadcast_from(torch.cat([b.reshape(-1).float() for b in bufs]),
                          mesh, axis_name, src)
    for b, part in zip(bufs, flat.split([b.numel() for b in bufs])):
        b.copy_(part.view_as(b))


def broadcast_object(obj: Any, mesh: Mesh, axis_name: str = "data",
                     src: int = 0) -> Any:
    """Rank ``src``'s picklable ``obj`` on every rank of the axis (a run
    directory that rank 0 resolved, say)."""
    group = mesh.groups[axis_name]
    if group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, mesh.lines[axis_name][src], group=group,
                               device=None if via_host(group)
                               else mesh.device)
    return box[0]


def barrier(mesh: Mesh) -> None:
    """Wait for every rank of the process group (nothing at one rank)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[mesh.device.index])
        else:
            dist.barrier()


def shard_batch(batch: Any, mesh: Mesh, axis: str = "data") -> Any:
    """This rank's rows of every leaf of ``batch`` (numpy arrays or
    tensors), on the mesh's device."""
    shard = data_sharding(mesh, axis)
    return _map(batch, lambda x: torch.as_tensor(
        shard(np.asarray(x) if not torch.is_tensor(x) else x)).to(
            mesh.device))
