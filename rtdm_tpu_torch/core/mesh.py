"""Process groups and device meshes over ``torch.distributed``.

Counterpart of ``rtdm_tpu/core/mesh.py``. JAX drives every local device from
one process and names them in a ``jax.sharding.Mesh``; the port runs one
process a card (``torchrun``, or processes the caller spawns), so a
``Mesh`` here is the process group, its axis names and shape, this rank,
and this rank's device. The backend is NCCL when that device is a card and
gloo on the CPU.

Inputs keep JAX's single-controller semantics: every rank is handed the
global host batch and takes its own contiguous rows (``data_sharding``:
rank r of N holds rows ``[r B / N, (r + 1) B / N)``, as a ``P("data")``
sharding splits them), and whatever a data-parallel entry point returns
is all-gathered, so each rank holds the global result.

Without a process group, ``local_mesh`` is a world-size-1 mesh on the one
device asked for, and every data-parallel path runs as it does without a
mesh, as JAX's does on a one-chip host. A process that sees several cards
and was started by no launcher drives one of them, not all.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from rtdm_tpu_torch.core.device import resolve_device

# a collective that waits longer than this fails
TIMEOUT = datetime.timedelta(minutes=10)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of a mesh of ranks, row-major over ``axis_shapes``.

    ``lines[name]`` is the list of global ranks that share every coordinate
    but ``name`` with this rank (its ``name`` axis, in order), and
    ``groups[name]`` their process group: None where the axis has one rank
    or no process group exists, and then a collective along it is the
    identity. Copies of a mesh (``copy.deepcopy`` of a model that holds
    one) are the mesh itself."""
    axis_names: Tuple[str, ...]
    axis_shapes: Tuple[int, ...]
    rank: int
    device: torch.device
    lines: Dict[str, Tuple[int, ...]]
    groups: Dict[str, Optional[object]]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_shapes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_shapes)

    def axis_index(self, name: str) -> int:
        """This rank's coordinate along ``name``."""
        return self.lines[name].index(self.rank)

    def __deepcopy__(self, memo):
        return self

    def __copy__(self):
        return self


@dataclasses.dataclass(frozen=True)
class RowShard:
    """The rows of a batch that one rank holds: ``count`` equal contiguous
    blocks of the leading dim, block ``index``."""
    index: int
    count: int

    def rows(self, n: int) -> slice:
        if n % self.count:
            raise ValueError(f"batch {n} does not split over {self.count} "
                             "ranks")
        per = n // self.count
        return slice(self.index * per, (self.index + 1) * per)

    def __call__(self, x):
        return x[self.rows(x.shape[0])]


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def distributed_init(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     device="cuda", backend: Optional[str] = None,
                     init_method: Optional[str] = None) -> bool:
    """Join the process group (``dist.init_process_group``); returns
    whether one is initialised after the call.

    The address, count and rank come from the arguments, else JAX's
    ``JAX_COORDINATOR_ADDRESS`` / ``COORDINATOR_ADDRESS``, ``NUM_PROCESSES``
    and ``PROCESS_ID``, else torchrun's ``MASTER_ADDR``:``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK``. At one process this is a no-op, unless
    ``init_method`` (a ``file://`` or ``tcp://`` store) is given, which
    makes a group of any size, one included. The backend is NCCL for a
    CUDA ``device`` and gloo for the CPU unless ``backend`` says otherwise.

    JAX hands a coordinator without a count, and a SLURM allocation of
    several nodes, to ``jax.distributed``, which asks the cluster for the
    rest. ``torch.distributed`` needs the world size and this rank, so
    here both raise instead of running N independent one-process jobs.
    A failed init raises."""
    if coordinator_address is None:
        coordinator_address = (os.environ.get("JAX_COORDINATOR_ADDRESS")
                               or os.environ.get("COORDINATOR_ADDRESS"))
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = _env_int("NUM_PROCESSES", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("PROCESS_ID", "RANK")
    if dist.is_initialized():
        if num_processes is not None and \
                num_processes != dist.get_world_size():
            raise RuntimeError(f"a process group of {dist.get_world_size()} "
                               f"ranks exists; {num_processes} were asked "
                               "for")
        return True
    if init_method is None:
        if num_processes is None and (
                coordinator_address or os.environ.get(
                    "SLURM_JOB_NUM_NODES", "1") not in ("", "1")):
            raise ValueError(
                "a coordinator or a multi-node cluster without a process "
                "count: pass num_processes and process_id (or NUM_PROCESSES "
                "and PROCESS_ID, WORLD_SIZE and RANK); torch.distributed "
                "cannot ask the cluster for them")
        if num_processes is None or num_processes <= 1:
            return False
        if not coordinator_address:
            raise ValueError(f"{num_processes} processes need a coordinator "
                             "address (host:port)")
        init_method = f"tcp://{coordinator_address}"
    if num_processes is None or process_id is None:
        raise ValueError(f"{init_method}: pass num_processes and process_id")
    device = resolve_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=int(num_processes),
                            rank=int(process_id), timeout=TIMEOUT)
    return True


def _rank_device(device, rank: int) -> torch.device:
    """The device this rank computes on: a CUDA device without an index
    becomes card ``LOCAL_RANK`` (else the rank) modulo the cards this
    process sees; two ranks may share a card."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        local = _env_int("LOCAL_RANK")
        index = (rank if local is None else local) % torch.cuda.device_count()
        device = torch.device("cuda", index)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return device


def create_mesh(axis_shapes: Optional[Sequence[int]] = None,
                axis_names: Sequence[str] = ("data",),
                device="cuda") -> Mesh:
    """A mesh over every rank of the process group (one rank without one).
    The default is a 1-D ``('data',)`` mesh; the product of ``axis_shapes``
    must be the world size. Every rank must call this in the same order:
    the axes of a mesh of two or more axes get their own process groups."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    axis_names = tuple(axis_names)
    if axis_shapes is None:
        axis_shapes = (world,) + (1,) * (len(axis_names) - 1)
    axis_shapes = tuple(int(s) for s in axis_shapes)
    if len(axis_shapes) != len(axis_names):
        raise ValueError(f"mesh axes {axis_shapes} do not match the names "
                         f"{axis_names}")
    if math.prod(axis_shapes) != world:
        raise ValueError(f"mesh axes {axis_shapes} != #devices {world}")
    grid = np.arange(world).reshape(axis_shapes)
    coords = np.unravel_index(rank, axis_shapes)
    lines, groups = {}, {}
    for axis, name in enumerate(axis_names):
        here = tuple(int(r) for r in grid[tuple(
            slice(None) if a == axis else c for a, c in enumerate(coords))])
        lines[name] = here
        if not dist.is_initialized() or len(here) == 1:
            groups[name] = None
        elif len(here) == world:
            groups[name] = dist.group.WORLD
        else:
            # new_group is collective: every rank makes every line's group
            moved = np.moveaxis(grid, axis, -1).reshape(-1, axis_shapes[axis])
            for line in moved:
                g = dist.new_group([int(r) for r in line])
                if rank in line:
                    groups[name] = g
    return Mesh(axis_names, axis_shapes, rank, _rank_device(device, rank),
                lines, groups)


def local_mesh(n: Optional[int] = None, axis_names: Sequence[str] = ("data",),
               device="cuda") -> Mesh:
    """A mesh over every rank of the process group, or of this process
    alone when there is none. ``n``, if given, must be the world size (JAX
    takes the first n local devices; a rank here is one device). Raises
    where a launcher asked for more ranks than the group has (``WORLD_SIZE``
    set, no group joined: call ``distributed_init`` first)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    asked = _env_int("WORLD_SIZE")
    if not dist.is_initialized() and asked is not None and asked > 1:
        raise RuntimeError(f"WORLD_SIZE={asked} but this process joined no "
                           "process group; call distributed_init() first")
    if n is not None and n != world:
        raise ValueError(f"a mesh of {n} ranks was asked for; the process "
                         f"group has {world}")
    return create_mesh((world,) + (1,) * (len(axis_names) - 1), axis_names,
                       device)


def data_parallel_mesh(device="cuda") -> Mesh:
    """``distributed_init`` from the environment (torchrun's or JAX's
    variables; a no-op at one process), then ``local_mesh``: what a CLI's
    ``--data-parallel`` runs over."""
    distributed_init(device=device)
    return local_mesh(device=device)


def mesh_device(mesh: Optional[Mesh], device) -> torch.device:
    """The device an entry point runs on: ``device`` (default the card)
    without a mesh; with one, the mesh's, which ``device`` may name only by
    its type."""
    if mesh is None:
        return resolve_device("cuda" if device is None else device)
    if device is not None:
        asked = torch.device(device)
        if asked.type != mesh.device.type or (
                asked.index is not None and asked != mesh.device):
            raise ValueError(f"device {asked} is not the mesh's "
                             f"{mesh.device}")
    return mesh.device


def data_sharding(mesh: Mesh, axis: str = "data") -> RowShard:
    """This rank's rows of a batch split over ``axis``."""
    return RowShard(mesh.axis_index(axis), mesh.shape[axis])


def replicated(mesh: Mesh) -> RowShard:
    """Every rank holds every row."""
    return RowShard(0, 1)


def require_data_divisible(batch: int, mesh: Mesh, label: str = "batch"
                           ) -> int:
    """Validate that ``batch`` splits evenly over the mesh's 'data' axis;
    returns the axis extent. One spelling of the check for every serving
    surface (Engine/Detector/CLIs)."""
    n = mesh.shape["data"]
    if batch % n:
        raise ValueError(f"{label} {batch} must divide over the {n}-way "
                         f"'data' mesh axis")
    return n
