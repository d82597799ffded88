"""Portable model export through ``torch.export``.

Counterpart of ``rtdm_tpu/export/serialize.py``, where a jitted function
becomes a serialized StableHLO module. Here a function of tensors becomes
a ``torch.export`` program saved as ``.pt2``: the graph of ATen ops and of
the registered op ``rtdm::acff_infer`` (``ops/acff.py``; on the card its
CUDA route is the hand-written kernel, on the CPU its plain version), with
the parameters it reads as constants. As the JAX module does, it offers:

- an optional dynamic batch axis (a symbolic ``torch.export.Dim`` on dim 0
  of every argument; the reference's ONNX ``dynamic_axes``);
- a check after export (``verify_export``): the loaded program against
  the eager function on the example inputs;
- no ONNX: that needs a package this environment lacks.

``export_program`` calls ``fn`` once eagerly before tracing, so that state
a module makes at its first forward (an ACFF block's packed kernel
arguments) is made of real tensors and enters the program as constants.
A program runs on the device of its example inputs.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Sequence

import torch


class _Function(torch.nn.Module):
    """``fn`` as the module ``torch.export`` takes."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def export_program(fn: Callable, example_args: Sequence[torch.Tensor],
                   dynamic_batch: bool = False
                   ) -> torch.export.ExportedProgram:
    """``fn`` traced at the example inputs' shapes, with ``dynamic_batch``
    a symbolic dim 0 (at least 1). A batch of 1 would be specialised as a
    constant, so a dynamic export of batch-1 examples traces them repeated
    to a batch of 2."""
    args = tuple(example_args)
    with torch.no_grad():
        fn(*args)
    dynamic = None
    if dynamic_batch:
        if args[0].shape[0] == 1:
            args = tuple(torch.cat([a, a]) for a in args)
        batch = torch.export.Dim("batch", min=1)
        dynamic = (tuple({0: batch} for _ in args),)   # forward(*args)
    return torch.export.export(_Function(fn), args, dynamic_shapes=dynamic)


def save_exported(path: str, program: torch.export.ExportedProgram) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.export.save(program, path)
    return path


def load_exported(path: str) -> Callable:
    """The program saved at ``path``, as a callable."""
    import rtdm_tpu_torch.ops.acff  # noqa: F401  registers rtdm::acff_infer
    return torch.export.load(path).module()


def _flat(out: Any):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def verify_export(path: str, example_args: Sequence[torch.Tensor],
                  reference_fn: Callable = None) -> bool:
    """Run the program saved at ``path`` on the example inputs: its
    floating outputs must be finite and, given ``reference_fn``, equal
    the eager outputs exactly (the program runs the eager function's ops
    and kernels)."""
    call = load_exported(path)
    with torch.no_grad():
        got = _flat(call(*example_args))
        want = (_flat(reference_fn(*example_args))
                if reference_fn is not None else None)
    for g in got:
        if g.is_floating_point() and not torch.isfinite(g).all():
            raise ValueError("exported program produced non-finite outputs")
    if want is not None:
        if len(got) != len(want):
            raise ValueError(f"{len(got)} outputs, eager {len(want)}")
        for i, (g, w) in enumerate(zip(got, want)):
            if not torch.equal(g, w):
                raise ValueError(
                    f"output {i}: the program differs from eager by "
                    f"{(g.double() - w.double()).abs().max().item()}")
    return True
