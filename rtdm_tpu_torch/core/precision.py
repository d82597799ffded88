"""Precision policies, engine precisions, the float-cast helper and a
scoped TF32 switch.

Counterpart of ``rtdm_tpu/core/precision.py``. A training ``Policy`` keeps
the parameters in fp32 and computes in its ``compute_dtype``:
``cast_to_compute`` rounds every floating parameter (BatchNorm's scale and
bias and every bias too) inside the forward, a differentiable cast, so the
fp32 masters receive the gradient, as ``jax.value_and_grad`` of the JAX
trainer's ``loss_of`` gives it. Autocast is not used: it keeps BatchNorm's
parameters in fp32 and picks a dtype per op, where the JAX policy rounds
every parameter and BatchNorm then computes in fp32 on the rounded values.

The engine runs fp32, bf16 or int8 QDQ, which computes in bf16 as the JAX
int8 engine does; ``fp16`` and ``half`` name bf16, as they do for the JAX
engine, so a true fp16 engine does not exist in either package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, Mapping

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    """The dtype a training forward computes in; the parameters (masters)
    and the optimizer state stay fp32."""
    compute_dtype: torch.dtype = torch.bfloat16

    def cast_to_compute(self, tensors: Mapping[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
        return cast_floating(tensors, self.compute_dtype)


DEFAULT_POLICY = Policy()
FP32_POLICY = Policy(compute_dtype=torch.float32)
BF16_POLICY = Policy()


def policy_from_name(name: str) -> Policy:
    name = name.lower()
    if name in ("fp32", "float32", "f32"):
        return FP32_POLICY
    if name in ("bf16", "bfloat16", "fp16", "half", "mixed"):
        return BF16_POLICY
    raise ValueError(f"unknown precision policy: {name}")


# the dtype each engine precision computes in
ENGINE_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16,
                 "int8": torch.bfloat16}


def normalized_quant(quant: str) -> str:
    q = quant.lower()
    return {"fp16": "bf16", "half": "bf16"}.get(q, q)


def cast_floating(tensors: Mapping[str, torch.Tensor],
                  dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Cast every floating tensor to ``dtype``; others pass unchanged."""
    return {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in tensors.items()}


# TF32 is one setting for the whole process; the lock keeps two threads
# (two engines served side by side) from running inside each other's
# setting. Re-entrant: a TTA detector nests sections.
_TF32_LOCK = threading.RLock()


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 for cuDNN and cuBLAS set to ``on`` inside the ``with``, which
    holds a process-wide lock, so no other thread runs under another
    setting meanwhile; the previous setting is restored after it. On the
    card the body enqueues launches: the lock is not held while their
    results are awaited, unless the body waits for them itself."""
    with _TF32_LOCK:
        saved = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = on
        torch.backends.cuda.matmul.allow_tf32 = on
        try:
            yield
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = saved
