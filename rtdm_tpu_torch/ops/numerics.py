"""Elementwise functions rounded as the compiled JAX programs round them.

XLA:CPU compiles ``exp`` to the Cephes polynomial below (range reduction
by ln 2 in two FMA steps, a degree-5 polynomial in FMAs, denormal results
flushed to zero), not to a correctly rounded exp: about one fp32 result in
ten is one ulp away from ``torch.exp``'s. ``jax.nn.sigmoid`` compiles to
``1 / (1 + exp(-x))`` with that exp. A detection decision at a threshold
(confidence, IoU) can turn on one ulp, so decode and NMS use these.

Each FMA is ``torch.addcmul`` (one rounding on the CPU and on the card) and
every other step is one IEEE operation, so the result is the same on both
devices. ``exp_f32`` equals the jitted ``jnp.exp`` on every fp32 input
tried (``tests/test_torch_detector_ops.py``).
"""

from __future__ import annotations

import numpy as np
import torch

_F = np.float32
_LOG2E = _F(1.44269504088896341)
_LN2_HI, _LN2_LO = _F(0.693359375), _F(-2.12194440e-4)
_POLY = tuple(_F(c) for c in (1.9875691500e-4, 1.3981999507e-3,
                              8.3334519073e-3, 4.1665795894e-2,
                              1.6666665459e-1, 5.0000001201e-1))
_TINY = _F(2.0 ** -126)


def _const(v, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), v, dtype=torch.float32, device=like.device)


def exp_f32(x: torch.Tensor) -> torch.Tensor:
    """exp of a float32 tensor, rounded as XLA:CPU's compiled exp."""
    x = x.float().clamp(_F(-87.8), _F(88.8))
    n = torch.floor(torch.addcmul(_const(0.5, x), x, _const(_LOG2E, x)))
    n = n.clamp(-127.0, 127.0)
    a = torch.addcmul(x, n, _const(-_LN2_HI, x))
    a = torch.addcmul(a, n, _const(-_LN2_LO, x))
    z = torch.addcmul(_const(_POLY[1], x), a, _const(_POLY[0], x))
    for c in _POLY[2:]:
        z = torch.addcmul(_const(c, x), z, a)
    z = torch.addcmul(a, z, a * a) + 1.0
    # 2^n built in the exponent bits, as XLA does (n = -127 gives +0)
    pow2 = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    return _flush(z * pow2)


def _flush(y: torch.Tensor) -> torch.Tensor:
    """Denormal results to zero, as XLA:CPU computes with them."""
    return torch.where(y.abs() < _TINY, torch.zeros_like(y), y)


def sigmoid_f32(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as compiled: 1 / (1 + exp_f32(-x)), in fp32."""
    return _flush(1.0 / (exp_f32(-x.float()) + 1.0))
