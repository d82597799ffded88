"""NHWC conv / pooling primitives with the reference's torch semantics.

Counterpart of ``rtdm_tpu/ops/convpool.py``. Every function takes and
returns NHWC tensors; inside, the NHWC tensor is viewed as NCHW with
channels_last strides (no copy), so ``torch.nn.functional`` (cuDNN on the
card) keeps that layout and the NHWC view of its result is contiguous.
Weights are in PyTorch's own OIHW layout.

- Conv2d(padding=p, dilation=d) is torch's own; the ACFF block uses p=d-1 so
  each branch shrinks H, W by exactly 2.
- MaxPool2d(k, s) rounds down (ceil_mode=False).
- AvgPool2d(k, s, p) with count_include_pad=True divides every window by
  k*k, also where it overlaps the padding (AvgPool2d(5,1,1) on 4x4 -> 2x2).
  ``avg_pool2d_sequential`` is the same pool rounded as the compiled JAX
  engine rounds a bf16 one.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

_PairT = Union[int, Tuple[int, int]]


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None, stride: _PairT = 1,
           padding: _PairT = 0, dilation: _PairT = 1,
           groups: int = 1) -> torch.Tensor:
    """2-D convolution, NHWC x OIHW -> NHWC."""
    return _nhwc(F.conv2d(_nchw(x), weight, bias, stride, padding, dilation,
                          groups))


def depthwise_conv2d(x: torch.Tensor, weight: torch.Tensor,
                     bias: Optional[torch.Tensor] = None, stride: _PairT = 1,
                     padding: _PairT = 0, dilation: _PairT = 1) -> torch.Tensor:
    """Depthwise conv: weight (C, 1, kh, kw), groups = C."""
    return conv2d(x, weight, bias, stride, padding, dilation,
                  groups=x.shape[-1])


def max_pool2d(x: torch.Tensor, kernel: _PairT,
               stride: Optional[_PairT] = None,
               padding: _PairT = 0) -> torch.Tensor:
    """Max pool with torch floor semantics (ceil_mode=False)."""
    return _nhwc(F.max_pool2d(_nchw(x), kernel,
                              stride if stride is not None else kernel,
                              padding, ceil_mode=False))


def avg_pool2d(x: torch.Tensor, kernel: _PairT,
               stride: Optional[_PairT] = None, padding: _PairT = 0,
               count_include_pad: bool = True) -> torch.Tensor:
    """Average pool matching torch AvgPool2d. On a CUDA tensor it pools a
    contiguous NCHW copy: torch's channels_last CUDA pool gives a wrong
    input gradient where the window overlaps the padding (the head's
    AvgPool2d(5, 1, 1); ``chip_smoke.py`` phase 9 prints both against
    float64). The values are the same."""
    t = _nchw(x)
    if x.is_cuda:
        t = t.contiguous()
    return _nhwc(F.avg_pool2d(t, kernel,
                              stride if stride is not None else kernel,
                              padding, count_include_pad=count_include_pad))


def avg_pool2d_sequential(x: torch.Tensor, kernel: int,
                          padding: int = 0) -> torch.Tensor:
    """``avg_pool2d(x, kernel, 1, padding, count_include_pad=True)``
    rounded as XLA:CPU compiles the JAX package's bf16 pool: the window's
    k*k values are summed one by one in row-major order, each partial sum
    rounded to x's dtype, and the sum is multiplied by the fp32 reciprocal
    of k*k and rounded once more. One add a window position: k*k small
    launches on the card."""
    xp = F.pad(x, (0, 0, padding, padding, padding, padding))
    oh, ow = xp.shape[1] - kernel + 1, xp.shape[2] - kernel + 1
    acc = torch.zeros((x.shape[0], oh, ow, x.shape[3]), dtype=x.dtype,
                      device=x.device)
    for i in range(kernel):
        for j in range(kernel):
            acc = acc + xp[:, i:i + oh, j:j + ow]
    inv = torch.tensor(1.0 / (kernel * kernel), dtype=torch.float32)
    return (acc.float() * inv).to(x.dtype)
