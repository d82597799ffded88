"""Small building blocks shared by the classifier family, NHWC in and out.

Counterpart of ``rtdm_tpu/models/layers.py``: ``Conv``, ``DepthwiseConv``,
``BatchNorm`` (inference with running stats) and ``Dense``. Parameters
carry PyTorch's names and layouts (``weight`` OIHW or (O, I), ``bias``,
``running_mean``, ``running_var``), so a JAX variables tree maps onto them
one leaf per tensor (``models/io.py``). Each layer computes in the dtype of
its input, as the JAX layers cast their kernels to ``x.dtype``, and adds
its bias after the product, in that dtype.

``round_output = False`` (``Conv``, ``Dense``; set by the int8 engine on
the layers its model names) leaves a bf16 layer's last step in fp32: the
product of a layer without bias, or the bias sum after the product is
rounded. XLA compiles the JAX int8 engine so: a bf16 result that the next
step reads back in fp32 (the next layer's QDQ, the engine's fp32 logits)
is not rounded to bf16 in between.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import nn

from rtdm_tpu_torch.ops.convpool import conv2d, depthwise_conv2d

PairT = Union[int, Tuple[int, int]]


def _pair(v: PairT) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _he_normal(*shape: int) -> nn.Parameter:
    """The JAX layers' he_normal initializer (fan_in, gain sqrt(2))."""
    return nn.Parameter(nn.init.kaiming_normal_(
        torch.empty(*shape), mode="fan_in", nonlinearity="relu"))


def _zeros(n: int, use: bool) -> Optional[nn.Parameter]:
    return nn.Parameter(torch.zeros(n)) if use else None


def _add_bias(y: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """y + bias in y's dtype, after the product is rounded to it, as the JAX
    layers add theirs (a bf16 layer rounds twice)."""
    return y if bias is None else y + bias.to(y.dtype)


class Conv(nn.Module):
    """Conv2d with explicit torch-style padding/dilation/groups."""

    def __init__(self, in_channels: int, features: int,
                 kernel_size: PairT = 3, stride: PairT = 1,
                 padding: PairT = 0, dilation: PairT = 1, groups: int = 1,
                 use_bias: bool = True):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self.stride, self.padding = stride, padding
        self.dilation, self.groups = dilation, groups
        self.weight = _he_normal(features, in_channels // groups, kh, kw)
        self.bias = _zeros(features, use_bias)
        self.round_output = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(x.dtype)
        if self.round_output or self.bias is not None:
            y = conv2d(x, w, None, self.stride, self.padding, self.dilation,
                       self.groups)
            return _add_bias(y if self.round_output else y.float(),
                             self.bias)
        return conv2d(x.float(), w.float(), None, self.stride, self.padding,
                      self.dilation, self.groups)


class DepthwiseConv(nn.Module):
    """Depthwise Conv2d (torch groups=in_channels), weight (C, 1, kh, kw)."""

    def __init__(self, channels: int, kernel_size: PairT = 3,
                 stride: PairT = 1, padding: PairT = 0, dilation: PairT = 1,
                 use_bias: bool = True):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.weight = _he_normal(channels, 1, kh, kw)
        self.bias = _zeros(channels, use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _add_bias(depthwise_conv2d(x, self.weight.to(x.dtype), None,
                                          self.stride, self.padding,
                                          self.dilation), self.bias)


class BatchNorm(nn.Module):
    """Inference BatchNorm2d over the last (channel) axis.

    Uses the running statistics as stored (no unbiased correction at
    inference), computes in fp32 and casts back to the input's dtype."""

    def __init__(self, channels: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "BatchNorm runs at inference only; training is ported in a "
                "later slice")
        inv = torch.rsqrt(self.running_var.float() + self.epsilon) \
            * self.weight.float()
        out = (x.float() - self.running_mean.float()) * inv \
            + self.bias.float()
        return out.to(x.dtype)


class Dense(nn.Module):
    """Fully connected layer, weight (features, in_features)."""

    def __init__(self, in_features: int, features: int,
                 use_bias: bool = True):
        super().__init__()
        self.weight = _he_normal(features, in_features)
        self.bias = _zeros(features, use_bias)
        self.round_output = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.nn.functional.linear(x, self.weight.to(x.dtype))
        return _add_bias(y if self.round_output else y.float(), self.bias)
