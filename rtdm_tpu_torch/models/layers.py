"""Small building blocks shared by all model families, NHWC in and out.

Counterpart of ``rtdm_tpu/models/layers.py``: ``Conv`` (with groups),
``DepthwiseConv``, ``BatchNorm`` (batch statistics in training, running
statistics at inference), ``Dense``, ``Dropout`` (its mask from an explicit
generator) and the parametric activations ``FReLU``, ``AconC`` and
``MetaAconC``, with
the detectors' ``leaky_relu`` and ``silu`` rounded as the compiled JAX
graphs round them in bf16. Parameters
carry PyTorch's names and layouts (``weight`` OIHW or (O, I), ``bias``,
``running_mean``, ``running_var``), so a JAX variables tree maps onto them
one leaf per tensor (``models/io.py``). ``DepthwiseConv`` and ``Dense``
compute in the dtype of their input, as the JAX layers cast their kernels
to ``x.dtype``; ``Conv`` casts its input to its weight's dtype instead
(see ``Conv``). Each adds its bias after the product, in that dtype.

``round_output = False`` (``Conv``, ``Dense``; set by the int8 engine on
the layers its model names) leaves a bf16 layer's last step in fp32: the
product of a layer without bias, or the bias sum after the product is
rounded. XLA compiles the JAX int8 engine so: a bf16 result that the next
step reads back in fp32 (the next layer's QDQ, the engine's fp32 logits)
is not rounded to bf16 in between.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
from torch import nn

from rtdm_tpu_torch.core.mesh import data_sharding
from rtdm_tpu_torch.ops.convpool import conv2d, depthwise_conv2d
from rtdm_tpu_torch.parallel.comms import pmean_along

PairT = Union[int, Tuple[int, int]]


def _pair(v: PairT) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _he_normal(*shape: int) -> nn.Parameter:
    """A He-normal weight (fan_in, gain sqrt(2)) from torch's global
    generator; ``init_he_normal`` draws the JAX layers' initializer from an
    explicit one."""
    return nn.Parameter(nn.init.kaiming_normal_(
        torch.empty(*shape), mode="fan_in", nonlinearity="relu"))


def _zeros(n: int, use: bool) -> Optional[nn.Parameter]:
    return nn.Parameter(torch.zeros(n)) if use else None


def acc_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype a layer accumulates ``x``'s dtype in: fp32, or float64 for
    a float64 x (the float64 readings of the training gates)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _add_bias(y: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """y + bias in y's dtype, after the product is rounded to it, as the JAX
    layers add theirs (a bf16 layer rounds twice)."""
    return y if bias is None else y + bias.to(y.dtype)


class Conv(nn.Module):
    """Conv2d with explicit torch-style padding/dilation/groups.

    Computes in its weight's dtype: an input of another dtype is cast to it
    first. An int8 detector hands a conv its SiLU product or residual sum
    in fp32 where the compiled JAX graph holds bf16 (``keep_fp32``), so the
    cast stands for the JAX layer's bf16 input; the classifiers' convs
    always get their weight's dtype, so for them nothing changes.

    A bf16 conv is a different call on each device, for the same function
    (fp32 sums of exact products, rounded once): on the CPU an fp32 conv of
    the bf16 values, as XLA:CPU compiles it; on the card cuDNN's bf16 conv.
    The CPU tests hold the first against the JAX package; only
    ``chip_smoke.py`` and the ``cuda`` tests reach the second."""

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
        x = x.to(self.weight.dtype)
        args = (None, self.stride, self.padding, self.dilation, self.groups)
        if not (self.round_output or self.bias is not None):
            acc = acc_dtype(x)
            return conv2d(x.to(acc), self.weight.to(acc), *args)
        y = conv_product(x, self.weight, *args)
        return _add_bias(y if self.round_output else y.float(), self.bias)


def conv_product(x: torch.Tensor, weight: torch.Tensor, *args) -> torch.Tensor:
    """``conv2d(x, weight, *args)`` in x's dtype, rounded once; a bf16 one
    on the CPU as an fp32 conv of the bf16 values (torch's fp32 conv sums
    as XLA:CPU's does where oneDNN's bf16 conv does not)."""
    if x.dtype == torch.bfloat16 and not x.is_cuda:
        return conv2d(x.float(), weight.float(), *args).to(x.dtype)
    return conv2d(x, weight, *args)


class DepthwiseConv(nn.Module):
    """Depthwise Conv2d (torch groups=in_channels), weight (C, 1, kh, kw).

    A bf16 one on the CPU runs as an fp32 conv of the bf16 values, rounded
    once, as ``Conv`` does: oneDNN's bf16 depthwise conv sums otherwise,
    and its weight gradient at dilation 2 and 3 is wrong (far from the
    float64 gradient, inf on some calls)."""

    def __init__(self, channels: int, kernel_size: PairT = 3,
                 stride: PairT = 1, padding: PairT = 0, dilation: PairT = 1,
                 use_bias: bool = True):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.weight = _he_normal(channels, 1, kh, kw)
        self.bias = _zeros(channels, use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        args = (None, self.stride, self.padding, self.dilation)
        if x.dtype == torch.bfloat16 and not x.is_cuda:
            y = depthwise_conv2d(x.float(), self.weight.to(x.dtype).float(),
                                 *args).to(x.dtype)
        else:
            y = depthwise_conv2d(x, self.weight.to(x.dtype), *args)
        return _add_bias(y, self.bias)


class BatchNorm(nn.Module):
    """BatchNorm2d over the last (channel) axis, computed in fp32 and cast
    back to the input's dtype.

    In training mode it normalizes with the batch's statistics as the JAX
    ``BatchNorm(train=True)`` computes them: ``mean`` and ``mean2`` (the
    mean of x²) over (B, H, W), the biased ``var = mean2 - mean²`` (not
    torch's two-pass or Welford variance), and updates the running
    statistics with ``momentum`` and the unbiased ``var * n / (n - 1)``,
    unless ``update_stats`` is False (the detectors' BN burn-in,
    ``set_bn_update``): then the batch still normalizes and its statistics
    are dropped. At inference it uses the running statistics as stored.

    ``group`` (a ``core/mesh.py::Mesh``, set by ``set_mesh`` or
    ``set_bn_group``; the JAX ``axis_name``) syncs the statistics over the
    mesh's 'data' axis: ``mean`` and ``mean2`` are
    averaged over the ranks by an all-reduce that carries gradients (a
    rank's inputs get the terms of every rank's loss), ``var`` is taken
    from the averages in fp32 and ``n`` counts every rank's rows."""

    def __init__(self, channels: int, epsilon: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        self.epsilon, self.momentum = epsilon, momentum
        self.group = None
        self.update_stats = True
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return self.affine(x).to(x.dtype)
        acc = acc_dtype(x)
        xf = x.to(acc)
        mean = xf.mean((0, 1, 2))
        mean2 = xf.square().mean((0, 1, 2))
        n = x.shape[0] * x.shape[1] * x.shape[2]
        if self.group is not None:
            mean, mean2 = pmean_along(torch.stack([mean, mean2]),
                                      self.group).unbind()
            n *= self.group.shape["data"]
        var = mean2 - mean.square()
        if self.update_stats:
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_((1 - m) * self.running_mean
                                        + m * mean)
                self.running_var.copy_((1 - m) * self.running_var
                                       + m * (var * (n / max(n - 1, 1))))
        inv = torch.rsqrt(var + self.epsilon) * self.weight.to(acc)
        return torch.addcmul(self.bias.to(acc), xf - mean, inv).to(x.dtype)

    def affine(self, x: torch.Tensor) -> torch.Tensor:
        """The fp32 result at inference, before the cast to x's dtype, as
        the jitted JAX ``BatchNorm`` computes it (read off its compiled HLO,
        fp32 and bf16 inputs alike): ``inv = rsqrt(var + eps) * scale`` per
        channel, then ``fma(x - mean, inv, bias)`` in fp32. The per-channel
        rsqrt is taken correctly rounded; XLA:CPU's own is within one ulp
        of it."""
        var = self.running_var.float() + self.epsilon
        inv = torch.rsqrt(var.double()).float() * self.weight.float()
        return torch.addcmul(self.bias.float(),
                             x.float() - self.running_mean.float(), inv)


class Dropout(nn.Module):
    """``flax.linen.Dropout``: in training mode each unit is kept with
    probability 1 - rate and kept units are scaled by 1 / (1 - rate); the
    mask is drawn from ``generator`` (on x's device), which the trainer
    sets before each forward (``set_dropout_generator``). Identity at
    inference and at rate 0.

    Under a data-parallel ``group`` (``set_mesh``; a ``Mesh``) each rank
    draws the mask of the global batch, its rows times the 'data' axis,
    from the same generator state and keeps its own rows, so that the
    masks are the one-process run's bit for bit (JAX's GSPMD step draws
    one global mask)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None
        self.group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError("Dropout in training needs a generator "
                               "(set_dropout_generator)")
        keep = 1.0 - self.rate
        if self.group is None:
            mask = torch.rand(x.shape, generator=self.generator,
                              device=x.device) < keep
        else:
            n = self.group.shape["data"]
            mask = data_sharding(self.group)(torch.rand(
                (x.shape[0] * n,) + x.shape[1:], generator=self.generator,
                device=x.device) < keep)
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


def set_bn_update(model: nn.Module, on: bool) -> None:
    """Every ``BatchNorm`` of ``model`` updates its running statistics in
    training (``on``) or keeps them as they are."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.update_stats = on


def set_bn_group(model: nn.Module, group) -> None:
    """Every ``BatchNorm`` of ``model`` syncs its statistics over ``group``
    (a ``Mesh``), or keeps them local (None). The one route by which a
    model's BatchNorm is synced (the JAX ``bn_axis``): ``set_mesh`` calls
    it, and so does a caller of the DDP-form step
    (``parallel/shard.py``)."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.group = group


def set_mesh(model: nn.Module, mesh, sync_bn: bool = True) -> None:
    """Run ``model`` data-parallel over ``mesh`` (None: on one process) as
    JAX's GSPMD step runs it: dropout masks sliced from the global mask,
    and the BatchNorm statistics the global batch's unless ``sync_bn`` is
    False (then each rank's own: the DDP form)."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.group = mesh
    set_bn_group(model, mesh if sync_bn else None)


def set_dropout_generator(model: nn.Module,
                          generator: Optional[torch.Generator]) -> None:
    """Every ``Dropout`` of ``model`` draws its masks from ``generator``."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator


def init_he_normal(model: nn.Module, generator: torch.Generator) -> None:
    """Draw every conv and dense weight of ``model`` (each parameter of two
    or more dimensions) from the JAX layers' initializer, flax's
    ``he_normal``: a normal of variance 2 / fan_in truncated to two standard
    deviations (the draw scaled up by 1 / 0.87962566103423978 so that the
    variance stays 2 / fan_in), by the inverse CDF of a uniform from
    ``generator`` (CPU) as ``jax.random.truncated_normal`` draws it. The
    numbers differ from the JAX package's for the same seed. Biases and
    BatchNorm stay as constructed (zeros; unit scales and variances)."""
    lo, hi = math.erf(-2 / math.sqrt(2)), math.erf(2 / math.sqrt(2))
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() < 2:
                continue
            fan_in = p[0].numel()
            std = math.sqrt(2.0 / fan_in) / 0.87962566103423978
            u = torch.rand(p.shape, generator=generator,
                           dtype=torch.float64) * (hi - lo) + lo
            z = (math.sqrt(2) * torch.erfinv(u)).clamp(-2.0, 2.0)
            p.copy_((z * std).to(p.dtype))


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


def leaky_relu(x: torch.Tensor, slope: float) -> torch.Tensor:
    """``flax.linen.leaky_relu``: the slope in x's dtype (bf16(0.1) =
    0.10009765625 for a bf16 x) and the product rounded to it."""
    return torch.where(x >= 0, x, x * torch.tensor(slope, dtype=x.dtype))


def silu(x: torch.Tensor, round_output: bool = True) -> torch.Tensor:
    """``jax.nn.silu``, x * sigmoid(x). For a bf16 x the compiled JAX graph
    rounds each step of the sigmoid to bf16 (exp(-x), + 1, the reciprocal)
    and multiplies in fp32; ``round_output = False`` returns that fp32
    product, as it stands where the next step (an int8 QDQ) reads it at
    once."""
    if x.dtype != torch.bfloat16:
        return x * torch.sigmoid(x)
    sig = 1.0 / (torch.exp(-x) + 1.0)
    y = x.float() * sig.float()
    return y.to(x.dtype) if round_output else y


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + exp(x)) as max(x, 0) + log1p(exp(-|x|))."""
    return x.clamp_min(0) + torch.log1p(torch.exp(-x.abs()))


class FReLU(nn.Module):
    """Funnel activation max(x, BN(dwconv_kxk(x))), BN eps 1e-3 and
    momentum 0.03 (v5's ``initialize_weights`` sets both on every BN)."""

    def __init__(self, channels: int, k: int = 3):
        super().__init__()
        self.conv = DepthwiseConv(channels, k, 1, padding=k // 2,
                                  use_bias=False)
        self.bn = BatchNorm(channels, epsilon=1e-3, momentum=0.03)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.maximum(x, self.bn(self.conv(x)))


def _acon(x: torch.Tensor, p1, p2, beta) -> torch.Tensor:
    xf = x.float()
    dpx = (p1.float() - p2.float()) * xf
    return (dpx * torch.sigmoid(beta * dpx) + p2.float() * xf).to(x.dtype)


class AconC(nn.Module):
    """ACON-C: (p1-p2)x * sigmoid(beta (p1-p2)x) + p2 x, per-channel p1, p2,
    beta, in fp32."""

    def __init__(self, channels: int):
        super().__init__()
        self.p1 = nn.Parameter(torch.randn(channels))
        self.p2 = nn.Parameter(torch.randn(channels))
        self.beta = nn.Parameter(torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _acon(x, self.p1, self.p2, self.beta.float())


class MetaAconC(nn.Module):
    """ACON-C with beta from two 1x1 convs over the spatial mean of x (no
    BN), hidden width max(r, C // r)."""

    def __init__(self, channels: int, r: int = 16):
        super().__init__()
        hidden = max(r, channels // r)
        self.p1 = nn.Parameter(torch.randn(channels))
        self.p2 = nn.Parameter(torch.randn(channels))
        self.fc1 = Conv(channels, hidden, 1)
        self.fc2 = Conv(hidden, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.float().mean((1, 2), keepdim=True)
        y = self.fc2(self.fc1(y.to(self.fc1.weight.dtype)))
        return _acon(x, self.p1, self.p2, torch.sigmoid(y.float()))
