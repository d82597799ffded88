"""ACFF — Atrous Convolution Feature Fusion block.

Counterpart of ``rtdm_tpu/models/acff.py::ACFF``: three parallel depthwise
3x3 convs at dilation 1/2/3 with padding 0/1/2 (each branch shrinks H, W by
exactly 2), channel concat, 1x1 fuse conv, then — in this order —
LeakyReLU(0.01) BEFORE BatchNorm, then Dropout(rate).

At inference the forward runs the whole block as one fused call,
``ops.acff.acff_infer``: the hand-written kernel on a CUDA tensor, its plain
version on a CPU tensor. The kernel's folded fp32 arguments, and fuse_w
packed for the kernel of the parameters' dtype, are made at the first
forward and again after any event that may change the parameters:
``load_state_dict``, a move (``.to``, ``.cuda``), a ``train()``/``eval()``
switch, or ``clear_packed`` (``clear_packed_arguments`` for a whole
model; the trainer calls it after every optimizer step and restore).
Weights changed in place without one of these are not seen.
``act_scales`` (set by ``quant/int8.py::quantize_classifier``) makes the
call the int8 QDQ block.

In training mode the block runs ``forward_layers`` then dropout as torch
ops under autograd, as the JAX package differentiates its unfused block:
the reference has no backward kernel, so neither has the port.

Calibration needs the inputs of the block's layers, which the fused call
never writes out: inside ``layer_by_layer(model)`` the blocks run their
submodules one by one (conv1/2/3 -> concat -> fused_conv -> LeakyReLU ->
batch_norm), so forward pre-hooks on them see what the JAX package's
unfused block gives its layers. No engine runs that way.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch
from torch import nn

from rtdm_tpu_torch.models.layers import (BatchNorm, Conv, DepthwiseConv,
                                          Dropout, leaky_relu)
from rtdm_tpu_torch.ops.acff import (FuseOperands, Packed, acff_infer,
                                     pack_acff_params)
from rtdm_tpu_torch.quant.int8 import fake_quant_tensor


class ACFF(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 dropout_rate: float = 0.2):
        super().__init__()
        self.conv1 = DepthwiseConv(in_channels, 3, padding=0, dilation=1)
        self.conv2 = DepthwiseConv(in_channels, 3, padding=1, dilation=2)
        self.conv3 = DepthwiseConv(in_channels, 3, padding=2, dilation=3)
        self.fused_conv = Conv(3 * in_channels, out_channels, kernel_size=1)
        self.batch_norm = BatchNorm(out_channels)
        self.dropout = Dropout(dropout_rate)
        # (s_x1, s_x2, s_x3, s_f): int8 QDQ of the three depthwise inputs
        # and of the fuse input, or None
        self.act_scales: Optional[Sequence[float]] = None
        self.unfused = False
        self._packed: Optional[Packed] = None

    def _load_from_state_dict(self, *args, **kwargs):
        self._packed = None
        super()._load_from_state_dict(*args, **kwargs)

    def _apply(self, fn, *args, **kwargs):
        self._packed = None
        return super()._apply(fn, *args, **kwargs)

    def train(self, mode: bool = True):
        self._packed = None
        return super().train(mode)

    def clear_packed(self) -> None:
        """Forget the kernel's arguments: the next inference forward packs
        the parameters as they are then."""
        self._packed = None

    def packed(self) -> Packed:
        """The kernel's arguments for the loaded tensors: the fp32 ones of
        ``pack_acff_params``, then fuse_w packed for the kernel of the
        parameters' dtype (``FuseOperands``: ``pack_fuse_operand`` for
        bf16, ``pack_fuse_operand_tf32`` for fp32, and the launches of
        shapes that ``acff_decomposed`` cuts)."""
        if self._packed is None:
            state = {**dict(self.named_parameters()),
                     **dict(self.named_buffers())}
            args = pack_acff_params(state, self.batch_norm.epsilon)
            self._packed = (*args, FuseOperands(
                args[2], self.fused_conv.weight.dtype))
        return self._packed

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, C) -> (B, H-2, W-2, O) in x's dtype."""
        if self.training:
            return self.dropout(self.forward_layers(x))
        if self.unfused:
            return self.forward_layers(x)
        return acff_infer(self.kernel_input(x), *self.packed(),
                          act_scales=self.act_scales)

    def kernel_input(self, x: torch.Tensor) -> torch.Tensor:
        """x as the fused call takes it: contiguous; and in an int8 block an
        fp32 x (from a layer that leaves its output in fp32,
        ``Conv.round_output``) in bf16, QDQ'd once with s_x1 before the
        rounding where the three branch scales are equal (as calibration
        makes them: the branches see one input). The kernel's own QDQ
        returns that value unchanged (the bf16 rounding moves x / s by
        under 127 * 2^-9 < 1/2), so each branch reads bf16(QDQ(x)) of the
        unrounded x, as the compiled JAX int8 engine's do."""
        if self.act_scales is not None and x.dtype == torch.float32:
            s1, s2, s3, _ = self.act_scales
            if s1 == s2 == s3:
                x = fake_quant_tensor(x, s1)
            x = x.to(self.fused_conv.weight.dtype)
        return x.contiguous()

    def forward_layers(self, x: torch.Tensor) -> torch.Tensor:
        """The block layer by layer, NHWC, in x's dtype (no QDQ); its
        BatchNorm takes batch statistics in training mode."""
        feat = torch.cat([self.conv1(x), self.conv2(x), self.conv3(x)], -1)
        return self.batch_norm(leaky_relu(self.fused_conv(feat), 0.01))


def clear_packed_arguments(model: nn.Module) -> None:
    """``ACFF.clear_packed`` on every ACFF block of ``model``."""
    for m in model.modules():
        if isinstance(m, ACFF):
            m.clear_packed()


@contextlib.contextmanager
def layer_by_layer(model: nn.Module):
    """Inside the ``with``, every ACFF block of ``model`` runs
    ``forward_layers`` instead of the fused call."""
    blocks = [m for m in model.modules() if isinstance(m, ACFF)]
    for m in blocks:
        m.unfused = True
    try:
        yield model
    finally:
        for m in blocks:
            m.unfused = False
