"""ACFF — Atrous Convolution Feature Fusion block.

Counterpart of ``rtdm_tpu/models/acff.py::ACFF``: three parallel depthwise
3x3 convs at dilation 1/2/3 with padding 0/1/2 (each branch shrinks H, W by
exactly 2), channel concat, 1x1 fuse conv, then — in this order —
LeakyReLU(0.01) BEFORE BatchNorm, then Dropout(rate).

At inference the forward runs the whole block as one fused call, the
registered op ``rtdm::acff_infer`` (``ops/acff.py::acff_infer_op``, which
``torch.export`` keeps as one node): the hand-written kernel on a CUDA
tensor, its plain version on a CPU tensor. The kernel's folded fp32
arguments, and fuse_w packed for the kernel of the parameters' dtype
(every operand a launch at the input's H x W may read,
``FuseOperands.for_shape``; none on the CPU), and the op's arguments
for each input H x W, are made at the first forward and again after
any event that may change the parameters:
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

``split_fuse=True`` (JAX ``_SplitFusedConv1x1``) makes ``forward_layers``
compute the 1x1 fuse as three per-branch 1x1 convs over the slices
``[i*C:(i+1)*C]`` of ``fused_conv.weight``, summed in the branches' dtype
(each sum rounded, as the compiled JAX bf16 block rounds it), then the
bias: no 3C concat is built. The parameters keep their names
(``fused_conv.weight`` / ``.bias``), so every checkpoint loads unchanged.
Training and ``layer_by_layer`` take that route; the inference forward
calls ``rtdm::acff_infer`` whatever the flag says, since the kernel never
builds the concat either.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from rtdm_tpu_torch.models.layers import (BatchNorm, Conv, DepthwiseConv,
                                          Dropout, conv_product, leaky_relu)
from rtdm_tpu_torch.ops.acff import (FuseOperands, Packed, acff_infer_op,
                                     pack_acff_params)
from rtdm_tpu_torch.quant.int8 import fake_quant_tensor


class ACFF(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 dropout_rate: float = 0.2, split_fuse: bool = False):
        super().__init__()
        self.split_fuse = split_fuse
        self.conv1 = DepthwiseConv(in_channels, 3, padding=0, dilation=1)
        self.conv2 = DepthwiseConv(in_channels, 3, padding=1, dilation=2)
        self.conv3 = DepthwiseConv(in_channels, 3, padding=2, dilation=3)
        self.fused_conv = Conv(3 * in_channels, out_channels, kernel_size=1)
        self.batch_norm = BatchNorm(out_channels)
        self.dropout = Dropout(dropout_rate)
        self.unfused = False
        self._packed: Optional[Packed] = None
        # the op's arguments after x, by (H, W, on CUDA)
        self._op_args: Dict[Tuple[int, int, bool], tuple] = {}
        # (s_x1, s_x2, s_x3, s_f): int8 QDQ of the three depthwise inputs
        # and of the fuse input, or None
        self.act_scales: Optional[Sequence[float]] = None

    @property
    def act_scales(self) -> Optional[Sequence[float]]:
        return self._act_scales

    @act_scales.setter
    def act_scales(self, scales: Optional[Sequence[float]]) -> None:
        self._act_scales = scales
        self._op_args = {}

    def _load_from_state_dict(self, *args, **kwargs):
        self.clear_packed()
        super()._load_from_state_dict(*args, **kwargs)

    def _apply(self, fn, *args, **kwargs):
        self.clear_packed()
        return super()._apply(fn, *args, **kwargs)

    def train(self, mode: bool = True):
        self.clear_packed()
        return super().train(mode)

    def clear_packed(self) -> None:
        """Forget the kernel's arguments: the next inference forward packs
        the parameters as they are then."""
        self._packed = None
        self._op_args = {}

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
        x = self.kernel_input(x)
        key = (x.shape[1], x.shape[2], x.is_cuda)
        args = self._op_args.get(key)
        if args is None:
            *packed, fuse = self.packed()
            scales = (None if self.act_scales is None
                      else [float(s) for s in self.act_scales])
            operands = (fuse.for_shape(key[0], key[1], scales) if key[2]
                        else [])
            args = self._op_args[key] = (*packed, operands, scales)
        return acff_infer_op(x, *args)

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
        branches = [self.conv1(x), self.conv2(x), self.conv3(x)]
        if self.split_fuse:
            out = self._split_fused_conv(branches)
        else:
            out = self.fused_conv(torch.cat(branches, -1))
        return self.batch_norm(leaky_relu(out, 0.01))

    def _split_fused_conv(self, branches) -> torch.Tensor:
        """``fused_conv`` over the concat of ``branches``, as the sum of a
        1x1 conv a branch over its slice of the weight, in the branches'
        dtype, then the bias."""
        c = branches[0].shape[-1]
        weight = self.fused_conv.weight.to(branches[0].dtype)
        out = None
        for i, b in enumerate(branches):
            y = conv_product(b, weight[:, i * c:(i + 1) * c])
            out = y if out is None else out + y
        return out + self.fused_conv.bias.to(out.dtype)


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
