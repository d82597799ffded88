"""ACFF — Atrous Convolution Feature Fusion block, inference.

Counterpart of ``rtdm_tpu/models/acff.py::ACFF``: three parallel depthwise
3x3 convs at dilation 1/2/3 with padding 0/1/2 (each branch shrinks H, W by
exactly 2), channel concat, 1x1 fuse conv, then — in this order —
LeakyReLU(0.01) BEFORE BatchNorm; Dropout is identity at inference.

The forward runs the whole block as one fused call, ``ops.acff.acff_infer``:
the hand-written kernel on a CUDA tensor, its plain version on a CPU tensor.
The kernel's folded fp32 arguments, and fuse_w packed for the kernel of
the parameters' dtype, are made at the first forward and again after
``load_state_dict`` or a move (``.to``, ``.cuda``); weights changed in
place without either are not seen. ``act_scales`` (set by
``quant/int8.py::quantize_classifier``) makes the call the int8 QDQ block.

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

from rtdm_tpu_torch.models.layers import BatchNorm, Conv, DepthwiseConv
from rtdm_tpu_torch.ops.acff import (Packed, acff_infer, pack_acff_params,
                                     pack_fuse_operand,
                                     pack_fuse_operand_tf32)
from rtdm_tpu_torch.quant.int8 import fake_quant_tensor


class ACFF(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv1 = DepthwiseConv(in_channels, 3, padding=0, dilation=1)
        self.conv2 = DepthwiseConv(in_channels, 3, padding=1, dilation=2)
        self.conv3 = DepthwiseConv(in_channels, 3, padding=2, dilation=3)
        self.fused_conv = Conv(3 * in_channels, out_channels, kernel_size=1)
        self.batch_norm = BatchNorm(out_channels)
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

    def packed(self) -> Packed:
        """The kernel's arguments for the loaded tensors: the fp32 ones of
        ``pack_acff_params``, then fuse_w in the B layout of the kernel of
        the parameters' dtype: ``pack_fuse_operand`` for bf16,
        ``pack_fuse_operand_tf32`` for fp32."""
        if self._packed is None:
            state = {**dict(self.named_parameters()),
                     **dict(self.named_buffers())}
            args = pack_acff_params(state, self.batch_norm.epsilon)
            bf16 = self.fused_conv.weight.dtype == torch.bfloat16
            pack = pack_fuse_operand if bf16 else pack_fuse_operand_tf32
            self._packed = (*args, pack(args[2]))
        return self._packed

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, C) -> (B, H-2, W-2, O) in x's dtype."""
        if self.training:
            raise NotImplementedError(
                "ACFF runs at inference only; training is ported in a later "
                "slice")
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
        """The block layer by layer, NHWC, in x's dtype (no QDQ)."""
        feat = torch.cat([self.conv1(x), self.conv2(x), self.conv3(x)], -1)
        out = torch.nn.functional.leaky_relu(self.fused_conv(feat), 0.01)
        return self.batch_norm(out)


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
