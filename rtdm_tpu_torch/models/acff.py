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
place without either are not seen.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from rtdm_tpu_torch.models.layers import BatchNorm, Conv, DepthwiseConv
from rtdm_tpu_torch.ops.acff import (Packed, acff_infer, pack_acff_params,
                                     pack_fuse_operand,
                                     pack_fuse_operand_tf32)


class ACFF(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv1 = DepthwiseConv(in_channels, 3, padding=0, dilation=1)
        self.conv2 = DepthwiseConv(in_channels, 3, padding=1, dilation=2)
        self.conv3 = DepthwiseConv(in_channels, 3, padding=2, dilation=3)
        self.fused_conv = Conv(3 * in_channels, out_channels, kernel_size=1)
        self.batch_norm = BatchNorm(out_channels)
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
        return acff_infer(x.contiguous(), *self.packed())
