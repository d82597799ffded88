"""ErNET classifier family (EmergencyNet), NHWC in.

Counterpart of ``rtdm_tpu/models/ernet.py``: SqueezeErNET and
SqueezeRedConv at 140x140, ErNET at 240x240, all built around the ACFF
block. Submodules are named as the JAX variables tree is, so
``models/io.py`` maps weights one to one and ``load_state_dict(strict=True)``
leaves no key over.

Shape flow:
- SqueezeErNET @140: 140 ->conv s2-> 69 ->acff-> 67 ->pool-> 33 ->acff-> 31
  ->pool-> 15 ->acff-> 13 ->pool-> 6 ->acff-> 4 ->1x1-> 4x4x5
  ->avgpool(5,1,1)-> 2x2x5 ->fc(20->5)->softmax.
- SqueezeRedConv adds 1x1 reductions 16->8 / 96->48 / 128->64.
- ErNET @240: 6 ACFFs, avgpool(5,1,0) -> 3x3x5 -> fc(45->5).

The flatten before fc follows torch's NCHW order, as the JAX model's does.
In training mode (``model.train()``) a forward returns logits without the
softmax, as the JAX models do with ``train=True``, and each ACFF block ends
in Dropout(``dropout_rate``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from rtdm_tpu_torch.core.device import resolve_device
from rtdm_tpu_torch.models.acff import ACFF
from rtdm_tpu_torch.models.io import infer_num_classes
from rtdm_tpu_torch.models.layers import Conv, Dense, init_he_normal
from rtdm_tpu_torch.ops.convpool import (avg_pool2d, avg_pool2d_sequential,
                                         max_pool2d)

NUM_CLASSES = 5
CLASS_NAMES = ("collapsed_building", "fire", "flooded_areas", "normal",
               "traffic_incident")


def _nchw_flatten(x: torch.Tensor) -> torch.Tensor:
    """Flatten NHWC in torch's (C,H,W) order for fc-weight compatibility."""
    return x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)


def _stem(size: int) -> int:
    return (size - 3) // 2 + 1           # conv1: 3x3, stride 2


class _ErnetHead(nn.Module):
    """1x1 conv -> odd avg-pool -> flatten -> fc -> (optional) softmax."""

    def __init__(self, in_channels: int, spatial: int, pool_padding: int,
                 num_classes: int = NUM_CLASSES):
        super().__init__()
        self.pool_padding = pool_padding
        pooled = spatial + 2 * pool_padding - 5 + 1
        self.conv2 = Conv(in_channels, num_classes, kernel_size=1,
                          use_bias=False)
        self.fc = Dense(num_classes * pooled * pooled, num_classes)
        # the int8 engine pools as the compiled JAX int8 engine rounds
        # (ops/convpool.py::avg_pool2d_sequential)
        self.sequential_pool = False

    def forward(self, x: torch.Tensor,
                apply_softmax: bool = True) -> torch.Tensor:
        x = self.conv2(x)
        if self.sequential_pool:
            x = avg_pool2d_sequential(x, 5, self.pool_padding)
        else:
            x = avg_pool2d(x, 5, 1, self.pool_padding,
                           count_include_pad=True)
        x = self.fc(_nchw_flatten(x))
        if apply_softmax:
            x = torch.softmax(x.float(), dim=-1)
        return x


# Layers whose output the int8 engine leaves in fp32 (``Conv.round_output``):
# those the next layer's QDQ reads straight from them, and the logits. The
# compiled JAX int8 engine rounds them to bf16 nowhere (XLA drops a bf16
# rounding that an fp32 read follows at once).
_UNROUNDED = ("conv1", "head.fc")


class SqueezeErNET(nn.Module):
    """Squeeze variant; input 140x140x3 NHWC."""
    UNROUNDED_IN_INT8 = _UNROUNDED

    def __init__(self, image_size: int = 140, num_classes: int = NUM_CLASSES,
                 dropout_rate: float = 0.2, split_fuse: bool = False):
        super().__init__()
        self.image_size, self.num_classes = image_size, num_classes
        self.dropout_rate, self.split_fuse = dropout_rate, split_fuse
        s = _stem(image_size)
        self.conv1 = Conv(3, 16, 3, stride=2, use_bias=False)
        self.acff1 = ACFF(16, 64, dropout_rate, split_fuse)
        self.acff2 = ACFF(64, 96, dropout_rate, split_fuse)
        self.acff3 = ACFF(96, 128, dropout_rate, split_fuse)
        self.acff4 = ACFF(128, 256, dropout_rate, split_fuse)
        for _ in range(3):
            s = (s - 2) // 2
        self.head = _ErnetHead(256, s - 2, 1, num_classes)

    def forward(self, x: torch.Tensor,
                apply_softmax: bool = True) -> torch.Tensor:
        x = self.conv1(x)
        x = max_pool2d(self.acff1(x), 2, 2)
        x = max_pool2d(self.acff2(x), 2, 2)
        x = max_pool2d(self.acff3(x), 2, 2)
        return self.head(self.acff4(x), apply_softmax and not self.training)


class SqueezeRedConv(nn.Module):
    """Variant with 1x1 reduction convs; input 140x140x3."""
    UNROUNDED_IN_INT8 = _UNROUNDED + ("conv_red1", "conv_red3")

    def __init__(self, image_size: int = 140, num_classes: int = NUM_CLASSES,
                 dropout_rate: float = 0.2, split_fuse: bool = False):
        super().__init__()
        self.image_size, self.num_classes = image_size, num_classes
        self.dropout_rate, self.split_fuse = dropout_rate, split_fuse
        s = _stem(image_size)
        self.conv1 = Conv(3, 16, 3, stride=2, use_bias=False)
        self.conv_red1 = Conv(16, 8, kernel_size=1)
        self.acff1 = ACFF(8, 64, dropout_rate, split_fuse)
        self.acff2 = ACFF(64, 96, dropout_rate, split_fuse)
        self.conv_red2 = Conv(96, 48, kernel_size=1)
        self.acff3 = ACFF(48, 128, dropout_rate, split_fuse)
        self.conv_red3 = Conv(128, 64, kernel_size=1)
        self.acff4 = ACFF(64, 256, dropout_rate, split_fuse)
        for _ in range(3):
            s = (s - 2) // 2
        self.head = _ErnetHead(256, s - 2, 1, num_classes)

    def forward(self, x: torch.Tensor,
                apply_softmax: bool = True) -> torch.Tensor:
        x = self.conv_red1(self.conv1(x))
        x = max_pool2d(self.acff1(x), 2, 2)
        x = max_pool2d(self.conv_red2(self.acff2(x)), 2, 2)
        x = max_pool2d(self.acff3(x), 2, 2)
        return self.head(self.acff4(self.conv_red3(x)),
                         apply_softmax and not self.training)


class ErNET(nn.Module):
    """EmergencyNet baseline; input 240x240x3."""
    UNROUNDED_IN_INT8 = _UNROUNDED

    def __init__(self, image_size: int = 240, num_classes: int = NUM_CLASSES,
                 dropout_rate: float = 0.2, split_fuse: bool = False):
        super().__init__()
        self.image_size, self.num_classes = image_size, num_classes
        self.dropout_rate, self.split_fuse = dropout_rate, split_fuse
        s = _stem(image_size)
        self.conv1 = Conv(3, 16, 3, stride=2, use_bias=False)
        self.acff1 = ACFF(16, 64, dropout_rate, split_fuse)
        self.acff2 = ACFF(64, 96, dropout_rate, split_fuse)
        self.acff3 = ACFF(96, 128, dropout_rate, split_fuse)
        self.acff4 = ACFF(128, 128, dropout_rate, split_fuse)
        self.acff5 = ACFF(128, 128, dropout_rate, split_fuse)
        self.acff6 = ACFF(128, 256, dropout_rate, split_fuse)
        for _ in range(3):
            s = (s - 2) // 2
        self.head = _ErnetHead(256, s - 6, 0, num_classes)

    def forward(self, x: torch.Tensor,
                apply_softmax: bool = True) -> torch.Tensor:
        x = self.conv1(x)
        x = max_pool2d(self.acff1(x), 2, 2)
        x = max_pool2d(self.acff2(x), 2, 2)
        x = max_pool2d(self.acff3(x), 2, 2)
        x = self.acff6(self.acff5(self.acff4(x)))
        return self.head(x, apply_softmax and not self.training)


MODEL_REGISTRY = {
    "ernet": ErNET,
    "squeeze-ernet": SqueezeErNET,
    "squeeze_ernet": SqueezeErNET,
    "squeeze-redconv": SqueezeRedConv,
    "squeeze_redconv": SqueezeRedConv,
    "squeeze-ernet-redconv": SqueezeRedConv,
}


def create_model(name: str, device="cuda",
                 generator: Optional[torch.Generator] = None,
                 **kwargs) -> nn.Module:
    """Build a classifier in eval mode on ``device``, its conv and dense
    weights drawn from flax's He-normal (``layers.init_he_normal``) with
    ``generator`` (a CPU generator; seed 0 when none is given), so that one
    seed gives one start. ``kwargs`` go to the class (``image_size``,
    ``num_classes``, ``dropout_rate``, ``split_fuse``: the ACFF blocks'
    concat-free fuse, ``models/acff.py``)."""
    key = name.lower()
    if key not in MODEL_REGISTRY:
        raise ValueError(f"unknown model '{name}'; "
                         f"choices: {sorted(set(MODEL_REGISTRY))}")
    device = resolve_device(device)
    model = MODEL_REGISTRY[key](**kwargs)
    init_he_normal(model, generator if generator is not None
                   else torch.Generator().manual_seed(0))
    return model.to(device).eval()


def input_size_for(name: str) -> int:
    """ernet -> 240, squeeze variants -> 140."""
    return 240 if name.lower() == "ernet" else 140


def with_checkpoint_head(model: nn.Module, variables) -> nn.Module:
    """Rebuild `model` with num_classes matching the checkpoint's fc head,
    on the same device."""
    nc = infer_num_classes(variables)
    if nc and model.num_classes != nc:
        device = next(model.parameters()).device
        model = type(model)(image_size=model.image_size, num_classes=nc,
                            dropout_rate=model.dropout_rate,
                            split_fuse=model.split_fuse)
        model = model.to(device).eval()
    return model
