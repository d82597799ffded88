"""Darknet-cfg detectors, NHWC.

Counterpart of ``rtdm_tpu/models/darknet.py``. ``parse_darknet_cfg`` reads
the cfg DSL; ``Darknet`` builds its graph from it, with the JAX package's
module names (``l{i}_conv``, ``l{i}_bn``, ``l{i}_act``,
``l{i}_acff_conv1..3``, ``l{i}_acff_fused``, ``l{i}_acff_bn``, the
weighted shortcut's ``l{i}_w``), so a JAX variables tree loads one leaf per
tensor (``models/io.py``):

- convolutional: conv (pad k//2 if ``pad``, groups) + BN (eps 1e-4,
  momentum 0.003) +
  activation (leaky 0.1, swish, mish, relu, hardswish, relu6, logistic,
  linear, or the parametric frelu / aconc / meta_aconc). A conv followed by
  BN leaves its product unrounded for the BN, as the compiled JAX graph
  reads it in fp32;
- acff: the detector's additive ACFF (three dilated depthwise convs summed,
  1x1 fuse, LeakyReLU(0.01), BN with torch's momentum 0.1, then dropout at
  ``dropout_rate`` in training, its mask from the generator that
  ``layers.set_dropout_generator`` sets), in torch ops;
- maxpool: pad (k-1)//2 with -inf; the size-2 stride-1 pool pads the
  bottom and right with zeros (the reference's ZeroPad2d);
- upsample: integer nearest-neighbour repeat;
- route: channel concat, with ``groups``/``group_id`` channel slices and a
  nearest resize (half-pixel centres, as ``jax.image.resize``) where the
  sources' sizes differ;
- shortcut: sum with channel slicing on mismatch, optionally weighted by
  sigmoid(w) * 2/n;
- yolo: the raw map is returned, with ``YoloHead`` metadata for decode.

Loading darknet ``.weights`` and the fork's ``.pt`` checkpoints waits for
the tooling slice.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rtdm_tpu_torch.models.layers import (AconC, BatchNorm, Conv,
                                          DepthwiseConv, Dropout, FReLU,
                                          MetaAconC, leaky_relu, silu,
                                          softplus)
from rtdm_tpu_torch.ops.convpool import max_pool2d

PARAMETRIC_ACTIVATIONS = ("frelu", "aconc", "meta_aconc")


def parse_darknet_cfg(text_or_path: str) -> List[Dict[str, Any]]:
    """Parse darknet .cfg text into a list of block dicts (first is [net])."""
    if "\n" not in text_or_path:
        with open(text_or_path) as f:
            text = f.read()
    else:
        text = text_or_path
    blocks: List[Dict[str, Any]] = []
    for raw in text.splitlines():
        line = raw.split("#")[0].strip()
        if not line:
            continue
        if line.startswith("["):
            blocks.append({"type": line.strip("[]").strip()})
        elif "=" in line and blocks:
            key, val = (s.strip() for s in line.split("=", 1))
            blocks[-1][key] = _parse_value(key, val)
    return blocks


def _parse_value(key: str, val: str):
    if key in ("layers", "mask", "from"):
        return tuple(int(v) for v in val.split(","))
    if key == "anchors":
        nums = [float(v) for v in val.replace(" ", "").split(",") if v]
        return tuple((nums[i], nums[i + 1]) for i in range(0, len(nums), 2))
    if key in ("steps", "scales"):
        return tuple(float(v) for v in val.split(","))
    try:
        f = float(val)
        return int(f) if f.is_integer() and "." not in val else f
    except ValueError:
        return val


def _activation(name: str):
    if name == "leaky":
        return lambda x: leaky_relu(x, 0.1)
    if name in ("swish", "silu"):
        return silu
    if name == "mish":
        return lambda x: x * torch.tanh(softplus(x))
    if name == "relu":
        return torch.relu
    if name in ("hardswish", "hard_swish"):
        return lambda x: x * F.relu6(x + 3.0) / 6.0
    if name == "relu6":
        return lambda x: x.clamp(0, 6)
    if name == "logistic":
        return torch.sigmoid
    if name == "linear":
        return lambda x: x
    raise ValueError(f"unsupported activation '{name}'")


class YoloHead:
    """Static metadata for one [yolo] block."""

    def __init__(self, anchors_px: np.ndarray, num_classes: int,
                 layer_index: int, scale_x_y: float = 1.0,
                 new_coords: bool = False, v5: bool = False):
        self.anchors_px = np.asarray(anchors_px, np.float32)  # (na, 2)
        self.num_classes = int(num_classes)
        self.layer_index = int(layer_index)
        self.scale_x_y = float(scale_x_y)
        self.new_coords = bool(new_coords)
        self.v5 = bool(v5)

    @property
    def na(self) -> int:
        return self.anchors_px.shape[0]

    @property
    def no(self) -> int:
        return self.num_classes + 5


def _route_targets(defs: Sequence[Dict[str, Any]]) -> set:
    needed = set()
    for i, d in enumerate(defs):
        for key in ("layers", "from"):
            if key in d and d["type"] in ("route", "shortcut"):
                for li in d[key]:
                    needed.add(li if li >= 0 else i + li)
    return needed


class Darknet(nn.Module):
    """cfg-driven detector: ``forward`` returns the raw NHWC map of every
    [yolo] block (channels na*(5+nc)); ``heads`` holds their metadata."""

    def __init__(self, cfg_text: str, in_channels: int = 3,
                 dropout_rate: float = 0.2):
        super().__init__()
        self.cfg_text = cfg_text
        blocks = parse_darknet_cfg(cfg_text)
        self.net_info, self.defs = blocks[0], tuple(blocks[1:])
        self.needed = _route_targets(self.defs)
        heads, ch = [], []
        c = in_channels
        for i, d in enumerate(self.defs):
            t = d["type"]
            if t == "convolutional":
                k = int(d.get("size", 1))
                bn = bool(d.get("batch_normalize", 0))
                conv = Conv(c, int(d["filters"]), k, int(d.get("stride", 1)),
                            (k - 1) // 2 if d.get("pad", 0) else 0,
                            groups=int(d.get("groups", 1)), use_bias=not bn)
                conv.round_output = not bn
                self.add_module(f"l{i}_conv", conv)
                c = int(d["filters"])
                if bn:
                    self.add_module(f"l{i}_bn", BatchNorm(c, 1e-4, 0.003))
                act = d.get("activation", "linear")
                if act == "frelu":
                    self.add_module(f"l{i}_act", FReLU(c))
                elif act == "aconc":
                    self.add_module(f"l{i}_act", AconC(c))
                elif act == "meta_aconc":
                    self.add_module(f"l{i}_act", MetaAconC(c))
                else:
                    _activation(act)        # unknown names fail here
            elif t == "acff":
                k, o = int(d.get("size", 3)), int(d["filters"])
                for j, dil in ((1, 1), (2, 2), (3, 3)):
                    self.add_module(f"l{i}_acff_conv{j}", DepthwiseConv(
                        c, k, 1, padding=dil - 1, dilation=dil))
                self.add_module(f"l{i}_acff_fused", Conv(c, o, 1))
                self.add_module(f"l{i}_acff_bn", BatchNorm(o))
                self.add_module(f"l{i}_acff_drop", Dropout(dropout_rate))
                c = o
            elif t == "route":
                g = int(d.get("groups", 1))
                c = sum(ch[li if li >= 0 else i + li] // g
                        for li in d["layers"])
            elif t == "shortcut" and "weights_type" in d:
                self.register_parameter(
                    f"l{i}_w", nn.Parameter(torch.zeros(len(d["from"]) + 1)))
            elif t == "yolo":
                anchors = np.array(d["anchors"], np.float32)[list(d["mask"])]
                heads.append(YoloHead(
                    anchors, d.get("classes", 80), i,
                    scale_x_y=float(d.get("scale_x_y", 1.0)),
                    new_coords=bool(d.get("new_coords", 0))))
            elif t not in ("maxpool", "upsample", "shortcut", "reorg3d",
                           "dropout"):
                raise ValueError(f"unsupported block [{t}] at layer {i}")
            ch.append(c)
        self.heads = tuple(heads)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outputs: List[Optional[torch.Tensor]] = []
        yolo_raw: List[torch.Tensor] = []
        for i, d in enumerate(self.defs):
            t = d["type"]
            if t == "convolutional":
                x = getattr(self, f"l{i}_conv")(x)
                if d.get("batch_normalize", 0):
                    x = getattr(self, f"l{i}_bn")(x)
                act = d.get("activation", "linear")
                if act in PARAMETRIC_ACTIVATIONS:
                    x = getattr(self, f"l{i}_act")(x)
                else:
                    x = _activation(act)(x)
            elif t == "acff":
                x = self._acff(i, x)
            elif t == "maxpool":
                k, s = int(d["size"]), int(d["stride"])
                if k == 2 and s == 1:
                    x = max_pool2d(F.pad(x, (0, 0, 0, 1, 0, 1)), 2, 1)
                else:
                    x = max_pool2d(x, k, s, (k - 1) // 2)
            elif t == "upsample":
                s = int(d["stride"])
                x = x.repeat_interleave(s, 1).repeat_interleave(s, 2)
            elif t == "route":
                srcs = [outputs[li if li >= 0 else i + li]
                        for li in d["layers"]]
                g = int(d.get("groups", 1))
                if g > 1:
                    gid = int(d.get("group_id", 0))
                    srcs = [s[..., (s.shape[-1] // g) * gid:
                              (s.shape[-1] // g) * (gid + 1)] for s in srcs]
                x = _concat_with_resize(srcs)
            elif t == "shortcut":
                x = self._shortcut(i, d, x, outputs)
            elif t == "yolo":
                yolo_raw.append(x)
            outputs.append(x if i in self.needed else None)
        return yolo_raw

    def _acff(self, i: int, x: torch.Tensor) -> torch.Tensor:
        out = (getattr(self, f"l{i}_acff_conv1")(x)
               + getattr(self, f"l{i}_acff_conv2")(x)
               + getattr(self, f"l{i}_acff_conv3")(x))
        out = leaky_relu(getattr(self, f"l{i}_acff_fused")(out), 0.01)
        return getattr(self, f"l{i}_acff_drop")(
            getattr(self, f"l{i}_acff_bn")(out))

    def _shortcut(self, i: int, d: Dict[str, Any], x: torch.Tensor,
                  outputs: List[Optional[torch.Tensor]]) -> torch.Tensor:
        layers = d["from"]
        weighted = "weights_type" in d
        if weighted:
            w_raw = getattr(self, f"l{i}_w")
            w = (torch.sigmoid(w_raw) * (2.0 / (len(layers) + 1))).to(x.dtype)
            x = x * w[0]
        nc = x.shape[-1]
        for j, li in enumerate(layers):
            a = outputs[li if li >= 0 else i + li]
            if weighted:
                a = a * w[j + 1]
            ac = a.shape[-1]
            if nc == ac:
                x = x + a
            elif nc > ac:       # add into the leading channels
                x = torch.cat([x[..., :ac] + a, x[..., ac:]], -1)
            else:
                x = x + a[..., :nc]
        return x


def _concat_with_resize(srcs: List[torch.Tensor]) -> torch.Tensor:
    """Channel concat; a source of another size is resized to the largest
    by nearest neighbour with half-pixel centres (``jax.image.resize``
    'nearest' is torch's 'nearest-exact', not its 'nearest')."""
    if len(srcs) == 1:
        return srcs[0]
    hmax = max(s.shape[1] for s in srcs)
    wmax = max(s.shape[2] for s in srcs)
    fixed = []
    for s in srcs:
        if s.shape[1] != hmax or s.shape[2] != wmax:
            s = F.interpolate(s.permute(0, 3, 1, 2), size=(hmax, wmax),
                              mode="nearest-exact").permute(0, 2, 3, 1)
        fixed.append(s)
    return torch.cat(fixed, -1)


def load_cfg_text(path: str) -> str:
    with open(path) as f:
        return f.read()


def create_darknet(cfg_path: str, **kwargs) -> Darknet:
    return Darknet(load_cfg_text(cfg_path), **kwargs)


def init_darknet(model: nn.Module, seed: int = 0) -> Dict[str, Any]:
    """Fresh weights for ``model`` from ``seed`` (he-normal conv kernels,
    zero biases, unit BN scales and variances), loaded into it; returns
    them as a JAX-layout variables tree. The numbers differ from the JAX
    package's init for the same seed."""
    from rtdm_tpu_torch.models.io import variables_from_torch_state_dict
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if p.dim() >= 2:
                fan_in = p[0].numel()
                p.copy_(torch.randn(p.shape, generator=gen)
                        * np.sqrt(2.0 / fan_in))
            elif leaf in ("p1", "p2"):
                p.copy_(torch.randn(p.shape, generator=gen))
            elif leaf in ("weight", "beta"):
                p.fill_(1.0)
            else:
                p.zero_()
    return variables_from_torch_state_dict(model.state_dict())


def load_darknet_weights(*args, **kwargs):
    raise NotImplementedError(
        "darknet .weights import is not ported yet (ROADMAP queue 1, "
        "tooling); convert the weights to .npz with the JAX package")


def load_darknet_torch_checkpoint(*args, **kwargs):
    raise NotImplementedError(
        "the fork's .pt checkpoint import is not ported yet (ROADMAP queue "
        "1, tooling); convert it to .npz with the JAX package")
