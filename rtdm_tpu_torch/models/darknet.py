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

``load_darknet_weights`` and ``save_darknet_weights`` read and write
darknet ``.weights`` files; ``load_darknet_torch_checkpoint`` reads the
fork's ``.pt`` checkpoints, ACFF blocks and fusion weights included. All
three work on JAX-layout trees of numpy arrays, as the JAX package's do.
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


def load_darknet_weights(variables: Dict[str, Any], cfg_text: str,
                         weights_path: str) -> Dict[str, Any]:
    """``variables`` with every conv of the cfg filled from a darknet
    ``.weights`` file: int32[3] version and int64 images seen, then for
    each conv in cfg order [bn_bias, bn_scale, bn_mean, bn_var, kernel
    OIHW] with BN or [bias, kernel OIHW] without. ``[acff]`` blocks are the
    fork's extension and never appear in such files."""
    from rtdm_tpu_torch.models.io import numpy_tree
    defs = parse_darknet_cfg(cfg_text)[1:]
    with open(weights_path, "rb") as f:
        np.fromfile(f, dtype=np.int32, count=3)
        np.fromfile(f, dtype=np.int64, count=1)
        w = np.fromfile(f, dtype=np.float32)
    variables = numpy_tree(variables)
    params = variables["params"]
    stats = variables.setdefault("batch_stats", {})
    ptr = 0

    def take(n):
        nonlocal ptr
        out = w[ptr:ptr + n]
        ptr += n
        return out.copy()

    for i, d in enumerate(defs):
        if d["type"] != "convolutional":
            continue
        kh, kw, cin, cout = params[f"l{i}_conv"]["kernel"].shape
        if d.get("batch_normalize", 0):
            bn = params[f"l{i}_bn"]
            bn["bias"], bn["scale"] = take(cout), take(cout)
            st = stats.setdefault(f"l{i}_bn", {})
            st["mean"], st["var"] = take(cout), take(cout)
        else:
            params[f"l{i}_conv"]["bias"] = take(cout)
        oihw = take(cout * cin * kh * kw).reshape(cout, cin, kh, kw)
        params[f"l{i}_conv"]["kernel"] = np.ascontiguousarray(
            oihw.transpose(2, 3, 1, 0))
    if ptr != len(w):
        raise ValueError(f"weights file size mismatch: used {ptr} of "
                         f"{len(w)}")
    return variables


def save_darknet_weights(variables: Dict[str, Any], cfg_text: str,
                         weights_path: str) -> None:
    """Write the convs of ``variables`` as a darknet ``.weights`` file
    (version 0.2.5, 0 images seen), the layout ``load_darknet_weights``
    reads."""
    defs = parse_darknet_cfg(cfg_text)[1:]
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    chunks = [np.array([0, 2, 5], np.int32).tobytes(),
              np.array([0], np.int64).tobytes()]
    for i, d in enumerate(defs):
        if d["type"] != "convolutional":
            continue
        kernel = np.asarray(params[f"l{i}_conv"]["kernel"], np.float32)
        if d.get("batch_normalize", 0):
            bn, st = params[f"l{i}_bn"], stats[f"l{i}_bn"]
            for arr in (bn["bias"], bn["scale"], st["mean"], st["var"]):
                chunks.append(np.asarray(arr, np.float32).tobytes())
        else:
            chunks.append(np.asarray(params[f"l{i}_conv"]["bias"],
                                     np.float32).tobytes())
        chunks.append(np.ascontiguousarray(
            kernel.transpose(3, 2, 0, 1)).tobytes())
    with open(weights_path, "wb") as f:
        f.writelines(chunks)


# the fork's ACFF submodules -> the port's names (l{i}_acff_<name>)
_ACFF_MODULES = {"conv1": "conv1", "conv2": "conv2", "conv3": "conv3",
                 "fused_conv": "fused", "batch_norm": "bn"}
_BN_LEAVES = {"weight": ("params", "scale"), "bias": ("params", "bias"),
              "running_mean": ("batch_stats", "mean"),
              "running_var": ("batch_stats", "var")}


def load_darknet_torch_checkpoint(variables: Dict[str, Any], cfg_text: str,
                                  path: str) -> Dict[str, Any]:
    """``variables`` filled from the fork's torch checkpoint (``{'model':
    state_dict}`` with keys ``module_list.{i}.Conv2d.*``,
    ``.BatchNorm2d.*``, ``.acff_{i}.<conv1|conv2|conv3|fused_conv|
    batch_norm>.*`` and a weighted shortcut's ``.w``)."""
    from rtdm_tpu_torch.models.io import numpy_tree
    from rtdm_tpu_torch.models.torch_import import load_torch_state_dict
    sd = load_torch_state_dict(path)
    if not any(k.startswith("module_list") for k in sd):
        raise ValueError(f"not a darknet-fork checkpoint: {path}")
    variables = numpy_tree(variables)
    trees = {"params": variables["params"],
             "batch_stats": variables.setdefault("batch_stats", {})}

    def put(name, leaf, val):
        if leaf in _BN_LEAVES:
            coll, slot = _BN_LEAVES[leaf]
            trees[coll].setdefault(name, {})[slot] = val.astype(np.float32)

    for key, val in sd.items():
        parts = key.split(".")
        if parts[0] != "module_list" or val.ndim == 0:
            continue
        i, sub, leaf = int(parts[1]), parts[2], parts[-1]
        if sub == "w":
            trees["params"][f"l{i}_w"] = val.astype(np.float32)
            continue
        if sub == "BatchNorm2d":
            put(f"l{i}_bn", leaf, val)
            continue
        if sub == "Conv2d":
            name = f"l{i}_conv"
        elif sub.startswith("acff") and parts[3] in _ACFF_MODULES:
            name = f"l{i}_acff_{_ACFF_MODULES[parts[3]]}"
            if parts[3] == "batch_norm":
                put(name, leaf, val)
                continue
        else:
            continue
        tgt = trees["params"][name]
        if leaf == "weight":
            tgt["kernel"] = np.transpose(val, (2, 3, 1, 0)).astype(np.float32)
        else:
            tgt["bias"] = val.astype(np.float32)
    return variables
