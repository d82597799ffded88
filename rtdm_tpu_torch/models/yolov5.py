"""YOLOv5 yaml detectors, NHWC.

Counterpart of ``rtdm_tpu/models/yolov5.py`` for the blocks that
``yolov5s.yaml`` uses: ``ConvBnSiLU`` (conv without bias, BN eps 1e-3
and momentum 0.03, SiLU), ``Focus`` (2x2 space-to-depth, then a conv), ``Bottleneck``,
``C3``, ``SPP``, ``Concat``, ``nn.Upsample`` and ``Detect`` (a 1x1 conv
with bias per level, raw maps out, with v5 decode metadata). Module names
follow the JAX tree (``m{i}``, ``m{i}_{j}`` for an n>1 repeat of a plain
module, ``m{i}/cv1/conv``, ``m{i}_m{level}`` for the Detect convs), so a
JAX variables tree loads one leaf per tensor. Channel arithmetic (depth
and width multiples, ``make_divisible``) is resolved by ``build_plan``.

Rounding as the compiled JAX graph rounds a bf16 model: the conv's product
goes to BN unrounded; SiLU runs its bf16 steps (``layers.silu``). With
``keep_fp32`` (set by ``quant/int8.py::quantize_detector``) a ConvBnSiLU
returns its SiLU product, and a Bottleneck its residual sum, in fp32: the
int8 program QDQs the result of an arithmetic step without rounding it to
bf16 first. Every other consumer (a residual add, a concat, a pool, an
upsample) rounds it to bf16 first.

``parse_v5_yaml`` reads the yaml subset these model files use (a mapping
of scalars, flow lists and block lists of flow lists) without PyYAML
(``utils/yaml_io.py``). The
rest of the v5 block zoo (BottleneckCSP, C3TR/TransformerBlock, DWConv,
CrossConv, GhostConv/GhostBottleneck, MixConv2d, Sum, Classify,
Contract/Expand) and the ``up_to`` prefix forward are not ported yet and
raise.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from rtdm_tpu_torch.models.darknet import YoloHead
from rtdm_tpu_torch.models.layers import BatchNorm, Conv, acc_dtype, silu
from rtdm_tpu_torch.ops.convpool import max_pool2d
from rtdm_tpu_torch.utils import yaml_io

NOT_PORTED = ("BottleneckCSP", "C3TR", "DWConv", "CrossConv", "GhostConv",
              "GhostBottleneck", "MixConv2d", "Sum", "Classify", "Contract",
              "Expand")


def make_divisible(x: float, divisor: int = 8) -> int:
    return int(math.ceil(x / divisor) * divisor)


def autopad(k, p=None):
    if p is not None:
        return p
    if isinstance(k, (tuple, list)):
        return tuple(x // 2 for x in k)
    return k // 2


def parse_v5_yaml(yaml_text: str, nc_override: Optional[int] = None
                  ) -> Dict[str, Any]:
    """The model file as a dict, as ``yaml.safe_load`` reads it
    (``utils/yaml_io.py``), with ``nc`` replaced by ``nc_override`` if
    given."""
    out = yaml_io.loads(yaml_text)
    if nc_override is not None:
        out["nc"] = nc_override
    return out


def build_plan(d: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Resolve channels and depth like the reference's parse_model."""
    nc, gd, gw = d["nc"], d["depth_multiple"], d["width_multiple"]
    anchors = d["anchors"]
    na = len(anchors[0]) // 2 if isinstance(anchors, list) else anchors
    no = na * (nc + 5)
    ch = [3]
    plan = []
    for i, (f, n, m, args) in enumerate(d["backbone"] + d["head"]):
        args = list(args)
        n_rep = max(round(n * gd), 1) if n > 1 else n
        entry = {"i": i, "f": f, "module": m, "n": n_rep, "args": args}
        if m in ("Conv", "GhostConv", "Bottleneck", "GhostBottleneck",
                 "SPP", "DWConv", "MixConv2d", "Focus", "CrossConv",
                 "BottleneckCSP", "C3", "C3TR"):
            c2 = args[0]
            if c2 != no:
                c2 = make_divisible(c2 * gw, 8)
            entry["args"] = [c2] + args[1:]
        elif m == "Concat":
            c2 = sum(ch[x] for x in f)
        elif m == "Classify":
            c2 = args[0]
        elif m == "Detect":
            entry["ch_in"] = [ch[x] for x in f]
            c2 = no
        elif m == "Contract":
            c2 = ch[f] * args[0] ** 2
        elif m == "Expand":
            c2 = ch[f] // args[0] ** 2
        else:
            c2 = ch[f if isinstance(f, int) else f[0]]
        entry["c2"] = c2
        entry["c1"] = (ch[f] if isinstance(f, int)
                       else [ch[x] for x in f])
        plan.append(entry)
        if i == 0:
            ch = []
        ch.append(c2)
    return plan


# ---------------------------------------------------------------------------
# blocks


class ConvBnSiLU(nn.Module):
    def __init__(self, c1: int, c2: int, k=1, s=1, p=None, g: int = 1,
                 act: bool = True):
        super().__init__()
        self.conv = Conv(c1, c2, k, s, autopad(k, p), groups=g,
                         use_bias=False)
        self.conv.round_output = False       # BN reads the product in fp32
        self.bn = BatchNorm(c2, 1e-3, 0.03)
        self.act = act
        self.keep_fp32 = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.conv.weight.dtype
        y = self.conv(x)
        y = (self.bn(y) if self.training else self.bn.affine(y)).to(dtype)
        if not self.act:
            return y
        return silu(y, round_output=not self.keep_fp32)


class Focus(nn.Module):
    def __init__(self, c1: int, c2: int, k=1, s=1):
        super().__init__()
        self.conv = ConvBnSiLU(c1 * 4, c2, k, s)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.cat([x[:, ::2, ::2], x[:, 1::2, ::2], x[:, ::2, 1::2],
                       x[:, 1::2, 1::2]], -1)
        return self.conv(x)


class Bottleneck(nn.Module):
    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1,
                 e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBnSiLU(c1, c_, 1)
        self.cv2 = ConvBnSiLU(c_, c2, 3, g=g)
        self.add = shortcut and c1 == c2
        self.keep_fp32 = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.cv2(self.cv1(x))
        if not self.add:
            return out
        dtype = self.cv1.conv.weight.dtype
        acc = acc_dtype(out)
        y = x.to(dtype).to(acc) + out.to(dtype).to(acc)
        return y if self.keep_fp32 else y.to(dtype)


class C3(nn.Module):
    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True,
                 g: int = 1, e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBnSiLU(c1, c_, 1)
        self.cv2 = ConvBnSiLU(c1, c_, 1)
        self.cv3 = ConvBnSiLU(2 * c_, c2, 1)
        self.n = n
        for j in range(n):
            self.add_module(f"m{j}", Bottleneck(c_, c_, shortcut, g, 1.0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y1 = self.cv1(x)
        for j in range(self.n):
            y1 = getattr(self, f"m{j}")(y1)
        dtype = self.cv1.conv.weight.dtype
        return self.cv3(torch.cat([y1.to(dtype),
                                   self.cv2(x).to(dtype)], -1))


class SPP(nn.Module):
    def __init__(self, c1: int, c2: int, ks=(5, 9, 13)):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = ConvBnSiLU(c1, c_, 1)
        self.cv2 = ConvBnSiLU(c_ * (len(ks) + 1), c2, 1)
        self.ks = tuple(ks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.cv1(x).to(self.cv1.conv.weight.dtype)
        return self.cv2(torch.cat(
            [x] + [max_pool2d(x, k, 1, k // 2) for k in self.ks], -1))


# ---------------------------------------------------------------------------
# the model


class YoloV5(nn.Module):
    """yaml-driven v5 detector; ``forward`` returns the raw NHWC head maps."""

    def __init__(self, yaml_text: str, num_classes: Optional[int] = None):
        super().__init__()
        self.yaml_text, self.num_classes = yaml_text, num_classes
        d = parse_v5_yaml(yaml_text, num_classes)
        self.nc = int(d["nc"])
        anchors = d["anchors"]
        self.anchors_px = np.array(anchors, np.float32).reshape(
            len(anchors), -1, 2)
        self.plan = build_plan(d)
        na = self.anchors_px.shape[1]
        self.needed = set()
        for e in self.plan:
            f = e["f"]
            for src in ([f] if isinstance(f, int) else f):
                if src != -1:
                    self.needed.add(src if src >= 0 else e["i"] + src)
        for e in self.plan:
            i, m, n, args, c1 = e["i"], e["module"], e["n"], e["args"], e["c1"]
            name = f"m{i}"
            if m in NOT_PORTED:
                raise NotImplementedError(
                    f"v5 module {m!r} (layer {i}) is not ported yet (ROADMAP "
                    f"queue 1, the rest of the v5 zoo)")
            if m in ("Focus", "Conv", "Bottleneck", "SPP"):
                for j in range(n):
                    nm = f"{name}_{j}" if n > 1 else name
                    cin = c1 if j == 0 else e["c2"]
                    if m == "Focus":
                        mod = Focus(cin, *args)
                    elif m == "Conv":
                        mod = ConvBnSiLU(cin, *args)
                    elif m == "Bottleneck":
                        mod = Bottleneck(cin, *args)
                    else:
                        mod = SPP(cin, args[0], tuple(args[1]) if len(args) > 1
                                  else (5, 9, 13))
                    self.add_module(nm, mod)
            elif m == "C3":
                self.add_module(name, C3(c1, args[0], n=n, shortcut=(
                    args[1] if len(args) > 1 else True)))
            elif m == "Detect":
                for li, cin in enumerate(e["ch_in"]):
                    self.add_module(f"{name}_m{li}",
                                    Conv(cin, na * (self.nc + 5), 1))
            elif m not in ("nn.Upsample", "Concat"):
                raise ValueError(f"unsupported v5 module '{m}'")

    @property
    def heads(self) -> List[YoloHead]:
        return yolov5_heads(self)

    def forward(self, x: torch.Tensor, up_to: Optional[int] = None
                ) -> List[torch.Tensor]:
        if up_to is not None:
            raise NotImplementedError("the up_to prefix forward is not "
                                      "ported yet (ROADMAP queue 1)")
        dtype = next(self.parameters()).dtype
        outputs: List[Optional[torch.Tensor]] = []
        raw_heads: List[torch.Tensor] = []
        for e in self.plan:
            i, f, m, n = e["i"], e["f"], e["module"], e["n"]
            src = ((x if f == -1 else outputs[f]) if isinstance(f, int)
                   else [x if j == -1 else outputs[j] for j in f])
            if m in ("Focus", "Conv", "Bottleneck", "SPP"):
                x = src
                for j in range(n):
                    x = getattr(self, f"m{i}_{j}" if n > 1 else f"m{i}")(x)
            elif m == "C3":
                x = getattr(self, f"m{i}")(src)
            elif m == "nn.Upsample":
                s = int(e["args"][1])
                x = src.to(dtype).repeat_interleave(s, 1)\
                    .repeat_interleave(s, 2)
            elif m == "Concat":
                x = torch.cat([t.to(dtype) for t in src], -1)
            else:                                        # Detect
                for li, t in enumerate(src):
                    raw_heads.append(getattr(self, f"m{i}_m{li}")(t))
                x = raw_heads[-1]
            outputs.append(x if i in self.needed else None)
        return raw_heads


def create_yolov5(yaml_path: str, num_classes: Optional[int] = None
                  ) -> YoloV5:
    with open(yaml_path) as f:
        return YoloV5(f.read(), num_classes)


def yolov5_heads(model: YoloV5) -> List[YoloHead]:
    """Head metadata for a v5 model (v5 decode; stride from each map)."""
    a = model.anchors_px
    return [YoloHead(a[i], model.nc, i, v5=True) for i in range(a.shape[0])]


def initialize_detect_biases(model: YoloV5, variables: Dict[str, Any],
                             img_size: int = 640,
                             cf: Optional[np.ndarray] = None
                             ) -> Dict[str, Any]:
    """Focal-prior Detect bias init on a JAX-layout tree: per level with
    stride s, obj bias += log(8 / (640 / s)^2) and class biases +=
    log(0.6 / (nc - 0.99)) (or log(cf / cf.sum()) given class counts)."""
    nc, na = model.nc, model.anchors_px.shape[1]
    # the levels' strides: the Detect inputs' sizes at img_size, from the
    # strides of the layers the yaml wires into Detect
    strides = _detect_strides(model, img_size)
    params = {k: dict(v) if isinstance(v, dict) else v
              for k, v in variables["params"].items()}
    detect = model.plan[-1]["i"]
    for li, stride in enumerate(strides):
        name = f"m{detect}_m{li}"
        b = np.array(params[name]["bias"], np.float32).reshape(na, 5 + nc)
        b[:, 4] += math.log(8.0 / (640.0 / stride) ** 2)
        if cf is None:
            b[:, 5:] += math.log(0.6 / (nc - 0.99))
        else:
            b[:, 5:] += np.log(np.asarray(cf, np.float64)
                               / np.sum(cf)).astype(np.float32)
        params[name]["bias"] = b.reshape(-1)
    return dict(variables, params=params)


def _detect_strides(model: YoloV5, img_size: int) -> List[float]:
    """img_size / the size of each Detect input's map, by a forward of a
    zero frame at img_size."""
    with torch.inference_mode():
        dev = next(model.parameters()).device
        maps = model(torch.zeros((1, img_size, img_size, 3), device=dev))
    return [img_size / p.shape[1] for p in maps]
