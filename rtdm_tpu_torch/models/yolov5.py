"""YOLOv5 yaml detectors, NHWC.

Counterpart of ``rtdm_tpu/models/yolov5.py``: the reference fork's block
zoo (yolov5/models/common.py, experimental.py) as the JAX package builds
it. ``ConvBnSiLU`` (conv without bias, BN eps 1e-3 and momentum 0.03,
SiLU), ``Focus`` (2x2 space-to-depth, then a conv), ``Bottleneck``,
``C3``, ``BottleneckCSP``, ``C3TR`` (a C3 around a ``TransformerBlock`` of
``TransformerLayer`` blocks), ``SPP``, ``DWConv``, ``CrossConv``,
``GhostConv``, ``GhostBottleneck``, ``MixConv2d``, ``Sum``, ``Classify``,
``Contract``/``Expand``, ``Concat``, ``nn.Upsample`` and ``Detect`` (a 1x1
conv with bias per level, raw maps out, with v5 decode metadata). Module
names follow the JAX tree (``m{i}``, ``m{i}_{j}`` for an n>1 repeat of a
plain module, ``m{i}/cv1/conv``, ``m{i}_m{level}`` for the Detect convs;
a transformer's linear maps are (in, out) matrices ``q_w``, ``in_q_w``,
``in_q_b``, ... as JAX names and lays them out), so a JAX variables tree
loads one leaf per tensor. Channel arithmetic (depth and width multiples,
``make_divisible``) is resolved by ``build_plan``. ``forward(x, up_to=k)``
returns layer k's output, the prefix that ``utils/layer_profile.py``
measures. ``load_yolov5_torch_checkpoint`` reads the reference's ``.pt``
checkpoints into a JAX-layout tree.

Rounding as the compiled JAX graph rounds a bf16 model: the conv's product
goes to BN unrounded; SiLU runs its bf16 steps (``layers.silu``). With
``keep_fp32`` (set by ``quant/int8.py::quantize_detector``) a ConvBnSiLU
returns its SiLU product, and a Bottleneck its residual sum, in fp32: the
int8 program QDQs the result of an arithmetic step without rounding it to
bf16 first. Every other consumer (a residual add, a concat, a pool, an
upsample) rounds it to bf16 first. The committed detectors use only the
yolov5s.yaml blocks; the others are held to the JAX package in fp32.

``parse_v5_yaml`` reads the yaml subset these model files use (a mapping
of scalars, flow lists and block lists of flow lists) without PyYAML
(``utils/yaml_io.py``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from rtdm_tpu_torch.models.darknet import YoloHead
from rtdm_tpu_torch.models.layers import (BatchNorm, Conv, acc_dtype,
                                          leaky_relu, silu)
from rtdm_tpu_torch.ops.convpool import max_pool2d
from rtdm_tpu_torch.utils import yaml_io

# modules whose n > 1 repeats them (nn.Sequential in the reference), as
# m{i}_{j}; C3, C3TR and BottleneckCSP take n themselves
REPEATED = ("Focus", "Conv", "DWConv", "Bottleneck", "SPP", "CrossConv",
            "GhostConv", "GhostBottleneck", "MixConv2d")


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


class BottleneckCSP(nn.Module):
    """CSP bottleneck (common.py BottleneckCSP): cv1 -> n Bottlenecks ->
    cv3 (a plain conv), beside cv2 (a plain conv) of the input, then BN of
    the concat, LeakyReLU(0.1) and cv4."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True,
                 g: int = 1, e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBnSiLU(c1, c_, 1)
        self.cv2 = Conv(c1, c_, 1, use_bias=False)
        self.cv3 = Conv(c_, c_, 1, use_bias=False)
        self.cv4 = ConvBnSiLU(2 * c_, c2, 1)
        self.bn = BatchNorm(2 * c_, 1e-3, 0.03)
        self.n = n
        for j in range(n):
            self.add_module(f"m{j}", Bottleneck(c_, c_, shortcut, g, 1.0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.cv2.weight.dtype
        y1 = self.cv1(x)
        for j in range(self.n):
            y1 = getattr(self, f"m{j}")(y1)
        y = torch.cat([self.cv3(y1.to(dtype)), self.cv2(x)], -1)
        return self.cv4(leaky_relu(self.bn(y), 0.1))


class TransformerLayer(nn.Module):
    """common.py TransformerLayer over (B, T, C) tokens: q/k/v projections
    without bias, multi-head attention with its own in and out projections
    (``in_q``/``in_k``/``in_v``/``out``, with bias), then a two-layer MLP
    without bias; both residual, no LayerNorm (the reference removed it).
    Each linear map is an (in, out) matrix applied as ``y @ w``."""

    def __init__(self, c: int, num_heads: int = 4):
        super().__init__()
        self.num_heads = num_heads
        for name in ("q", "k", "v", "in_q", "in_k", "in_v", "out", "fc1",
                     "fc2"):
            self.register_parameter(f"{name}_w",
                                    nn.Parameter(torch.empty(c, c)))
        for name in ("in_q", "in_k", "in_v", "out"):
            self.register_parameter(f"{name}_b",
                                    nn.Parameter(torch.zeros(c)))
        for name in ("q", "k", "v", "in_q", "in_k", "in_v", "out", "fc1",
                     "fc2"):
            nn.init.xavier_normal_(getattr(self, f"{name}_w"))

    def _lin(self, name: str, y: torch.Tensor) -> torch.Tensor:
        out = y @ getattr(self, f"{name}_w").to(y.dtype)
        b = getattr(self, f"{name}_b", None)
        return out if b is None else out + b.to(y.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, c = x.shape
        h = self.num_heads
        dk = c // h

        def heads(y):
            return y.reshape(b, t, h, dk).transpose(1, 2)

        q, k, v = (self._lin(f"in_{n}", self._lin(n, x)) for n in "qkv")
        att = heads(q) @ heads(k).transpose(-1, -2) / math.sqrt(dk)
        att = torch.softmax(att.float(), -1).to(x.dtype)
        out = (att @ heads(v)).transpose(1, 2).reshape(b, t, c)
        x = self._lin("out", out) + x
        return self._lin("fc2", self._lin("fc1", x)) + x


class TransformerBlock(nn.Module):
    """common.py TransformerBlock: a ConvBnSiLU where c1 != c2, a learned
    linear position embedding (``linear_w``, ``linear_b``) added to the HW
    tokens, then n TransformerLayers (``tr{j}``)."""

    def __init__(self, c1: int, c2: int, num_heads: int = 4, n: int = 1):
        super().__init__()
        self.conv = ConvBnSiLU(c1, c2, 1) if c1 != c2 else None
        self.linear_w = nn.Parameter(nn.init.xavier_normal_(
            torch.empty(c2, c2)))
        self.linear_b = nn.Parameter(torch.zeros(c2))
        self.n = n
        for j in range(n):
            self.add_module(f"tr{j}", TransformerLayer(c2, num_heads))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.conv is not None:
            x = self.conv(x)
        x = x.to(self.linear_w.dtype)
        b, hh, ww, c = x.shape
        tokens = x.reshape(b, hh * ww, c)
        tokens = tokens + (tokens @ self.linear_w.to(tokens.dtype)
                           + self.linear_b.to(tokens.dtype))
        for j in range(self.n):
            tokens = getattr(self, f"tr{j}")(tokens)
        return tokens.reshape(b, hh, ww, c)


class C3TR(C3):
    """A C3 whose inner stack is a TransformerBlock of n layers
    (common.py C3TR)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True,
                 g: int = 1, e: float = 0.5):
        super().__init__(c1, c2, 0, shortcut, g, e)
        self.m = TransformerBlock(int(c2 * e), int(c2 * e), 4, n)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.cv1.conv.weight.dtype
        y1 = self.m(self.cv1(x))
        return self.cv3(torch.cat([y1.to(dtype),
                                   self.cv2(x).to(dtype)], -1))


class DWConv(ConvBnSiLU):
    """A ConvBnSiLU in gcd(c1, c2) groups (common.py DWConv), its conv and
    BN at its own level as the reference's keys are."""

    def __init__(self, c1: int, c2: int, k=1, s=1, act: bool = True):
        super().__init__(c1, c2, k, s, g=math.gcd(c1, c2), act=act)


class CrossConv(nn.Module):
    """experimental.py CrossConv: a (1, k) conv at stride (1, s), then a
    (k, 1) conv at stride (s, 1) in g groups; residual where asked and
    c1 == c2."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, g: int = 1,
                 e: float = 1.0, shortcut: bool = False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBnSiLU(c1, c_, (1, k), (1, s))
        self.cv2 = ConvBnSiLU(c_, c2, (k, 1), (s, 1), g=g)
        self.add = shortcut and c1 == c2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.cv2(self.cv1(x))
        if not self.add:
            return out
        dtype = self.cv1.conv.weight.dtype
        return x.to(dtype) + out.to(dtype)


class GhostConv(nn.Module):
    """experimental.py GhostConv: cv1 to c2/2 channels, cv2 a 5x5
    depthwise conv of that, both with ``act``; their concat."""

    def __init__(self, c1: int, c2: int, k=1, s=1, act: bool = True):
        super().__init__()
        c_ = c2 // 2
        self.cv1 = ConvBnSiLU(c1, c_, k, s, act=act)
        self.cv2 = ConvBnSiLU(c_, c_, 5, 1, g=c_, act=act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.cv1.conv.weight.dtype
        y = self.cv1(x).to(dtype)
        return torch.cat([y, self.cv2(y).to(dtype)], -1)


class GhostBottleneck(nn.Module):
    """experimental.py GhostBottleneck: GhostConv (``conv0``), at stride 2
    a DWConv without activation (``conv1``), a GhostConv without
    activation (``conv2``); at stride 1 the input is added (c1 == c2), at
    stride 2 a DWConv and a 1x1 conv of it (``sc_dw``, ``sc_pw``)."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1):
        super().__init__()
        c_ = c2 // 2
        self.s = s
        self.conv0 = GhostConv(c1, c_, 1, 1)
        if s == 2:
            self.conv1 = DWConv(c_, c_, k, s, act=False)
            self.sc_dw = DWConv(c1, c1, k, s, act=False)
            self.sc_pw = ConvBnSiLU(c1, c2, 1, act=False)
        self.conv2 = GhostConv(c_, c2, 1, 1, act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.conv2.cv1.conv.weight.dtype
        y = self.conv0(x)
        if self.s == 2:
            y = self.conv1(y)
        y = self.conv2(y).to(dtype)
        sc = x if self.s != 2 else self.sc_pw(self.sc_dw(x))
        return sc.to(dtype) + y


class MixConv2d(nn.Module):
    """experimental.py MixConv2d: parallel bias-free convs of kernel sizes
    ``k`` (``m{g}``) splitting c2 equally, their concat, BN,
    LeakyReLU(0.1), and the input added."""

    def __init__(self, c1: int, c2: int, k=(1, 3), s: int = 1):
        super().__init__()
        groups = len(k)
        idx = np.floor(np.linspace(0, groups - 1e-6, c2)).astype(int)
        self.groups = groups
        for g in range(groups):
            self.add_module(f"m{g}", Conv(c1, int(np.sum(idx == g)), k[g], s,
                                          k[g] // 2, use_bias=False))
        self.bn = BatchNorm(c2, 1e-3, 0.03)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.cat([getattr(self, f"m{g}")(x)
                       for g in range(self.groups)], -1)
        y = self.bn(y).to(self.m0.weight.dtype)
        y = torch.where(y > 0, y, 0.1 * y)
        return x.to(y.dtype) + y


class Sum(nn.Module):
    """experimental.py Sum of n inputs: x0 + sum x[i+1], each weighted by
    sigmoid(w_i) * 2 when ``weight``."""

    def __init__(self, n: int, weight: bool = False):
        super().__init__()
        self.n = n
        self.w = (nn.Parameter(-torch.arange(1.0, n) / 2) if weight
                  else None)

    def forward(self, xs: List[torch.Tensor]) -> torch.Tensor:
        y = xs[0]
        w = None if self.w is None else torch.sigmoid(self.w.to(y.dtype)) * 2
        for i in range(self.n - 1):
            y = y + (xs[i + 1] if w is None else xs[i + 1] * w[i])
        return y


class Classify(nn.Module):
    """common.py Classify: each input average-pooled to (B, 1, 1, C), the
    channel concat, a conv with bias to c2, flattened to (B, c2)."""

    def __init__(self, c1: int, c2: int, k=1, s=1):
        super().__init__()
        self.c2 = c2
        self.conv = Conv(c1, c2, k, s, autopad(k))

    def forward(self, x) -> torch.Tensor:
        xs = x if isinstance(x, (list, tuple)) else [x]
        z = torch.cat([y.mean((1, 2), keepdim=True) for y in xs], -1)
        z = self.conv(z)
        return z.reshape(z.shape[0], self.c2)


def contract(x: torch.Tensor, gain: int = 2) -> torch.Tensor:
    """common.py Contract, NHWC: (N, H, W, C) -> (N, H/g, W/g, C*g*g)."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // gain, gain, w // gain, gain, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h // gain, w // gain,
                                               c * gain * gain)


def expand(x: torch.Tensor, gain: int = 2) -> torch.Tensor:
    """common.py Expand, NHWC: (N, H, W, C) -> (N, H*g, W*g, C/g^2)."""
    n, h, w, c = x.shape
    x = x.reshape(n, h, w, gain, gain, c // gain ** 2)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h * gain, w * gain,
                                               c // gain ** 2)


def _repeated_block(m: str, c1: int, args: List[Any]) -> nn.Module:
    """One instance of a module that n > 1 repeats."""
    if m == "SPP":
        return SPP(c1, args[0], tuple(args[1]) if len(args) > 1
                   else (5, 9, 13))
    if m == "MixConv2d":
        return MixConv2d(c1, args[0],
                         tuple(args[1]) if len(args) > 1 else (1, 3),
                         int(args[2]) if len(args) > 2 else 1)
    cls = {"Focus": Focus, "Conv": ConvBnSiLU, "DWConv": DWConv,
           "Bottleneck": Bottleneck, "CrossConv": CrossConv,
           "GhostConv": GhostConv, "GhostBottleneck": GhostBottleneck}[m]
    return cls(c1, *args)


_STACKS = {"C3": C3, "C3TR": C3TR, "BottleneckCSP": BottleneckCSP}


# ---------------------------------------------------------------------------
# the model


class YoloV5(nn.Module):
    """yaml-driven v5 detector; ``forward`` returns the raw NHWC head maps
    (a Classify-headed yaml: its logits)."""

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
            if m in REPEATED:
                for j in range(n):
                    self.add_module(f"{name}_{j}" if n > 1 else name,
                                    _repeated_block(m, c1 if j == 0
                                                    else e["c2"], args))
            elif m in _STACKS:
                self.add_module(name, _STACKS[m](c1, args[0], n=n, shortcut=(
                    args[1] if len(args) > 1 else True)))
            elif m == "Sum":
                self.add_module(name, Sum(len(e["f"]),
                                          bool(args[0]) if args else False))
            elif m == "Classify":
                self.add_module(name, Classify(
                    sum(c1) if isinstance(c1, list) else c1, *args))
            elif m == "Detect":
                for li, cin in enumerate(e["ch_in"]):
                    self.add_module(f"{name}_m{li}",
                                    Conv(cin, na * (self.nc + 5), 1))
            elif m not in ("nn.Upsample", "Concat", "Contract", "Expand"):
                raise ValueError(f"unsupported v5 module '{m}'")

    @property
    def heads(self) -> List[YoloHead]:
        return yolov5_heads(self)

    def forward(self, x: torch.Tensor, up_to: Optional[int] = None):
        """The yaml graph on NHWC x: the raw head maps (a Classify-headed
        yaml: its logits); with ``up_to=k``, layer k's output (the prefix
        program whose cost differences ``utils/layer_profile.py``
        measures)."""
        dtype = next(self.parameters()).dtype
        outputs: List[Optional[torch.Tensor]] = []
        raw_heads: List[torch.Tensor] = []
        for e in self.plan:
            i, f, m, n = e["i"], e["f"], e["module"], e["n"]
            src = ((x if f == -1 else outputs[f]) if isinstance(f, int)
                   else [x if j == -1 else outputs[j] for j in f])
            if m in REPEATED:
                x = src
                for j in range(n):
                    x = getattr(self, f"m{i}_{j}" if n > 1 else f"m{i}")(x)
            elif m in _STACKS or m in ("Sum", "Classify"):
                x = getattr(self, f"m{i}")(src)
            elif m == "nn.Upsample":
                s = int(e["args"][1])
                x = src.to(dtype).repeat_interleave(s, 1)\
                    .repeat_interleave(s, 2)
            elif m == "Concat":
                x = torch.cat([t.to(dtype) for t in src], -1)
            elif m == "Contract":
                x = contract(src.to(dtype), e["args"][0])
            elif m == "Expand":
                x = expand(src.to(dtype), e["args"][0])
            else:                                        # Detect
                for li, t in enumerate(src):
                    raw_heads.append(getattr(self, f"m{i}_m{li}")(t))
                x = raw_heads[-1]
            if up_to is not None and i == up_to:
                return x
            outputs.append(x if i in self.needed else None)
        return raw_heads if raw_heads else x


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


# ---------------------------------------------------------------------------
# the reference's torch checkpoints


def load_yolov5_torch_checkpoint(variables: Dict[str, Any], path: str,
                                 prefer_ema: bool = True,
                                 intersect: bool = False) -> Dict[str, Any]:
    """``variables`` (a JAX-layout tree) filled from a v5-era checkpoint
    (``{'model': module, 'ema': module}``, or a module or state dict), the
    EMA's weights where ``prefer_ema`` and it has them.

    Keys: ``model.{i}.<path>.conv.weight`` -> ``m{i}/<path>/conv/kernel``
    (OIHW -> HWIO), ``.bn.*`` -> BN scale/bias and batch_stats mean/var,
    ``model.{i}.{j}.*`` (an nn.Sequential repeat) -> ``m{i}_{j}``,
    ``.m.{j}`` -> ``m{j}``, GhostBottleneck's ``conv.{k}`` -> ``conv{k}``
    and ``shortcut.{0,1}`` -> ``sc_dw``/``sc_pw``, ``model.{i}.m.{j}.*`` of
    Detect -> ``m{i}_m{j}``, and the transformer tensors as
    ``_transformer_puts`` says. With ``intersect``, keys that match no
    leaf or whose shapes differ are skipped (a COCO checkpoint seeds a
    model of other ``nc``), else they raise."""
    import logging

    from rtdm_tpu_torch.models.io import numpy_tree
    from rtdm_tpu_torch.models.torch_import import _STUB_PICKLE
    obj = torch.load(path, map_location="cpu", weights_only=False,
                     pickle_module=_STUB_PICKLE)
    model_obj = None
    if isinstance(obj, dict):
        if prefer_ema and obj.get("ema") is not None:
            model_obj = obj["ema"]
        elif "model" in obj:
            model_obj = obj["model"]
    if model_obj is None:
        model_obj = obj
    sd = (model_obj.float().state_dict()
          if hasattr(model_obj, "state_dict") else dict(model_obj))
    sd = {k: v.detach().cpu().numpy() if hasattr(v, "detach") else v
          for k, v in sd.items()}

    variables = numpy_tree(variables)
    params = variables["params"]
    stats = variables.setdefault("batch_stats", {})
    unmatched, skipped = [], []
    transferred = 0
    for key, val in sd.items():
        if not key.startswith("model."):
            continue
        parts = key.split(".")
        i, rest = int(parts[1]), parts[2:]
        if (len(rest) == 3 and rest[0] == "m" and rest[1].isdigit()
                and rest[2] in ("weight", "bias")):
            name = f"m{i}_m{rest[1]}"
            if name in params:                    # a Detect conv
                arr = (np.transpose(val, (2, 3, 1, 0))
                       if rest[2] == "weight" else np.asarray(val))
                slot = "kernel" if rest[2] == "weight" else "bias"
                if tuple(np.shape(params[name][slot])) != arr.shape:
                    skipped.append(key)
                else:
                    params[name][slot] = arr.astype(np.float32)
                    transferred += 1
                continue
        puts = _transformer_puts(rest, np.asarray(val))
        if puts is not None:
            results = [_set_nested(params, [f"m{i}"] + list(suffix), leaf,
                                   np.ascontiguousarray(a))
                       for suffix, leaf, a in puts]
            if False in results:
                unmatched.append(key)
            elif "shape" in results:
                skipped.append(key)
            else:
                transferred += 1
            continue
        mapped, j = [f"m{i}"], 0
        if rest and rest[0].isdigit():
            mapped, j = [f"m{i}_{rest[0]}"], 1
        while j < len(rest) - 1:
            if rest[j] == "m" and rest[j + 1].isdigit():
                mapped.append(f"m{rest[j + 1]}")
                j += 2
            elif (rest[j] == "conv" and j + 1 < len(rest) - 1
                    and rest[j + 1].isdigit()):
                mapped.append(f"conv{rest[j + 1]}")
                j += 2
            elif (rest[j] == "shortcut" and j + 1 < len(rest) - 1
                    and rest[j + 1] in ("0", "1")):
                mapped.append("sc_dw" if rest[j + 1] == "0" else "sc_pw")
                j += 2
            else:
                mapped.append(rest[j])
                j += 1
        leaf, arr = rest[-1], np.asarray(val)
        if mapped[-1] == "bn":
            ok = {"weight": lambda: _set_nested(params, mapped, "scale", arr),
                  "bias": lambda: _set_nested(params, mapped, "bias", arr),
                  "running_mean": lambda: _set_nested(stats, mapped, "mean",
                                                      arr, create=True),
                  "running_var": lambda: _set_nested(stats, mapped, "var",
                                                     arr, create=True),
                  }.get(leaf, lambda: True)()
        elif leaf == "weight" and arr.ndim == 4:
            ok = _set_nested(params, mapped, "kernel",
                             np.transpose(arr, (2, 3, 1, 0)))
        elif leaf == "bias":
            ok = _set_nested(params, mapped, "bias", arr)
        else:
            ok = leaf in ("anchors", "anchor_grid")   # read from the yaml
        if ok == "shape":
            skipped.append(key)
        elif not ok:
            unmatched.append(key)
        elif leaf != "num_batches_tracked":
            transferred += 1
    if unmatched and not intersect:
        raise ValueError(f"unmatched v5 checkpoint keys: {unmatched[:8]}"
                         f" (+{max(len(unmatched) - 8, 0)} more)")
    if skipped and not intersect:
        raise ValueError(
            f"shape-mismatched v5 checkpoint keys: {skipped[:8]} "
            f"(+{max(len(skipped) - 8, 0)} more); pass intersect=True for a "
            "partial pretrained load")
    if intersect and (skipped or unmatched):
        logging.getLogger(__name__).info(
            "transferred %d items from %s (%d shape-mismatched, %d "
            "unmatched skipped)", transferred, path, len(skipped),
            len(unmatched))
    return variables


def _transformer_puts(rest: List[str], arr: np.ndarray):
    """The (path suffix, leaf, value) puts of a TransformerBlock or
    TransformerLayer key's tail, or None for another key. nn.Linear stores
    (out, in) and the port's maps (in, out), so 2-D weights transpose;
    nn.MultiheadAttention's packed ``in_proj_weight``/``_bias`` (3C rows)
    split into ``in_q``/``in_k``/``in_v``; ``out_proj`` is ``out``."""
    if (len(rest) >= 2 and rest[-2] == "linear"
            and rest[-1] in ("weight", "bias") and arr.ndim <= 2):
        prefix = rest[:-2]
        if rest[-1] == "weight":
            return [(prefix, "linear_w", arr.T)]
        return [(prefix, "linear_b", arr)]
    if "tr" not in rest:
        return None
    t = rest.index("tr")
    if t + 2 >= len(rest) or not rest[t + 1].isdigit():
        return None
    prefix = rest[:t] + [f"tr{rest[t + 1]}"]
    tail = rest[t + 2:]
    if (len(tail) == 2 and tail[0] in ("q", "k", "v", "fc1", "fc2")
            and tail[1] == "weight"):
        return [(prefix, f"{tail[0]}_w", arr.T)]
    if tail == ["ma", "in_proj_weight"]:
        return [(prefix, f"in_{n}_w", w.T)
                for n, w in zip("qkv", np.split(arr, 3, axis=0))]
    if tail == ["ma", "in_proj_bias"]:
        return [(prefix, f"in_{n}_b", b)
                for n, b in zip("qkv", np.split(arr, 3, axis=0))]
    if tail == ["ma", "out_proj", "weight"]:
        return [(prefix, "out_w", arr.T)]
    if tail == ["ma", "out_proj", "bias"]:
        return [(prefix, "out_b", arr)]
    return None


def _set_nested(tree: Dict[str, Any], path: List[str], leaf: str,
                value: np.ndarray, create: bool = False):
    """Put ``value`` (as float32) at ``tree[path...][leaf]``: True; False
    where the path is missing (and not ``create``); "shape" where the leaf
    holds another shape."""
    node = tree
    for p in path:
        if p not in node:
            if not create:
                return False
            node[p] = {}
        node = node[p]
    if leaf in node and tuple(np.shape(node[leaf])) != np.shape(value):
        return "shape"
    node[leaf] = value.astype(np.float32)
    return True
