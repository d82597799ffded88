"""Plain reference of a sealed int8 YOLOv5 detector: network, decode, NMS.

Plain torch in float32 (TF32 off) and numpy, from the engine directory's
``spec.json`` (thresholds, ``num_classes``), ``model.txt`` (the v5 yaml,
parsed here), ``params.npz`` (int8 kernel codes ``.q`` with
per-output-channel scales ``.s``; BatchNorm scale and bias, its running
mean and variance under ``batch_stats``; the Detect convs' biases) and
``act_scales.npz`` as committed; it imports nothing of ``rtdm_tpu_torch``
or ``rtdm_tpu``. As ultralytics/yolov5 v5.0 computes it (models/common.py,
models/yolo.py), with int8 QDQ:

- the input is ``u8 / 255``; Focus stacks the four pixels of each 2x2
  square, ``(::2, ::2), (1::2, ::2), (::2, 1::2), (1::2, 1::2)`` of (H, W),
  on the channels, then convolves;
- every conv that has an activation scale s takes ``clip(round(x / s),
  -127, 127) * s`` (round half to even), and its kernel is ``codes *
  scale``; a Conv pads k // 2, has no bias, then BatchNorm with eps 1e-3
  from the running statistics and SiLU;
- Bottleneck: cv2(cv1(x)), plus x where shortcut and c1 == c2; C3:
  ``cv3(cat(m(cv1(x)), cv2(x)))``; SPP: cv1, then its output beside its
  stride-1 max-pools 5, 9 and 13 padded by k // 2, then cv2; nn.Upsample
  repeats nearest; Concat joins channels in yaml order; depth and width
  multiples as ``parse_model`` resolves them;
- Detect: a 1x1 conv with bias a level; decode, rows (b, anchor, y, x):
  s = sigmoid(t), xy = (2s - 0.5 + grid) * stride, wh = (2s)^2 * anchor,
  objectness and classes s;
- greedy NMS per frame, the rules of ``darknet_int8.py::nms`` (a copy:
  each reference stands alone): rows with objectness over ``conf_thres``
  and both sides in (2, 4096) px, the best class by objectness * class,
  the ``top_k`` best by that score (ties to the lower row), then in score
  order a box is kept unless a kept box of its class overlaps it by IoU
  over ``iou_thres``; at most ``max_det`` rows x1, y1, x2, y2, conf, cls.

Where the program (``rtdm_tpu_torch``'s ``Detector``) rounds otherwise:
its convs, their kernels and the BatchNorm scale and bias are bf16 (the
reference: fp32); it divides by a scale as a multiply by the scale's fp32
reciprocal (``quant/int8.py::fake_quant_tensor``), so a code can differ
where x / s lies within an ulp of k + 1/2; it rounds the input, the
BatchNorm output and every tensor that a concat, pool, upsample or
residual add reads to bf16, and runs SiLU's sigmoid in bf16 steps.

``precision="int<n>"``, n from 2 to 7, is a control: kernel codes and
activation codes cut to [-L, L], L = 2^(n-1) - 1, at 127/L times the
scale (``int4``: [-7, 7]).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-3
MIN_WH, MAX_WH = 2.0, 4096.0
BLOCKS = ("Focus", "Conv", "C3", "SPP", "nn.Upsample", "Concat", "Detect")


# yaml's booleans and nulls; any other bare word (``None`` too) is a string
_WORDS = {"True": True, "true": True, "False": False, "false": False,
          "null": None, "~": None}


def _scalar(word: str):
    """A bare yaml word: a number, a boolean, a null or a string."""
    for kind in (int, float):
        try:
            return kind(word)
        except ValueError:
            pass
    return _WORDS.get(word, word)


def _flow(text: str):
    """A yaml flow value (nested lists of numbers, quoted strings, booleans
    and bare words) as Python values."""
    pos = 0

    def value():
        nonlocal pos
        while text[pos] == " ":
            pos += 1
        if text[pos] == "[":
            pos += 1
            items = []
            while True:
                while text[pos] in " ,":
                    pos += 1
                if text[pos] == "]":
                    pos += 1
                    return items
                items.append(value())
        if text[pos] in "'\"":
            end = text.index(text[pos], pos + 1)
            word, pos = text[pos + 1:end], end + 1
            return word
        end = pos
        while end < len(text) and text[end] not in ",]":
            end += 1
        word, pos = text[pos:end].strip(), end
        return _scalar(word)

    return value()


def parse_yaml(text: str) -> Dict:
    """The keys of a v5 model yaml: scalars, ``anchors`` (a block list of
    flow lists) and ``backbone`` / ``head`` (flow lists over lines)."""
    out: Dict = {}
    key, body = None, []

    def close():
        if key is None:
            return
        joined = " ".join(body).strip()
        if joined.startswith("-"):
            out[key] = [_flow(item) for item in
                        (b.strip()[1:] for b in body if b.strip())]
        else:
            out[key] = _flow(joined)

    for raw in text.splitlines():
        line = raw.split("#", 1)[0].rstrip()
        if not line.strip():
            continue
        if not line[0].isspace() and ":" in line:
            close()
            key, rest = line.split(":", 1)
            key, body = key.strip(), []
            if rest.strip():
                out[key] = _flow(rest.strip())
                key = None
        else:
            body.append(line)
    close()
    return out


def plan(model: Dict, nc: int) -> List[Dict]:
    """Each yaml entry with its input and output channels and repeats, as
    ``parse_model`` resolves them."""
    gd, gw = model["depth_multiple"], model["width_multiple"]
    na = len(model["anchors"][0]) // 2
    no = na * (nc + 5)
    ch, out = [3], []
    for i, (f, n, m, args) in enumerate(model["backbone"] + model["head"]):
        if m not in BLOCKS:
            raise ValueError(f"module {m!r} not in the reference")
        n = max(round(n * gd), 1) if n > 1 else n
        c1 = ch[f] if isinstance(f, int) else [ch[j] for j in f]
        if m in ("Focus", "Conv", "C3", "SPP"):
            c2 = int(np.ceil(args[0] * gw / 8)) * 8
        elif m == "Concat":
            c2 = sum(c1)
        elif m == "Detect":
            c2 = no
        else:
            c2 = c1
        out.append({"i": i, "f": f, "m": m, "n": n, "args": args,
                    "c1": c1, "c2": c2})
        ch = ch[1:] + [c2] if i == 0 else ch + [c2]
    return out


def load(config: Dict, root: str, device) -> Dict:
    path = os.path.join(root, config["engine"])
    with open(os.path.join(path, "spec.json")) as f:
        spec = json.load(f)
    with open(os.path.join(path, "model.txt")) as f:
        model = parse_yaml(f.read())
    nc = int(spec.get("num_classes") or model["nc"])
    with np.load(os.path.join(path, "params.npz")) as z:
        tree = {k: np.asarray(z[k]) for k in z.files}
    with np.load(os.path.join(path, "act_scales.npz")) as z:
        scales = {k: float(z[k]) for k in z.files}

    def tensor(key):
        return torch.from_numpy(tree[key].astype(np.float32)).to(device)

    convs = {}
    for key in tree:
        if not key.endswith("/kernel.q"):
            continue
        name = key[len("params/"):-len("/kernel.q")]
        q = tensor(key).permute(3, 2, 0, 1).contiguous()
        c = {"q": q, "s": tensor(f"params/{name}/kernel.s").reshape(-1),
             "act": scales[name]}
        if f"params/{name}/bias" in tree:                  # Detect
            c["b"] = tensor(f"params/{name}/bias")
        else:
            bn = name.rsplit("/", 1)[0] + "/bn"
            c["bn"] = (tensor(f"params/{bn}/scale"),
                       tensor(f"params/{bn}/bias"),
                       tensor(f"batch_stats/{bn}/mean"),
                       tensor(f"batch_stats/{bn}/var"))
        convs[name] = c
    anchors = np.array(model["anchors"], np.float32).reshape(
        len(model["anchors"]), -1, 2)
    return {"plan": plan(model, nc), "convs": convs, "spec": spec,
            "nc": nc, "anchors": anchors}


def _qdq(x: torch.Tensor, s: float, levels: int) -> torch.Tensor:
    return torch.clamp(torch.round(x / s), -levels, levels) * s


class _Net:
    """The yaml graph at one precision over NCHW float32 tensors."""

    def __init__(self, state: Dict, precision: str):
        bits = precision[3:] if precision.startswith("int") else ""
        if not bits.isdigit() or not 2 <= int(bits) <= 8:
            raise ValueError(f"unknown reference precision {precision!r}")
        self.convs = state["convs"]
        self.levels = 2 ** (int(bits) - 1) - 1
        self.widen = 127.0 / self.levels

    def _weight(self, name: str):
        """Kernel ``name`` as codes times scale, and its activation scale."""
        c = self.convs[name]
        q, scale = c["q"], c["s"]
        if self.levels != 127:
            q = torch.clamp(torch.round(q / self.widen), -self.levels,
                            self.levels)
            scale = scale * self.widen
        return c, q * scale[:, None, None, None], c["act"] * self.widen

    def conv(self, block: str, x: torch.Tensor, k: int = 1,
             s: int = 1) -> torch.Tensor:
        """The Conv ``block`` (its conv and BatchNorm): QDQ, the conv,
        BatchNorm, SiLU."""
        c, w, act = self._weight(f"{block}/conv")
        x = F.conv2d(_qdq(x, act, self.levels), w, stride=s, padding=k // 2)
        gamma, beta, mean, var = (t[:, None, None] for t in c["bn"])
        x = (x - mean) / torch.sqrt(var + BN_EPS) * gamma + beta
        return x * torch.sigmoid(x)

    def head(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """The Detect conv ``name``: QDQ, the 1x1 conv with its bias."""
        c, w, act = self._weight(name)
        return F.conv2d(_qdq(x, act, self.levels), w, c["b"])

    def bottleneck(self, name, x, shortcut):
        out = self.conv(f"{name}/cv2", self.conv(f"{name}/cv1", x), 3)
        return x + out if shortcut and x.shape[1] == out.shape[1] else out

    def c3(self, name, x, n, shortcut):
        y = self.conv(f"{name}/cv1", x)
        for j in range(n):
            y = self.bottleneck(f"{name}/m{j}", y, shortcut)
        return self.conv(f"{name}/cv3",
                         torch.cat([y, self.conv(f"{name}/cv2", x)], 1))

    def spp(self, name, x, ks):
        x = self.conv(f"{name}/cv1", x)
        return self.conv(f"{name}/cv2", torch.cat(
            [x] + [F.max_pool2d(x, k, 1, k // 2) for k in ks], 1))

    def __call__(self, state: Dict, x: torch.Tensor) -> List[torch.Tensor]:
        """The raw NCHW head maps of NCHW ``x`` in [0, 1]."""
        outputs: List[torch.Tensor] = []
        for e in state["plan"]:
            i, f, m, n, args = e["i"], e["f"], e["m"], e["n"], e["args"]
            src = (x if f == -1 else outputs[f]) if isinstance(f, int) \
                else [x if j == -1 else outputs[j] for j in f]
            if m == "Focus":
                x = self.conv(f"m{i}/conv", torch.cat(
                    [src[..., ::2, ::2], src[..., 1::2, ::2],
                     src[..., ::2, 1::2], src[..., 1::2, 1::2]], 1),
                    args[1] if len(args) > 1 else 1)
            elif m == "Conv":
                x = src
                for j in range(n):
                    x = self.conv(f"m{i}_{j}" if n > 1 else f"m{i}", x,
                                  args[1] if len(args) > 1 else 1,
                                  args[2] if len(args) > 2 else 1)
            elif m == "C3":
                x = self.c3(f"m{i}", src, n,
                            bool(args[1]) if len(args) > 1 else True)
            elif m == "SPP":
                x = self.spp(f"m{i}", src,
                             tuple(args[1]) if len(args) > 1 else (5, 9, 13))
            elif m == "nn.Upsample":
                x = F.interpolate(src, scale_factor=int(args[1]),
                                  mode="nearest")
            elif m == "Concat":
                x = torch.cat(src, 1)
            else:                                          # Detect
                return [self.head(f"m{i}_m{level}", t)
                        for level, t in enumerate(src)]
            outputs.append(x)
        raise ValueError("the yaml has no Detect")


def _decode(state: Dict, heads: List[torch.Tensor],
            img_hw: Tuple[int, int]) -> torch.Tensor:
    rows = []
    no = state["nc"] + 5
    for level, p in enumerate(heads):
        anchors = torch.from_numpy(state["anchors"][level]).to(p.device)
        na = anchors.shape[0]
        b, _, ny, nx = p.shape
        s = torch.sigmoid(p.reshape(b, na, no, ny, nx).permute(0, 1, 3, 4, 2))
        gy, gx = torch.meshgrid(torch.arange(ny, device=p.device),
                                torch.arange(nx, device=p.device),
                                indexing="ij")
        grid = torch.stack([gx, gy], -1).float()
        stride = torch.tensor([img_hw[1] / nx, img_hw[0] / ny],
                              device=p.device)
        xy = (s[..., :2] * 2.0 - 0.5 + grid) * stride
        wh = (s[..., 2:4] * 2.0) ** 2 * anchors[None, :, None, None, :]
        out = torch.cat([xy, wh, s[..., 4:]], -1)
        rows.append(out.reshape(b, na * ny * nx, no))
    return torch.cat(rows, 1)


def _iou(box: np.ndarray, others: np.ndarray) -> np.ndarray:
    lt = np.maximum(box[:2], others[:, :2])
    rb = np.minimum(box[2:4], others[:, 2:4])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[:, 0] * wh[:, 1]
    area = (box[2] - box[0]) * (box[3] - box[1])
    areas = (others[:, 2] - others[:, 0]) * (others[:, 3] - others[:, 1])
    return inter / np.maximum(area + areas - inter, 1e-9)


def nms(pred: np.ndarray, spec: Dict) -> np.ndarray:
    """Greedy NMS of one frame's decoded rows -> (k, 6) detections."""
    conf, iou_thres = float(spec["conf_thres"]), float(spec["iou_thres"])
    obj = pred[:, 4]
    wh = pred[:, 2:4]
    ok = (obj > conf) & np.all((wh > MIN_WH) & (wh < MAX_WH), 1)
    cls_scores = pred[:, 5:] * obj[:, None]
    best = cls_scores.argmax(1)
    score = cls_scores.max(1)
    idx = np.nonzero(ok)[0]
    idx = idx[np.argsort(-score[idx], kind="stable")][:int(spec["top_k"])]
    boxes = np.concatenate([pred[idx, :2] - pred[idx, 2:4] / 2,
                            pred[idx, :2] + pred[idx, 2:4] / 2], 1)
    kept: List[int] = []
    for j in range(len(idx)):
        same = [m for m in kept if best[idx[m]] == best[idx[j]]]
        if same and np.any(_iou(boxes[j], boxes[same]) > iou_thres):
            continue
        kept.append(j)
        if len(kept) == int(spec["max_det"]):
            break
    return np.concatenate([boxes[kept], score[idx[kept]][:, None],
                           best[idx[kept]][:, None].astype(np.float64)],
                          1).astype(np.float32)


def _blocks(frames_u8: np.ndarray, device, rows: int):
    """(block of frames as uint8 NHWC on ``device``, NCHW float32 / 255),
    with TF32 off while the caller iterates."""
    for i in range(0, len(frames_u8), rows):
        u8 = torch.from_numpy(
            np.ascontiguousarray(frames_u8[i:i + rows])).to(device)
        yield u8, u8.permute(0, 3, 1, 2).float() / 255.0


class _NoTF32:
    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


def raw_maps(state: Dict, frames_u8: np.ndarray, device,
             precision: str = "int8", rows: int = 32) -> List[np.ndarray]:
    """The raw head maps of every frame, NHWC as the program's
    ``Detector.raw_maps`` gives them: one (frames, ny, nx, na * (5 + nc))
    array a level."""
    net = _Net(state, precision)
    out: List[List[np.ndarray]] = []
    with _NoTF32(), torch.inference_mode():
        for _, x in _blocks(frames_u8, device, rows):
            out.append([p.permute(0, 2, 3, 1).cpu().numpy()
                        for p in net(state, x)])
    return [np.concatenate(level) for level in zip(*out)]


def forward(state, frames_u8: np.ndarray, device, precision: str = "int8",
            rows: int = 32) -> List[np.ndarray]:
    """Each frame's detections (k, 6), in blocks of ``rows`` frames, with
    TF32 off."""
    net = _Net(state, precision)
    out: List[np.ndarray] = []
    with _NoTF32(), torch.inference_mode():
        for u8, x in _blocks(frames_u8, device, rows):
            pred = _decode(state, net(state, x),
                           tuple(u8.shape[1:3])).cpu().numpy()
            out.extend(nms(p, state["spec"]) for p in pred)
    return out


def flops_per_frame(config: Dict, state: Dict) -> int:
    """Operations of the convs of one frame at the configuration's square
    input, two a multiply-add, from the yaml's shapes alone."""
    side = int(config["image_size"])
    sides: List[int] = []
    total = 0

    def conv(c1, c2, k, s, at):
        nonlocal total
        out = (at + 2 * (k // 2) - k) // s + 1
        total += 2 * out * out * k * k * c1 * c2
        return out

    for e in state["plan"]:
        m, f, n, args, c1, c2 = (e["m"], e["f"], e["n"], e["args"],
                                 e["c1"], e["c2"])
        at = side if f == -1 else sides[f] if isinstance(f, int) else None
        if m == "Focus":
            side = conv(4 * c1, c2, args[1] if len(args) > 1 else 1, 1,
                        at // 2)
        elif m == "Conv":
            for j in range(n):
                side = conv(c1 if j == 0 else c2, c2,
                            args[1] if len(args) > 1 else 1,
                            args[2] if len(args) > 2 else 1,
                            at if j == 0 else side)
        elif m == "C3":
            c_ = c2 // 2
            conv(c1, c_, 1, 1, at)
            conv(c1, c_, 1, 1, at)
            for _ in range(n):
                conv(c_, c_, 1, 1, at)
                conv(c_, c_, 3, 1, at)
            side = conv(2 * c_, c2, 1, 1, at)
        elif m == "SPP":
            c_ = c1 // 2
            ks = args[1] if len(args) > 1 else (5, 9, 13)
            conv(c1, c_, 1, 1, at)
            side = conv(c_ * (len(ks) + 1), c2, 1, 1, at)
        elif m == "nn.Upsample":
            side = at * int(args[1])
        elif m == "Concat":
            side = sides[f[0] if f[0] >= 0 else -1]
        else:                                               # Detect
            for j, cin in zip(f, c1):
                conv(cin, c2, 1, 1, sides[j])
        sides.append(side)
    return int(total)
