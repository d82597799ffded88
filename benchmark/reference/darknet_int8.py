"""Plain reference of a sealed int8 darknet detector: network, decode, NMS.

Plain torch in float32 (TF32 off) and numpy, from the engine directory's
``spec.json``, ``model.txt`` (the darknet cfg), ``params.npz`` (int8
kernel codes ``.q`` with per-output-channel scales ``.s``, fp32 biases;
BatchNorm folded in) and ``act_scales.npz`` as committed; it imports
nothing of ``rtdm_tpu_torch`` or ``rtdm_tpu``. As darknet and the
reference repo's ``yolov3/models.py`` compute it, with int8 QDQ:

- the input is ``u8 / 255``;
- every conv that has an activation scale s takes ``clip(round(x / s),
  -127, 127) * s`` (round half to even), and its kernel is ``codes *
  scale``; ``pad=1`` pads a k x k conv by (k - 1) // 2; activations leaky
  (slope 0.1) or linear;
- maxpool: a 2x2 stride-1 pool pads the bottom and right with zeros, any
  other pads (k - 1) // 2; upsample repeats; route concatenates channels;
- decode of each [yolo] head, rows (b, anchor, y, x): xy = (sigmoid(t) +
  grid) * stride, wh = exp(t) * anchor, objectness and classes sigmoid;
- greedy NMS per frame: rows with objectness over ``conf_thres`` and both
  sides in (2, 4096) px, the best class by objectness * class, the
  ``top_k`` best by that score (ties to the lower row), then in score
  order a box is kept unless a kept box of its class overlaps it by IoU
  over ``iou_thres``; at most ``max_det`` rows x1, y1, x2, y2, conf, cls.

``precision="int4"`` is the control: kernel codes and activation codes cut
to [-7, 7] at 127/7 times the scale.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

MIN_WH, MAX_WH = 2.0, 4096.0


def parse_cfg(text: str) -> List[Dict]:
    """The blocks of a darknet cfg, ``[net]`` first, values as strings."""
    blocks: List[Dict] = []
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        if line.startswith("["):
            blocks.append({"type": line[1:-1].strip()})
        else:
            key, val = line.split("=", 1)
            blocks[-1][key.strip()] = val.strip()
    return blocks


def _ints(text: str) -> List[int]:
    return [int(v) for v in text.split(",") if v.strip()]


def load(config: Dict, root: str, device) -> Dict:
    path = os.path.join(root, config["engine"])
    with open(os.path.join(path, "spec.json")) as f:
        spec = json.load(f)
    with open(os.path.join(path, "model.txt")) as f:
        defs = parse_cfg(f.read())[1:]
    with np.load(os.path.join(path, "params.npz")) as z:
        tree = {k: np.asarray(z[k]) for k in z.files}
    with np.load(os.path.join(path, "act_scales.npz")) as z:
        scales = {k: float(z[k]) for k in z.files}
    convs = {}
    for i, d in enumerate(defs):
        if d["type"] != "convolutional":
            continue
        p = f"params/l{i}_conv"
        q = torch.from_numpy(tree[p + "/kernel.q"].astype(np.float32))
        s = torch.from_numpy(tree[p + "/kernel.s"].astype(np.float32))
        convs[i] = {"q": q.permute(3, 2, 0, 1).contiguous().to(device),
                    "s": s.reshape(-1).to(device),
                    "b": torch.from_numpy(tree[p + "/bias"].astype(
                        np.float32)).to(device),
                    "act": scales[f"l{i}_conv"]}
    return {"defs": defs, "convs": convs, "spec": spec}


def _qdq(x: torch.Tensor, s: float, levels: int) -> torch.Tensor:
    return torch.clamp(torch.round(x / s), -levels, levels) * s


def _network(state, x: torch.Tensor, precision: str) -> List[torch.Tensor]:
    levels = 7 if precision == "int4" else 127
    widen = 127.0 / levels
    outputs, heads = [], []
    for i, d in enumerate(state["defs"]):
        t = d["type"]
        if t == "convolutional":
            c = state["convs"][i]
            k = int(d.get("size", 1))
            q, s = c["q"], c["s"]
            if levels != 127:
                q = torch.clamp(torch.round(q / widen), -levels, levels)
                s = s * widen
            w = q * s[:, None, None, None]
            x = _qdq(x, c["act"] * widen, levels)
            pad = (k - 1) // 2 if int(d.get("pad", 0)) else 0
            x = F.conv2d(x, w, c["b"], stride=int(d.get("stride", 1)),
                         padding=pad)
            act = d.get("activation", "linear")
            if act == "leaky":
                x = F.leaky_relu(x, 0.1)
            elif act != "linear":
                raise ValueError(f"activation {act!r} not in the reference")
        elif t == "maxpool":
            k, s = int(d["size"]), int(d["stride"])
            if k == 2 and s == 1:
                x = F.max_pool2d(F.pad(x, (0, 1, 0, 1)), 2, 1)
            else:
                x = F.max_pool2d(x, k, s, (k - 1) // 2)
        elif t == "upsample":
            s = int(d["stride"])
            x = x.repeat_interleave(s, 2).repeat_interleave(s, 3)
        elif t == "route":
            srcs = [outputs[j if j >= 0 else i + j]
                    for j in _ints(d["layers"])]
            x = torch.cat(srcs, 1)
        elif t == "yolo":
            heads.append((x, d))
        else:
            raise ValueError(f"block [{t}] not in the reference")
        outputs.append(x)
    return heads


def _decode(heads, img_hw: Tuple[int, int]) -> torch.Tensor:
    rows = []
    for p, d in heads:
        anchors = np.array(_ints(d["anchors"]), np.float32).reshape(-1, 2)
        anchors = torch.from_numpy(anchors[_ints(d["mask"])]).to(p.device)
        na, nc = anchors.shape[0], int(d["classes"])
        b, _, ny, nx = p.shape
        p = p.reshape(b, na, 5 + nc, ny, nx).permute(0, 1, 3, 4, 2)
        gy, gx = torch.meshgrid(torch.arange(ny, device=p.device),
                                torch.arange(nx, device=p.device),
                                indexing="ij")
        grid = torch.stack([gx, gy], -1).float()
        stride = torch.tensor([img_hw[1] / nx, img_hw[0] / ny],
                              device=p.device)
        xy = (torch.sigmoid(p[..., :2]) + grid) * stride
        wh = torch.exp(p[..., 2:4]) * anchors[None, :, None, None, :]
        out = torch.cat([xy, wh, torch.sigmoid(p[..., 4:])], -1)
        rows.append(out.reshape(b, na * ny * nx, 5 + nc))
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


def forward(state, frames_u8: np.ndarray, device, precision: str = "int8",
            rows: int = 32) -> List[np.ndarray]:
    """Each frame's detections (k, 6), in blocks of ``rows`` frames, with
    TF32 off."""
    if precision not in ("int8", "int4"):
        raise ValueError(f"unknown reference precision {precision!r}")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out: List[np.ndarray] = []
    try:
        with torch.inference_mode():
            for i in range(0, len(frames_u8), rows):
                u8 = torch.from_numpy(
                    np.ascontiguousarray(frames_u8[i:i + rows])).to(device)
                x = u8.permute(0, 3, 1, 2).float() / 255.0
                pred = _decode(_network(state, x, precision),
                               tuple(u8.shape[1:3])).cpu().numpy()
                out.extend(nms(p, state["spec"]) for p in pred)
        return out
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def flops_per_frame(config: Dict, state: Dict) -> int:
    """Operations of the convs of one frame at the configuration's square
    input, two a multiply-add, from the cfg's shapes alone."""
    side = int(config["image_size"])
    sides: List[int] = []
    chans: List[int] = []
    c, total = 3, 0
    for i, d in enumerate(state["defs"]):
        t = d["type"]
        if t == "convolutional":
            k, s = int(d.get("size", 1)), int(d.get("stride", 1))
            o = int(d["filters"])
            pad = (k - 1) // 2 if int(d.get("pad", 0)) else 0
            side = (side + 2 * pad - k) // s + 1
            total += 2 * side * side * k * k * c * o
            c = o
        elif t == "maxpool":
            k, s = int(d["size"]), int(d["stride"])
            if not (k == 2 and s == 1):
                side = (side + 2 * ((k - 1) // 2) - k) // s + 1
        elif t == "upsample":
            side *= int(d["stride"])
        elif t == "route":
            srcs = [j if j >= 0 else i + j for j in _ints(d["layers"])]
            side, c = sides[srcs[0]], sum(chans[j] for j in srcs)
        sides.append(side)
        chans.append(c)
    return int(total)
