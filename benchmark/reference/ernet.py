"""Plain reference of the ErNET classifier family (Squeeze_ErNET, ErNET).

Plain torch in float32 (TF32 off), NCHW, from the engine directory's
``params.npz`` and ``spec.json`` as committed; it imports nothing of
``rtdm_tpu_torch`` or ``rtdm_tpu``. The network, as the reference repo's
``code/disaster_detection/model/`` defines it:

- ``(x / 255 - mean) / std`` with the ImageNet mean and std;
- conv1: 3x3, stride 2, no padding, no bias;
- ACFF blocks: three depthwise 3x3 convs with bias, at dilation 1, 2, 3
  and padding 0, 1, 2; their channel concat; a 1x1 conv with bias;
  LeakyReLU(0.01); BatchNorm with the running statistics (eps 1e-5);
  a 2x2 max-pool after each of the first three blocks;
- head: a 1x1 conv to the classes without bias, AvgPool(5, 1, p) counting
  the padding, a flatten in (C, H, W) order, a dense layer, softmax.

``precision="fp8"`` is the control: every conv and dense input and weight
rounded to float8 e4m3 with a scale (activations per tensor, weights per
output channel, absmax over 448) before the float32 product.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
FP8_MAX = 448.0


def load(config: Dict, root: str, device) -> Dict:
    """The engine's tensors on ``device``, in float32, NCHW kernels."""
    path = os.path.join(root, config["engine"])
    with open(os.path.join(path, "spec.json")) as f:
        spec = json.load(f)
    with np.load(os.path.join(path, "params.npz")) as z:
        tree = {k: np.asarray(z[k], np.float32) for k in z.files}
    t = {}
    for key, val in tree.items():
        v = torch.from_numpy(val)
        if key.endswith("/kernel") and v.ndim == 4:   # HWIO -> OIHW
            v = v.permute(3, 2, 0, 1)
        t[key] = v.contiguous().to(device)
    blocks = sorted({k.split("/")[1] for k in tree if "/acff" in k},
                    key=lambda name: int(name[4:]))
    return {"t": t, "blocks": blocks, "spec": spec,
            "head_pool_padding": int(config["head_pool_padding"]),
            "pooled_blocks": int(config["pooled_blocks"])}


def _fp8(x: torch.Tensor, dims) -> torch.Tensor:
    scale = x.abs().amax(dim=dims, keepdim=True).clamp_min(1e-30) / FP8_MAX
    q = (x / scale).clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn)
    return q.float() * scale


def _conv(x, w, b=None, *, precision, **kw):
    if precision == "fp8":
        x = _fp8(x, None)
        w = _fp8(w, (1, 2, 3))
    return F.conv2d(x, w, b, **kw)


def _acff(x, t, name, precision):
    p = f"params/{name}"
    c = x.shape[1]
    branches = [_conv(x, t[f"{p}/conv{i}/kernel"], t[f"{p}/conv{i}/bias"],
                      precision=precision, padding=i - 1, dilation=i,
                      groups=c) for i in (1, 2, 3)]
    y = _conv(torch.cat(branches, 1), t[f"{p}/fused_conv/kernel"],
              t[f"{p}/fused_conv/bias"], precision=precision)
    y = F.leaky_relu(y, 0.01)
    mean = t[f"batch_stats/{name}/batch_norm/mean"]
    var = t[f"batch_stats/{name}/batch_norm/var"]
    scale = t[f"{p}/batch_norm/scale"]
    bias = t[f"{p}/batch_norm/bias"]
    inv = scale / torch.sqrt(var + 1e-5)
    return (y - mean[:, None, None]) * inv[:, None, None] \
        + bias[:, None, None]


def _forward(state, u8: torch.Tensor, precision: str) -> torch.Tensor:
    t = state["t"]
    mean = torch.tensor(MEAN, device=u8.device)[:, None, None]
    std = torch.tensor(STD, device=u8.device)[:, None, None]
    x = (u8.permute(0, 3, 1, 2).float() / 255.0 - mean) / std
    x = _conv(x, t["params/conv1/kernel"], None, precision=precision,
              stride=2)
    for i, name in enumerate(state["blocks"]):
        x = _acff(x, t, name, precision)
        if i < state["pooled_blocks"]:
            x = F.max_pool2d(x, 2, 2)
    x = _conv(x, t["params/head/conv2/kernel"], None, precision=precision)
    x = F.avg_pool2d(x, 5, 1, state["head_pool_padding"],
                     count_include_pad=True)
    x = x.reshape(x.shape[0], -1)
    w = t["params/head/fc/kernel"]
    if precision == "fp8":
        x, w = _fp8(x, None), _fp8(w, (0,))
    return torch.softmax(x @ w + t["params/head/fc/bias"], -1)


def forward(state, frames_u8: np.ndarray, device, precision: str = "fp32",
            rows: int = 512) -> np.ndarray:
    """Softmax rows (N, classes) of uint8 NHWC frames, in blocks of
    ``rows`` frames, with TF32 off."""
    if precision not in ("fp32", "fp8"):
        raise ValueError(f"unknown reference precision {precision!r}")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = []
        with torch.inference_mode():
            for i in range(0, len(frames_u8), rows):
                u8 = torch.from_numpy(
                    np.ascontiguousarray(frames_u8[i:i + rows])).to(device)
                out.append(_forward(state, u8, precision).cpu().numpy())
        return np.concatenate(out)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def block_shapes(config: Dict, state: Dict) -> list:
    """(C, O, input side) of each ACFF block of one forward."""
    side = (int(config["image_size"]) - 3) // 2 + 1
    shapes = []
    for i, name in enumerate(state["blocks"]):
        c = state["t"][f"params/{name}/conv1/kernel"].shape[0]
        o = state["t"][f"params/{name}/fused_conv/kernel"].shape[0]
        shapes.append((c, o, side))
        side -= 2
        if i < state["pooled_blocks"]:
            side //= 2
    return shapes


def flops_per_frame(config: Dict, state: Dict) -> int:
    """Operations of the convs and the dense layer of one frame, two a
    multiply-add, from the shapes alone."""
    t = state["t"]
    side = (int(config["image_size"]) - 3) // 2 + 1
    total = 2 * side * side * 27 * t["params/conv1/kernel"].shape[0]
    for c, o, s in block_shapes(config, state):
        p = (s - 2) * (s - 2)
        total += 2 * p * 27 * c + 2 * p * 3 * c * o
        side = s - 2
    classes, cin = t["params/head/conv2/kernel"].shape[:2]
    total += 2 * side * side * cin * classes
    fc_in, fc_out = t["params/head/fc/kernel"].shape
    return int(total + 2 * fc_in * fc_out)
