"""YOLO head decode.

Counterpart of ``rtdm_tpu/ops/yolo.py`` (``decode_head``, ``decode_all``).
A raw NHWC head map with ``na * (5 + nc)`` channels, anchor-major
(``[x, y, w, h, obj, cls...]`` per anchor), becomes (B, na*ny*nx, 5+nc)
rows of cx, cy, w, h in input pixels, then obj and class scores, flattened
anchor-major ((b, na, ny, nx) order). Four decodes:

- classic: xy = (sigmoid(t)*sxy - (sxy-1)/2 + grid) * stride,
  wh = exp(t) * anchor, obj and classes sigmoid (``scale_x_y`` = sxy);
- new_coords: the map is already squashed: xy = (t*sxy - (sxy-1)/2 + grid)
  * stride, wh = (2t)^2 * anchor, the rest as is;
- v5: s = sigmoid(t), xy = (2s - 0.5 + grid) * stride, wh = (2s)^2 * anchor.

The stride is per axis (input w / nx, input h / ny), so ``img_size`` may be
an (h, w) pair. Everything runs in fp32 with the compiled reference's exp
and sigmoid (``ops/numerics.py``) and its one fused multiply-add.
``raw_to_train_layout`` gives the training loss its (B, na, ny, nx, no)
view of a map. A head's anchors and stride are built on the host and
copied to the map's device, each copy a ``det:decode:wait`` span
(``utils/profiler.py::span``): on the card it blocks the host.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from rtdm_tpu_torch.ops.numerics import exp_f32, sigmoid_f32
from rtdm_tpu_torch.utils.profiler import span


def _hw(img_size):
    if isinstance(img_size, (int, float, np.integer, np.floating)):
        return int(img_size), int(img_size)
    return int(img_size[0]), int(img_size[1])


def decode_head(p: torch.Tensor, anchors_px, img_size, num_classes: int,
                scale_x_y: float = 1.0, new_coords: bool = False,
                v5: bool = False) -> torch.Tensor:
    """(B, ny, nx, na*(5+nc)) raw map -> (B, na*ny*nx, 5+nc) decoded."""
    b, ny, nx, _ = p.shape
    with span("det:decode:wait"):
        anchors = torch.as_tensor(np.asarray(anchors_px, np.float32),
                                  device=p.device)
    na, no = anchors.shape[0], num_classes + 5
    in_h, in_w = _hw(img_size)
    with span("det:decode:wait"):
        stride = torch.tensor([np.float32(in_w / nx), np.float32(in_h / ny)],
                              device=p.device)
    p = p.reshape(b, ny, nx, na, no).float()
    gy, gx = torch.meshgrid(torch.arange(ny, device=p.device),
                            torch.arange(nx, device=p.device), indexing="ij")
    grid = torch.stack([gx, gy], -1).float()[None, :, :, None, :]
    anchors = anchors[None, None, None]
    if v5:
        s = sigmoid_f32(p)
        xy = (s[..., 0:2] * 2.0 - 0.5 + grid) * stride
        wh = torch.square(s[..., 2:4] * 2.0) * anchors
        out = torch.cat([xy, wh, s[..., 4:]], -1)
    else:
        sxy = torch.full((), np.float32(scale_x_y), device=p.device)
        shift = torch.full((), -np.float32(0.5 * (scale_x_y - 1.0)),
                           device=p.device)
        txy = p[..., 0:2] if new_coords else sigmoid_f32(p[..., 0:2])
        xy = (torch.addcmul(shift, txy, sxy) + grid) * stride
        if new_coords:
            wh = torch.square(p[..., 2:4] * 2.0) * anchors
            rest = p[..., 4:]
        else:
            wh = exp_f32(p[..., 2:4]) * anchors
            rest = sigmoid_f32(p[..., 4:])
        out = torch.cat([xy, wh, rest], -1)
    # anchor-major flatten, the torch fork's (b, na, ny, nx) order
    return out.permute(0, 3, 1, 2, 4).reshape(b, na * ny * nx, no)


def decode_all(raw_maps: Sequence[torch.Tensor], heads, img_size
               ) -> torch.Tensor:
    """The decoded rows of every head, concatenated: (B, total, 5+nc)."""
    return torch.cat([decode_head(p, h.anchors_px, img_size, h.num_classes,
                                  h.scale_x_y, h.new_coords,
                                  getattr(h, "v5", False))
                      for p, h in zip(raw_maps, heads)], 1)


def raw_to_train_layout(p: torch.Tensor, na: int, num_classes: int
                        ) -> torch.Tensor:
    """(B, ny, nx, na*no) -> (B, na, ny, nx, no), the loss-side layout (a
    view: no copy)."""
    b, ny, nx, _ = p.shape
    return p.reshape(b, ny, nx, na, num_classes + 5).permute(0, 3, 1, 2, 4)
