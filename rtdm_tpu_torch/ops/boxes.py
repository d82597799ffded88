"""Box IoU family: plain/GIoU/DIoU/CIoU of aligned boxes and the wh-IoU
matrix.

Counterpart of ``rtdm_tpu/ops/boxes.py``, on tensors, with its arithmetic
in the same order (yolov3/utils/utils.py:237-315 and
yolov5/utils/general.py:415 semantics). The training losses use both; the
CIoU's ``alpha`` is detached, as the reference stops its gradient.
"""

from __future__ import annotations

import math

import torch


def bbox_iou(box1: torch.Tensor, box2: torch.Tensor, xywh: bool = True,
             giou: bool = False, diou: bool = False, ciou: bool = False,
             eps: float = 1e-9) -> torch.Tensor:
    """Pairwise IoU of aligned boxes (..., 4) x (..., 4) -> (...)."""
    if xywh:
        b1x1 = box1[..., 0] - box1[..., 2] / 2
        b1x2 = box1[..., 0] + box1[..., 2] / 2
        b1y1 = box1[..., 1] - box1[..., 3] / 2
        b1y2 = box1[..., 1] + box1[..., 3] / 2
        b2x1 = box2[..., 0] - box2[..., 2] / 2
        b2x2 = box2[..., 0] + box2[..., 2] / 2
        b2y1 = box2[..., 1] - box2[..., 3] / 2
        b2y2 = box2[..., 1] + box2[..., 3] / 2
    else:
        b1x1, b1y1, b1x2, b1y2 = box1.unbind(-1)
        b2x1, b2y1, b2x2, b2y2 = box2.unbind(-1)

    inter_w = (torch.minimum(b1x2, b2x2)
               - torch.maximum(b1x1, b2x1)).clamp_min(0)
    inter_h = (torch.minimum(b1y2, b2y2)
               - torch.maximum(b1y1, b2y1)).clamp_min(0)
    inter = inter_w * inter_h
    w1, h1 = b1x2 - b1x1, b1y2 - b1y1
    w2, h2 = b2x2 - b2x1, b2y2 - b2y1
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union

    if not (giou or diou or ciou):
        return iou

    cw = torch.maximum(b1x2, b2x2) - torch.minimum(b1x1, b2x1)
    ch = torch.maximum(b1y2, b2y2) - torch.minimum(b1y1, b2y1)
    if giou:
        c_area = cw * ch + eps
        return iou - (c_area - union) / c_area
    c2 = cw ** 2 + ch ** 2 + eps  # convex diagonal squared
    rho2 = ((b2x1 + b2x2 - b1x1 - b1x2) ** 2
            + (b2y1 + b2y2 - b1y1 - b1y2) ** 2) / 4
    if diou:
        return iou - rho2 / c2
    v = (4 / math.pi ** 2) * torch.square(
        torch.atan(w2 / (h2 + eps)) - torch.atan(w1 / (h1 + eps)))
    alpha = (v / (v - iou + (1 + eps))).detach()
    return iou - (rho2 / c2 + v * alpha)


def wh_iou_matrix(wh1: torch.Tensor, wh2: torch.Tensor) -> torch.Tensor:
    """(..., N, 2) x (M, 2) -> (..., N, M) IoU of co-centred boxes; leading
    dims of ``wh1`` broadcast (the loss's (B, M, 2) x (na, 2) match)."""
    inter = torch.minimum(wh1[..., :, None, :],
                          wh2[..., None, :, :]).prod(-1)
    return inter / (wh1.prod(-1)[..., :, None]
                    + wh2.prod(-1)[..., None, :] - inter + 1e-16)
