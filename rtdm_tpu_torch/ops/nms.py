"""Batched NMS with fixed-size outputs.

Counterpart of ``rtdm_tpu/ops/nms.py``: ``xywh_to_xyxy``,
``box_iou_matrix``, ``batched_nms`` (greedy = 'or' = 'vision_batch',
merge, soft and 'and', with multi_label, class_agnostic, the ``classes``
filter, the (min_wh, max_wh) size gate and the class-offset trick) and
``scale_coords``. Results are (B, max_det, 6) rows x1, y1, x2, y2, conf,
cls, zero-padded, with a count per frame.

Candidates are taken as ``lax.top_k`` takes them: by score, ties to the
lower index (a stable descending sort; ``torch.topk`` promises no tie
order), and the kept ones ordered as ``jnp.argsort(-score)`` orders them
(a stable ascending sort). On the same predictions, det and count equal the
jitted reference's bit for bit for every method but merge, whose weighted
box sums are taken in another order (within a few ulps).

The greedy keep is the fixpoint of ``keep[i] = valid[i] & ~any_{j<i}(keep[j]
& iou[j, i] > thr)``: its unique solution is the sequential greedy result,
reached by Jacobi steps from ``keep = valid``. Each step ends in one host
sync (the convergence test), a ``det:nms:wait`` span
(``utils/profiler.py::span``), as is the copy of the ``classes`` mask to
the device. The soft and 'and' variants walk the K candidates one at a
time, as the reference's loops do.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from rtdm_tpu_torch.ops.numerics import exp_f32
from rtdm_tpu_torch.utils.profiler import span

METHODS = ("greedy", "or", "vision_batch", "merge", "soft", "and")


def xywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    xy, wh = b[..., :2], b[..., 2:4]
    return torch.cat([xy - wh / 2.0, xy + wh / 2.0], -1)


def box_iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of (..., N, 4) x (..., M, 4) xyxy boxes -> (..., N, M)."""
    wa = (a[..., 2] - a[..., 0]).clamp_min(0)
    ha = (a[..., 3] - a[..., 1]).clamp_min(0)
    wb = (b[..., 2] - b[..., 0]).clamp_min(0)
    hb = (b[..., 3] - b[..., 1]).clamp_min(0)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:4], b[..., None, :, 2:4])
    wh = (rb - lt).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    union = (wa * ha)[..., :, None] + (wb * hb)[..., None, :] - inter
    return inter / union.clamp_min(1e-9)


def greedy_keep(iou: torch.Tensor, valid: torch.Tensor, iou_thres: float
                ) -> Tuple[torch.Tensor, int]:
    """(B, K, K) IoU of score-sorted candidates, (B, K) valid -> (keep mask,
    Jacobi steps taken). Capped at K steps, as the reference's loop is."""
    k = iou.shape[-1]
    order = torch.arange(k, device=iou.device)
    s = (iou > iou_thres) & (order[:, None] < order[None, :])
    keep, steps = valid, 0
    while steps < k:
        new = valid & ~(keep[..., :, None] & s).any(-2)
        steps += 1
        with span("det:nms:wait"):
            converged = torch.equal(new, keep)
        if converged:
            break
        keep = new
    return keep, steps


def and_keep(iou: torch.Tensor, valid: torch.Tensor, same_cls: torch.Tensor,
             iou_thres: float) -> torch.Tensor:
    """'and'-NMS: a head box is kept only if it overlaps (IoU > 0.5) another
    still-alive box of its class; the head suppresses later boxes (IoU >=
    iou_thres) whether or not it is kept. A class with one candidate keeps
    it."""
    b, k = valid.shape
    pos = torch.arange(k, device=iou.device)
    alive = valid.clone()
    keep = torch.zeros_like(valid)
    for i in range(k):
        later = alive & (pos > i) & same_cls[:, i]
        overlap = torch.where(later, iou[:, i], 0.0).amax(-1)
        head = alive[:, i] & valid[:, i]
        keep[:, i] = head & (overlap > 0.5)
        alive = alive & ~(head[:, None] & later & (iou[:, i] >= iou_thres))
    count = (same_cls & valid[:, None, :]).sum(-1)
    return keep | (valid & (count == 1))


def soft_keep(iou: torch.Tensor, valid: torch.Tensor, scores: torch.Tensor,
              same: torch.Tensor, conf_thres: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Soft-NMS (Gaussian, sigma 0.5) in score order: each emitted box
    multiplies every later box's score by exp(-iou^2 / 0.5) (cross-class
    IoU is 0 under the class offset); a box whose decayed score falls to
    conf_thres or below is dropped and decays nobody, except the first
    candidate of its class. Returns (keep, decayed scores)."""
    b, k = valid.shape
    pos = torch.arange(k, device=iou.device)
    later = pos[:, None] > pos[None, :]
    head = valid & ~(same & later & valid[:, None, :]).any(-1)
    decay = exp_f32(-torch.square(iou) * 2.0)
    keep = torch.zeros_like(valid)
    for i in range(k):
        alive = valid[:, i] & ((scores[:, i] > conf_thres) | head[:, i])
        scores = torch.where((pos > i) & alive[:, None],
                             scores * decay[:, i], scores)
        keep[:, i] = alive
    return keep, scores


def batched_nms(pred: torch.Tensor, conf_thres: float = 0.001,
                iou_thres: float = 0.6, max_det: int = 300, top_k: int = 512,
                multi_label: bool = False, class_agnostic: bool = False,
                max_wh: float = 4096.0, min_wh: float = 2.0,
                method: str = "greedy",
                classes: Optional[Sequence[int]] = None, stats=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """NMS over decoded predictions.

    pred: (B, N, 5+nc) rows cx, cy, w, h, obj, class probabilities. Scores
    are obj * cls. Filters, in the reference's order: obj > conf_thres,
    min_wh < w, h < max_wh, then the best class of each row, or with
    multi_label (nc > 1) one row per (box, class) with obj * cls >
    conf_thres; ``classes`` drops rows whose class is not listed. Returns
    (det (B, min(max_det, K), 6), count (B,)), K = min(top_k, candidates).
    ``stats``, a dict, gets the greedy fixpoint's step count."""
    if method not in METHODS:
        raise ValueError(f"unknown NMS method {method!r}")
    pred = pred.float()
    b, n, width = pred.shape
    nc = width - 5
    dev = pred.device
    boxes = xywh_to_xyxy(pred[..., :4])
    obj = pred[..., 4]
    wh = pred[..., 2:4]
    base_ok = (obj > conf_thres) & ((wh > min_wh) & (wh < max_wh)).all(-1)
    cls_probs = pred[..., 5:] * obj[..., None]
    allowed = None
    if classes is not None:
        a = np.zeros((nc,), bool)
        a[[c for c in classes if 0 <= int(c) < nc]] = True
        with span("det:nms:wait"):
            allowed = torch.as_tensor(a, device=dev)

    if multi_label and nc > 1:
        flat = cls_probs.reshape(b, n * nc)
        flat_box = torch.arange(n, device=dev).repeat_interleave(nc)
        flat_cls = torch.arange(nc, device=dev).repeat(n)
        ok = base_ok[:, flat_box] & (flat > conf_thres)
        if allowed is not None:
            ok = ok & allowed[flat_cls]
        key = torch.where(ok, flat, -1.0)
        top_scores, idx = _top(key, top_k)
        top_boxes = torch.gather(boxes, 1, flat_box[idx][..., None]
                                 .expand(-1, -1, 4))
        top_cls = flat_cls[idx]
    else:
        best_cls = cls_probs.argmax(-1)
        score = cls_probs.amax(-1)
        ok = base_ok if allowed is None else base_ok & allowed[best_cls]
        key = torch.where(ok, score, -1.0)
        top_scores, idx = _top(key, top_k)
        top_boxes = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
        top_cls = torch.gather(best_cls, 1, idx)
    valid = top_scores > -0.5

    nms_boxes = (top_boxes if class_agnostic
                 else top_boxes + top_cls.float()[..., None] * max_wh)
    iou = box_iou_matrix(nms_boxes, nms_boxes)
    same_cls = top_cls[:, :, None] == top_cls[:, None, :]

    if method == "soft":
        same = torch.ones_like(same_cls) if class_agnostic else same_cls
        keep, soft = soft_keep(iou, valid, top_scores, same, conf_thres)
        top_scores = torch.where(keep, soft, 0.0)
    elif method == "and":
        keep = and_keep(iou, valid, same_cls, iou_thres)
    else:
        keep, steps = greedy_keep(iou, valid, iou_thres)
        if stats is not None:
            stats["greedy_steps"] = steps
        if method == "merge":
            # yolov5's merge: each kept box becomes the score-weighted mean
            # of every candidate with IoU > thres (itself included), and a
            # kept box that overlaps only itself is dropped
            overlap = (iou > iou_thres) & valid[:, None, :]
            w = torch.where(overlap, top_scores[:, None, :], 0.0)
            merged = torch.bmm(w, top_boxes) / w.sum(-1, keepdim=True)\
                .clamp_min(1e-9)
            top_boxes = torch.where(keep[..., None], merged, top_boxes)
            keep = keep & (overlap.sum(-1) > 1)

    kept = torch.where(keep, top_scores, -1.0)
    order = torch.argsort(-kept, dim=1, stable=True)[:, :max_det]
    sel = torch.gather(keep, 1, order)
    det = torch.cat([torch.gather(top_boxes, 1,
                                  order[..., None].expand(-1, -1, 4)),
                     torch.gather(top_scores, 1, order)[..., None],
                     torch.gather(top_cls, 1, order).float()[..., None]], -1)
    det = torch.where(sel[..., None], det, 0.0)
    return det, sel.sum(-1, dtype=torch.int32)


def _top(key: torch.Tensor, top_k: int):
    """``lax.top_k`` along the last axis: the k largest, ties to the lower
    index, k = min(top_k, length)."""
    k = min(top_k, key.shape[-1])
    values, idx = torch.sort(key, dim=-1, descending=True, stable=True)
    return values[:, :k], idx[:, :k]


def scale_coords(det: torch.Tensor, model_hw: Tuple[int, int],
                 orig_hw: Tuple[int, int], letterboxed: bool = True,
                 ratio_pad=None) -> torch.Tensor:
    """x1, y1, x2, y2 from model-input space back to the original frame,
    clipped to it; ``ratio_pad = (gain, (pad_w, pad_h))`` gives the
    letterbox that was applied instead of recomputing the fit."""
    mh, mw = model_hw
    oh, ow = orig_hw
    dev = det.device
    if letterboxed:
        if ratio_pad is not None:
            gain = float(ratio_pad[0])
            pad_w, pad_h = float(ratio_pad[1][0]), float(ratio_pad[1][1])
        else:
            gain = min(mh / oh, mw / ow)
            pad_w, pad_h = (mw - ow * gain) / 2.0, (mh - oh * gain) / 2.0
        pad = torch.tensor([pad_w, pad_h, pad_w, pad_h], device=dev)
        boxes = (det[..., :4] - pad) / torch.tensor(np.float32(gain),
                                                    device=dev)
    else:
        boxes = det[..., :4] * torch.tensor(
            [ow / mw, oh / mh, ow / mw, oh / mh], device=dev)
    boxes = torch.minimum(boxes.clamp_min(0.0),
                          torch.tensor([ow, oh, ow, oh], dtype=torch.float32,
                                       device=dev))
    return torch.cat([boxes, det[..., 4:]], -1)
