"""YOLO training losses, v3 and v5, on fixed-size candidates.

Counterpart of ``rtdm_tpu/train/yolo_loss.py``. Every (image, label slot,
anchor) triple (v5: times five cell offsets) is a candidate with a validity
mask, so the loss has no data-dependent shapes:

- ``yolo_loss`` (the v3 fork, yolov3/utils/utils.py:366-485): a candidate
  is valid where its slot holds a label and the wh-IoU of label and anchor
  exceeds ``iou_t``; box loss ``mean(1 - GIoU)``, objectness BCE over every
  cell against ``tobj``, class BCE on one-hot targets when nc > 1, each
  BCE optionally focal (``fl_gamma``); gains ``giou``, ``obj``, ``cls``.
- ``yolo_loss_v5`` (ultralytics ComputeLoss, yolov5/utils/loss.py:90-216):
  ratio anchor match ``max(r, 1/r) < anchor_t``, the centre cell and up to
  two neighbours, v5 box decode and CIoU, the per-level objectness balance
  ``[4, 1, 0.4]``, and the total times the batch size.

Under a data-parallel ``mesh`` (``core/mesh.py``) each rank passes its
rows of the global batch, and its loss is its share of the global batch's:
every mean divides the rank's sum by the global count (the masked means'
denominators all-reduced, carrying no gradient; the objectness mean over
every rank's cells), and v5 scales by the global batch size. The ranks'
losses then sum to the one-process loss, and so do their gradients. A mean
of per-rank losses is another loss.

``tobj`` is a scatter-max of the IoU ratio into the cells
(``scatter_reduce(..., "amax")``), deterministic where candidates collide
in one cell as the reference's ``.at[].max`` is; an index-put would keep
whichever write came last. The gathers ``p[b, a, gj, gi]`` sum their
gradients over candidates that share a cell, as JAX's transpose of a
gather does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from rtdm_tpu_torch.models.layers import acc_dtype, softplus
from rtdm_tpu_torch.parallel.comms import psum_along
from rtdm_tpu_torch.ops.boxes import bbox_iou, wh_iou_matrix
from rtdm_tpu_torch.ops.yolo import raw_to_train_layout


@dataclasses.dataclass(frozen=True)
class YoloHyp:
    """v3 loss hyperparameters (defaults = yolov3/train.py:27-44)."""
    giou: float = 1.0
    cls: float = 37.4
    cls_pw: float = 1.0
    obj: float = 64.3
    obj_pw: float = 1.0
    iou_t: float = 0.3
    fl_gamma: float = 1.5
    fl_alpha: float = 0.25
    gr: float = 1.0           # giou-ratio for obj targets (train.py:226)
    label_smoothing: float = 0.0


@dataclasses.dataclass(frozen=True)
class YoloHypV5:
    """v5 loss hyperparameters (defaults = yolov5/data/hyp.scratch.yaml)."""
    box: float = 0.05
    cls: float = 0.5
    cls_pw: float = 1.0
    obj: float = 1.0
    obj_pw: float = 1.0
    anchor_t: float = 4.0
    fl_gamma: float = 0.0
    fl_alpha: float = 0.25
    gr: float = 1.0
    label_smoothing: float = 0.0


def scale_v5_gains(hyp: YoloHypV5, nl: int, nc: int,
                   img_size: int) -> YoloHypV5:
    """The v5 gain scaling (yolov5/train.py:225-227): hyp.scratch assumes 3
    levels, 80 classes and 640 px; box scales to the levels, cls to the
    classes and levels, obj to the image size and levels."""
    return dataclasses.replace(
        hyp,
        box=hyp.box * 3.0 / nl,
        cls=hyp.cls * nc / 80.0 * 3.0 / nl,
        obj=hyp.obj * (img_size / 640.0) ** 2 * 3.0 / nl)


def _bce_logits(x, t, pos_weight=1.0):
    """Elementwise BCE-with-logits with a positive weight, in log space."""
    log_p = -softplus(-x)
    log_np = -softplus(x)
    return -(pos_weight * t * log_p + (1.0 - t) * log_np)


def _focal(bce, x, t, gamma, alpha):
    """TF-style focal modulation of an elementwise BCE (utils.py:330-341)."""
    p = torch.sigmoid(x)
    p_t = t * p + (1 - t) * (1 - p)
    alpha_f = t * alpha + (1 - t) * (1 - alpha)
    return bce * alpha_f * torch.pow(1.0 - p_t, gamma)


def _masked_mean(x, mask, mesh=None, eps=1e-9):
    m = mask.to(x.dtype)
    den = m.sum() if mesh is None else psum_along(m.sum(), mesh)
    return (x * m).sum() / torch.clamp(den, min=eps)


def _mean(x, mesh=None):
    """The mean over every rank's elements of ``x``."""
    if mesh is None:
        return x.mean()
    return x.sum() / (x.numel() * mesh.shape["data"])


def _slot_valid(labels, num_labels):
    m = labels.shape[1]
    return (torch.arange(m, device=labels.device)[None, :]
            < num_labels.to(labels.device)[:, None])


def _candidate_index(shape, dim, device):
    """The index along ``dim`` of every element of ``shape``, flattened."""
    view = [1] * len(shape)
    view[dim] = shape[dim]
    return torch.arange(shape[dim], device=device).view(view).expand(
        shape).reshape(-1)


def _obj_and_cls(p, ps, b_idx, a_idx, gj, gi, vmask, tcls, iou, hyp, nc,
                 mesh=None):
    """(objectness BCE mean, class BCE masked mean) of one level."""
    bsz, na, ny, nx, _ = p.shape
    val = torch.where(vmask, (1.0 - hyp.gr)
                      + hyp.gr * iou.detach().clamp_min(0.0),
                      torch.zeros_like(iou))
    cell = ((b_idx * na + a_idx) * ny + gj) * nx + gi
    tobj = p.new_zeros(bsz * na * ny * nx).scatter_reduce(
        0, cell, val, "amax", include_self=True).view(bsz, na, ny, nx)
    obj_bce = _bce_logits(p[..., 4], tobj, hyp.obj_pw)
    if hyp.fl_gamma > 0:
        obj_bce = _focal(obj_bce, p[..., 4], tobj, hyp.fl_gamma,
                         hyp.fl_alpha)
    cls_term = torch.zeros((), device=p.device)
    if nc > 1:
        cp = 1.0 - 0.5 * hyp.label_smoothing
        cn = 0.5 * hyp.label_smoothing
        one = F.one_hot(tcls, nc) > 0
        t_one = torch.where(one, torch.tensor(cp, device=p.device),
                            torch.tensor(cn, device=p.device))
        cls_bce = _bce_logits(ps[:, 5:], t_one, hyp.cls_pw)
        if hyp.fl_gamma > 0:
            cls_bce = _focal(cls_bce, ps[:, 5:], t_one, hyp.fl_gamma,
                             hyp.fl_alpha)
        cls_term = _masked_mean(cls_bce.mean(-1), vmask, mesh)
    return _mean(obj_bce, mesh), cls_term


def yolo_loss(raw_maps: Sequence[torch.Tensor], heads,
              labels: torch.Tensor, num_labels: torch.Tensor,
              img_size: int, hyp: YoloHyp = YoloHyp(), mesh=None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The v3 loss. raw_maps: per-head NHWC maps (B, ny, nx, na*(5+nc));
    labels (B, M, 5) = class, cx, cy, w, h in letterboxed pixels;
    num_labels (B,); ``mesh``: this rank's share (module docstring)."""
    nc = heads[0].num_classes
    dev = labels.device
    total_box = torch.zeros((), device=dev)
    total_obj = torch.zeros((), device=dev)
    total_cls = torch.zeros((), device=dev)
    bsz, m = labels.shape[0], labels.shape[1]
    slot_valid = _slot_valid(labels, num_labels)

    for raw, head in zip(raw_maps, heads):
        p = raw_to_train_layout(raw, head.na, nc)
        p = p.to(acc_dtype(p))
        _, na, ny, nx, _ = p.shape
        stride = img_size / max(nx, ny)
        anchor_vec = torch.as_tensor(head.anchors_px, dtype=torch.float32,
                                     device=dev) / stride
        gxy = labels[..., 1:3] / stride
        gwh = labels[..., 3:5] / stride
        valid = slot_valid[:, :, None] & (wh_iou_matrix(gwh, anchor_vec)
                                          > hyp.iou_t)
        gi = torch.floor(gxy[..., 0]).clamp(0, nx - 1)
        gj = torch.floor(gxy[..., 1]).clamp(0, ny - 1)
        shape = (bsz, m, na)
        b_idx = _candidate_index(shape, 0, dev)
        a_idx = _candidate_index(shape, 2, dev)
        gi_f = gi.long()[:, :, None].expand(shape).reshape(-1)
        gj_f = gj.long()[:, :, None].expand(shape).reshape(-1)
        vmask = valid.reshape(-1)
        tcls = labels[..., 0].long()[:, :, None].expand(shape).reshape(-1)
        # offset from the clipped cell, so an edge centre trains toward it
        cell = torch.stack([gi, gj], -1)
        txy = (gxy - cell)[:, :, None, :].expand(shape + (2,)).reshape(-1, 2)
        twh = gwh[:, :, None, :].expand(shape + (2,)).reshape(-1, 2)
        avec = anchor_vec[None, None].expand(shape + (2,)).reshape(-1, 2)

        ps = p[b_idx, a_idx, gj_f, gi_f]
        pxy = torch.sigmoid(ps[:, 0:2])
        pwh = torch.exp(ps[:, 2:4]).clamp(max=1e3) * avec
        giou = bbox_iou(torch.cat([pxy, pwh], -1), torch.cat([txy, twh], -1),
                        xywh=True, giou=True)
        total_box = total_box + _masked_mean(1.0 - giou, vmask, mesh)
        obj, cls = _obj_and_cls(p, ps, b_idx, a_idx, gj_f, gi_f, vmask,
                                tcls, giou, hyp, nc, mesh)
        total_obj = total_obj + obj
        total_cls = total_cls + cls

    lbox = total_box * hyp.giou
    lobj = total_obj * hyp.obj
    lcls = total_cls * hyp.cls
    loss = lbox + lobj + lcls
    return loss, {"box": lbox, "obj": lobj, "cls": lcls, "total": loss}


_V5_OFFSETS = ((0.0, 0.0), (0.5, 0.0), (0.0, 0.5), (-0.5, 0.0), (0.0, -0.5))


def yolo_loss_v5(raw_maps: Sequence[torch.Tensor], heads,
                 labels: torch.Tensor, num_labels: torch.Tensor,
                 img_size: int, hyp: YoloHypV5 = YoloHypV5(), mesh=None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The v5 loss (ComputeLoss), same inputs as ``yolo_loss``."""
    nc = heads[0].num_classes
    nl = len(raw_maps)
    balance = {3: (4.0, 1.0, 0.4)}.get(nl, (4.0, 1.0, 0.25, 0.06, 0.02))
    dev = labels.device
    total_box = torch.zeros((), device=dev)
    total_obj = torch.zeros((), device=dev)
    total_cls = torch.zeros((), device=dev)
    bsz, m = labels.shape[0], labels.shape[1]
    slot_valid = _slot_valid(labels, num_labels)
    offs = torch.tensor(_V5_OFFSETS, dtype=torch.float32, device=dev)

    for li, (raw, head) in enumerate(zip(raw_maps, heads)):
        p = raw_to_train_layout(raw, head.na, nc)
        p = p.to(acc_dtype(p))
        _, na, ny, nx, _ = p.shape
        stride = img_size / max(nx, ny)
        anchor_vec = torch.as_tensor(head.anchors_px, dtype=torch.float32,
                                     device=dev) / stride
        gxy = labels[..., 1:3] / stride
        gwh = labels[..., 3:5] / stride

        r = gwh[:, :, None, :] / anchor_vec[None, None]
        ratio_ok = torch.maximum(r, 1.0 / (r + 1e-16)).amax(-1) \
            < hyp.anchor_t
        base_valid = slot_valid[:, :, None] & ratio_ok
        x, y = gxy[..., 0], gxy[..., 1]
        fx, fy = x % 1.0, y % 1.0
        jm = (fx < 0.5) & (x > 1.0)
        km = (fy < 0.5) & (y > 1.0)
        lm = ((nx - x) % 1.0 < 0.5) & ((nx - x) > 1.0)
        mm = ((ny - y) % 1.0 < 0.5) & ((ny - y) > 1.0)
        off_ok = torch.stack([torch.ones_like(jm), jm, km, lm, mm], -1)
        valid = base_valid[:, :, :, None] & off_ok[:, :, None, :]

        shape = (bsz, m, na, len(_V5_OFFSETS))
        b_idx = _candidate_index(shape, 0, dev)
        a_idx = _candidate_index(shape, 2, dev)
        o_idx = _candidate_index(shape, 3, dev)
        vmask = valid.reshape(-1)
        gxy_c = gxy[:, :, None, None, :].expand(shape + (2,)).reshape(-1, 2)
        gwh_c = gwh[:, :, None, None, :].expand(shape + (2,)).reshape(-1, 2)
        gij = torch.floor(gxy_c - offs[o_idx])
        gi = gij[:, 0].clamp(0, nx - 1)
        gj = gij[:, 1].clamp(0, ny - 1)
        tbox = torch.cat([gxy_c - torch.stack([gi, gj], -1), gwh_c], -1)
        avec = anchor_vec[None, None, :, None, :].expand(
            shape + (2,)).reshape(-1, 2)
        tcls = labels[..., 0].long()[:, :, None, None].expand(
            shape).reshape(-1)
        gi, gj = gi.long(), gj.long()

        ps = p[b_idx, a_idx, gj, gi]
        pxy = torch.sigmoid(ps[:, 0:2]) * 2.0 - 0.5
        pwh = torch.square(torch.sigmoid(ps[:, 2:4]) * 2.0) * avec
        iou = bbox_iou(torch.cat([pxy, pwh], -1), tbox, xywh=True, ciou=True)
        total_box = total_box + _masked_mean(1.0 - iou, vmask, mesh)
        obj, cls = _obj_and_cls(p, ps, b_idx, a_idx, gj, gi, vmask, tcls,
                                iou, hyp, nc, mesh)
        total_obj = total_obj + obj * balance[li]
        total_cls = total_cls + cls

    lbox = total_box * hyp.box
    lobj = total_obj * hyp.obj
    lcls = total_cls * hyp.cls
    if mesh is not None:
        bsz *= mesh.shape["data"]       # the global batch's size
    loss = (lbox + lobj + lcls) * bsz  # loss.py:161 scales by batch size
    return loss, {"box": lbox, "obj": lobj, "cls": lcls, "total": loss}
