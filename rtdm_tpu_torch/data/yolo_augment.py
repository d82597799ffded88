"""Detection training augmentations, on the host (numpy and cv2).

Counterpart of ``rtdm_tpu/data/yolo_augment.py``, draw for draw: every
random number comes from the ``np.random.Generator`` passed in, in the
reference's order, so the same generator gives the same images and labels
in both packages (yolov3/utils/datasets.py: load_mosaic :532-596,
augment_hsv :525-529, random_affine :633+; yolov5's load_mosaic9, mixup
and cutout). ``load_mosaic`` and ``load_mosaic9`` read their tiles through
``dataset.load_scaled`` (a ``.jpg`` through the native libjpeg decode
of ``data/native_io.py``, as in the JAX package; other formats through
PIL). Defaults mirror
yolov3/train.py:38-44's hyp.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np

DEFAULT_AUG_HYP = {
    "hsv_h": 0.0138, "hsv_s": 0.678, "hsv_v": 0.36,
    "degrees": 0.0, "translate": 0.0, "scale": 0.0, "shear": 0.0,
    "fliplr": 0.5, "mosaic": 1.0, "mosaic9": 0.0, "mixup": 0.0,
    "cutout": 0.0,
}


def augment_hsv(img: np.ndarray, h_gain: float, s_gain: float,
                v_gain: float, rng: np.random.Generator) -> np.ndarray:
    """Random HSV gains (datasets.py:525-529 semantics)."""
    import cv2

    r = rng.uniform(-1, 1, 3) * [h_gain, s_gain, v_gain] + 1
    hue, sat, val = cv2.split(cv2.cvtColor(img, cv2.COLOR_RGB2HSV))
    x = np.arange(256)
    lut_h = ((x * r[0]) % 180).astype(img.dtype)
    lut_s = np.clip(x * r[1], 0, 255).astype(img.dtype)
    lut_v = np.clip(x * r[2], 0, 255).astype(img.dtype)
    hsv = cv2.merge((cv2.LUT(hue, lut_h), cv2.LUT(sat, lut_s),
                     cv2.LUT(val, lut_v)))
    return cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)


def random_affine(img: np.ndarray, boxes_xyxy: np.ndarray,
                  cls: np.ndarray,
                  degrees: float, translate: float, scale: float,
                  shear: float, rng: np.random.Generator,
                  border: int = 0, pad_value: int = 114
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Affine warp of image + xyxy boxes; filters degenerate boxes
    (wh > 4px, area ratio > 0.2, aspect < 10 — datasets.py semantics).
    Negative `border` crops (the mosaic 2s->s path)."""
    import cv2

    height = img.shape[0] + border * 2
    width = img.shape[1] + border * 2

    r = cv2.getRotationMatrix2D(
        angle=rng.uniform(-degrees, degrees),
        center=(img.shape[1] / 2, img.shape[0] / 2),
        scale=rng.uniform(1 - scale, 1 + scale))
    rot = np.eye(3)
    rot[:2] = r
    t_mat = np.eye(3)
    # the reference scales x-translation by HEIGHT and y by WIDTH
    # (datasets.py:651-652) — a quirk, but parity means keeping it
    t_mat[0, 2] = rng.uniform(-translate, translate) * img.shape[0] + border
    t_mat[1, 2] = rng.uniform(-translate, translate) * img.shape[1] + border
    s_mat = np.eye(3)
    s_mat[0, 1] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    s_mat[1, 0] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    m = (s_mat @ t_mat @ rot)  # S @ T @ R (datasets.py:660, order matters:
    # the translation — incl. the mosaic border shift — is itself sheared)

    out = cv2.warpAffine(img, m[:2], dsize=(width, height),
                         flags=cv2.INTER_LINEAR,
                         borderValue=(pad_value,) * 3)
    if len(boxes_xyxy) == 0:
        return out, boxes_xyxy, cls

    n = len(boxes_xyxy)
    pts = np.ones((n * 4, 3))
    pts[:, :2] = boxes_xyxy[:, [0, 1, 2, 3, 0, 3, 2, 1]].reshape(n * 4, 2)
    pts = (pts @ m.T)[:, :2].reshape(n, 8)
    xs, ys = pts[:, [0, 2, 4, 6]], pts[:, [1, 3, 5, 7]]
    new = np.stack([xs.min(1), ys.min(1), xs.max(1), ys.max(1)], axis=1)
    new[:, [0, 2]] = new[:, [0, 2]].clip(0, width)
    new[:, [1, 3]] = new[:, [1, 3]].clip(0, height)

    w_old = boxes_xyxy[:, 2] - boxes_xyxy[:, 0]
    h_old = boxes_xyxy[:, 3] - boxes_xyxy[:, 1]
    w_new = new[:, 2] - new[:, 0]
    h_new = new[:, 3] - new[:, 1]
    area_ratio = (w_new * h_new) / (w_old * h_old + 1e-16)
    ar = np.maximum(w_new / (h_new + 1e-16), h_new / (w_new + 1e-16))
    keep = (w_new > 4) & (h_new > 4) & (area_ratio > 0.2) & (ar < 10)
    return out, new[keep], cls[keep]


def load_mosaic(dataset, idx: int, rng: np.random.Generator,
                hyp: Optional[Dict[str, float]] = None
                ) -> Tuple[np.ndarray, np.ndarray]:
    """4-image mosaic (datasets.py:532-596): random center on a 2s x 2s
    canvas, each quadrant a random image, labels merged in canvas pixels,
    then affine down to s x s. Returns (img s x s, labels (N,5) cls+xyxy px)."""
    s = dataset.img_size
    canvas = np.full((2 * s, 2 * s, 3), 114, np.uint8)
    xc = int(rng.uniform(s * 0.5, s * 1.5))
    yc = int(rng.uniform(s * 0.5, s * 1.5))
    idxs = [idx] + list(rng.integers(0, len(dataset), 3))
    all_labels = []
    for i, index in enumerate(idxs):
        img = dataset.load_scaled(index, s)
        h, w = img.shape[:2]
        if i == 0:      # top-left
            x1a, y1a = max(xc - w, 0), max(yc - h, 0)
            x2a, y2a = xc, yc
            x1b, y1b = w - (x2a - x1a), h - (y2a - y1a)
            x2b, y2b = w, h
        elif i == 1:    # top-right
            x1a, y1a = xc, max(yc - h, 0)
            x2a, y2a = min(xc + w, 2 * s), yc
            x1b, y1b = 0, h - (y2a - y1a)
            x2b, y2b = min(w, x2a - x1a), h
        elif i == 2:    # bottom-left
            x1a, y1a = max(xc - w, 0), yc
            x2a, y2a = xc, min(2 * s, yc + h)
            x1b, y1b = w - (x2a - x1a), 0
            x2b, y2b = w, min(y2a - y1a, h)
        else:           # bottom-right
            x1a, y1a = xc, yc
            x2a, y2a = min(xc + w, 2 * s), min(2 * s, yc + h)
            x1b, y1b = 0, 0
            x2b, y2b = min(w, x2a - x1a), min(y2a - y1a, h)
        canvas[y1a:y2a, x1a:x2a] = img[y1b:y2b, x1b:x2b]
        padw, padh = x1a - x1b, y1a - y1b
        raw = dataset.labels[index]
        if len(raw):
            lab = np.zeros((len(raw), 5), np.float32)
            lab[:, 0] = raw[:, 0]
            lab[:, 1] = raw[:, 1] * w - raw[:, 3] * w / 2 + padw  # x1
            lab[:, 2] = raw[:, 2] * h - raw[:, 4] * h / 2 + padh  # y1
            lab[:, 3] = raw[:, 1] * w + raw[:, 3] * w / 2 + padw  # x2
            lab[:, 4] = raw[:, 2] * h + raw[:, 4] * h / 2 + padh  # y2
            all_labels.append(lab)
    labels = (np.concatenate(all_labels)
              if all_labels else np.zeros((0, 5), np.float32))
    labels[:, 1:] = labels[:, 1:].clip(0, 2 * s - 1)

    hyp = {**DEFAULT_AUG_HYP, **(hyp or {})}
    # negative border crops the 2s canvas back to s x s (datasets.py:595)
    img_out, boxes, cls = random_affine(
        canvas, labels[:, 1:5], labels[:, 0],
        degrees=hyp["degrees"], translate=hyp["translate"],
        scale=hyp["scale"], shear=hyp["shear"], rng=rng, border=-s // 2)
    if len(boxes):
        labels = np.concatenate([cls[:, None], boxes], axis=1)
    else:
        labels = np.zeros((0, 5), np.float32)
    return img_out, labels.astype(np.float32)


def load_mosaic9(dataset, idx: int, rng: np.random.Generator,
                 hyp: Optional[Dict[str, float]] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """9-image mosaic (yolov5/utils/datasets.py:734 load_mosaic9): a 3x3
    grid on a 3s canvas, then affine-cropped to s x s."""
    s = dataset.img_size
    canvas = np.full((3 * s, 3 * s, 3), 114, np.uint8)
    idxs = [idx] + list(rng.integers(0, len(dataset), 8))
    all_labels = []
    for cell, index in enumerate(idxs):
        r, c = divmod(cell, 3)
        img = dataset.load_scaled(index, s)
        h, w = img.shape[:2]
        y0, x0 = r * s, c * s
        canvas[y0:y0 + h, x0:x0 + w] = img
        raw = dataset.labels[index]
        if len(raw):
            lab = np.zeros((len(raw), 5), np.float32)
            lab[:, 0] = raw[:, 0]
            lab[:, 1] = raw[:, 1] * w - raw[:, 3] * w / 2 + x0
            lab[:, 2] = raw[:, 2] * h - raw[:, 4] * h / 2 + y0
            lab[:, 3] = raw[:, 1] * w + raw[:, 3] * w / 2 + x0
            lab[:, 4] = raw[:, 2] * h + raw[:, 4] * h / 2 + y0
            all_labels.append(lab)
    labels = (np.concatenate(all_labels)
              if all_labels else np.zeros((0, 5), np.float32))
    labels[:, 1:] = labels[:, 1:].clip(0, 3 * s - 1)
    hyp = {**DEFAULT_AUG_HYP, **(hyp or {})}
    img_out, boxes, cls = random_affine(
        canvas, labels[:, 1:5], labels[:, 0],
        degrees=hyp["degrees"], translate=hyp["translate"],
        scale=hyp["scale"], shear=hyp["shear"], rng=rng, border=-s)
    if len(boxes):
        labels = np.concatenate([cls[:, None], boxes], axis=1)
    else:
        labels = np.zeros((0, 5), np.float32)
    return img_out, labels.astype(np.float32)


def mixup(img1: np.ndarray, lab1: np.ndarray, img2: np.ndarray,
          lab2: np.ndarray, rng: np.random.Generator
          ) -> Tuple[np.ndarray, np.ndarray]:
    """Image mixup (datasets.py __getitem__: beta(8,8) blend, labels
    concatenated)."""
    r = rng.beta(8.0, 8.0)
    img = (img1.astype(np.float32) * r
           + img2.astype(np.float32) * (1 - r)).astype(np.uint8)
    return img, np.concatenate([lab1, lab2], axis=0)


def cutout(img: np.ndarray, labels_xyxy: np.ndarray,
           rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """Cutout (yolov3/utils/datasets.py:703): random gray patches; labels
    whose boxes are >60%% obscured are dropped."""
    h, w = img.shape[:2]
    img = img.copy()
    scales = ([0.5] * 1 + [0.25] * 2 + [0.125] * 4 + [0.0625] * 8
              + [0.03125] * 16)  # full reference ladder (datasets.py:728)
    keep = np.ones(len(labels_xyxy), bool)
    for s in scales:
        mh, mw = int(h * s * rng.uniform(0.5, 1.0)), \
            int(w * s * rng.uniform(0.5, 1.0))
        cy, cx = int(rng.uniform(0, h)), int(rng.uniform(0, w))
        y1, y2 = max(cy - mh // 2, 0), min(cy + mh // 2, h)
        x1, x2 = max(cx - mw // 2, 0), min(cx + mw // 2, w)
        img[y1:y2, x1:x2] = rng.integers(64, 191, 3, dtype=np.uint8)
        if len(labels_xyxy):
            bx1, by1 = labels_xyxy[:, 1], labels_xyxy[:, 2]
            bx2, by2 = labels_xyxy[:, 3], labels_xyxy[:, 4]
            iw = np.clip(np.minimum(bx2, x2) - np.maximum(bx1, x1), 0, None)
            ih = np.clip(np.minimum(by2, y2) - np.maximum(by1, y1), 0, None)
            area = np.maximum((bx2 - bx1) * (by2 - by1), 1e-9)
            keep &= (iw * ih / area) < 0.6
    return img, labels_xyxy[keep]
