"""Autoanchor: the anchors' fit to a dataset and their evolution.

Counterpart of ``rtdm_tpu/train/autoanchor.py``, in numpy (and scipy's
``kmeans``), draw for draw: ``check_anchors`` (yolov5/utils/autoanchor.py:
22-58) computes the best possible recall (BPR) of the anchors over the
labels' wh, with the reference's +-10% scale jitter, and evolves new ones
when it is under 0.98: ``kmean_anchors`` (autoanchor.py:61-161), a k-means
seed in whitened space and 1000 generations of mutation (probability 0.9,
sigma 0.1) on the anchor fitness. ``check_anchor_order`` puts the levels
in stride order.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _ratio_metric(wh: np.ndarray, anchors: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """x[i,j] = min-ratio metric of label i vs anchor j; best[i] = max_j."""
    r = wh[:, None] / anchors[None]
    x = np.minimum(r, 1.0 / r).min(2)
    return x, x.max(1)


def anchor_fitness(anchors: np.ndarray, wh: np.ndarray,
                   thr: float = 4.0) -> float:
    _, best = _ratio_metric(wh, anchors)
    mask = best > 1.0 / thr
    return float((best * mask).mean())


def best_possible_recall(anchors: np.ndarray, wh: np.ndarray,
                         thr: float = 4.0) -> float:
    _, best = _ratio_metric(wh, anchors)
    return float((best > 1.0 / thr).mean())


def collect_label_wh(dataset, img_size: int,
                     jitter: bool = True,
                     seed: int = 0) -> np.ndarray:
    """Label wh in pixels at LETTERBOXED img_size scale, with the
    reference's +-10% scale augmentation (autoanchor.py:27-29:
    `shapes = imgsz * dataset.shapes / shapes.max(1)` — per-axis, so a
    non-square frame scales w and h by the same gain, not to a square).
    Falls back to square scaling when the dataset exposes no image
    paths (synthetic datasets in tests)."""
    rng = np.random.default_rng(seed)
    paths = getattr(dataset, "image_paths", None)
    whs = []
    for i in range(len(dataset)):
        raw = dataset.labels[i]  # normalized cls,x,y,w,h
        if not len(raw):
            continue
        shape = np.array([img_size, img_size], np.float32)
        if paths is not None:
            try:  # header-only size read; no pixel decode
                from PIL import Image
                with Image.open(paths[i]) as im:
                    w, h = im.size
                shape = img_size * np.array([w, h], np.float32) / max(w, h)
            except Exception:
                pass
        scale = rng.uniform(0.9, 1.1) if jitter else 1.0
        whs.append(raw[:, 3:5] * shape * scale)
    if not whs:
        return np.zeros((0, 2), np.float32)
    return np.concatenate(whs).astype(np.float32)


def _mutation(rng: np.random.Generator, shape,
              mp: float = 0.9, s: float = 0.1) -> np.ndarray:
    """One genetic mutation-factor draw (autoanchor.py:150-152):
    (mask < mp) * r * randn * s + 1, clipped to [0.3, 3] — ZERO-mean noise,
    so factors are symmetric around 1 and anchors can shrink as well as
    grow. Redrawn until at least one entry mutates."""
    v = np.ones(shape)
    while (v == 1).all():
        v = ((rng.random(shape) < mp) * rng.random()
             * rng.normal(0.0, s, shape) + 1).clip(0.3, 3.0)
    return v


def kmean_anchors(wh: np.ndarray, n: int = 9, img_size: int = 416,
                  thr: float = 4.0, gen: int = 1000,
                  seed: int = 0, verbose: bool = False) -> np.ndarray:
    """Evolve `n` anchors over the label wh distribution."""
    wh = wh[(wh >= 2.0).any(1)]  # ignore tiny boxes (autoanchor.py:77)
    if len(wh) < n:
        raise ValueError(f"need >= {n} labels for {n} anchors, got {len(wh)}")
    rng = np.random.default_rng(seed)

    # k-means seed in whitened space. scipy's kmeans DROPS empty clusters
    # (returning < n rows, no exception) and a degenerate wh distribution
    # can make std 0 in a dimension — both fall back to Lloyd's below.
    std = np.maximum(wh.std(0), 1e-6)
    k = None
    try:
        from scipy.cluster.vq import kmeans
        cand, _ = kmeans(wh / std, n, iter=30, seed=seed)
        if cand.shape == (n, 2) and np.isfinite(cand).all():
            k = cand * std
    except Exception:
        pass
    if k is None:  # scipy absent/failed/short -> simple Lloyd's
        k = wh[rng.choice(len(wh), n, replace=False)].copy()
        for _ in range(30):
            d = ((wh[:, None] - k[None]) ** 2).sum(-1)
            assign = d.argmin(1)
            for j in range(n):
                pts = wh[assign == j]
                if len(pts):
                    k[j] = pts.mean(0)

    # genetic evolution (autoanchor.py:140-156)
    f = anchor_fitness(k, wh, thr)
    shape = k.shape
    for _ in range(gen):
        v = _mutation(rng, shape)
        kg = (k * v).clip(2.0, img_size)
        fg = anchor_fitness(kg, wh, thr)
        if fg > f:
            f, k = fg, kg.copy()
    return k[np.argsort(k.prod(1))].astype(np.float32)  # small-to-large


def check_anchors(dataset, anchors_px: np.ndarray, img_size: int,
                  thr: float = 4.0, bpr_threshold: float = 0.98,
                  gen: int = 1000, verbose: bool = True
                  ) -> Tuple[np.ndarray, float, bool]:
    """Returns (anchors, bpr, evolved?). Evolves new anchors when the BPR
    of the current set is below threshold (autoanchor.py:40-56)."""
    wh = collect_label_wh(dataset, img_size)
    flat = anchors_px.reshape(-1, 2)
    if not len(wh):
        return anchors_px, 1.0, False
    bpr = best_possible_recall(flat, wh, thr)
    # too few labels to cluster: keep the current set (kmeans needs at
    # least one label per anchor). Count AFTER the >=2px filter
    # kmean_anchors applies, or it can still raise at startup.
    n_clusterable = int(((wh >= 2.0).any(1)).sum())
    if bpr >= bpr_threshold or n_clusterable < flat.shape[0]:
        return anchors_px, bpr, False
    new = kmean_anchors(wh, n=flat.shape[0], img_size=img_size, thr=thr,
                        gen=gen)
    new_bpr = best_possible_recall(new, wh, thr)
    if new_bpr > bpr:
        return new.reshape(anchors_px.shape), new_bpr, True
    return anchors_px, bpr, False


def check_anchor_order(anchors: np.ndarray) -> np.ndarray:
    """(nl, na, 2) anchors with level index in stride-ASCENDING order
    (P3->P5, the layout of every shipped v5 yaml). Mirror of the
    reference's check_anchor_order (yolov5/models/yolo.py:105-112 via
    autoanchor.py:10-21): if mean anchor area DECREASES across levels,
    flip the level axis so small anchors ride small strides."""
    anchors = np.asarray(anchors, np.float32)
    areas = anchors.prod(-1).mean(-1)
    if len(areas) > 1 and areas[-1] < areas[0]:
        return anchors[::-1].copy()
    return anchors
