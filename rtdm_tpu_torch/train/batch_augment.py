"""Batch mixing for classification: mixup and cutmix.

Counterpart of ``rtdm_tpu/train/batch_augment.py``. Each is split into a
draw on the host (``draw_mixup``, ``draw_cutmix``: a numpy ``Generator``
gives lam, the pairing permutation and the box) and a deterministic apply
on the device (``mixup_apply``, ``cutmix_apply``), so that an apply can be
held against the JAX function on the values its keys drew. The images
blend with the permuted batch and the trainer's loss becomes
lam * L(y) + (1 - lam) * L(y[perm]).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def draw_mixup(rng: np.random.Generator, batch: int, alpha: float
               ) -> Tuple[float, np.ndarray]:
    """(lam ~ Beta(alpha, alpha) as fp32, a permutation of the batch)."""
    lam = float(np.float32(rng.beta(alpha, alpha)))
    return lam, rng.permutation(batch)


def mixup_apply(images: torch.Tensor, perm, lam: float) -> torch.Tensor:
    """lam * images + (1 - lam) * images[perm], in images' dtype."""
    perm = torch.as_tensor(np.array(perm), device=images.device)
    lam_t = torch.tensor(lam, dtype=torch.float32, device=images.device)
    mixed = lam_t * images + (1.0 - lam_t) * images[perm]
    return mixed.to(images.dtype)


def draw_cutmix(rng: np.random.Generator, batch: int, h: int, w: int,
                alpha: float) -> Tuple[np.ndarray, Tuple[int, int, int, int]]:
    """(a permutation of the batch, the box (y1, y2, x1, x2)): a centre
    drawn uniformly in the image and sides h * sqrt(1 - lam0), w * sqrt(1 -
    lam0) with lam0 ~ Beta(alpha, alpha), clipped to the image."""
    lam0 = np.float32(rng.beta(alpha, alpha))
    cut = np.sqrt(np.float32(1.0) - lam0)
    ch, cw = int(np.float32(h) * cut), int(np.float32(w) * cut)
    cy, cx = int(rng.integers(0, h)), int(rng.integers(0, w))
    box = (int(np.clip(cy - ch // 2, 0, h)), int(np.clip(cy + ch // 2, 0, h)),
           int(np.clip(cx - cw // 2, 0, w)), int(np.clip(cx + cw // 2, 0, w)))
    return rng.permutation(batch), box


def cutmix_apply(images: torch.Tensor, perm, box: Tuple[int, int, int, int]
                 ) -> Tuple[torch.Tensor, float]:
    """The box of every image replaced by the same box of its partner
    images[perm]; returns (mixed, lam) with lam = 1 - box area / image
    area recomputed from the clipped box, as fp32."""
    y1, y2, x1, x2 = box
    _, h, w, _ = images.shape
    perm = torch.as_tensor(np.array(perm), device=images.device)
    mixed = images.clone()
    mixed[:, y1:y2, x1:x2] = images[perm][:, y1:y2, x1:x2]
    lam = float(np.float32(1.0) - np.float32((y2 - y1) * (x2 - x1))
                / np.float32(h * w))
    return mixed, lam
