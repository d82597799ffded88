"""Seeded frames from the committed aerial photos.

The pool of a run is made from the photos in ``docs/examples/`` (the
mini-set the detector was trained on, and AIDER-like scenes for the
classifiers), the i-th frame from photo ``i % photos``: a crop of 60-100%
of each side at a seeded place, a horizontal flip on a seeded half of the
frames, a brightness gain in [0.75, 1.25], then either a resize to the
square input (``fit="resize"``) or a letterbox into it, the long side
fitted and the rest filled with grey 114 (``fit="letterbox"``). Every seed
gives the same sizes; only the content moves.
"""

from __future__ import annotations

import glob
import os
from typing import List

import numpy as np
from PIL import Image

PHOTOS = "docs/examples"
PAD = 114


def _photos(root: str, longest: int) -> List[Image.Image]:
    """Each photo, shrunk once so its long side is at most ``longest``."""
    out = []
    for path in sorted(glob.glob(os.path.join(root, PHOTOS, "*.jpg"))):
        img = Image.open(path).convert("RGB")
        scale = longest / max(img.size)
        if scale < 1:
            img = img.resize((max(1, round(img.size[0] * scale)),
                              max(1, round(img.size[1] * scale))),
                             Image.BILINEAR)
        out.append(img)
    if not out:
        raise FileNotFoundError(
            f"no photos under {os.path.join(root, PHOTOS)}")
    return out


def make_pool(root: str, seed: int, count: int, size: int,
              fit: str = "resize") -> np.ndarray:
    """(count, size, size, 3) uint8 frames from ``seed``."""
    if fit not in ("resize", "letterbox"):
        raise ValueError(f"unknown fit {fit!r}")
    photos = _photos(root, 2 * size)
    rng = np.random.default_rng(seed)
    crop = rng.uniform(0.6, 1.0, (count, 2))
    place = rng.uniform(0.0, 1.0, (count, 2))
    flip = rng.random(count) < 0.5
    gain = rng.uniform(0.75, 1.25, count)
    out = np.empty((count, size, size, 3), np.uint8)
    for i in range(count):
        img = photos[i % len(photos)]
        w, h = img.size
        cw, ch = max(8, int(w * crop[i, 0])), max(8, int(h * crop[i, 1]))
        x0, y0 = int((w - cw) * place[i, 0]), int((h - ch) * place[i, 1])
        tile = img.crop((x0, y0, x0 + cw, y0 + ch))
        if flip[i]:
            tile = tile.transpose(Image.FLIP_LEFT_RIGHT)
        if fit == "resize":
            nw = nh = size
        else:
            g = size / max(cw, ch)
            nw, nh = max(1, round(cw * g)), max(1, round(ch * g))
        arr = np.asarray(tile.resize((nw, nh), Image.BILINEAR), np.float32)
        arr = np.clip(arr * gain[i], 0, 255).astype(np.uint8)
        out[i] = PAD
        top, left = (size - nh) // 2, (size - nw) // 2
        out[i, top:top + nh, left:left + nw] = arr
    return out
