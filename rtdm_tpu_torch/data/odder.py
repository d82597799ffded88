"""Letterboxing for the detectors.

Counterpart of ``letterbox_image`` and ``PAD_COLOR`` in
``rtdm_tpu/data/odder.py``, on the PIL path: an aspect-preserving bilinear
resize and gray (114) padding to a fixed target, so every batch has one
shape. The dataset readers and the training loader wait for later slices.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

PAD_COLOR = 114


def letterbox_image(img: np.ndarray, size, gain_cap: Optional[float] = None
                    ) -> Tuple[np.ndarray, float, Tuple[float, float]]:
    """HWC uint8 -> (out (H, W, 3) uint8, gain, (pad_w, pad_h)).

    ``size`` is an int (square target) or an (h, w) pair; ``gain_cap``
    bounds the resize factor (the surplus becomes border)."""
    from PIL import Image

    th, tw = ((int(size), int(size)) if isinstance(size, (int, np.integer))
              else (int(size[0]), int(size[1])))
    h, w = img.shape[:2]
    gain = min(th / h, tw / w)
    if gain_cap is not None:
        gain = min(gain, gain_cap)
    nw, nh = int(round(w * gain)), int(round(h * gain))
    resized = np.asarray(
        Image.fromarray(img).resize((nw, nh), Image.BILINEAR), np.uint8)
    out = np.full((th, tw, 3), PAD_COLOR, np.uint8)
    pad_w, pad_h = (tw - nw) // 2, (th - nh) // 2
    out[pad_h:pad_h + nh, pad_w:pad_w + nw] = resized
    return out, gain, (float(pad_w), float(pad_h))
