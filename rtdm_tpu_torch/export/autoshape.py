"""Input-robust detection wrapper with rich results.

Counterpart of ``rtdm_tpu/export/autoshape.py`` (yolov5's
AutoShape/Detections, models/common.py:237-383). ``AutoShape`` wraps a
``Detector`` (or loads an engine directory onto a device) so callers can
pass raw inputs (a file path, a PIL image, an HWC or CHW array of any
size, grayscale, floats in [0, 1], or a list of those) and get back
detections in original-image pixels. It letterboxes on the host, runs the
detector's fixed batch in chunks (a short chunk zero-padded), and
un-letterboxes each frame's boxes in numpy.

As in the JAX package: the engine's input is square (img_size), so there
is no per-call inference shape; no URL fetching.
"""

from __future__ import annotations

import os
from typing import Any, List, Optional, Sequence, Union

import numpy as np

ImageLike = Union[str, np.ndarray, Any]  # path | HWC array | PIL.Image


def _to_rgb_array(im: ImageLike) -> tuple[np.ndarray, str]:
    """Coerce one input to an HWC uint8 RGB array + a display name."""
    from PIL import Image

    name = "image"
    if isinstance(im, str):
        name = os.path.basename(im)
        im = Image.open(im)
    if hasattr(im, "convert"):  # PIL image
        name = getattr(im, "filename", None) or name
        im = np.asarray(im.convert("RGB"))
    im = np.asarray(im)
    if im.ndim == 2:
        im = np.tile(im[:, :, None], (1, 1, 3))
    if im.shape[0] <= 4 and im.ndim == 3 and im.shape[2] > 4:  # CHW input
        im = im.transpose(1, 2, 0)
    im = im[:, :, :3]
    if im.dtype != np.uint8:
        # float arrays in [0,1] (the reference accepts torch 0-1 tensors)
        mx = float(im.max()) if im.size else 1.0
        im = (im * 255.0 if mx <= 1.0 else im).clip(0, 255).astype(np.uint8)
    return np.ascontiguousarray(im), os.path.basename(str(name))


class Detections:
    """Per-batch detection results (common.py:290-383 analogue): boxes in
    original-image xyxy pixels, with print/save/render/to_dicts views."""

    def __init__(self, images: List[np.ndarray], dets: List[np.ndarray],
                 names: Sequence[str], files: List[str]):
        self.images = images          # original HWC uint8 frames
        self.xyxy = dets              # list of (n_i, 6) [x1,y1,x2,y2,conf,cls]
        self.names = list(names)
        self.files = files
        self.n = len(images)

    def __len__(self) -> int:
        return self.n

    def _label(self, cls: int) -> str:
        return self.names[cls] if cls < len(self.names) else str(cls)

    def summary(self) -> str:
        lines = []
        for f, im, d in zip(self.files, self.images, self.xyxy):
            h, w = im.shape[:2]
            counts: dict[str, int] = {}
            for row in d:
                k = self._label(int(row[5]))
                counts[k] = counts.get(k, 0) + 1
            body = ", ".join(f"{v} {k}{'s' if v > 1 else ''}"
                             for k, v in counts.items()) or "(no detections)"
            lines.append(f"{f}: {w}x{h} {body}")
        return "\n".join(lines)

    def print(self) -> None:
        print(self.summary())

    def to_dicts(self) -> List[List[dict]]:
        """pandas()-style records per image (without the pandas dep)."""
        out = []
        for d in self.xyxy:
            out.append([{"xmin": float(r[0]), "ymin": float(r[1]),
                         "xmax": float(r[2]), "ymax": float(r[3]),
                         "confidence": float(r[4]), "class": int(r[5]),
                         "name": self._label(int(r[5]))} for r in d])
        return out

    def render(self) -> List[np.ndarray]:
        from rtdm_tpu_torch.cli.yolo_detect import draw_detections
        return [draw_detections(im, d, self.names)
                for im, d in zip(self.images, self.xyxy)]

    def save(self, save_dir: str = "runs/autoshape") -> List[str]:
        from PIL import Image
        os.makedirs(save_dir, exist_ok=True)
        paths = []
        for i, (f, im) in enumerate(zip(self.files, self.render())):
            f = f or "image"
            if not os.path.splitext(f)[1]:
                f += ".jpg"  # array inputs get .jpg names (common.py:269)
            p = os.path.join(save_dir, f)
            if p in paths:  # disambiguate repeated names
                stem, ext = os.path.splitext(p)
                p = f"{stem}_{i}{ext}"
            Image.fromarray(im).save(p)
            paths.append(p)
        return paths


class AutoShape:
    """Wrap a Detector (or an engine dir, loaded onto ``device``) for
    raw-input inference."""

    def __init__(self, detector, names: Optional[Sequence[str]] = None,
                 device="cuda"):
        if isinstance(detector, str):
            from rtdm_tpu_torch.export.detector import load_detector
            detector = load_detector(detector, device=device)
        self.detector = detector
        if names:
            self.names = list(names)
        else:
            # same nc-driven fallback the detect CLI uses (get_cls_dict
            # semantics): person/vehicle for 2, COCO for 80, CLS{i} else
            from rtdm_tpu_torch.data.odder import default_names
            self.names = default_names(detector.num_classes)

    def __call__(self, imgs: Union[ImageLike, Sequence[ImageLike]]
                 ) -> Detections:
        from rtdm_tpu_torch.data.odder import letterbox_image

        singles = (imgs,) if not isinstance(imgs, (list, tuple)) else imgs
        frames, files = [], []
        for im in singles:
            a, f = _to_rgb_array(im)
            frames.append(a)
            files.append(f)

        size = self.detector.spec.img_size
        boxed, geoms = [], []
        for a in frames:
            out, gain, (pw, ph) = letterbox_image(a, size)
            boxed.append(out)
            geoms.append((gain, pw, ph))

        dets: List[np.ndarray] = []
        b = self.detector.batch_size
        for i in range(0, len(boxed), b):
            chunk = np.stack(boxed[i:i + b])
            det, cnt = self.detector(chunk)
            for j in range(chunk.shape[0]):
                d = np.array(det[j][: int(cnt[j])], np.float32)  # writable
                gain, pw, ph = geoms[i + j]
                h, w = frames[i + j].shape[:2]
                if d.size:
                    d[:, [0, 2]] = ((d[:, [0, 2]] - pw) / gain).clip(0, w)
                    d[:, [1, 3]] = ((d[:, [1, 3]] - ph) / gain).clip(0, h)
                dets.append(d)
        return Detections(frames, dets, self.names, files)
