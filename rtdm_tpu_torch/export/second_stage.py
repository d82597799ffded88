"""Second-stage classifier veto over detection crops (apply_classifier).

Counterpart of ``rtdm_tpu/export/second_stage.py`` (the reference's
``apply_classifier``, yolov5/utils/general.py, wired into detect.py behind
``--classify``): each detection box is squared and padded (w, h ->
max(w, h) * 1.3 + 30 px), cropped from the letterboxed frame, resized
bilinearly to the classifier's input and classified; detections whose
classifier argmax disagrees with the detector's class id are dropped, the
kept rows compacted forward in order.

The classifier is the port's ``create_model`` network with its parameters
cast to the veto's dtype (BatchNorm statistics as stored); on the card its
ACFF blocks run ``csrc/acff.cu``. The JAX package classifies all max_det
rows of a frame and lets the veto drop the invalid ones; the port
classifies only the ``count`` valid rows of each frame (all frames' in
one batch), which gives the same result: no classifier call for a frame
without detections. Any frame shape and row count runs (the JAX veto is
compiled for one). The crop arithmetic is the compiled JAX program's
(XLA:CPU's multiply by fp32(1/n) fused into the coordinate's add, and the
two-tap mix as fma(a, 1 - f, b * f)), bit-equal to the jitted function on
the CPU.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from rtdm_tpu_torch.core.device import resolve_device
from rtdm_tpu_torch.data.aider import normalize_batch


def square_pad_boxes(xyxy: torch.Tensor, gain: float = 1.3,
                     pad: float = 30.0) -> torch.Tensor:
    """Reference box prep: xyxy -> square of side max(w, h) * gain + pad
    around the box centre, back to xyxy, truncated to int32."""
    cx = (xyxy[..., 0] + xyxy[..., 2]) * 0.5
    cy = (xyxy[..., 1] + xyxy[..., 3]) * 0.5
    side = torch.maximum(xyxy[..., 2] - xyxy[..., 0],
                         xyxy[..., 3] - xyxy[..., 1]) * np.float32(gain) \
        + np.float32(pad)
    half = side * 0.5
    out = torch.stack([cx - half, cy - half, cx + half, cy + half], -1)
    return torch.trunc(out).to(torch.int32)


def _taps(a0: torch.Tensor, a1: torch.Tensor, n: int):
    """Per box, the two source indices and the weight of the second for
    each of n output samples over [a0, a1): sample a0 + (j + .5) * len / n
    - .5 clamped to the crop (cv2 INTER_LINEAR on the crop)."""
    length = (a1 - a0).float()[:, None]
    t = (torch.arange(n, dtype=torch.float32, device=a0.device) + 0.5)[None]
    inv = torch.full((), np.float32(1.0) / np.float32(n), device=a0.device)
    s = torch.addcmul(a0.float()[:, None], t * length, inv) - 0.5
    s = torch.minimum(torch.maximum(s, a0.float()[:, None]),
                      (a1.float() - 1)[:, None])
    i = torch.floor(s)
    frac = s - i
    i = i.long()
    j = torch.minimum(i + 1, (a1 - 1).long()[:, None])
    return i, j, frac


def _mix(a: torch.Tensor, b: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """a * (1 - f) + b * f as the compiled JAX program rounds it."""
    return torch.addcmul(b * f, a, 1 - f)


def crop_resize_bilinear(img: torch.Tensor, boxes_xyxy: torch.Tensor,
                         out_hw: Tuple[int, int]) -> torch.Tensor:
    """Crop integer boxes (N, 4) from one (H, W, 3) uint8 frame and resize
    each bilinearly to ``out_hw`` -> (N, oh, ow, 3) fp32: output pixel j
    samples x0 + (j + .5) * w / ow - .5, edges clamped to the crop; a box
    is clamped to the frame and to at least one pixel."""
    h, w = img.shape[0], img.shape[1]
    oh, ow = out_hw
    imf = img.float()
    b = boxes_xyxy.long()
    x0 = b[:, 0].clamp(0, w - 1)
    y0 = b[:, 1].clamp(0, h - 1)
    x1 = torch.minimum(torch.maximum(b[:, 2], x0 + 1), torch.full_like(x0, w))
    y1 = torch.minimum(torch.maximum(b[:, 3], y0 + 1), torch.full_like(y0, h))
    xi, xj, fx = _taps(x0, x1, ow)
    yi, yj, fy = _taps(y0, y1, oh)
    n = b.shape[0]

    def cols(rows, x):
        return torch.gather(rows, 2, x[:, None, :, None].expand(n, oh, ow, 3))
    r0, r1 = imf[yi], imf[yj]                       # (N, oh, W, 3)
    fxx, fyy = fx[:, None, :, None], fy[:, :, None, None]
    top = _mix(cols(r0, xi), cols(r0, xj), fxx)
    bot = _mix(cols(r1, xi), cols(r1, xj), fxx)
    return _mix(top, bot, fyy)


class SecondStageClassifier:
    """The apply_classifier veto: ``(frames_u8, det, count) -> (det',
    count')`` with the rows whose class the classifier confirms compacted
    forward in order and the others zeroed.

    ``model`` is a port classifier (``create_model``) on the veto's device
    whose label space covers the detector's class ids; ``class_map``
    translates a detector class id to the classifier's (ids past the map
    pass through unchanged)."""

    def __init__(self, model: torch.nn.Module, quant: str = "bf16",
                 class_map: Optional[Dict[int, int]] = None):
        self.model = model
        self.device = next(model.parameters()).device
        self.size = int(getattr(model, "image_size", 224))
        self.dtype = (torch.bfloat16 if quant in ("bf16", "fp16", "half")
                      else torch.float32)
        self.lut = None
        if class_map:
            lut = np.arange(max(class_map) + 1, dtype=np.int64)
            for k, v in class_map.items():
                lut[k] = v
            self.lut = torch.as_tensor(lut, device=self.device)

    @torch.inference_mode()
    def logits(self, frames_u8: torch.Tensor, det: torch.Tensor,
               count) -> torch.Tensor:
        """fp32 classifier logits of the valid rows of every frame, frame
        by frame in row order: (sum(count), classes)."""
        crops = [crop_resize_bilinear(frames_u8[i],
                                      square_pad_boxes(det[i, :int(c), :4]),
                                      (self.size, self.size))
                 for i, c in enumerate(count) if int(c)]
        if not crops:
            return torch.zeros((0, 0), device=self.device)
        crops = torch.cat(crops)
        x = normalize_batch(crops)
        return self.model(x.to(self.dtype).contiguous(),
                          apply_softmax=False).float()

    @torch.inference_mode()
    def veto(self, frames_u8: torch.Tensor, det: torch.Tensor,
             count: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Device (B, H, W, 3) uint8 frames, (B, max_det, 6) rows and (B,)
        counts -> the vetoed rows and counts, on the device."""
        counts = count.cpu().tolist()
        logits = self.logits(frames_u8, det, counts)
        out = torch.zeros_like(det)
        kept = torch.zeros_like(count)
        start = 0
        for i, c in enumerate(counts):
            if not c:
                continue
            rows = det[i, :c]
            cls1 = rows[:, 5].long()
            want = cls1
            if self.lut is not None:
                mapped = self.lut[cls1.clamp(0, self.lut.shape[0] - 1)]
                want = torch.where(cls1 < self.lut.shape[0], mapped, cls1)
            keep = logits[start:start + c].argmax(-1) == want
            start += c
            rows = rows[keep]
            out[i, :rows.shape[0]] = rows
            kept[i] = rows.shape[0]
        return out, kept

    def __call__(self, frames_u8, det, count
                 ) -> Tuple[np.ndarray, np.ndarray]:
        d, c = self.veto(torch.as_tensor(frames_u8, device=self.device),
                         torch.as_tensor(det, dtype=torch.float32,
                                         device=self.device),
                         torch.as_tensor(count, device=self.device))
        return d.cpu().numpy(), c.cpu().numpy()


def build_second_stage(model_name: str, weights: Optional[str],
                       quant: str = "bf16",
                       class_map: Optional[Dict[int, int]] = None,
                       device="cuda") -> SecondStageClassifier:
    """The veto from a classifier name and ``.npz`` or torch ``.pt``/``.pth``
    weights (opened at that path and nowhere else), its head sized to the
    checkpoint's classes."""
    from rtdm_tpu_torch.export.engine import EngineSpec, load_model
    from rtdm_tpu_torch.models.ernet import input_size_for
    from rtdm_tpu_torch.models.io import infer_num_classes, load_variables
    if weights is None:
        raise ValueError("--classifier-weights is required with --classify")
    variables = load_variables(weights)
    dtype = (torch.bfloat16 if quant in ("bf16", "fp16", "half")
             else torch.float32)
    spec = EngineSpec(model=model_name,
                      num_classes=infer_num_classes(variables) or 5,
                      image_size=input_size_for(model_name))
    model = load_model(spec, variables, resolve_device(device), dtype)
    return SecondStageClassifier(model, quant=quant, class_map=class_map)
