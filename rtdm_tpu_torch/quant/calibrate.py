"""Activation-range calibration for int8 engines.

Counterpart of ``rtdm_tpu/quant/calibrate.py``. Observation points are the
inputs of every Conv, DepthwiseConv and Dense module, caught with forward
pre-hooks and named by their JAX path (the module name with '.' -> '/').
The model runs in fp32 with TF32 off, its ACFF blocks layer by layer
(``models/acff.py::layer_by_layer``), so the hooks see each depthwise input
and the 3C concat that the fused call never writes out.

Each input is taken in NHWC order, raveled and subsampled exactly as the
JAX package does it (``x[::max(x.size // (sample_cap // 8), 1)]`` per
batch of ``batch_size`` frames), so both reduce the same samples.

Two reducers:
- 'percentile' (default): scale = P99.99(|x|)/127.
- 'entropy': KL-divergence-minimizing threshold over a 2048-bin histogram,
  the algorithm TensorRT's IInt8EntropyCalibrator2 implements.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch
from torch import nn

from rtdm_tpu_torch.core.precision import tf32
from rtdm_tpu_torch.data.aider import normalize_batch
from rtdm_tpu_torch.models.acff import layer_by_layer
from rtdm_tpu_torch.models.layers import Conv, Dense, DepthwiseConv


def compute_scale(values: np.ndarray, method: str = "percentile",
                  percentile: float = 99.99, bins: int = 2048) -> float:
    """Symmetric int8 scale from observed |activation| samples."""
    absv = np.abs(values.astype(np.float32)).ravel()
    amax = float(absv.max()) if absv.size else 0.0
    if amax == 0.0:
        return 1.0
    if method == "percentile":
        t = float(np.percentile(absv, percentile))
        return max(t, amax * 1e-4) / 127.0
    if method == "entropy":
        return _entropy_threshold(absv, amax, bins) / 127.0
    raise ValueError(f"unknown calibration method '{method}'")


def _entropy_threshold(absv: np.ndarray, amax: float, bins: int) -> float:
    """KL-minimizing saturation threshold (TensorRT-style, 128-bin target),
    tried every 8 bins from 128 up."""
    hist, edges = np.histogram(absv, bins=bins, range=(0, amax))
    hist = hist.astype(np.float64)
    best_t, best_kl = amax, np.inf
    for i in range(128, bins + 1, 8):
        p = hist[:i].copy()
        p[i - 1] += hist[i:].sum()  # clip outliers into the last bin
        if p.sum() == 0:
            continue
        # quantize the clipped i-bin distribution (its last bin holds the
        # folded outlier mass) down to 128 levels
        factor = i / 128.0
        q = np.zeros(i)
        for j in range(128):
            lo = int(j * factor)
            hi = max(int((j + 1) * factor), lo + 1)
            chunk = p[lo:hi]
            nz = chunk > 0
            if nz.any():
                q[lo:hi][nz] = chunk[nz].sum() / nz.sum()
        pn, qn = p / p.sum(), q / max(q.sum(), 1e-12)
        mask = pn > 0
        kl = float(np.sum(pn[mask] * np.log(pn[mask] /
                                            np.maximum(qn[mask], 1e-12))))
        if kl < best_kl:
            best_kl, best_t = kl, edges[i]
    return best_t


@torch.inference_mode()
def calibrate_model(model: nn.Module, calib_images_u8: np.ndarray,
                    preprocess: Callable[[torch.Tensor], torch.Tensor],
                    method: str = "percentile", batch_size: int = 64,
                    sample_cap: int = 1 << 20) -> Dict[str, np.float32]:
    """Run the uint8 NHWC frames, ``batch_size`` at a time, through
    ``preprocess`` and the fp32 ``model`` (on its own device); return
    {JAX module path: scale} for every Conv/DepthwiseConv/Dense input."""
    device = next(model.parameters()).device
    samples: Dict[str, list] = {}
    step = sample_cap // 8

    def hook(mod, args, path):
        x = args[0].detach()
        if x.dim() == 4:
            x = x.contiguous()       # NHWC order, whatever the strides
        x = x.reshape(-1)
        if x.numel() > step:
            x = x[:: max(x.numel() // step, 1)]
        samples.setdefault(path, []).append(x.abs().float().cpu().numpy())
    hooks = [mod.register_forward_pre_hook(
        lambda m, args, path=name.replace(".", "/"): hook(m, args, path))
        for name, mod in model.named_modules()
        if isinstance(mod, (Conv, DepthwiseConv, Dense))]
    try:
        with tf32(False), layer_by_layer(model):
            for start in range(0, calib_images_u8.shape[0], batch_size):
                batch = torch.as_tensor(
                    calib_images_u8[start:start + batch_size]).to(device)
                model(preprocess(batch))
    finally:
        for h in hooks:
            h.remove()
    return {path: np.float32(compute_scale(np.concatenate(vals), method))
            for path, vals in samples.items()}


def calibrate_classifier(model: nn.Module, calib_images_u8: np.ndarray,
                         method: str = "percentile", batch_size: int = 64,
                         sample_cap: int = 1 << 20) -> Dict[str, np.float32]:
    """Classifier calibration: uint8 frames through the AIDER normalize."""
    return calibrate_model(model, calib_images_u8, normalize_batch, method,
                           batch_size, sample_cap)


def calibrate_detector(model: nn.Module, calib_images_u8: np.ndarray,
                       method: str = "percentile", batch_size: int = 16,
                       sample_cap: int = 1 << 20) -> Dict[str, np.float32]:
    """Detector calibration: letterboxed uint8 frames through /255."""
    return calibrate_model(model, calib_images_u8,
                           lambda u8: u8.float() / 255.0, method,
                           batch_size, sample_cap)
