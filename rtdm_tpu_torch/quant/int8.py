"""int8 (w8a8) quantize-dequantize inference, classifiers and detectors.

Counterpart of ``rtdm_tpu/quant/int8.py``:

- Weights: symmetric per-output-channel int8 (absmax/127) on every conv,
  depthwise and dense kernel (``quantize_params``, on the JAX-layout tree,
  where the last axis is the output channel: HWIO, (3,3,1,C) depthwise,
  (I,O) dense), then cast to bf16 like the bf16 engine's.
- Activations: symmetric per-tensor int8 with calibrated scales
  (``quant/calibrate.py``) at the input of every Conv, DepthwiseConv and
  Dense. The JAX package intercepts the flax modules' calls;
  ``quantize_classifier`` registers forward pre-hooks on the Conv and Dense
  layers the forward calls, and hands each ACFF block its four scales,
  which the block's fused call applies (``ops/acff.py``);
  ``quantize_detector`` hooks every Conv, DepthwiseConv and Dense that has
  a scale.

QDQ semantics, so the numbers are an int8 engine's while the compute runs
on the bf16 path. True int8 products (``int8_classifier_forward``) are not
ported.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch
from torch import nn

ACFF_SCALE_KEYS = ("conv1", "conv2", "conv3", "fused_conv")


def fake_quant_tensor(x: torch.Tensor, scale) -> torch.Tensor:
    """Symmetric int8 quantize-dequantize of a float32 x with a fixed
    scale, as the compiled JAX int8 engine computes it:
    ``clip(round(x * inv), -127, 127) * scale``, inv = ``reciprocal(scale)``,
    rounding half to even. XLA compiles ``x / scale`` by a constant into a
    multiply by the constant's fp32 reciprocal, and a code can differ from
    true division's where x / scale lies within an ulp of k + 1/2."""
    # 0-dim CPU tensors: scalar operands on the card too (no copy, so the
    # call can be captured in a CUDA graph), multiplied in fp32
    s = np.float32(scale)
    inv = torch.tensor(np.float32(1.0) / s)
    return torch.clamp(torch.round(x * inv), -127, 127) * torch.tensor(s)


def quantize_kernel_per_channel(kernel: np.ndarray) -> np.ndarray:
    """Per-output-channel (last axis) symmetric int8 QDQ of an HWIO/IO kernel."""
    k = np.asarray(kernel, np.float32)
    absmax = np.max(np.abs(k), axis=tuple(range(k.ndim - 1)), keepdims=True)
    scale = np.maximum(absmax, 1e-12) / 127.0
    q = np.clip(np.round(k / scale), -127, 127)
    return (q * scale).astype(np.float32)


def seal_kernel(kernel: np.ndarray):
    """fp32 kernel -> (int8 codes, fp32 per-output-channel scale); ``codes *
    scale`` is ``quantize_kernel_per_channel(kernel)`` bit for bit."""
    k = np.asarray(kernel, np.float32)
    absmax = np.max(np.abs(k), axis=tuple(range(k.ndim - 1)), keepdims=True)
    scale = (np.maximum(absmax, 1e-12) / 127.0).astype(np.float32)
    q = np.clip(np.round(k / scale), -127, 127).astype(np.int8)
    return q, scale


def quantize_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """Every ``kernel`` leaf of a JAX-layout params tree, QDQ'd per output
    channel; other leaves unchanged."""
    def walk(node):
        if isinstance(node, dict):
            return {k: (quantize_kernel_per_channel(v) if k == "kernel"
                        else walk(v)) for k, v in node.items()}
        return node
    return walk(params)


def acff_scales(act_scales: Mapping[str, Any], block: str):
    """The four scales of ACFF ``block`` (its three depthwise inputs and the
    fuse input), or None where the archive has none of them."""
    keys = [f"{block}/{k}" for k in ACFF_SCALE_KEYS]
    have = [k in act_scales for k in keys]
    if not any(have):
        return None
    if not all(have):
        raise ValueError(f"{block}: act_scales has "
                         f"{[k for k, h in zip(keys, have) if h]}; the "
                         f"fused block takes all of {keys} or none")
    return tuple(float(np.float32(act_scales[k])) for k in keys)


def quantize_classifier(model: nn.Module, act_scales: Mapping[str, Any]
                        ) -> List[torch.utils.hooks.RemovableHandle]:
    """Make ``model`` (parameters already QDQ'd and cast) an int8 QDQ
    model: a forward pre-hook on every Conv, DepthwiseConv and Dense
    outside the ACFF blocks QDQs its input in fp32 with the scale of its
    JAX path (the module name with '.' -> '/') and casts it to the layer's
    dtype; a layer without a scale is left alone. Each ACFF block gets its
    four scales (``ACFF.act_scales``). The layers the model names in
    ``UNROUNDED_IN_INT8`` keep their last step in fp32
    (``models/layers.py``) and its head pools with bf16 partial sums
    (``sequential_pool``), as XLA compiles the JAX int8 engine. Returns the
    hooks' handles."""
    from rtdm_tpu_torch.models.acff import ACFF
    from rtdm_tpu_torch.models.layers import Conv, Dense, DepthwiseConv
    scales = {k: float(np.float32(v)) for k, v in act_scales.items()}
    handles = []
    blocks = {name for name, mod in model.named_modules()
              if isinstance(mod, ACFF)}
    for name, mod in model.named_modules():
        if isinstance(mod, ACFF):
            mod.act_scales = acff_scales(scales, name.replace(".", "/"))
            continue
        if (not isinstance(mod, (Conv, DepthwiseConv, Dense))
                or name.rpartition(".")[0] in blocks):
            continue
        s: Optional[float] = scales.get(name.replace(".", "/"))
        if s is not None:
            handles.append(mod.register_forward_pre_hook(_qdq_hook(s)))
    for name in getattr(model, "UNROUNDED_IN_INT8", ()):
        model.get_submodule(name).round_output = False
    for mod in model.modules():
        if hasattr(mod, "sequential_pool"):
            mod.sequential_pool = True
    return handles


def _qdq_hook(scale: float):
    def hook(m, args):
        with torch.profiler.record_function("qdq"):
            return (fake_quant_tensor(args[0].float(), scale).to(
                m.weight.dtype),) + args[1:]
    return hook


def quantize_detector(model: nn.Module, act_scales: Mapping[str, Any]
                      ) -> List[torch.utils.hooks.RemovableHandle]:
    """Make a detector (parameters already QDQ'd and cast to bf16) an int8
    QDQ model, as ``export/detector.py``'s JAX interceptor does: a forward
    pre-hook on every Conv, DepthwiseConv and Dense whose JAX path (the
    module name with '.' -> '/') has a scale QDQs its input in fp32 and
    casts it to the layer's dtype. A v5 ConvBnSiLU and Bottleneck then
    hand the next conv their SiLU product or residual sum in fp32
    (``keep_fp32``), which the compiled JAX int8 program QDQs without
    rounding it to bf16 first. Returns the hooks' handles."""
    from rtdm_tpu_torch.models.layers import Conv, Dense, DepthwiseConv
    from rtdm_tpu_torch.models.yolov5 import Bottleneck, ConvBnSiLU
    scales = {k: float(np.float32(v)) for k, v in act_scales.items()}
    handles = []
    for name, mod in model.named_modules():
        if isinstance(mod, (ConvBnSiLU, Bottleneck)):
            mod.keep_fp32 = True
        s = scales.get(name.replace(".", "/"))
        if s is not None and isinstance(mod, (Conv, DepthwiseConv, Dense)):
            handles.append(mod.register_forward_pre_hook(_qdq_hook(s)))
    return handles
