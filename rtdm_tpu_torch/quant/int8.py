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
on the bf16 path.

True int8 products: ``int8_classifier_forward`` runs each ACFF block's 1x1
fuse as an int8 x int8 -> int32 matrix product (``int8_pointwise``) with
calibrated activation scales and per-output-channel weight codes
(``_prep_int8_kernel``), and the rest of the classifier in bf16, its head
in fp32, as the jitted JAX function computes it. The product is
``torch._int_mm`` on both devices (cuBLASLt on the card, which needs more
than 16 rows and K and N multiples of 8: a product of 16 rows or fewer is
padded with zero rows, which changes no row of the result; any other
refusal raises). No Pallas kernel is involved on the JAX side either.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rtdm_tpu_torch.utils.profiler import span

ACFF_SCALE_KEYS = ("conv1", "conv2", "conv3", "fused_conv")
# the int32 products of int8_matmul: the calls, those padded with zero rows
# (torch._int_mm needs more than MIN_INT_MM_ROWS) and the rows added
INT_MM = {"calls": 0, "padded_calls": 0, "rows_added": 0}
MIN_INT_MM_ROWS = 16


def fake_quant_tensor(x: torch.Tensor, scale) -> torch.Tensor:
    """Symmetric int8 quantize-dequantize of a float32 x with a fixed
    scale, as the compiled JAX int8 engine computes it:
    ``clip(round(x * inv), -127, 127) * scale``, inv = ``reciprocal(scale)``,
    rounding half to even. XLA compiles ``x / scale`` by a constant into a
    multiply by the constant's fp32 reciprocal, and a code can differ from
    true division's where x / scale lies within an ulp of k + 1/2."""
    return _codes(x, scale) * torch.tensor(np.float32(scale))


def _codes(x: torch.Tensor, scale) -> torch.Tensor:
    """``clip(round(x * inv), -127, 127)`` in x's dtype, inv the fp32
    reciprocal of the scale."""
    # 0-dim CPU tensors: scalar operands on the card too (no copy, so the
    # call can be captured in a CUDA graph), multiplied in fp32
    inv = torch.tensor(np.float32(1.0) / np.float32(scale))
    return torch.clamp(torch.round(x * inv), -127, 127)


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
        with span("qdq"):
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


def _prep_int8_kernel(kernel: np.ndarray):
    """HWIO 1x1 kernel -> (int8 (I,O), per-O scale) for a true int8 matrix
    product: symmetric per output channel, absmax/127."""
    k = np.asarray(kernel, np.float32)[0, 0]          # (I, O)
    absmax = np.max(np.abs(k), axis=0, keepdims=True)
    scale = np.maximum(absmax, 1e-12) / 127.0
    q = np.clip(np.round(k / scale), -127, 127).astype(np.int8)
    return q, scale[0].astype(np.float32)             # (I,O), (O,)


def quantize_codes(x: torch.Tensor, scale) -> torch.Tensor:
    """The int8 codes of a float32 x, as ``fake_quant_tensor`` takes them."""
    return _codes(x, scale).to(torch.int8)


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (K, N) int8 -> (M, N) int32, exact, by
    ``torch._int_mm``; M of ``MIN_INT_MM_ROWS`` or fewer is padded with zero
    rows to the next multiple of 8 above it and cut back. No other
    product is taken: a refusal raises."""
    m = a.shape[0]
    INT_MM["calls"] += 1
    if m <= MIN_INT_MM_ROWS:
        rows = (MIN_INT_MM_ROWS // 8 + 1) * 8
        INT_MM["padded_calls"] += 1
        INT_MM["rows_added"] += rows - m
        return torch._int_mm(F.pad(a, (0, 0, 0, rows - m)), b)[:m]
    return torch._int_mm(a.contiguous(), b)


def int8_pointwise(x: torch.Tensor, kq: torch.Tensor, kscale: torch.Tensor,
                   bias: torch.Tensor, act_scale: float) -> torch.Tensor:
    """A 1x1 conv as a true int8 product: x (B,H,W,C) float32 quantized with
    ``act_scale`` (``quantize_codes``), times ``kq`` (C, O) int8 into int32
    (``int8_matmul``, exact in any order), dequantized in fp32 by
    ``act_scale * kscale`` per output channel and the bias added in one
    rounding, as XLA:CPU contracts the jitted JAX multiply and add.
    Returns (B,H,W,O) float32."""
    return _pointwise(x, kq, _dequant_scale(kscale, act_scale), bias,
                      act_scale)


def _dequant_scale(kscale: torch.Tensor, act_scale: float) -> torch.Tensor:
    """``act_scale * kscale`` in fp32, the per-output-channel factor that
    turns an int32 accumulator back into the product's scale."""
    # a 0-dim CPU tensor: a scalar operand on the card, with no copy
    return torch.tensor(np.float32(act_scale)) * kscale


def _pointwise(x, kq, s, bias, act_scale):
    """``int8_pointwise`` with its dequantize factor ``s`` given."""
    b, h, w, c = x.shape
    acc = int8_matmul(quantize_codes(x, act_scale).reshape(-1, c), kq)
    return torch.addcmul(bias, acc.float(), s).reshape(b, h, w, -1)


def _fold_bn(state, name: str):
    """The block's BatchNorm as XLA:CPU folds the JAX forward's constants:
    scale = gamma * (1 / sqrt(var + 1e-5)), shift = beta - mean * scale,
    each step rounded in fp32."""
    def get(leaf):
        return state[f"{name}.batch_norm.{leaf}"].float()
    scale = get("weight") * (1.0 / torch.sqrt(get("running_var") + 1e-5))
    return scale, get("bias") - get("running_mean") * scale


def int8_classifier_forward(model: nn.Module,
                            act_scales: Mapping[str, Any]
                            ) -> Callable[[torch.Tensor], torch.Tensor]:
    """True-int8 inference forward for the ErNET family: ``forward(x) ->
    probs`` for a normalized NHWC float32 x, on the model's device, with
    the model's weights (a JAX variables tree's, ``models/io.py``).

    Each ACFF block: the three depthwise branches in bf16 (each product and
    bias sum rounded), concatenated in fp32, the 1x1 fuse by
    ``int8_pointwise`` with the block's calibrated ``<block>/fused_conv``
    scale, LeakyReLU(0.01) and the folded BatchNorm in fp32 (one rounding,
    as the jitted JAX function contracts them), rounded to bf16. conv1 and
    the 1x1 reductions in bf16, the head (1x1 conv, the average pool summed
    window by window and scaled by the fp32 reciprocal of 25, flatten, fc,
    softmax) in fp32. On the card it runs with TF32 off. x must lie on the
    model's device. Raises ``TypeError`` for any other model."""
    from rtdm_tpu_torch.core.precision import tf32
    from rtdm_tpu_torch.models.ernet import (ErNET, SqueezeErNET,
                                             SqueezeRedConv, _nchw_flatten)
    from rtdm_tpu_torch.models.layers import conv_product
    from rtdm_tpu_torch.ops.convpool import (avg_pool2d_sequential,
                                             max_pool2d)
    if not isinstance(model, (SqueezeErNET, SqueezeRedConv, ErNET)):
        raise TypeError(f"unsupported model {type(model)}")
    state = {k: v.detach() for k, v in model.state_dict().items()}
    device = next(iter(state.values())).device
    bf16 = torch.bfloat16
    blocks = {}
    for name in (n for n, _ in model.named_children()
                 if n.startswith("acff")):
        w = state[f"{name}.fused_conv.weight"]
        kq, ks = _prep_int8_kernel(
            w.permute(2, 3, 1, 0).cpu().float().numpy())
        act_scale = float(np.float32(act_scales[f"{name}/fused_conv"]))
        blocks[name] = {
            "dw": [(state[f"{name}.conv{i}.weight"].to(bf16),
                    state[f"{name}.conv{i}.bias"].to(bf16))
                   for i in (1, 2, 3)],
            "kq": torch.from_numpy(kq).to(device),
            "dequant": _dequant_scale(torch.from_numpy(ks).to(device),
                                     act_scale),
            "bias": state[f"{name}.fused_conv.bias"].float(),
            "s": act_scale,
            "bn": _fold_bn(state, name)}
    # conv1 and the 1x1 reductions: (bf16 weight, bf16 bias or None)
    convs = {n: (state[f"{n}.weight"].to(bf16),
                 None if state.get(f"{n}.bias") is None
                 else state[f"{n}.bias"].to(bf16))
             for n, _ in model.named_children() if n.startswith("conv")}
    slope = torch.tensor(0.01, dtype=torch.float32)

    def acff(name, x):
        p = blocks[name]
        branches = []
        for d, (kw, kb) in enumerate(p["dw"]):
            y = conv_product(x, kw, None, 1, d, d + 1, x.shape[-1])
            branches.append(y + kb)
        cat = torch.cat(branches, -1).float()
        out = _pointwise(cat, p["kq"], p["dequant"], p["bias"], p["s"])
        out = torch.where(out > 0, out, out * slope)
        scale, shift = p["bn"]
        return torch.addcmul(shift, out, scale).to(bf16)

    def conv(name, x, stride=1):
        w, b = convs[name]
        y = conv_product(x, w, None, stride)
        return y if b is None else y + b

    conv2 = state["head.conv2.weight"].float()
    fc_w, fc_b = state["head.fc.weight"], state["head.fc.bias"]

    def head(x, pool_padding):
        x = conv_product(x.float(), conv2)
        x = avg_pool2d_sequential(x, 5, pool_padding)
        x = _nchw_flatten(x) @ fc_w.t() + fc_b
        return torch.softmax(x, dim=-1)

    if isinstance(model, SqueezeErNET):
        def body(x):
            x = conv("conv1", x, 2)
            for name in ("acff1", "acff2", "acff3"):
                x = max_pool2d(acff(name, x), 2, 2)
            return head(acff("acff4", x), 1)
    elif isinstance(model, SqueezeRedConv):
        def body(x):
            x = conv("conv_red1", conv("conv1", x, 2))
            x = max_pool2d(acff("acff1", x), 2, 2)
            x = max_pool2d(conv("conv_red2", acff("acff2", x)), 2, 2)
            x = max_pool2d(acff("acff3", x), 2, 2)
            return head(acff("acff4", conv("conv_red3", x)), 1)
    else:
        def body(x):
            x = conv("conv1", x, 2)
            for name in ("acff1", "acff2", "acff3"):
                x = max_pool2d(acff(name, x), 2, 2)
            for name in ("acff4", "acff5", "acff6"):
                x = acff(name, x)
            return head(x, 0)

    @torch.inference_mode()
    def forward(x: torch.Tensor) -> torch.Tensor:
        if x.device != device:
            raise ValueError(f"x is on {x.device}, the model on {device}")
        with tf32(False):
            return body(x.to(bf16))
    return forward
