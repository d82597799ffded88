"""Batch-in-channels packed inference for the ErNET classifier family.

Counterpart of ``rtdm_tpu/models/packed.py``: k images folded into the
channel dimension, ``[N,H,W,C] -> [N/k,H,W,k*C]`` (image j of a block in
channel group j), so every stage's channel count is k times the model's.
Depthwise convs become ``groups=k*C`` convs with their weights tiled k
times; pools and activations are untouched; BatchNorm's statistics tile
k times. Group j of every conv sees only image j's channels, so the result
per image is the model's: a layout transform, not another model.

Two layouts of the pointwise convs:
- ``grouped``: ``groups=k`` convs over weights tiled k times on the output
  axis; the fuse conv needs the three branches interleaved per image first
  (``[kC] x 3 -> [k][3C]``).
- ``dense``: plain convs over block-diagonal weights (``_block_diag_kernel``:
  k times the products, no interleave); the branches are concatenated
  branch-major (``[3][k][C]``) and the fuse weight's blocks follow that
  order.

Eval mode only (BatchNorm's running statistics, no dropout), as plain
torch ops (``ops/convpool.py``): the JAX package runs this path as XLA
convs, not through its Pallas kernel, so no ACFF kernel launches here.
Weights come from the classifier's state dict (``models/io.py::
torch_state_dict_from_variables`` of the same ``.npz`` the engines load),
so checkpoints need no conversion. Squeeze_RedConv has no plan: its
1x1 reductions between blocks would need their own packed layout.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping

import torch

from rtdm_tpu_torch.core.device import resolve_device
from rtdm_tpu_torch.core.precision import tf32
from rtdm_tpu_torch.data.aider import normalize_batch
from rtdm_tpu_torch.models.layers import conv_product, leaky_relu
from rtdm_tpu_torch.ops.convpool import avg_pool2d, max_pool2d

# (ACFF blocks in order, head pool padding) per model, as models/ernet.py
_PLANS = {
    "squeeze-ernet": (("acff1", "acff2", "acff3", "acff4"), 1),
    "ernet": (("acff1", "acff2", "acff3", "acff4", "acff5", "acff6"), 0),
}
_POOL_AFTER = {  # max_pool2d(2, 2) follows these blocks
    "squeeze-ernet": ("acff1", "acff2", "acff3"),
    "ernet": ("acff1", "acff2", "acff3"),
}
LAYOUTS = ("grouped", "dense")
BN_EPS = 1e-5


def _tile_o(w: torch.Tensor, k: int) -> torch.Tensor:
    """Tile an OIHW (or 1-D) weight k times on its output axis: group j of
    a grouped conv then applies the same per-image filter (output channel
    order [group][feature])."""
    return w.repeat(k, *([1] * (w.dim() - 1)))


def _block_diag_kernel(w: torch.Tensor, k: int,
                       in_order: str = "kc") -> torch.Tensor:
    """OIHW weight (O, I, kh, kw) -> the dense packed weight (k*O, k*I, kh,
    kw) that applies it to each image group on its own: output channel
    j*O+f reads input channel j*I+c (``in_order='kc'``, inputs ordered
    [image][feature], the pack layout) or c*k+j (``'ck'``, [feature][image]),
    and no other."""
    o, i, kh, kw = w.shape
    eye = torch.eye(k, dtype=w.dtype, device=w.device)
    if in_order == "kc":
        dense = torch.einsum("oihw,jl->jolihw", w, eye)
    elif in_order == "ck":
        dense = torch.einsum("oihw,jl->joilhw", w, eye)
    else:
        raise ValueError(f"in_order is 'kc' or 'ck', not {in_order!r}")
    return dense.reshape(k * o, k * i, kh, kw)


def pack_images(x: torch.Tensor, k: int) -> torch.Tensor:
    """[N,H,W,C] -> [N/k, H, W, k*C]; image j of block b -> channel group
    j. Raises where k does not divide N."""
    n, h, w, c = x.shape
    if n % k:
        raise ValueError(f"batch {n} not divisible by pack factor {k}")
    x = x.reshape(n // k, k, h, w, c)
    return x.permute(0, 2, 3, 1, 4).reshape(n // k, h, w, k * c)


def _packed_weights(state: Mapping[str, torch.Tensor], k: int, model: str,
                    layout: str, dtype: torch.dtype,
                    device) -> Dict[str, torch.Tensor]:
    """Every weight the packed forward reads, tiled or made block-diagonal
    for ``layout``, the conv weights in ``dtype`` and BatchNorm's folded
    affine in fp32, on ``device``."""
    def get(name):
        return state[name].detach().to(device)
    dense = layout == "dense"
    out = {}
    k1 = get("conv1.weight").to(dtype)
    out["conv1"] = _block_diag_kernel(k1, k) if dense else _tile_o(k1, k)
    for name in _PLANS[model][0]:
        for i in (1, 2, 3):
            out[f"{name}.conv{i}.weight"] = _tile_o(
                get(f"{name}.conv{i}.weight").to(dtype), k)
            out[f"{name}.conv{i}.bias"] = _tile_o(
                get(f"{name}.conv{i}.bias"), k).to(dtype)
        w = get(f"{name}.fused_conv.weight").to(dtype)   # (O, 3C, 1, 1)
        if dense:
            # rows of the branch-major concat: branch i, image j, channel c
            o, c3 = w.shape[:2]
            w3 = w[:, :, 0, 0].reshape(o, 3, c3 // 3)
            eye = torch.eye(k, dtype=dtype, device=device)
            out[f"{name}.fuse"] = torch.einsum(
                "fic,lj->lfijc", w3, eye).reshape(k * o, k * c3, 1, 1)
        else:
            out[f"{name}.fuse"] = _tile_o(w, k)
        out[f"{name}.fuse_bias"] = _tile_o(
            get(f"{name}.fused_conv.bias"), k).to(dtype)
        var = get(f"{name}.batch_norm.running_var").float() + BN_EPS
        inv = torch.rsqrt(var.double()).float() * get(
            f"{name}.batch_norm.weight").float()
        out[f"{name}.bn_inv"] = _tile_o(inv, k)
        out[f"{name}.bn_mean"] = _tile_o(
            get(f"{name}.batch_norm.running_mean").float(), k)
        out[f"{name}.bn_bias"] = _tile_o(
            get(f"{name}.batch_norm.bias").float(), k)
    k2 = get("head.conv2.weight").to(dtype)
    out["head.conv2"] = _block_diag_kernel(k2, k) if dense else _tile_o(k2, k)
    out["head.fc.weight"] = get("head.fc.weight").to(dtype)
    out["head.fc.bias"] = get("head.fc.bias").to(dtype)
    return out


def _packed_acff(x: torch.Tensor, w: Dict[str, torch.Tensor], name: str,
                 k: int, layout: str) -> torch.Tensor:
    """ACFF block (``models/acff.py``) on a [B,H,W,k*C] packed activation,
    eval mode; the output's channels are [image][feature]."""
    c = x.shape[-1] // k
    branches = []
    for i in (1, 2, 3):
        y = conv_product(x, w[f"{name}.conv{i}.weight"], None, 1, i - 1, i,
                         k * c)
        branches.append(y + w[f"{name}.conv{i}.bias"])
    b, h, wd = branches[0].shape[:3]
    if layout == "dense":
        cat = torch.cat(branches, -1)
        out = conv_product(cat, w[f"{name}.fuse"])
    else:
        # per image: [kC] x 3 -> [k, C] x 3 -> [k, 3C] -> [k*3C]
        cat = torch.cat([y.reshape(b, h, wd, k, c) for y in branches],
                        -1).reshape(b, h, wd, k * 3 * c)
        out = conv_product(cat, w[f"{name}.fuse"], None, 1, 0, 1, k)
    out = leaky_relu(out + w[f"{name}.fuse_bias"], 0.01)
    return torch.addcmul(w[f"{name}.bn_bias"],
                         out.float() - w[f"{name}.bn_mean"],
                         w[f"{name}.bn_inv"]).to(x.dtype)


def _forward(w: Dict[str, torch.Tensor], images_u8: torch.Tensor, k: int,
             model: str, layout: str, dtype: torch.dtype) -> torch.Tensor:
    stages, head_pad = _PLANS[model]
    dense = layout == "dense"
    x = pack_images(normalize_batch(images_u8).to(dtype), k)
    x = conv_product(x, w["conv1"], None, 2, 0, 1, 1 if dense else k)
    for name in stages:
        x = _packed_acff(x, w, name, k, layout)
        if name in _POOL_AFTER[model]:
            x = max_pool2d(x, 2, 2)
    # head: 1x1 conv (no bias) -> odd avg-pool -> NCHW flatten -> fc
    x = conv_product(x, w["head.conv2"], None, 1, 0, 1, 1 if dense else k)
    x = avg_pool2d(x, 5, 1, head_pad, count_include_pad=True)
    b, h, wd, kc = x.shape
    nc = kc // k
    # unpack: [B,H,W,k,nc] -> each image's torch (C,H,W) order -> [N, nc*h*w]
    x = x.reshape(b, h, wd, k, nc).permute(0, 3, 4, 1, 2)
    x = x.reshape(b * k, nc * h * wd)
    x = torch.nn.functional.linear(x, w["head.fc.weight"]) + w["head.fc.bias"]
    return torch.softmax(x.float(), dim=-1)


def _check(model: str, layout: str) -> None:
    if model not in _PLANS:
        raise ValueError(f"packed_forward supports {sorted(_PLANS)}, not "
                         f"'{model}' (redconv has no packed plan)")
    if layout not in LAYOUTS:
        raise ValueError(f"layout is one of {LAYOUTS}, not {layout!r}")


def packed_forward(state: Mapping[str, torch.Tensor],
                   images_u8: torch.Tensor, k: int = 8,
                   model: str = "squeeze-ernet", layout: str = "grouped",
                   compute_dtype: torch.dtype = torch.bfloat16
                   ) -> torch.Tensor:
    """Eval-mode forward, uint8 NHWC -> class probabilities [N, classes]
    (fp32), on the device of ``images_u8``; ``state`` is the classifier's
    state dict (its weights are cast and moved for this call). Per image
    the model's eval forward in ``compute_dtype``; only the layout
    differs. An fp32 forward on the card runs with TF32 off."""
    _check(model, layout)
    w = _packed_weights(state, k, model, layout, compute_dtype,
                        images_u8.device)
    with tf32(False):
        return _forward(w, images_u8, k, model, layout, compute_dtype)


def packed_engine_fn(state: Mapping[str, torch.Tensor], k: int = 8,
                     model: str = "squeeze-ernet", layout: str = "grouped",
                     compute_dtype: torch.dtype = torch.bfloat16,
                     device="cuda") -> Callable[[torch.Tensor], torch.Tensor]:
    """The weights cast and moved to ``device`` once (the card unless the
    caller asks for the CPU), then ``fn(images_u8) -> probs``: the frames
    copied to ``device`` and run through ``packed_forward``'s function;
    the probabilities stay on ``device``. No ACFF kernel runs."""
    _check(model, layout)
    device = resolve_device(device)
    w = _packed_weights(state, k, model, layout, compute_dtype, device)

    @torch.inference_mode()
    def fn(images_u8) -> torch.Tensor:
        frames = torch.as_tensor(images_u8).to(device)
        with tf32(False):
            return _forward(w, frames, k, model, layout, compute_dtype)
    return fn

