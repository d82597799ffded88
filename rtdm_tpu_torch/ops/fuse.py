"""Conv+BN folding for inference (numpy, on the JAX-layout tree).

Copy of ``rtdm_tpu/ops/fuse.py``: ``fuse_conv_bn`` folds BatchNorm's
inference affine into the preceding conv's HWIO kernel and bias,
``strip_bn_from_cfg`` drops every ``batch_normalize`` line so the convs
are built with a bias and no BatchNorm, and ``fuse_darknet_variables``
folds every batch-normalized darknet conv (eps 1e-4) of a variables tree.
"""

from __future__ import annotations

import copy
import re
from typing import Any, Dict, Tuple

import numpy as np


def fuse_conv_bn(kernel: np.ndarray, bias, bn_scale, bn_bias, bn_mean,
                 bn_var, eps: float) -> Tuple[np.ndarray, np.ndarray]:
    """kernel HWIO; returns (fused_kernel, fused_bias)."""
    scale = np.asarray(bn_scale) / np.sqrt(np.asarray(bn_var) + eps)
    fused_kernel = np.asarray(kernel) * scale  # broadcast over O (last axis)
    b = np.zeros(kernel.shape[-1], np.float32) if bias is None \
        else np.asarray(bias)
    fused_bias = (b - np.asarray(bn_mean)) * scale + np.asarray(bn_bias)
    return fused_kernel.astype(np.float32), fused_bias.astype(np.float32)


def strip_bn_from_cfg(cfg_text: str) -> str:
    """cfg text for the fused graph: no ``batch_normalize`` lines."""
    return "\n".join(ln for ln in cfg_text.splitlines()
                     if not re.match(r"\s*batch_normalize\s*=", ln))


def fuse_darknet_variables(variables: Dict[str, Any], cfg_text: str
                           ) -> Dict[str, Any]:
    """A copy of ``variables`` with BN folded into every batch-normalized
    conv of ``cfg_text`` (its BN parameters and statistics removed); pair
    it with ``strip_bn_from_cfg(cfg_text)``."""
    from rtdm_tpu_torch.models.darknet import parse_darknet_cfg

    variables = copy.deepcopy(variables)
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    for i, d in enumerate(parse_darknet_cfg(cfg_text)[1:]):
        if d["type"] != "convolutional" or not d.get("batch_normalize", 0):
            continue
        conv = params[f"l{i}_conv"]
        bn = params.pop(f"l{i}_bn")
        st = stats.pop(f"l{i}_bn")
        conv["kernel"], conv["bias"] = fuse_conv_bn(
            conv["kernel"], conv.get("bias"), bn["scale"], bn["bias"],
            st["mean"], st["var"], eps=1e-4)
    return variables
