"""Model summaries: parameter tables and forward FLOPs.

Counterpart of ``rtdm_tpu/utils/summary.py``: ``summarize_classifier``
(the reference's model_summary tables: Squeeze_ErNET 169,241 parameters;
parameters listed in the JAX layout, ``collection/path/leaf``) and
``summarize_detector`` (``yolo_train --summary``: one row per top-level
module with its output shape and parameter count). The FLOPs are torch's
``FlopCounterMode`` count of one CPU forward, where the JAX package reads
XLA's cost analysis of the compiled forward.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np


def param_table(params: Dict[str, Any], prefix: str = "") -> list:
    """[(path, shape, count)] rows over a param tree, keys sorted."""
    rows = []
    for key in sorted(params):
        val = params[key]
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(val, dict):
            rows.extend(param_table(val, path))
        else:
            rows.append((path, tuple(val.shape), int(np.prod(val.shape))))
    return rows


def summarize_classifier(name: str, batch: int = 1) -> str:
    """Summary text for an ErNET-family model (aider_train --summary)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from rtdm_tpu_torch.models import create_model
    from rtdm_tpu_torch.models.io import variables_from_torch_state_dict

    model = create_model(name, device="cpu")
    size = model.image_size
    params = variables_from_torch_state_dict(
        dict(model.named_parameters()))["params"]
    rows = param_table(params)
    total = sum(r[2] for r in rows)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        model(torch.zeros((batch, size, size, 3)))
    flops = counter.get_total_flops()
    lines = [f"model: {name}  input: {batch}x{size}x{size}x3 (NHWC)"]
    lines.append(f"{'module/param':<40} {'shape':<22} {'count':>10}")
    for path, shape, count in rows:
        lines.append(f"{path:<40} {str(shape):<22} {count:>10,}")
    lines.append(f"{'total params':<40} {'':<22} {total:>10,}")
    if flops:
        lines.append(f"forward FLOPs (torch FlopCounterMode, batch {batch}): "
                     f"{flops / 1e6:.2f} M  (~{flops / 2e6:.2f} M mult-adds)")
    return "\n".join(lines)


def summarize_detector(model_path: str, img_size: int = 416,
                       batch: int = 1) -> str:
    """Per-layer summary of a darknet .cfg or v5 .yaml detector (the
    reference's ``model_info()``): each top-level module's output shape
    (NHWC) and parameter count, in layer order, and the forward FLOPs."""
    import re

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from rtdm_tpu_torch.export.detector import load_detection_model

    model, _, _ = load_detection_model(model_path, None, img_size)
    model.eval()
    shapes: Dict[str, tuple] = {}
    hooks = [child.register_forward_hook(
        lambda mod, args, out, name=name: shapes.__setitem__(
            name, tuple(out.shape)))
        for name, child in model.named_children()]
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        model(torch.zeros((batch, img_size, img_size, 3)))
    for h in hooks:
        h.remove()
    pcounts: Dict[str, int] = {}
    for name, p in model.named_parameters():
        top = name.split(".")[0]
        pcounts[top] = pcounts.get(top, 0) + p.numel()

    def order(name: str):
        m = re.search(r"(\d+)", name)
        return (int(m.group(1)) if m else 10 ** 9, name)

    names = sorted(set(shapes) | set(pcounts), key=order)
    lines = [f"model: {model_path}  "
             f"input: {batch}x{img_size}x{img_size}x3 (NHWC)"]
    lines.append(f"{'layer':<28} {'output shape':<26} {'params':>12}")
    for n in names:
        lines.append(f"{n:<28} {str(shapes.get(n, '-')):<26} "
                     f"{pcounts.get(n, 0):>12,}")
    total = sum(pcounts.values())
    lines.append(f"{'total params':<28} {'':<26} {total:>12,}")
    flops = counter.get_total_flops()
    if flops:
        lines.append(f"forward FLOPs (torch FlopCounterMode, batch {batch}): "
                     f"{flops / 1e9:.3f} G")
    return "\n".join(lines)
