"""Classifier summary: parameter table and forward FLOPs.

Counterpart of ``rtdm_tpu/utils/summary.py::summarize_classifier`` (the
reference's model_summary tables: Squeeze_ErNET 169,241 parameters). The
parameters are listed in the JAX layout (``collection/path/leaf``); the
FLOPs are torch's ``FlopCounterMode`` count of one CPU forward, where the
JAX package reads XLA's cost analysis of the compiled forward.
``summarize_detector`` is not ported yet (ROADMAP item 7).
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
