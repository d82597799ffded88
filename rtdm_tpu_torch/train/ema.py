"""Model EMA: an exponential moving average of the weights with a ramped
decay.

Counterpart of ``rtdm_tpu/train/ema.py`` (ModelEMA,
yolov5/utils/torch_utils.py:276-306): after update k the average moves by
``d = 0.9999 * (1 - exp(-(k + 1) / 2000))``, ``e = e * d + p * (1 - d)``,
over the parameters and the BatchNorm running statistics alike (every
floating entry of the state dict), computed in fp32 as the JAX step does.
The average is a dict of tensors on the model's device, keyed as the
model's state dict, so ``load_state_dict`` takes it as it is.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn


def ema_init(model: nn.Module) -> Dict[str, torch.Tensor]:
    """A copy of every entry of ``model``'s state dict (the EMA owns its
    storage)."""
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def ema_decay(step: int, base_decay: float = 0.9999,
              tau: float = 2000.0) -> np.float32:
    """The decay of update ``step``, in fp32."""
    f = np.float32
    return f(base_decay) * (f(1.0) - np.exp(-(f(step) + f(1.0)) / f(tau)))


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], model: nn.Module, step: int,
               base_decay: float = 0.9999, tau: float = 2000.0
               ) -> Dict[str, torch.Tensor]:
    """One EMA update in place toward ``model``'s current weights; entries
    that are not floating (counters) are copied."""
    d = float(ema_decay(step, base_decay, tau))
    floats, news = [], []
    for k, v in model.state_dict().items():
        e = ema[k]
        if e.is_floating_point():
            floats.append(e)
            news.append(v.detach().to(e.dtype))
        else:
            e.copy_(v)
    torch._foreach_mul_(floats, d)
    torch._foreach_add_(floats, torch._foreach_mul(news, 1.0 - d))
    return ema
