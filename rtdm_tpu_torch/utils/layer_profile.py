"""Per-layer time, FLOPs and parameters of yaml-driven models.

Counterpart of ``rtdm_tpu/utils/layer_profile.py`` (the reference's
``Model.forward_once(profile=True)``, yolov5/models/yolo.py:142-150). As
there, layer k's cost is the difference between the prefix through layer k
(``YoloV5.forward(x, up_to=k)``) and the prefix through layer k - 1:

- time: the best of ``iters`` prefix runs, timed with CUDA events on the
  card (device time of the prefix's launches) and with the host clock on
  the CPU;
- FLOPs: ``torch.utils.flop_counter.FlopCounterMode``'s count of one
  prefix forward, as ``utils/summary.py`` counts a model (convolutions and
  matrix products; the JAX package reads XLA's cost analysis, which also
  counts elementwise work);
- params: the layer's own parameters (``m{k}``, ``m{k}_{j}``, the Detect
  convs ``m{k}_m{j}``).

Eager PyTorch runs each layer's kernels as they are, so the time
difference is the layer's own launches plus noise; a difference below
zero is reported as 0.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Tuple

import torch

__all__ = ["profile_prefix_layers", "profile_v5_layers",
           "format_profile_table"]


def _params_of_layer(model: torch.nn.Module, i: int) -> int:
    """The parameters of layer i: top-level modules ``m{i}`` and
    ``m{i}_*``."""
    pre = f"m{i}"
    return sum(p.numel() for name, p in model.named_parameters()
               if name.split(".")[0] == pre
               or name.split(".")[0].startswith(pre + "_"))


def _timer(device: torch.device) -> Callable[[Callable], float]:
    """Seconds of one run of a zero-argument callable: CUDA events around
    it on a card, the host clock on the CPU."""
    if device.type == "cuda":
        def timed(run):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        return timed

    def timed(run):
        t0 = time.perf_counter()
        run()
        return time.perf_counter() - t0
    return timed


def profile_prefix_layers(prefix_fn: Callable[[int], Tuple[Callable, float]],
                          modules: List[str], params: Callable[[int], int],
                          device: torch.device, iters: int = 10
                          ) -> List[Dict[str, Any]]:
    """The prefix-difference table. ``prefix_fn(k)`` returns (a
    zero-argument callable that runs the prefix through layer k, its
    FLOPs); ``modules[k]`` names layer k and ``params(k)`` counts its
    parameters."""
    timed = _timer(device)
    rows: List[Dict[str, Any]] = []
    prev_flops, prev_t = 0.0, 0.0
    for k, mod in enumerate(modules):
        run, flops = prefix_fn(k)
        run()                                       # warm
        best = min(timed(run) for _ in range(max(iters, 1)))
        rows.append({"i": k, "module": mod, "params": params(k),
                     "flops": max(flops - prev_flops, 0.0),
                     "dt_ms": max((best - prev_t) * 1e3, 0.0)})
        prev_flops, prev_t = flops, best
    return rows


def profile_v5_layers(model, x: torch.Tensor, iters: int = 10
                      ) -> List[Dict[str, Any]]:
    """The table of a port ``YoloV5`` (in eval mode, on x's device) at the
    input x."""
    from torch.utils.flop_counter import FlopCounterMode

    def prefix_fn(k):
        def run():
            with torch.inference_mode():
                model(x, up_to=k)
        counter = FlopCounterMode(display=False)
        with counter:
            run()
        return run, float(counter.get_total_flops())

    return profile_prefix_layers(prefix_fn,
                                 [e["module"] for e in model.plan],
                                 lambda k: _params_of_layer(model, k),
                                 x.device, iters)


def format_profile_table(rows: List[Dict[str, Any]]) -> str:
    """time (ms), GFLOPs, params and module a layer, then the totals (the
    reference's print format)."""
    lines = [f"{'time (ms)':>10} {'GFLOPs':>10} {'params':>10}  module"]
    for r in rows:
        lines.append(f"{r['dt_ms']:10.2f} {r['flops'] / 1e9:10.4f} "
                     f"{r['params']:10d}  {r['i']}: {r['module']}")
    tot_t = sum(r["dt_ms"] for r in rows)
    tot_f = sum(r["flops"] for r in rows)
    tot_p = sum(r["params"] for r in rows)
    lines.append(f"{tot_t:10.2f} {tot_f / 1e9:10.4f} {tot_p:10d}  total")
    return "\n".join(lines)
