"""Timing, FPS and energy instrumentation.

Counterpart of ``rtdm_tpu/utils/profiler.py``:
- ``StepTimer``: wall-clock step timing that waits for the device result
  it is given (``time_synchronized``, yolov3/utils/torch_utils.py:47): a
  tensor, or a tuple or list of them, is copied to the host.
- ``FpsMeter``: EMA-smoothed frames/s (trt_yolo.py:118-121,
  real-time-inference.py:194-198).
- ``PowerMonitor``: energy per frame. The reference reads a Jetson TX2's
  INA3221 rails (calculate-power-usage.py:26-39, 105-213); here energy is
  modelled as busy time x the device's power: on the card its power limit
  as ``nvidia-smi --query-gpu=power.limit`` reports it, on the CPU the
  65 W of ``DEFAULT_WATTS``; the same getTotalEnergy / energy-per-frame
  surface and step integration as the JAX package.
- ``trace``: a ``torch.profiler`` trace of the ``with`` body, written as a
  Chrome trace into a directory (TensorBoard's PyTorch profiler plugin or
  chrome://tracing read it).
- ``span``: the program's named ranges (``engine:*``, ``det:*``, ``qdq``).
  A range whose name ends in ``:wait`` covers one point where the call
  blocks the host on the device.
"""

from __future__ import annotations

import collections
import contextlib
import subprocess
import time
from dataclasses import dataclass
from typing import Any, List, Optional

import numpy as np
import torch

from rtdm_tpu_torch.core.device import resolve_device

# busy watts of a device without a power reading
DEFAULT_WATTS = {"cpu": 65.0}

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A ``record_function`` range named ``name`` where a profiler would
    record one on this thread, or while compiling or exporting; otherwise
    one shared no-op context, since a ``record_function`` costs its
    dispatcher round trip even with no profiler running."""
    if torch.compiler.is_compiling() or torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def _force(result: Any) -> None:
    """Wait for a device result: copy each tensor of it to the host."""
    if isinstance(result, (tuple, list)):
        for r in result:
            _force(r)
    elif isinstance(result, torch.Tensor):
        result.cpu()


class StepTimer:
    """Wall-clock timer for device work, over a bounded history (a live
    stream ticks it every frame for the life of the run)."""

    def __init__(self, max_records: int = 65536):
        self.times = collections.deque(maxlen=max_records)
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, result: Any = None) -> float:
        if result is not None:
            _force(result)
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    @property
    def mean(self) -> float:
        # skip the first (warm-up) step when enough samples exist
        ts = list(self.times)
        ts = ts[1:] if len(ts) > 1 else ts
        return float(np.mean(ts)) if ts else 0.0

    @property
    def total(self) -> float:
        return float(np.sum(self.times))


class FpsMeter:
    """EMA-smoothed frames/s."""

    def __init__(self, decay: float = 0.9):
        self.decay = decay
        self.fps = 0.0
        self._last: Optional[float] = None
        self.frames = 0

    def tick(self, n_frames: int = 1) -> float:
        now = time.perf_counter()
        if self._last is not None:
            inst = n_frames / max(now - self._last, 1e-9)
            self.fps = (inst if self.fps == 0.0
                        else self.decay * self.fps + (1 - self.decay) * inst)
        self._last = now
        self.frames += n_frames
        return self.fps


def card_power_limit(index: int = 0) -> float:
    """The card's power limit in W, as ``nvidia-smi`` reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit",
         "--format=csv,noheader,nounits", f"--id={index}"],
        capture_output=True, text=True, check=True, timeout=30).stdout
    return float(out.strip().splitlines()[0])


@dataclass
class PowerSample:
    t: float
    watts: float


class PowerMonitor:
    """Busy-time energy model with the PowerLogger reporting surface.
    ``chip_watts`` defaults to the device's: the card's power limit, or
    ``DEFAULT_WATTS["cpu"]`` for ``device="cpu"``."""

    def __init__(self, chip_watts: Optional[float] = None,
                 idle_watts: float = 30.0, device="cuda"):
        if chip_watts is None:
            device = resolve_device(device)
            chip_watts = (DEFAULT_WATTS["cpu"] if device.type == "cpu"
                          else card_power_limit(device.index or 0))
        self.chip_watts = float(chip_watts)
        self.idle_watts = float(idle_watts)
        self.samples: List[PowerSample] = []
        self._events: List[tuple] = []
        self._t_start: Optional[float] = None
        self._busy = 0.0

    def start(self) -> None:
        self._t_start = time.perf_counter()
        self.samples.append(PowerSample(0.0, self.idle_watts))

    def record_busy(self, seconds: float) -> None:
        """Log a span of device-busy time (one inference step)."""
        t = time.perf_counter() - self._t_start
        self._busy += seconds
        self.samples.append(PowerSample(t - seconds, self.chip_watts))
        self.samples.append(PowerSample(t, self.idle_watts))

    def mark_event(self, name: str) -> None:
        self._events.append((time.perf_counter() - self._t_start, name))

    def stop(self) -> None:
        self.samples.append(PowerSample(time.perf_counter() - self._t_start,
                                        self.idle_watts))

    def get_total_energy(self) -> float:
        """Joules over the modelled step trace: each sample's watts hold
        until the next sample (the where='post' plot), so the integral is
        sum(w[i] * dt[i]), not a trapezoid, which would ramp idle to busy
        over every host-side gap."""
        if len(self.samples) < 2:
            return 0.0
        t = np.array([s.t for s in self.samples])
        w = np.array([s.watts for s in self.samples])
        return float(np.sum(w[:-1] * np.diff(t)))

    def energy_per_frame(self, frames: int) -> float:
        """mJ per frame over the busy spans only."""
        if frames <= 0:
            return 0.0
        return self._busy * self.chip_watts / frames * 1e3

    def plot(self, path: str) -> str:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(8, 3.5))
        ax.step([s.t for s in self.samples],
                [s.watts for s in self.samples], where="post")
        for t, name in self._events:
            ax.axvline(t, ls="--", alpha=0.4)
            ax.text(t, ax.get_ylim()[1] * 0.95, name, rotation=90,
                    fontsize=7, va="top")
        ax.set_xlabel("s")
        ax.set_ylabel("W (modelled)")
        fig.savefig(path, dpi=110, bbox_inches="tight")
        plt.close(fig)
        return path


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` trace of the body (host, and the card's kernels
    when CUDA is available), written into ``log_dir`` as a Chrome trace."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
