"""A traced window: ``torch.profiler`` over the window, reduced to device
intervals, host ranges and what the host was doing while the device sat
idle.

The profiler's raw events (``kineto_results.events()``) become plain
``Event`` records first; everything after that works on records, so the
CPU tests feed it synthetic ones. Device time is the union of kernels,
copies and sets on the card inside the ``bench:window`` range. A device
operation belongs to the host ranges (``record_function``: the program's
``det:*`` and ``qdq``, the harness's ``bench:*``) that enclosed the
runtime call that launched it, matched by correlation id. An idle gap of
the device is charged to the innermost range open, on a thread that
launches device work, when the gap began.
"""

from __future__ import annotations

import collections
import dataclasses
import re
from typing import Dict, Iterable, List, Optional, Tuple

from benchmark import stats

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench:window"


@dataclasses.dataclass(frozen=True)
class Event:
    kind: str        # kernel | gpu_memcpy | gpu_memset | range | runtime
    name: str
    start: int       # ns
    end: int         # ns
    tid: int = 0
    corr: int = 0


RUNTIME = re.compile(r"^(cuda|cu)[A-Z]")


def _kind(ev) -> Optional[str]:
    """The record kind of a raw profiler event, or None to drop it."""
    activity = getattr(ev, "activity_type", None)
    if activity is not None:                 # newer torch names it
        kind = activity()
        if kind in DEVICE_KINDS:
            return kind
        if kind == "user_annotation":
            return "range"
        return "runtime" if kind in ("cuda_runtime", "cuda_driver") \
            else None
    on_device = "CPU" not in str(ev.device_type())
    name = ev.name()
    if ev.is_user_annotation():
        return None if on_device else "range"
    if on_device:
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        return "gpu_memset" if name.startswith("Memset") else "kernel"
    return "runtime" if RUNTIME.match(name) else None


def from_profiler(prof) -> List[Event]:
    """Records of a finished ``torch.profiler.profile``. A device event
    named as a host range is the profiler's device-side copy of that range,
    not device work, and is dropped."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        kind = _kind(ev)
        if kind is None:
            continue
        start = ev.start_ns()
        out.append(Event(kind, ev.name(), start, start + ev.duration_ns(),
                         ev.start_thread_id(), ev.correlation_id()))
    names = {e.name for e in out if e.kind == "range"}
    return [e for e in out if e.kind not in DEVICE_KINDS
            or e.name not in names]


@dataclasses.dataclass
class Summary:
    window: Tuple[int, int]
    device: List[Event]
    ranges: List[Event]
    # correlation id -> names of the host ranges around its launch
    launched_in: Dict[int, Tuple[str, ...]]
    idle_by_range: Dict[str, float]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    @property
    def busy_s(self) -> float:
        return stats.union_length(
            stats.clip([(e.start, e.end) for e in self.device],
                       *self.window)) / 1e9

    def device_s(self, match=None, ranges: Iterable[str] = ()) -> float:
        """Device seconds (summed, not unioned) of operations whose name
        passes ``match`` and, if ``ranges`` is given, that were launched
        inside one of those host ranges."""
        want = set(ranges)
        total = 0
        for e in self.device:
            if match is not None and not match(e):
                continue
            if want and not want.intersection(self.launched_in.get(e.corr,
                                                                   ())):
                continue
            s, t = max(e.start, self.window[0]), min(e.end, self.window[1])
            if t > s:
                total += t - s
        return total / 1e9

    def range_spans(self, name: str) -> List[Event]:
        return [r for r in self.ranges if r.name == name
                and r.start >= self.window[0] and r.end <= self.window[1]]

    def top_device_ops(self, n: int = 10) -> List[List]:
        acc: Dict[str, float] = collections.defaultdict(float)
        for e in self.device:
            s, t = max(e.start, self.window[0]), min(e.end, self.window[1])
            if t > s:
                acc[e.name[:80]] += (t - s) / 1e9
        return [[k, v] for k, v in sorted(acc.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def top_idle_gaps(self, n: int = 10) -> List[List]:
        return [[k, v] for k, v in sorted(self.idle_by_range.items(),
                                          key=lambda kv: -kv[1])[:n]]


def _enclosing(ranges: List[Event], points: List[Tuple[int, int]]
               ) -> Dict[int, Tuple[Event, ...]]:
    """For (time, key) points on one thread, the ranges of that thread open
    at that time, outermost first (ranges on a thread nest)."""
    marks = sorted([(r.start, 0, i) for i, r in enumerate(ranges)]
                   + [(t, 1, k) for t, k in points])
    stack: List[Event] = []
    out: Dict[int, Tuple[Event, ...]] = {}
    for t, typ, ref in marks:
        while stack and stack[-1].end <= t:
            stack.pop()
        if typ == 0:
            stack.append(ranges[ref])
        else:
            out[ref] = tuple(r for r in stack if r.end > t)
    return out


def summarize(events: List[Event]) -> Optional[Summary]:
    """The window's records, or None when no ``bench:window`` range or no
    device operation was recorded."""
    windows = [e for e in events if e.kind == "range" and e.name == WINDOW]
    device = [e for e in events if e.kind in DEVICE_KINDS]
    if not windows or not device:
        return None
    window = (windows[0].start, windows[0].end)
    ranges = [e for e in events if e.kind == "range"]
    by_tid: Dict[int, List[Event]] = collections.defaultdict(list)
    for r in ranges:
        by_tid[r.tid].append(r)
    launch_points: Dict[int, List[Tuple[int, int]]] = collections.defaultdict(
        list)
    for e in events:
        if e.kind == "runtime":
            launch_points[e.tid].append((e.start, e.corr))
    launched_in: Dict[int, Tuple[str, ...]] = {}
    for tid, points in launch_points.items():
        for corr, open_ in _enclosing(by_tid.get(tid, []), points).items():
            launched_in[corr] = tuple(r.name for r in open_)
    gaps = stats.gaps([(e.start, e.end) for e in device], *window)
    threads = list(launch_points) or list(by_tid)
    open_at = [_enclosing(by_tid.get(tid, []),
                          [(g[0], i) for i, g in enumerate(gaps)])
               for tid in threads]
    idle: Dict[str, float] = collections.defaultdict(float)
    for i, (s, t) in enumerate(gaps):
        inner = [o[i][-1] for o in open_at if o.get(i)]
        name = max(inner, key=lambda r: r.start).name if inner \
            else "(no range)"
        idle[name] += (t - s) / 1e9
    return Summary(window, device, ranges, launched_in, dict(idle))


def describe(events: List[Event], summary: Optional[Summary]) -> str:
    """One line on what the trace held: records by kind, and the share of
    device operations whose launch was matched to host ranges."""
    kinds = collections.Counter(e.kind for e in events)
    text = "trace: " + ", ".join(f"{k} {v}" for k, v in sorted(kinds.items()))
    if summary is not None and summary.device:
        matched = sum(1 for e in summary.device
                      if e.corr in summary.launched_in)
        text += (f"; device operations matched to their launch "
                 f"{matched / len(summary.device):.4f}; window "
                 f"{summary.window_s:.4f} s, busy {summary.busy_s:.4f} s")
    return text
