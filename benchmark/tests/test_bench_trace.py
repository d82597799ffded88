"""The device's busy and idle share, and what the host did meanwhile, from
synthetic profiler records."""

import pytest

from benchmark import trace
from benchmark.trace import Event

MS = 1_000_000


def _events():
    host, side = 1, 2
    return [
        Event("range", "bench:window", 0, 100 * MS, host),
        Event("range", "bench:dispatch", 0, 30 * MS, host),
        Event("range", "det:network", 5 * MS, 25 * MS, host),
        Event("runtime", "cudaLaunchKernel", 6 * MS, 6 * MS + 5, host, 11),
        Event("runtime", "cudaMemcpyAsync", 1 * MS, 1 * MS + 5, host, 10),
        Event("range", "bench:resolve", 40 * MS, 90 * MS, host),
        Event("runtime", "cudaLaunchKernel", 50 * MS, 50 * MS + 5, host, 12),
        Event("range", "side:sleep", 0, 100 * MS, side),
        Event("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 2 * MS,
              12 * MS, 0, 10),
        Event("kernel", "acff_bf16_kernel<32, 0>", 10 * MS, 30 * MS, 0, 11),
        Event("kernel", "max_pool", 60 * MS, 70 * MS, 0, 12),
        Event("kernel", "before_window", -10 * MS, -5 * MS, 0, 13),
    ]


def test_busy_idle_and_window():
    s = trace.summarize(_events())
    assert s.window_s == pytest.approx(0.1)
    # device covers [2, 30) and [60, 70): 38 ms of 100
    assert s.busy_s == pytest.approx(0.038)
    idle = load_idle(s)
    assert idle == pytest.approx(62.0)


def load_idle(s):
    from benchmark.run import load_module
    ctx = type("Ctx", (), {"summary": s})
    return load_module("metrics", "device_idle_pct.survey").read(ctx)


def test_device_time_by_name_and_by_launching_range():
    s = trace.summarize(_events())
    assert s.device_s(lambda e: "acff" in e.name) == pytest.approx(0.020)
    assert s.device_s(ranges=("det:network",)) == pytest.approx(0.020)
    assert s.device_s(ranges=("bench:resolve",)) == pytest.approx(0.010)
    assert s.device_s(lambda e: e.kind == "gpu_memcpy"
                      and "HtoD" in e.name) == pytest.approx(0.010)
    assert s.launched_in[11] == ("bench:window", "bench:dispatch",
                                 "det:network")


def test_idle_gaps_go_to_the_innermost_range_of_a_launching_thread():
    s = trace.summarize(_events())
    gaps = dict(s.top_idle_gaps())
    # [0, 2) dispatch; [30, 60) window (dispatch ended at 30, resolve
    # opens at 40 but the gap began at 30); [70, 100) resolve until 90
    assert gaps["bench:dispatch"] == pytest.approx(0.002)
    assert gaps["bench:window"] == pytest.approx(0.030)
    assert gaps["bench:resolve"] == pytest.approx(0.030)
    assert "side:sleep" not in gaps           # that thread launched nothing
    ops = dict(s.top_device_ops())
    assert ops["acff_bf16_kernel<32, 0>"] == pytest.approx(0.020)
    assert "before_window" not in ops


def test_no_window_or_no_device_work_reads_nothing():
    assert trace.summarize([e for e in _events()
                            if e.name != "bench:window"]) is None
    assert trace.summarize([e for e in _events()
                            if e.kind not in trace.DEVICE_KINDS]) is None


class _Raw:
    """A profiler event of a torch without ``activity_type``."""

    def __init__(self, name, device, annotation=False, corr=0):
        self._n, self._d, self._a, self._c = name, device, annotation, corr

    def name(self):
        return self._n

    def device_type(self):
        return f"DeviceType.{self._d}"

    def is_user_annotation(self):
        return self._a

    def start_ns(self):
        return 0

    def duration_ns(self):
        return 10

    def start_thread_id(self):
        return 1

    def correlation_id(self):
        return self._c


def test_raw_events_are_sorted_into_kinds_without_activity_type():
    raw = [_Raw("bench:window", "CPU", True), _Raw("bench:window", "CUDA"),
           _Raw("cudaLaunchKernel", "CPU", corr=3),
           _Raw("aten::add", "CPU"), _Raw("Memcpy HtoD (Pageable -> Device)",
                                          "CUDA"),
           _Raw("Memset (Device)", "CUDA"), _Raw("some_kernel", "CUDA")]
    prof = type("P", (), {"profiler": type("K", (), {
        "kineto_results": type("R", (), {"events": lambda self: raw})()})()})
    kinds = [(e.kind, e.name) for e in trace.from_profiler(prof)]
    assert ("range", "bench:window") in kinds
    assert ("runtime", "cudaLaunchKernel") in kinds
    assert ("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)") in kinds
    assert ("gpu_memset", "Memset (Device)") in kinds
    assert ("kernel", "some_kernel") in kinds
    # the device-side copy of a host range is no device work
    assert ("kernel", "bench:window") not in kinds
    assert all(n != "aten::add" for _, n in kinds)
