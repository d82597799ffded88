"""The readers of the program's own spans (``engine_enqueue_ms``,
``host_wait_ms``, ``host_syncs_per_call``, ``launches_per_call``) on
synthetic profiler records."""

from types import SimpleNamespace

import pytest

from benchmark import trace
from benchmark.run import load_module
from benchmark.trace import Event

MS = 1_000_000
HOST = 1


def _read(name, events, calls=2):
    s = trace.summarize(events)
    ctx = SimpleNamespace(summary=s, win=SimpleNamespace(
        dispatches=[(0.0, 0.0, 4)] * calls))
    return load_module("metrics", name + ".survey").read(ctx)


def _classifier():
    """Two calls in a 100 ms window, each ``engine:upload`` (holding its
    ``engine:upload:wait``) then ``engine:forward``; a third call's spans
    start before the window and are left out."""
    ev = [Event("range", "bench:window", 0, 100 * MS, HOST),
          Event("range", "engine:upload", -20 * MS, -15 * MS, HOST),
          Event("range", "engine:upload:wait", -19 * MS, -16 * MS, HOST),
          Event("kernel", "early", -18 * MS, -17 * MS, 0, 90)]
    for i, t in enumerate((10 * MS, 50 * MS)):
        ev += [Event("range", "bench:dispatch", t, t + 30 * MS, HOST),
               Event("range", "engine:upload", t, t + 10 * MS, HOST),
               Event("range", "engine:upload:wait", t + 2 * MS, t + 9 * MS,
                     HOST),
               Event("runtime", "cudaMemcpyAsync", t + 3 * MS, t + 3 * MS + 5,
                     HOST, 10 * i + 1),
               Event("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)",
                     t + 3 * MS, t + 8 * MS, 0, 10 * i + 1),
               Event("range", "engine:forward", t + 10 * MS, t + 14 * MS,
                     HOST)]
        for k in range(3):                 # three kernels a forward
            c = 10 * i + 2 + k
            ev += [Event("runtime", "cudaLaunchKernel", t + 11 * MS + k,
                         t + 11 * MS + k + 1, HOST, c),
                   Event("kernel", f"k{k}", t + 15 * MS + k * MS,
                         t + 15 * MS + (k + 1) * MS, 0, c)]
        # a launch from the harness, outside any program range
        ev += [Event("runtime", "cudaLaunchKernel", t + 20 * MS,
                     t + 20 * MS + 1, HOST, 10 * i + 9),
               Event("kernel", "harness", t + 21 * MS, t + 22 * MS, 0,
                     10 * i + 9)]
    return ev


def test_classifier_spans_per_call():
    ev = _classifier()
    assert _read("engine_enqueue_ms", ev) == pytest.approx(4.0)
    assert _read("host_wait_ms", ev) == pytest.approx(7.0)
    assert _read("host_syncs_per_call", ev) == pytest.approx(1.0)
    # the copy and three kernels a call; not the harness's, not the early
    assert _read("launches_per_call", ev) == pytest.approx(4.0)


def test_nested_ranges_count_a_launch_once():
    ev = [Event("range", "bench:window", 0, 100 * MS, HOST),
          Event("range", "det:network", 10 * MS, 40 * MS, HOST),
          Event("range", "qdq", 12 * MS, 14 * MS, HOST),
          Event("runtime", "cudaLaunchKernel", 13 * MS, 13 * MS + 1, HOST, 7),
          Event("kernel", "round", 20 * MS, 21 * MS, 0, 7),
          Event("range", "det:nms", 50 * MS, 80 * MS, HOST),
          Event("range", "det:nms:wait", 60 * MS, 70 * MS, HOST),
          Event("range", "det:nms:wait", 72 * MS, 75 * MS, HOST)]
    assert _read("launches_per_call", ev, calls=1) == pytest.approx(1.0)
    assert _read("host_syncs_per_call", ev, calls=1) == pytest.approx(2.0)
    assert _read("host_wait_ms", ev, calls=1) == pytest.approx(13.0)
    assert _read("engine_enqueue_ms", ev, calls=1) is None


def test_no_program_range_reads_nothing_and_no_wait_reads_zero():
    bare = [e for e in _classifier()
            if not e.name.startswith("engine:")]
    for name in ("engine_enqueue_ms", "host_wait_ms", "host_syncs_per_call",
                 "launches_per_call"):
        assert _read(name, bare) is None
    no_wait = [e for e in _classifier() if not e.name.endswith(":wait")]
    assert _read("host_syncs_per_call", no_wait) == 0.0
    assert _read("host_wait_ms", no_wait) == 0.0
    assert _read("engine_enqueue_ms", no_wait) == pytest.approx(4.0)


def test_no_trace_or_no_dispatch_reads_nothing():
    ctx = SimpleNamespace(summary=None, win=SimpleNamespace(
        dispatches=[(0.0, 0.0, 4)]))
    for name in ("engine_enqueue_ms", "host_wait_ms", "host_syncs_per_call",
                 "launches_per_call"):
        assert load_module("metrics", name + ".survey").read(ctx) is None
        assert _read(name, _classifier(), calls=0) is None
