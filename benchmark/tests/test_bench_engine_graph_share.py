"""The reader of ``engine_graph_share.survey`` on synthetic profiler
records: 100 where every forward replayed its graph, 50 where half did,
nothing without an ``engine:forward`` span or an ``engine:graph`` span."""

from types import SimpleNamespace

import pytest

from benchmark import trace
from benchmark.run import load_module
from benchmark.trace import Event

MS = 1_000_000
HOST = 1


def _read(events):
    ctx = SimpleNamespace(summary=trace.summarize(events),
                          win=SimpleNamespace(dispatches=[(0.0, 0.0, 4)] * 4))
    return load_module("metrics", "engine_graph_share.survey").read(ctx)


def _calls(graphed):
    """Four calls in a 100 ms window, each ``engine:forward`` holding an
    ``engine:graph`` where ``graphed`` says so, each launching a kernel;
    one more call before the window, replayed, is left out."""
    ev = [Event("range", "bench:window", 0, 100 * MS, HOST),
          Event("range", "engine:forward", -10 * MS, -8 * MS, HOST),
          Event("range", "engine:graph", -10 * MS + 1, -9 * MS, HOST)]
    for i, g in enumerate(graphed):
        t = 10 * MS + 20 * MS * i
        ev.append(Event("range", "engine:forward", t, t + 4 * MS, HOST))
        if g:
            ev.append(Event("range", "engine:graph", t + 1, t + 2 * MS, HOST))
        ev += [Event("runtime", "cudaGraphLaunch" if g else
                     "cudaLaunchKernel", t + 2, t + 3, HOST, i + 1),
               Event("kernel", "k", t + 5 * MS, t + 6 * MS, 0, i + 1)]
    return ev


@pytest.mark.parametrize("graphed, share", [
    ((True,) * 4, 100.0),
    ((True, False, True, False), 50.0),
])
def test_share_of_forwards_replayed(graphed, share):
    assert _read(_calls(graphed)) == pytest.approx(share)


def test_nothing_without_an_engine_forward_span():
    ev = [Event("range", "bench:window", 0, 100 * MS, HOST),
          Event("range", "det:network", 10 * MS, 20 * MS, HOST),
          Event("runtime", "cudaLaunchKernel", 11 * MS, 11 * MS + 1, HOST, 1),
          Event("kernel", "k", 12 * MS, 13 * MS, 0, 1)]
    assert _read(ev) is None


def test_nothing_from_a_program_without_the_graph_span():
    assert _read(_calls((False,) * 4)) is None


def test_nothing_without_a_trace():
    ctx = SimpleNamespace(summary=None, win=SimpleNamespace(dispatches=[]))
    assert load_module("metrics",
                       "engine_graph_share.survey").read(ctx) is None
