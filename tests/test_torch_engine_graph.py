"""``Engine.dispatch`` on the card replays the forward as one CUDA graph
(``export/engine.py::CapturedForward``); on the CPU it runs eagerly.

The CPU tests hold the eager path (no ``engine:graph`` span, no stale rows)
and the replay's bookkeeping with a stand-in for the graph: the static
input, the rows past ``n`` zeroed, a copy of the output a call, one
capture a number of rows, the spans. The ``cuda`` tests hold the replayed
``dispatch`` bit-equal to the eager forward for the bf16, fp32 and int8
Squeeze_ErNET engines, with 4 ACFF launches of the engine's precision
recorded at capture and none at replay.

Imports no JAX, so that the ``cuda`` tests run on the card with
``--noconftest``."""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rtdm_tpu_torch.export.engine import CapturedForward, Engine

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENGINES = ROOT / "artifacts" / "engines"
QUANTS = ("bf16", "fp32", "int8")


@pytest.fixture(autouse=True)
def two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _frames(n, seed, size=140):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3),
                                                dtype=np.uint8)


def _engine(quant, device, batch=None, with_softmax=False):
    """A Squeeze_ErNET engine of ``quant``: the committed directory, or
    for fp32 the bf16 directory's weights at fp32; logits unless
    ``with_softmax`` (on random frames the probabilities are one-hot)."""
    weights = "int8" if quant == "int8" else "bf16"
    loaded = Engine.load(str(ENGINES / f"squeeze-ernet_{weights}"),
                         device=device)
    spec = dataclasses.replace(loaded.spec, quant=quant,
                               batch_size=batch or loaded.spec.batch_size,
                               with_softmax=with_softmax)
    return Engine(spec, loaded.variables, loaded.act_scales, device=device)


def _eager(engine, frames):
    """The eager forward on ``frames`` zero-padded to the engine's batch."""
    b, s = engine.spec.batch_size, engine.spec.image_size
    x = torch.zeros((b, s, s, 3), dtype=torch.uint8, device=engine.device)
    x[:len(frames)] = torch.as_tensor(frames, device=engine.device)
    with torch.inference_mode():
        return engine._eager(x)


def _ranges(fn):
    """(fn's result, the names of the ``engine:*`` ranges it recorded, in
    start order, outer before inner)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    names = sorted(((e.time_range.start, -e.time_range.end, e.name)
                    for e in prof.events() if e.name.startswith("engine:")))
    return out, [n for _, _, n in names]


# the CPU: the eager path

def test_cpu_dispatch_opens_no_graph_span_and_runs_eagerly():
    engine = _engine("bf16", "cpu", batch=2)
    x = _frames(2, 1)
    out, names = _ranges(lambda: engine.dispatch(x))
    assert "engine:graph" not in names
    assert names == ["engine:upload", "engine:upload:wait", "engine:forward"]
    assert engine.graphs == {}
    assert torch.equal(out, _eager(engine, x))


def test_cpu_partial_batch_after_a_full_one_has_no_stale_rows():
    engine = _engine("bf16", "cpu", batch=3)
    engine.dispatch(_frames(3, 2))
    x = _frames(1, 3)
    got = engine.dispatch(x)
    fresh = _engine("bf16", "cpu", batch=3).dispatch(x)
    assert torch.equal(got, fresh)
    assert torch.equal(got, _eager(engine, x))


# the CPU: the replay's bookkeeping with a stand-in for the CUDA graph

class _StandInGraph:
    """Replays the eager forward on the static input into the static
    output, as the captured graph does on the card."""

    def __init__(self, engine, x, out):
        self.engine, self.x, self.out = engine, x, out
        self.replays = 0

    def replay(self):
        self.replays += 1
        self.out.copy_(self.engine._eager(self.x))


@pytest.fixture
def stand_in(monkeypatch):
    """Engines whose dispatch takes the card's path on the CPU, capturing a
    ``_StandInGraph``; yields the list of the inputs captured on."""
    captured = []

    def capture(self, x):
        captured.append(x)
        out = torch.empty((x.shape[0], self.spec.num_classes))
        return CapturedForward(_StandInGraph(self, x, out), x, out,
                               {"bf16": 4})

    def dispatch(self, images_u8):
        frames = torch.as_tensor(images_u8)
        with torch.inference_mode():
            return self._replay(frames, self.spec.batch_size)

    monkeypatch.setattr(Engine, "_capture", capture)
    monkeypatch.setattr(Engine, "dispatch", dispatch)
    return captured


def test_replay_keeps_one_static_input_and_zeroes_the_rows_past_n(stand_in):
    engine = _engine("bf16", "cpu", batch=3)
    full, part = _frames(3, 4), _frames(1, 5)
    assert torch.equal(engine.dispatch(full), _eager(engine, full))
    got = engine.dispatch(part)
    assert torch.equal(got, _eager(engine, part))
    assert len(stand_in) == 1 and len(engine.graphs) == 1
    (captured,) = engine.graphs.values()
    assert captured.x is stand_in[0]
    assert captured.graph.replays == 2
    assert not captured.x[1:].any()          # no stale rows of `full`


def test_two_batches_in_flight_keep_their_answers(stand_in):
    engine = _engine("bf16", "cpu", batch=2)
    a, b = _frames(2, 6), _frames(2, 7)
    out_a = engine.dispatch(a)
    out_b = engine.dispatch(b)
    assert out_a is not out_b
    assert torch.equal(out_a, _eager(engine, a))
    assert torch.equal(out_b, _eager(engine, b))
    assert not torch.equal(out_a, out_b)


def test_a_new_batch_size_captures_anew(stand_in):
    engine = _engine("bf16", "cpu", batch=2)
    engine.dispatch(_frames(2, 8))
    engine.spec.batch_size = 3
    x = _frames(3, 9)
    assert torch.equal(engine.dispatch(x), _eager(engine, x))
    assert sorted(k[0] for k in engine.graphs) == [2, 3]
    assert len(stand_in) == 2


def test_replay_spans(stand_in):
    engine = _engine("bf16", "cpu", batch=2)
    x = _frames(2, 10)
    engine.dispatch(x)
    _, names = _ranges(lambda: engine.dispatch(x))
    # the last is the stand-in's own eager forward, inside the replay
    assert names == ["engine:upload", "engine:upload:wait", "engine:forward",
                     "engine:graph", "engine:forward"]


# the card

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    from rtdm_tpu_torch.ops import kernels
    kernels.build("acff")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("with_softmax", [False, True])
@pytest.mark.parametrize("quant", QUANTS)
def test_cuda_replay_is_bit_equal_to_the_eager_forward(card, quant,
                                                      with_softmax):
    from rtdm_tpu_torch.ops.acff import LAUNCHES
    engine = _engine(quant, card, with_softmax=with_softmax)
    frames = _frames(256, 11)
    before = dict(LAUNCHES)
    for n in (256, 1, 100):
        got = engine.dispatch(frames[:n])
        want = _eager(engine, frames[:n])
        assert torch.equal(got, want), (quant, n,
                                        (got - want).abs().max().item())
    # one capture: 4 launches in the warm-up, 4 recorded into the graph;
    # none from the replays; the eager forwards above launch 4 each
    (captured,) = engine.graphs.values()
    assert captured.launches == {k: 4 if k == quant else 0 for k in LAUNCHES}
    made = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
    assert made == {k: 8 + 3 * 4 if k == quant else 0 for k in LAUNCHES}
    before = dict(LAUNCHES)
    engine.dispatch(frames)
    torch.cuda.synchronize()
    assert LAUNCHES == before


@pytest.mark.cuda
def test_cuda_two_batches_in_flight_keep_their_answers(card):
    engine = _engine("bf16", card)
    a, b = _frames(256, 12), _frames(256, 13)
    engine.dispatch(a)                       # captures
    out_a = engine.dispatch(a)
    out_b = engine.dispatch(b)
    assert torch.equal(out_a, _eager(engine, a))
    assert torch.equal(out_b, _eager(engine, b))
    assert not torch.equal(out_a, out_b)


@pytest.mark.cuda
def test_cuda_partial_batch_after_a_full_one_equals_a_fresh_engine(card):
    engine = _engine("bf16", card)
    engine.dispatch(_frames(256, 14))
    x = _frames(100, 15)
    got = engine.dispatch(x)
    fresh = _engine("bf16", card).dispatch(x)
    assert torch.equal(got, fresh)
    assert not engine.graphs[(256, card)].x[100:].any()


@pytest.mark.cuda
def test_cuda_replayed_kernels_are_traced_under_the_graph_launch(card):
    """A forward captured before the profiler starts (as a benchmark's
    warm-up captures it), replayed under ``torch.profiler``: its kernels
    appear by name, the ACFF kernel among them, each with the correlation
    id of the ``cudaGraphLaunch`` that replayed it, which ran inside the
    ``engine:graph`` span."""
    engine = _engine("bf16", card)
    x = torch.from_numpy(_frames(256, 16)).pin_memory()
    engine.dispatch(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.dispatch(x)
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    ranges = {e.name() for e in events if e.name().startswith("engine:")}
    launch = [e for e in events if e.name().startswith("cudaGraphLaunch")]
    on_card = [e for e in events if "CPU" not in str(e.device_type())
               and e.name() not in ranges]
    assert len(launch) == 1, [e.name() for e in launch]
    replayed = [e for e in on_card
                if e.correlation_id() == launch[0].correlation_id()]
    names = [e.name() for e in replayed]
    print(f"{len(replayed)} device operations under cudaGraphLaunch "
          f"(correlation id {launch[0].correlation_id()}): {names}")
    assert sum("acff_bf16_kernel" in n for n in names) == 4, names
    graph = [e for e in events if e.name() == "engine:graph"
             and "CPU" in str(e.device_type())]
    assert len(graph) == 1
    assert graph[0].start_ns() <= launch[0].start_ns() <= \
        launch[0].start_ns() + launch[0].duration_ns() <= \
        graph[0].start_ns() + graph[0].duration_ns()
