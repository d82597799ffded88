"""The port's spans (``utils/profiler.py::span``): a no-op with no profiler
running, the ranges ``record_function`` records under one, and the
``engine:*`` and ``det:*`` spans of a classifier and a detector call, with
a ``:wait`` span at each point where the call blocks the host on the
device. The ``cuda`` test holds the ``:wait`` spans of a call on the card
to the syncs that ``torch.cuda.set_sync_debug_mode`` reports for it.

Imports no JAX, so that the ``cuda`` test runs on the card with
``--noconftest``."""

import pathlib
import threading
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from rtdm_tpu_torch.utils.profiler import span

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENGINES = ROOT / "artifacts" / "engines"
CLASSIFIER = ENGINES / "squeeze-ernet_bf16"
DETECTOR = ENGINES / "yolov4-tiny-mini_int8"
GOLDEN_DET = ROOT / "tests" / "goldens" / "torch_port" / "detector_int8.npz"


@pytest.fixture(autouse=True)
def two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _detector_frames(n):
    with np.load(GOLDEN_DET) as g:
        x = g["frames_416"]
    return np.resize(x, (n,) + x.shape[1:])


def _classifier_frames(n, size=140):
    return np.random.default_rng(5).integers(0, 256, (n, size, size, 3),
                                             dtype=np.uint8)


def _recorded(fn):
    """(fn's result, the program's ranges it recorded: (name, start, end)
    in start order) under a CPU profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    ranges = sorted(((e.name, e.time_range.start, e.time_range.end)
                     for e in prof.events()
                     if e.name.startswith(("engine:", "det:"))
                     or e.name == "qdq"), key=lambda r: (r[1], -r[2]))
    return out, ranges


def _waits(ranges):
    return [r for r in ranges if r[0].endswith(":wait")]


def test_span_is_one_shared_no_op_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    a, b = span("engine:forward"), span("det:nms:wait")
    assert a is b
    assert not isinstance(a, record_function)
    with a:
        pass
    with b:                       # reusable
        pass


def test_span_records_what_record_function_records_on_each_thread():
    def body(tag):
        with span(f"{tag}:span"):
            torch.ones(2).add_(1)
        with record_function(f"{tag}:rf"):
            torch.ones(2).add_(1)

    worker = threading.Thread(target=body, args=("worker",))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert torch.autograd._profiler_enabled()
        body("main")
        worker.start()
        worker.join(timeout=60)
    assert not worker.is_alive()
    names = {e.name for e in prof.events()}
    assert "main:span" in names and "main:rf" in names
    assert ("worker:span" in names) == ("worker:rf" in names)


def test_engine_dispatch_spans():
    from rtdm_tpu_torch.export.engine import Engine
    engine = Engine.load(str(CLASSIFIER), device="cpu")
    engine.spec.batch_size = 2
    x = _classifier_frames(2)
    want = engine(x)
    _, ranges = _recorded(lambda: engine.dispatch(x))
    assert [r[0] for r in ranges] == ["engine:upload", "engine:upload:wait",
                                      "engine:forward"]
    up, wait, fwd = ranges
    assert up[1] <= wait[1] and wait[2] <= up[2]
    assert up[2] <= fwd[1]
    got, ranges = _recorded(lambda: engine(x))
    np.testing.assert_array_equal(got, want)
    assert [r[0] for r in _waits(ranges)] == ["engine:upload:wait",
                                              "engine:download:wait"]


def test_detector_submit_waits_and_no_unread_ranges():
    from rtdm_tpu_torch.export.detector import load_detector
    det = load_detector(str(DETECTOR), device="cpu", batch_size=2)
    x = _detector_frames(2)
    want = det(x)
    (_, count, _), ranges = _recorded(lambda: det.submit(x))
    names = [r[0] for r in ranges]
    steps = det.stats["greedy_steps"]
    assert len(det.heads) == 3 and steps >= 1 and int(count.sum()) > 0
    assert len(_waits(ranges)) == 1 + 2 * len(det.heads) + steps
    assert names.count("det:upload:wait") == 1
    assert names.count("det:decode:wait") == 2 * len(det.heads)
    assert names.count("det:nms:wait") == steps
    for gone in ("det:nms:topk", "det:nms:fixpoint", "det:download"):
        assert gone not in names
    assert {"det:upload", "det:normalize", "det:network", "det:decode",
            "det:nms", "qdq"} <= set(names)
    # each wait lies inside the stage it blocks
    for wait, stage in (("det:upload:wait", "det:upload"),
                        ("det:decode:wait", "det:decode"),
                        ("det:nms:wait", "det:nms")):
        outer = [r for r in ranges if r[0] == stage]
        for w in (r for r in ranges if r[0] == wait):
            assert any(o[1] <= w[1] and w[2] <= o[2] for o in outer), wait
    got, ranges = _recorded(lambda: det(x))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert [r[0] for r in _waits(ranges)].count("det:download:wait") == 2


def test_classes_mask_copy_is_a_wait():
    from rtdm_tpu_torch.ops.nms import batched_nms
    pred = torch.zeros(1, 4, 7)
    pred[0, :, :4] = torch.tensor([[50.0, 50.0, 20.0, 20.0]] * 4)
    pred[0, :, 4] = 0.9
    pred[0, :, 5] = 1.0
    stats = {}
    _, ranges = _recorded(lambda: batched_nms(pred, classes=[0],
                                              stats=stats))
    assert [r[0] for r in ranges].count("det:nms:wait") == \
        1 + stats["greedy_steps"]


def _synced(call):
    """The syncs ``call`` makes on the card, as sync-debug warnings."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            call()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return [str(w.message) for w in caught
            if "called a synchronizing CUDA operation" in str(w.message)]


@pytest.mark.cuda
def test_cuda_waits_are_the_calls_syncs():
    """On the card: one ``Engine.dispatch`` (squeeze-ernet bf16, batch 256)
    and one ``Detector.submit`` (yolov4-tiny int8, batch 64) each raise as
    many sync warnings as the ``:wait`` spans a profiled run of the same
    call records: 1 and 1 + 2 x 3 heads + the NMS steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    from rtdm_tpu_torch.export.detector import load_detector
    from rtdm_tpu_torch.export.engine import Engine
    from rtdm_tpu_torch.ops import kernels
    kernels.build("acff")
    engine = Engine.load(str(CLASSIFIER), device="cuda")
    x = torch.from_numpy(_classifier_frames(256)).pin_memory()
    det = load_detector(str(DETECTOR), device="cuda", batch_size=64)
    frames = _detector_frames(64)
    for call, expect in ((lambda: engine.dispatch(x), lambda: 1),
                         (lambda: det.submit(frames),
                          lambda: 1 + 2 * len(det.heads)
                          + det.stats["greedy_steps"])):
        for _ in range(2):
            call()
        torch.cuda.synchronize()
        syncs = _synced(call)
        torch.cuda.synchronize()
        _, ranges = _recorded(call)
        torch.cuda.synchronize()
        print(f"syncs {len(syncs)}, waits {len(_waits(ranges))}: "
              f"{[r[0] for r in _waits(ranges)]}")
        assert len(syncs) == len(_waits(ranges)) == expect(), syncs
