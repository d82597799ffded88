"""The YOLOv5s cell on the CPU at a small batch: its plain reference against
the port on the committed engine, a sound run that comes out correct, and
runs with faults planted underneath that come out not correct (half of a
batch left out, a class flipped, one row of every batch answering boxes
the frame does not hold, which only ``unmatched_slot_max`` catches); the
configuration's control failing the limits; the two readers of the
``det:v5:*`` spans on synthetic profiler records."""

import os

import numpy as np
import pytest
import torch

from benchmark import frames, loops
from benchmark.run import ROOT, load_json, load_module
from helpers import run_cell

CELL = "yolov5s-int8.survey"
SMALL = {"batch": 8, "pool_batches": 2}
# one row of 32 holds a 32nd of the answers
WIDE = {"batch": 32, "pool_batches": 2}


@pytest.fixture(autouse=True)
def few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _config():
    return load_json(ROOT, "benchmark", "configs", "yolov5s-416-int8.json")


def test_v5_reference_against_the_port():
    from rtdm_tpu_torch.export.detector import load_detector
    cfg = _config()
    ref = load_module("reference", "yolov5_int8")
    state = ref.load(cfg, ROOT, "cpu")
    assert ref.flops_per_frame(cfg, state) == 6_881_225_728
    pool = frames.make_pool(ROOT, 11, 16, 416, "letterbox")
    want = ref.forward(state, pool, "cpu")
    assert sum(len(w) for w in want) >= 8          # frames with victims
    det = load_detector(os.path.join(ROOT, cfg["engine"]), device="cpu",
                        batch_size=16)
    boxes, counts = det(pool)
    got = [boxes[i, :c] for i, c in enumerate(counts)]
    check = load_module("checks", "detections_slots")
    numbers = check.compare(got, np.arange(16), np.arange(16), want)
    # each frame sits in a row of its own here, so a row's share is one
    # frame's: the shares over all answers are what the cell's limits hold
    for key in ("unmatched_share", "conf_gap"):
        assert numbers[key] <= cfg["limits"][key], (key, numbers)
    # the same detections, row for row, where both found the same count
    for g, w in zip(got, want):
        if len(g) == len(w) and len(g):
            np.testing.assert_allclose(g[:, :4], w[:, :4], atol=8.0)
            assert (g[:, 5] == w[:, 5]).all()


def test_v5_control_fails_the_limits():
    """The configuration's control (the reference in the precision below
    int8) in the program's place fails the limits; the reference itself
    passes them."""
    cfg = _config()
    ref = load_module("reference", cfg["reference"])
    check = load_module("checks", cfg["check"])
    state = ref.load(cfg, ROOT, "cpu")
    pool = frames.make_pool(ROOT, 2001, 16, 416, "letterbox")
    want = ref.forward(state, pool, "cpu")
    low = ref.forward(state, pool, "cpu", precision=cfg["control_precision"])
    ids, slots = loops.cycle(8, 16)
    limits = cfg["limits"]
    numbers = check.compare([low[i] for i in ids], ids, slots, want)
    assert any(numbers[k] > limits[k] for k in limits), numbers
    same = check.compare([want[i] for i in ids], ids, slots, want)
    assert all(same[k] <= limits[k] for k in limits), same


def test_slot_max_is_the_worst_row():
    check = load_module("checks", "detections_slots")
    box = np.array([[10, 10, 50, 50, 0.9, 0]], np.float32)
    other = np.array([[200, 200, 250, 250, 0.8, 1]], np.float32)
    reference = [box, box]
    # frame 0 in rows 0 and 1, frame 1 in rows 0 and 1; row 1 of frame 1
    # answers a box that is not there
    answers = [box, box, box, np.concatenate([box, other])]
    numbers = check.compare(answers, [0, 0, 1, 1], [0, 1, 0, 1], reference)
    assert numbers["unmatched_slot_max"] == pytest.approx(1 / 5)
    assert numbers["unmatched_share"] == pytest.approx(1 / 9)
    assert numbers["missing"] == 0


def _half_batch(system):
    full = system.dispatch

    def dispatch(batch):
        return full(batch[:len(batch) // 2])
    system.dispatch = dispatch


def _class_flipped(system):
    fetch = system.fetch

    def flipped(handle):
        det, count = fetch(handle)
        det = det.copy()
        det[..., 5] = 1.0 - det[..., 5]
        return det, count
    system.fetch = flipped


def _last_row_altered(system):
    """The last row of every batch answers its boxes 200 px off and one
    box more that the frame does not hold, as a fault at a tile's edge
    would; the rest of the batch is sound."""
    fetch = system.fetch

    def altered(handle):
        det, count = fetch(handle)
        det = np.concatenate([det, np.zeros_like(det[:, :1])], 1)
        count = count.copy()
        det[-1, :count[-1], :4] += 200.0
        det[-1, count[-1]] = [4.0, 4.0, 40.0, 40.0, 0.9, 0.0]
        count[-1] += 1
        return det, count
    system.fetch = altered


def test_sound_run_is_correct(capsys):
    rc, result = run_cell(capsys, CELL, seconds=2, **SMALL)
    assert rc == 0 and result["correct"], result
    assert result["failed"] == 0 < result["attempted"]
    assert set(result["checks"]) == {"unmatched_share", "conf_gap",
                                     "unmatched_slot_max", "missing"}


@pytest.mark.parametrize("fault", [_half_batch, _class_flipped])
def test_faults_are_caught(capsys, fault):
    rc, result = run_cell(capsys, CELL, seconds=2, patch=fault, **SMALL)
    assert rc == 0 and not result["correct"]
    assert any(v["value"] > v["limit"] for v in result["checks"].values())


def test_one_row_of_every_batch_altered_is_caught_by_its_row(capsys):
    rc, result = run_cell(capsys, CELL, seconds=2, patch=_last_row_altered,
                          **WIDE)
    assert rc == 0 and not result["correct"]
    checks = result["checks"]
    assert checks["unmatched_slot_max"]["value"] > \
        checks["unmatched_slot_max"]["limit"]
    assert checks["unmatched_share"]["value"] <= \
        checks["unmatched_share"]["limit"]


MS = 1_000_000


def _v5_trace(with_v5_spans=True):
    """Two detector calls in a 100 ms window: under ``det:network`` a C3
    whose conv (2 ms) is followed by a QDQ (1 ms) and an epilogue (0.5
    ms), then a QDQ'd head conv (3 ms); decode outside the network."""
    from benchmark.trace import Event
    ev = [Event("range", "bench:window", 0, 100 * MS, 1)]
    for i, t in enumerate((10 * MS, 50 * MS)):
        c = 10 * i
        ev += [Event("range", "det:network", t, t + 20 * MS, 1),
               Event("range", "qdq", t + 1 * MS, t + 2 * MS, 1),
               Event("range", "qdq", t + 6 * MS, t + 7 * MS, 1)]
        if with_v5_spans:
            ev += [Event("range", "det:v5:c3", t, t + 5 * MS, 1),
                   Event("range", "det:v5:epilogue", t + 3 * MS, t + 4 * MS,
                         1),
                   Event("range", "det:v5:head", t + 5 * MS, t + 10 * MS, 1)]
        ev += [Event("range", "det:decode", t + 20 * MS, t + 25 * MS, 1)]
        for k, (at, ms) in enumerate(((t + 1.5 * MS, 1.0),      # qdq
                                      (t + 2.5 * MS, 2.0),      # conv
                                      (t + 3.5 * MS, 0.5),      # epilogue
                                      (t + 6.5 * MS, 1.0),      # head qdq
                                      (t + 8 * MS, 3.0),        # head conv
                                      (t + 22 * MS, 4.0))):     # decode
            ev += [Event("runtime", "cudaLaunchKernel", int(at),
                         int(at) + 1, 1, c + k),
                   Event("kernel", f"k{k}", int(at) + 2,
                         int(at + ms * MS) + 2, 0, c + k)]
    return ev


def test_v5_readers_on_synthetic_records():
    from types import SimpleNamespace

    from benchmark import trace

    def read(name, events):
        ctx = SimpleNamespace(summary=trace.summarize(events),
                              win=SimpleNamespace(dispatches=[(0, 0, 64)] * 2))
        return load_module("metrics", name).read(ctx)
    ev = _v5_trace()
    assert read("v5_c3_ms.survey", ev) == pytest.approx(3.5)
    # the C3's QDQ and epilogue and the head's QDQ, not its conv
    assert read("v5_epilogue_ms.survey", ev) == pytest.approx(2.5)
    # a program without the v5 spans (the parent's) reads nothing
    bare = _v5_trace(with_v5_spans=False)
    assert read("v5_c3_ms.survey", bare) is None
    assert read("v5_epilogue_ms.survey", bare) is None
