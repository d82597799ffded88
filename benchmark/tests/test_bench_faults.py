"""A run with its timed path broken underneath comes out not correct: the
harness's look for a chip is skipped (the CPU, small sizes) and the rest of
the run is driven as on the card. One test for each fault these cells can
have: half of a batch left out, an answer altered where it is produced (a
row handed to the wrong frame, one row of every batch changed, a
detection's class changed). A step that returns its state unchanged, and a
missing exchange between chips, have no place here: no cell trains or
spans chips."""

import numpy as np
import pytest
import torch

from helpers import run_cell

CLS = {"batch": 8, "pool_batches": 2}
DET = {"batch": 5, "pool_batches": 2}


@pytest.fixture(autouse=True)
def few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _half_batch(system):
    full = system.dispatch

    def dispatch(frames):
        return full(frames[:len(frames) // 2])
    system.dispatch = dispatch


def _rows_to_wrong_frames(system):
    fetch = system.fetch
    system.fetch = lambda handle: np.roll(fetch(handle), 1, axis=0)


def _last_row_altered(system):
    """The last row of every batch answers with its classes rotated, as a
    fault at a tile's edge would: the rest of the batch is sound."""
    fetch = system.fetch

    def altered(handle):
        rows = fetch(handle).copy()
        rows[-1] = np.roll(rows[-1], 1)
        return rows
    system.fetch = altered


@pytest.mark.parametrize("workload,kw", [("sqernet-bf16.pinned-survey", CLS),
                                         ("yolov4tiny-int8.survey", DET)])
def test_sound_runs_are_correct(capsys, workload, kw):
    rc, result = run_cell(capsys, workload, seconds=2, **kw)
    assert rc == 0 and result["correct"], (workload, result)
    assert result["failed"] == 0 < result["attempted"]
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("fault", [_half_batch, _rows_to_wrong_frames])
def test_classifier_faults_are_caught(capsys, fault):
    rc, result = run_cell(capsys, "sqernet-bf16.pinned-survey", patch=fault,
                          **CLS)
    assert rc == 0 and not result["correct"]
    checks = result["checks"]["prob_l1_mean"]
    assert checks["value"] > checks["limit"]


def test_one_row_of_every_batch_altered_is_caught(capsys):
    """At the engine's own batch of 256 one row moves the mean over all
    answers by a 256th of its gap; the mean of that row does not hide it."""
    rc, result = run_cell(capsys, "sqernet-bf16.pinned-survey",
                          patch=_last_row_altered, **CLS)
    assert rc == 0 and not result["correct"]
    slot = result["checks"]["prob_l1_slot_max"]
    assert slot["value"] > slot["limit"]


def _class_flipped(system):
    fetch = system.fetch

    def flipped(handle):
        det, count = fetch(handle)
        det = det.copy()
        det[..., 5] = 1.0 - det[..., 5]
        return det, count
    system.fetch = flipped


@pytest.mark.parametrize("fault", [_half_batch, _class_flipped])
def test_detector_faults_are_caught(capsys, fault):
    rc, result = run_cell(capsys, "yolov4tiny-int8.survey", seconds=2,
                          patch=fault, **DET)
    assert rc == 0 and not result["correct"]
    numbers = result["checks"]
    assert any(v["value"] > v["limit"] for v in numbers.values())
