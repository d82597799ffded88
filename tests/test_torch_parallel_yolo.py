"""The port's data-parallel detector training against one process.

A gloo group of 2 CPU processes (``tests/torch_parallel_jobs.py``
``job_yolo``) and the port in one process here, on the detector train
golden's first 8 frames at 416 (8 rows divide over 2 ranks and JAX's 8
devices alike), from the committed detectors' dequantized weights, two
steps (``tests/test_torch_parallel_yolo_jax.py`` holds the same step
against JAX's 8-way step):

- case a: yolov5s-mini, v5 loss (the global batch's size), SGD, EMA;
  case b: yolov4-tiny-mini, v3 loss, two microbatches, BN burn-in.
  The data-parallel step (``cli/yolo_train.py::make_train_step`` with a
  mesh) holds ``chip_smoke.YOLO_GATES`` of its case against the
  one-process step.
- A control that must miss: each rank's loss is the one-process loss of
  its own rows, divided by the ranks (the mean of per-rank losses); the
  masked means' denominators and v5's batch size are then each rank's.
- ``yolo_train --sync-bn`` in the 2-rank group equals the one-process run
  (the losses of its epoch, the mAP and the weights it writes).
- ``yolo_train --batch-size 8`` with the default nominal batch (64) in the
  2-rank group: the one-device count, 8, would leave microbatches of one
  row; the ranks take 4 microbatches of 2 rows, and equal the one-process
  run with ``--accumulate 4``.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from tests import torch_parallel_jobs as J

CASE_GATES = {"a": chip_smoke.YOLO_GATES["a"],
              "b": chip_smoke.YOLO_GATES["b"]}


@pytest.fixture(autouse=True)
def two_threads(monkeypatch):
    monkeypatch.setenv("RTDM_XLA_CACHE", "0")
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from rtdm_tpu_torch.cli import yolo_train
    from rtdm_tpu_torch.data.example_set import (write_engine_as_cfg,
                                                 write_example_set)
    work = tmp_path_factory.mktemp("parallel_yolo")
    torch.set_num_threads(2)
    cfg, weights = write_engine_as_cfg(J.ENGINES / "yolov4-tiny-mini_int8",
                                       work / "cfg")
    data = write_example_set(work / "examples")
    group = J.start_group("yolo", 2, work / "w2", control=True,
                          cli=[cfg, weights, data])
    ref = {"one": J.yolo_dp_runs(None, work / "one")}
    cli = yolo_train.train(yolo_train.parse_args(J.yolo_argv(
        cfg, weights, data, work / "cli_one")))
    ref["cli"] = {"history_loss": np.array([h["loss"]
                                            for h in cli["history"]]),
                  "last_loss": np.array(cli["last_loss"]),
                  "map50": cli["last_eval"]["map50"],
                  "dir": work / "cli_one"}
    ref["accumulate"] = J.yolo_accumulate_run(
        cfg, weights, data, work / "accumulate_one", "--accumulate", "4")
    return group.results(), ref, work


@pytest.mark.parametrize("case", sorted(CASE_GATES))
def test_step_equals_one_process(runs, case):
    ranks, ref, _ = runs
    for res in ranks:
        gap = chip_smoke.yolo_gaps(ref["one"][case],
                                   chip_smoke.unflat_yolo_run(res, f"{case}/"))
        print(f"case {case} against one process: " + chip_smoke._fmt(gap))
        assert all(g <= t for g, t in zip(gap, CASE_GATES[case])), \
            (case, gap, CASE_GATES[case])


def test_ranks_hold_one_state(runs):
    ranks, _, _ = runs
    for k, v in ranks[0].items():
        np.testing.assert_array_equal(ranks[1][k], v, err_msg=k)


def test_mean_of_rank_losses_misses(runs):
    ranks, ref, _ = runs
    gap = chip_smoke.yolo_gaps(
        ref["one"]["a"], chip_smoke.unflat_yolo_run(ranks[0], "control_a/"))
    print("mean of per-rank losses against one process: "
          + chip_smoke._fmt(gap))
    assert not all(g <= t for g, t in zip(gap, CASE_GATES["a"])), gap


def test_yolo_train_sync_bn_in_a_group_of_two(runs):
    from rtdm_tpu_torch.models.io import flatten_tree, load_variables
    ranks, ref, work = runs
    res = ranks[0]
    np.testing.assert_allclose(res["cli/history_loss"],
                               ref["cli"]["history_loss"], rtol=1e-4)
    np.testing.assert_allclose(res["cli/last_loss"], ref["cli"]["last_loss"],
                               rtol=1e-4)
    assert abs(float(res["cli/map50"]) - ref["cli"]["map50"]) <= 1e-6
    for name in ("last.npz", "best.npz"):
        got = flatten_tree(load_variables(str(work / "w2" / "cli" / name)))
        want = flatten_tree(load_variables(str(ref["cli"]["dir"] / name)))
        assert set(got) == set(want)
        for k in want:
            assert np.abs(got[k] - want[k]).max() <= \
                2e-5 + 2e-4 * np.abs(want[k]).max(), (name, k)


@pytest.mark.parametrize("batch,ranks,want", [
    (8, 1, 8), (8, 2, 4), (16, 2, 4), (16, 8, 2), (64, 8, 1), (24, 4, 3)])
def test_accumulation_splits_over_the_ranks(batch, ranks, want):
    """The count of the default nominal batch (64): JAX's wherever each
    microbatch divides over the ranks, else the largest that does."""
    from rtdm_tpu_torch.cli.yolo_train import accumulation
    got = accumulation(batch, 64, None, ranks)
    assert got == want
    assert (batch // got) % ranks == 0


def test_yolo_train_default_nominal_batch_in_a_group_of_two(runs):
    ranks, ref, _ = runs
    for res in ranks:
        assert int(res["accumulate/accumulate"]) == 4
        np.testing.assert_allclose(res["accumulate/history_loss"],
                                   ref["accumulate"]["history_loss"],
                                   rtol=1e-4)
        np.testing.assert_allclose(res["accumulate/last_loss"],
                                   ref["accumulate"]["last_loss"], rtol=1e-4)
