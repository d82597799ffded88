"""The port's data-parallel classifier training against one process and the
JAX train golden.

gloo groups of 4 and then 2 CPU processes (``tests/torch_parallel_jobs.py``
``job_train``), the port in one process here:

- The GSPMD-form step (``train/trainer.py`` with a mesh) in the three cases
  of ``tests/goldens/torch_port/train.npz`` (Squeeze_ErNET at 140, batch 16,
  two microbatches, clip 1.0; a fp32 sgd, b fp32 adamw, c bf16 adamw)
  against the one-process step: in case a every parameter and BatchNorm
  statistic within rtol 2e-4 / atol 2e-5 and the loss within rtol 1e-4, as
  ``tests/test_parallel.py`` holds JAX's (read: 0.22 of that gate at the
  worst element); in b and c within ``tests/test_torch_trainer.py``'s
  per-case ``GATES``, the one-process run taking the golden's place
  (Adam's first updates are lr * sign(g), so an element whose gradient is
  near 0 moves by +-lr on the order of the sums: case b's worst element
  reads 4.2x the elementwise gate); the accuracy exactly. Each meets the
  ``GATES`` against the JAX golden too, and every rank holds the same
  state.
- With dropout 0.2, mixup and cutmix on, the mixed inputs and the dropout
  masks of two steps equal the one-process run's bit for bit.
- The shard_map form (``parallel/shard.py``, a model whose BatchNorm is
  synced by ``set_bn_group``) equals the GSPMD form with dropout off (bit for bit here),
  and both equal the one-process step, each leaf within atol 2e-5 + rtol
  2e-4 of its largest value (one kernel element of 18432 reads 2.4e-5
  off at a 2x2 max-pool near-tie, whose gradient goes to the other pixel
  when the two values swap order by an ulp); with
  ``sync_bn=False`` each rank normalizes by its own rows (another result)
  and the ranks still hold one state.
- A control that must miss the one-process gate: BatchNorm's statistics
  all-reduced by a plain ``dist.all_reduce``, which carries no gradient
  (its gap is printed).
- The elastic ladder 4 -> 2 -> 1: a state saved by the 4-rank group
  restores in the 2-rank group and in one process, and both continue as
  the 4-rank group's uninterrupted run did, within rtol 2e-3
  (``__graft_entry__.py::_dryrun_elastic``).
- ``cli/aider_train.py`` in the 2-rank group equals the one-process run;
  ``TrainingConfig(mesh_shape=(2, 2))`` over the 4 ranks is a 'data' x
  'spatial' grid whose step equals the one-process step.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from tests import torch_parallel_jobs as J
from tests.test_torch_trainer import GATES, gaps, within

CASES = sorted(GATES)
WORLDS = (4, 2)
STEP_TOL = {"params": (2e-4, 2e-5), "loss": 1e-4}


@pytest.fixture(autouse=True)
def two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{world: [rank results]} and the one-process references, the 4-rank
    group first (it saves the elastic checkpoint the others restore)."""
    work = tmp_path_factory.mktemp("parallel_train")
    torch.set_num_threads(2)
    elastic = work / "elastic"
    data = J.write_hue_set(work / "hue")
    four = J.start_group("train", 4, work / "w4", cases=CASES,
                         elastic_dir=str(elastic), restore=False,
                         mesh_shape=[2, 2])
    golden = chip_smoke._train_golden()
    ref = {"golden": golden,
           "cases": {c: chip_smoke.golden_train_case(golden, c, "cpu")
                     for c in CASES},
           "draws": {k: v.numpy() for k, v in J.draw_run().items()},
           "gspmd": J.gspmd_step()}
    results = {4: four.results()}
    two = J.start_group("train", 2, work / "w2", cases=CASES,
                        elastic_dir=str(elastic), restore=True,
                        aider=str(data))
    ref["elastic"] = chip_smoke.elastic_leg(None, elastic, True, "cpu",
                                            J.ELASTIC_BATCH)
    from rtdm_tpu_torch.cli.aider_train import train_model
    config = J.aider_config(data, work / "one")
    _, ref["aider"] = train_model(config)
    ref["aider_weights"] = config.weights
    results[2] = two.results()
    return results, ref


def _case(res, case):
    metrics = {k: res[f"{case}/{k}"] for k in ("loss", "accuracy",
                                                "grad_norm")}
    final = {k[len(case) + 7:]: v for k, v in res.items()
             if k.startswith(f"{case}/final/")}
    return metrics, final


def _assert_state_close(got, want, label, per_leaf=False):
    """Every element within atol + rtol |want|, or with ``per_leaf``
    within atol + rtol max |want| of its leaf."""
    rtol, atol = STEP_TOL["params"]
    assert set(got) == set(want), label
    for k in want:
        scale = np.abs(want[k]).max() if per_leaf else np.abs(want[k])
        excess = np.abs(got[k] - want[k]) - (atol + rtol * scale)
        assert excess.max() <= 0, (label, k, float(excess.max()))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("world", WORLDS)
def test_step_equals_one_process(runs, world, case):
    results, ref = runs
    want_m, want_f = ref["cases"][case]
    for res in results[world]:
        metrics, final = _case(res, case)
        np.testing.assert_array_equal(metrics["accuracy"],
                                      want_m["accuracy"])
        if case == "a":
            np.testing.assert_allclose(metrics["loss"], want_m["loss"],
                                       rtol=STEP_TOL["loss"])
            _assert_state_close(final, want_f, f"case a world {world}")
        else:
            gap = chip_smoke.train_gaps((want_m, want_f), metrics, final)
            assert within(gap, GATES[case]), (gap, GATES[case])


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("world", WORLDS)
def test_step_meets_the_golden_gates(runs, world, case):
    results, ref = runs
    metrics, final = _case(results[world][0], case)
    gap = gaps(ref["golden"], case, metrics, final)
    assert within(gap, GATES[case]), (gap, GATES[case])


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_hold_one_state(runs, world):
    results, _ = runs
    first = results[world][0]
    for res in results[world][1:]:
        assert set(res) == set(first)
        for k, v in first.items():
            if k != "grid_lines":                # each rank's own lines
                np.testing.assert_array_equal(res[k], v, err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
def test_draws_equal_one_process_bit_for_bit(runs, world):
    results, ref = runs
    want = ref["draws"]
    assert sum(k.startswith("mask_") for k in want) == 4 * 2 * 2
    for res in results[world]:
        got = {k[6:]: v for k, v in res.items() if k.startswith("draws/")}
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def _flat(res, prefix):
    return {k[len(prefix) + 1:]: v for k, v in res.items()
            if k.startswith(prefix + "/") and k != prefix + "/loss"}


@pytest.mark.parametrize("world", WORLDS)
def test_shard_map_form_equals_gspmd_form(runs, world):
    results, ref = runs
    want_loss, want = ref["gspmd"]
    for res in results[world]:
        _assert_state_close(_flat(res, "shard_map"), _flat(res, "gspmd"),
                            f"shard_map world {world}")
        _assert_state_close(_flat(res, "gspmd"), want,
                            f"gspmd world {world}", per_leaf=True)
        np.testing.assert_allclose(float(res["shard_map/loss"]),
                                   float(res["gspmd/loss"]),
                                   rtol=STEP_TOL["loss"])
        np.testing.assert_allclose(float(res["gspmd/loss"]), want_loss,
                                   rtol=STEP_TOL["loss"])


def test_config_mesh_shape_makes_a_grid(runs):
    """TrainingConfig(mesh_shape=(2, 2)) over 4 ranks: a 'data' x
    'spatial' grid whose axes have their own groups; the step over it
    splits the batch over 'data' only and equals the one-process step."""
    results, ref = runs
    want_loss, want = ref["gspmd"]
    for rank, res in enumerate(results[4]):
        row, col = divmod(rank, 2)
        np.testing.assert_array_equal(res["grid_lines"],
                                      [[col, 2 + col], [2 * row, 2 * row + 1]])
        _assert_state_close(_flat(res, "grid"), want, "2x2 grid",
                            per_leaf=True)
        np.testing.assert_allclose(float(res["grid/loss"]), want_loss,
                                   rtol=STEP_TOL["loss"])


@pytest.mark.parametrize("world", WORLDS)
def test_unsynced_batchnorm_is_each_ranks_own(runs, world):
    """sync_bn=False (TrainingConfig.sync_batchnorm): the running
    statistics are rank 0's rows' (every rank holds them), not the global
    batch's."""
    results, _ = runs
    res = results[world][0]
    local, synced = _flat(res, "local_bn"), _flat(res, "gspmd")
    gap = max(np.abs(local[k] - synced[k]).max() / np.abs(synced[k]).max()
              for k in synced if k.startswith("batch_stats/"))
    assert gap > 1e-3, gap


@pytest.mark.parametrize("world", WORLDS)
def test_control_without_autograd_misses(runs, world):
    """BatchNorm's statistics all-reduced without their gradient: the
    parameters after case a's three steps miss the one-process gate."""
    results, ref = runs
    want_m, want_f = ref["cases"]["a"]
    rtol, atol = STEP_TOL["params"]
    res = results[world][0]
    final = {k[len("control/final/"):]: v for k, v in res.items()
             if k.startswith("control/final/")}
    excess = max(float((np.abs(final[k] - want_f[k])
                        / (atol + rtol * np.abs(want_f[k]))).max())
                 for k in want_f if k.startswith("params/"))
    loss_gap = float(np.abs(res["control/loss"] - want_m["loss"]).max()
                     / np.abs(want_m["loss"]).max())
    print(f"world {world}: control params at {excess:.1f}x the gate, "
          f"loss gap {loss_gap:.3e}")
    assert excess > 1.0
    ok_m, ok_f = _case(res, "a")
    assert max(float((np.abs(ok_f[k] - want_f[k])
                      / (atol + rtol * np.abs(want_f[k]))).max())
               for k in want_f if k.startswith("params/")) <= 1.0


def test_elastic_ladder_4_2_1(runs):
    results, ref = runs
    pre4, cont4, step4 = (results[4][0][k] for k in
                          ("elastic/pre", "elastic/cont", "elastic/step"))
    assert pre4[-1] < pre4[0]
    ladder = {2: tuple(results[2][0][k] for k in
                       ("elastic/pre", "elastic/cont", "elastic/step")),
              1: ref["elastic"]}
    for world, (pre, cont, step) in ladder.items():
        np.testing.assert_array_equal(pre, pre4)      # the saved metadata
        assert int(step) == int(step4) == 2
        np.testing.assert_allclose(cont, cont4, rtol=2e-3,
                                   err_msg=f"resumed at world size {world}")


def test_aider_train_in_a_group_of_two(runs):
    from rtdm_tpu_torch.models.io import flatten_tree, load_variables
    results, ref = runs
    res = results[2][0]
    for key in ("train_loss", "val_loss", "val_acc", "train_acc"):
        np.testing.assert_allclose(res[f"aider/{key}"], ref["aider"][key],
                                   rtol=1e-4, err_msg=key)
    got = flatten_tree(load_variables(str(res["aider/weights"])))
    want = flatten_tree(load_variables(ref["aider_weights"]))
    _assert_state_close(got, want, "aider_train")
