"""The port's evaluation path against the JAX package's: the metrics
(numpy copies, so equal to the last bit), the AIDER dataset and batch
loader (the same uint8 frames and labels), and the build_engine and
evaluate_classification CLIs on a small AIDER directory made from
docs/examples/*.jpg, with labels from the file names: the same confusion
matrix at fp32, and for int8 the same calibrated scales (rtol 1e-4, the
percentile of fp32 activations that differ by summation order)."""

import shutil

import numpy as np
import pytest

from rtdm_tpu.cli import build_engine as jax_build_cli
from rtdm_tpu.cli import evaluate_classification as jax_eval_cli
from rtdm_tpu.data import aider as jax_aider
from rtdm_tpu.eval.classification import \
    ClassificationMetrics as JaxMetrics
from rtdm_tpu_torch.cli import build_engine as build_cli
from rtdm_tpu_torch.cli import evaluate_classification as eval_cli
from rtdm_tpu_torch.data import aider
from rtdm_tpu_torch.eval.classification import ClassificationMetrics
from tests.torch_port_goldens import EXAMPLES, params_path

LABELS = {"collapsed_building": 0, "fire": 1, "flood": 2, "normal": 3,
          "traffic_incident": 4}
WEIGHTS = params_path("squeeze-ernet")


@pytest.fixture(scope="module")
def aider_dir(tmp_path_factory):
    """An AIDER-style directory: one folder a class, and a CSV split of
    (relative path, label) rows."""
    root = tmp_path_factory.mktemp("aider")
    rows = []
    for p in EXAMPLES:
        cls = p.stem.rsplit("_image", 1)[0]
        (root / cls).mkdir(exist_ok=True)
        shutil.copy(p, root / cls / p.name)
        rows.append(f"{cls}/{p.name},{LABELS[cls]}")
    (root / "test.csv").write_text("\n".join(rows) + "\n")
    return root


def test_metrics_match_jax(rng):
    got = ClassificationMetrics(5, aider.CLASS_NAMES)
    want = JaxMetrics(5, jax_aider.CLASS_NAMES)
    for _ in range(3):
        cm = rng.integers(0, 20, size=(5, 5))
        cm[2] = 0                      # a class with no support
        got.update(cm, 1.5, int(cm.sum()))
        want.update(cm, 1.5, int(cm.sum()))
    assert got.report() == want.report()
    np.testing.assert_array_equal(got.confusion, want.confusion)
    assert (got.accuracy, got.loss) == (want.accuracy, want.loss)
    for avg in ("macro", "weighted"):
        assert got.f1(avg) == want.f1(avg)
        assert got.precision(avg) == want.precision(avg)
        assert got.recall(avg) == want.recall(avg)


@pytest.mark.parametrize("size", [140, 240])
def test_dataset_and_loader_match_jax(aider_dir, size):
    csv = aider_dir / "test.csv"
    got = aider.AiderDataset(csv, aider_dir, size)
    want = jax_aider.AiderDataset(csv, aider_dir, size)
    np.testing.assert_array_equal(got.labels, want.labels)
    batches = zip(aider.BatchLoader(got, 4, num_workers=2),
                  jax_aider.BatchLoader(want, 4, num_workers=2))
    for (gi, gl, gv), (wi, wl, wv) in batches:
        assert gv == wv and gi.dtype == np.uint8
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)
    assert len(aider.BatchLoader(got, 4)) == 3


def test_dataset_missing_image_is_black(aider_dir, tmp_path):
    csv = tmp_path / "bad.csv"
    csv.write_text("nowhere/missing.jpg,3\n")
    ds = aider.AiderDataset(csv, aider_dir, 140)
    img, label = ds.load(0)
    assert label == 3 and not img.any() and ds.load_errors == 1


def _eval_args(aider_dir):
    return ["--root-dir", str(aider_dir), "--test-split",
            str(aider_dir / "test.csv"), "--batch-size", "4",
            "--num-workers", "2"]


def test_evaluate_weights_matches_jax_cli(aider_dir, capsys):
    want = jax_eval_cli.main(["--weights", WEIGHTS, "--precision", "fp32",
                              *_eval_args(aider_dir)])
    got = eval_cli.main(["--weights", WEIGHTS, "--precision", "fp32",
                         "--device", "cpu", *_eval_args(aider_dir)])
    np.testing.assert_array_equal(got.confusion, want.confusion)
    assert got.total == len(EXAMPLES)
    out = capsys.readouterr().out
    assert "frames/s on cpu" in out and "weighted F1" in out


def test_built_engine_evaluates_as_jax(aider_dir, tmp_path):
    """build_engine's directory (fp32, batch 4) evaluated by the port
    gives the JAX CLI's confusion matrix."""
    out = tmp_path / "eng"
    build_cli.main(["--weights", WEIGHTS, "--quant", "fp32", "--batch-size",
                    "4", "--output", str(out), "--device", "cpu"])
    assert sorted(p.name for p in out.iterdir()) == ["params.npz",
                                                     "spec.json"]
    want = jax_eval_cli.main(["--weights", WEIGHTS, "--precision", "fp32",
                              *_eval_args(aider_dir)])
    got = eval_cli.main(["--engine", str(out), "--device", "cpu",
                         *_eval_args(aider_dir)])
    np.testing.assert_array_equal(got.confusion, want.confusion)


def test_int8_build_calibrates_as_jax_cli(aider_dir, tmp_path):
    calib = aider_dir / "fire"
    common = ["--weights", WEIGHTS, "--quant", "int8", "--batch-size", "2",
              "--calib-dir", str(calib)]
    build_cli.main([*common, "--output", str(tmp_path / "port"),
                    "--device", "cpu"])
    jax_build_cli.main([*common, "--output", str(tmp_path / "jax")])
    with np.load(tmp_path / "port" / "act_scales.npz") as g, \
            np.load(tmp_path / "jax" / "act_scales.npz") as w:
        assert sorted(g.files) == sorted(w.files) and len(g.files) == 19
        for key in w.files:
            np.testing.assert_allclose(g[key], w[key], rtol=1e-4,
                                       err_msg=key)


@pytest.mark.parametrize("argv", [
    ["--cfg", "yolov4-tiny.cfg"], ["--sealed"],
    ["--quant", "int8"]])                     # int8 without --calib-dir
def test_build_engine_cli_refuses(tmp_path, argv):
    with pytest.raises(SystemExit):
        build_cli.main(["--weights", WEIGHTS, "--output",
                        str(tmp_path / "x"), "--device", "cpu", *argv])


def test_evaluate_cli_refuses_data_parallel(aider_dir, monkeypatch):
    """--data-parallel runs over the launcher's process group: where the
    launcher asked for two ranks and named no coordinator, it refuses
    instead of running one rank alone."""
    for name in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
                 "NUM_PROCESSES", "PROCESS_ID", "MASTER_ADDR"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="coordinator"):
        eval_cli.main(["--weights", WEIGHTS, "--data-parallel",
                       "--device", "cpu", *_eval_args(aider_dir)])
