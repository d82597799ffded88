"""``rtdm_tpu_torch/cli/yolo_train.py`` against the JAX package's, on the
CPU (``--device cpu``):

- two epochs of the CLI on the labelled example set (PNG frames, mosaic
  and the augmentations on, batch 8 of nominal 16: two microbatches) from
  the same initial weights, for a narrow darknet cfg (BN convs, a route
  and an upsample, two heads; EMA, BN burn-in of one batch) and a narrow
  v5 yaml (autoanchor on, its evolved anchors equal): the epochs' loss
  components within ``CLI_LOSS_TOL`` (1e-4) of their max (read: 1.6e-7
  darknet, 3.7e-8 v5), every leaf of ``last.npz`` within
  ``CLI_WEIGHT_TOL`` (5e-5) of its max |value| (read: 2.7e-6, 1.1e-5),
  P, R and mAP@0.5 within ``CLI_METRIC_TOL`` (1e-6; read: equal);
- one step of case b of ``tests/goldens/torch_port/yolo_train.npz``
  (yolov4-tiny-mini at 416, two microbatches, nesterov SGD with burn-in)
  within ``chip_smoke.YOLO_GATES['b']``; the other cases and all three
  steps run on the card (``chip_smoke.py`` phase 10);
- ``--device`` (the card by default: it raises without CUDA), ``.pt`` and
  ``.weights`` starts (ROADMAP item 7), ``--resume`` continuing at the next
  epoch with the optimizer's count, ``--summary`` against
  ``summarize_detector`` of the JAX package (the rows; FLOPs are counted
  differently), and ``--evolve`` writing its files.
"""

import json
import os

import numpy as np
import pytest
import torch

CLI_LOSS_TOL = 1e-4
CLI_WEIGHT_TOL = 5e-5
CLI_METRIC_TOL = 1e-6

DARKNET_CFG = """[net]
width=128
height=128

[convolutional]
batch_normalize=1
filters=8
size=3
stride=1
pad=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
batch_normalize=1
filters=16
size=3
stride=1
pad=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
batch_normalize=1
filters=16
size=3
stride=1
pad=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
batch_normalize=1
filters=32
size=3
stride=1
pad=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
batch_normalize=1
filters=32
size=3
stride=1
pad=1
activation=leaky

[convolutional]
size=1
stride=1
pad=1
filters=21
activation=linear

[yolo]
mask=3,4,5
anchors=10,14, 23,27, 37,58, 81,82, 135,169, 344,319
classes=2

[route]
layers=-3

[convolutional]
batch_normalize=1
filters=16
size=1
stride=1
pad=1
activation=leaky

[upsample]
stride=2

[route]
layers=-1,6

[convolutional]
batch_normalize=1
filters=16
size=3
stride=1
pad=1
activation=leaky

[convolutional]
size=1
stride=1
pad=1
filters=21
activation=linear

[yolo]
mask=0,1,2
anchors=10,14, 23,27, 37,58, 81,82, 135,169, 344,319
classes=2
"""

V5_YAML = """nc: 2
depth_multiple: 1.0
width_multiple: 1.0
anchors:
  - [10,13, 16,30, 33,23]
  - [30,61, 62,45, 59,119]
backbone:
  [[-1, 1, Focus, [16, 3]],
   [-1, 1, Conv, [32, 3, 2]],
   [-1, 1, C3, [32]],
   [-1, 1, Conv, [64, 3, 2]],
   [-1, 1, SPP, [64, [3, 5]]],
  ]
head:
  [[-1, 1, Conv, [32, 1, 1]],
   [[4, 5], 1, Detect, [nc, anchors]],
  ]
"""


@pytest.fixture(autouse=True)
def few_threads(monkeypatch):
    monkeypatch.setenv("RTDM_XLA_CACHE", "0")
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def example_data(tmp_path_factory):
    from rtdm_tpu_torch.data.example_set import write_example_set
    return write_example_set(tmp_path_factory.mktemp("examples"))


def _model_files(tmp_path, family):
    """The narrow model file and its port init as ``.npz`` (both packages
    start from it)."""
    from rtdm_tpu_torch.export.detector import load_detection_model
    from rtdm_tpu_torch.models.io import save_variables
    path = tmp_path / ("narrow.cfg" if family == "darknet" else
                       "narrow.yaml")
    path.write_text(DARKNET_CFG if family == "darknet" else V5_YAML)
    _, variables, _ = load_detection_model(str(path), None, 128)
    return str(path), save_variables(str(tmp_path / "init.npz"), variables)


def _argv(cfg, weights, data, out, family, *extra):
    argv = ["--cfg", cfg, "--weights", weights, "--data", data,
            "--img-size", "128", "--batch-size", "8", "--nominal-batch",
            "16", "--epochs", "2", "--lr0", "0.01", "--momentum", "0.937",
            "--burn-in", "1", "--seed", "3", "--num-workers", "2",
            "--no-plots", "--output", str(out)]
    if family == "darknet":
        argv += ["--ema", "--bn-burn-in", "1"]
    return argv + list(extra)


def _leaf_gap(a, b):
    from rtdm_tpu_torch.models.io import flatten_tree, load_variables
    fa = flatten_tree(load_variables(str(a)))
    fb = flatten_tree(load_variables(str(b)))
    assert set(fa) == set(fb)
    return max(float(np.abs(fa[k] - fb[k]).max() / max(np.abs(fb[k]).max(),
                                                        1e-30))
               for k in fb)


@pytest.mark.parametrize("family", ["darknet", "yolov5"])
def test_cli_two_epochs_match_jax(tmp_path, example_data, family):
    from rtdm_tpu.cli import yolo_train as jax_cli

    from rtdm_tpu_torch.cli import yolo_train
    cfg, weights = _model_files(tmp_path, family)
    got = yolo_train.main(_argv(cfg, weights, example_data,
                                tmp_path / "port", family, "--device",
                                "cpu"))
    want = jax_cli.main(_argv(cfg, weights, example_data, tmp_path / "jax",
                              family))
    g_loss = np.array([h["loss"] for h in got["history"]])
    w_loss = np.array([h["loss"] for h in want["history"]])
    assert g_loss.shape == w_loss.shape == (2, 3)
    assert np.abs(g_loss - w_loss).max() <= \
        CLI_LOSS_TOL * np.abs(w_loss).max()
    for k in ("mp", "mr", "map50"):
        assert abs(got["last_eval"][k] - want["last_eval"][k]) <= \
            CLI_METRIC_TOL, k
    assert _leaf_gap(tmp_path / "port" / "last.npz",
                     tmp_path / "jax" / "last.npz") <= CLI_WEIGHT_TOL
    if family == "yolov5":
        import yaml

        from rtdm_tpu_torch.utils import yaml_io
        text = (tmp_path / "port" / "model-autoanchor.yaml").read_text()
        want = yaml.safe_load((tmp_path / "jax" / "model-autoanchor.yaml")
                              .read_text())
        assert yaml.safe_load(text) == want == yaml_io.loads(text)
    # a completed run keeps only the deployable weights
    assert not os.path.exists(tmp_path / "port" / "last_state.pt")


def test_golden_case_b_first_step(tmp_path):
    import chip_smoke
    golden = chip_smoke._yolo_golden()
    run = chip_smoke.golden_yolo_case(golden, "b", "cpu", tmp_path, steps=1)
    gaps = chip_smoke.yolo_gaps(chip_smoke.golden_yolo_ref(golden, "b", 1),
                                run)
    assert all(g <= t for g, t in zip(gaps, chip_smoke.YOLO_GATES["b"])), \
        gaps


def test_device_defaults_to_the_card(tmp_path, example_data):
    from rtdm_tpu_torch.cli import yolo_train
    cfg, weights = _model_files(tmp_path, "darknet")
    argv = _argv(cfg, weights, example_data, tmp_path / "run", "darknet")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        yolo_train.main(argv)


@pytest.mark.parametrize("start", ["start.pt", "start.weights"])
def test_pt_and_weights_starts_raise(tmp_path, example_data, start):
    from rtdm_tpu_torch.cli import yolo_train
    cfg, _ = _model_files(tmp_path, "darknet")
    with pytest.raises(NotImplementedError, match="item 7"):
        yolo_train.main(_argv(cfg, str(tmp_path / start), example_data,
                              tmp_path / "run", "darknet", "--device",
                              "cpu"))


def test_resume_continues_at_the_next_epoch(tmp_path, example_data):
    from rtdm_tpu_torch.cli import yolo_train
    cfg, weights = _model_files(tmp_path, "darknet")
    out = tmp_path / "run"
    first = yolo_train.main(_argv(cfg, weights, example_data, out,
                                  "darknet", "--device", "cpu", "--epochs",
                                  "1", "--no-strip"))
    assert len(first["history"]) == 1
    assert os.path.exists(out / "last_state.pt")
    meta = json.loads((out / "last_state.meta.json").read_text())
    assert meta["epoch"] == 0 and meta["it"] == 1
    state = torch.load(out / "last_state.pt", weights_only=True)
    assert state["optimizer"]["count"] == 1 and state["ema"]
    second = yolo_train.main(_argv(cfg, weights, example_data, out,
                                   "darknet", "--device", "cpu", "--epochs",
                                   "3", "--resume"))
    assert len(second["history"]) == 3
    assert second["history"][0] == first["history"][0]
    assert not os.path.exists(out / "last_state.pt")


def test_summary_rows_match_jax(tmp_path):
    from rtdm_tpu.utils.summary import summarize_detector as jax_summary

    from rtdm_tpu_torch.utils.summary import summarize_detector
    for family in ("darknet", "yolov5"):
        cfg, _ = _model_files(tmp_path, family)
        got = summarize_detector(cfg, 128).splitlines()
        want = jax_summary(cfg, 128).splitlines()
        rows = [ln for ln in want if not ln.startswith("forward FLOPs")]
        assert got[:len(rows)] == rows
        assert got[-1].startswith("forward FLOPs")


def test_evolve_writes_its_files(tmp_path, example_data):
    import yaml

    from rtdm_tpu_torch.cli import yolo_train
    from rtdm_tpu_torch.train.evolve import V3_EVOLVE_META
    cfg, weights = _model_files(tmp_path, "darknet")
    out = tmp_path / "evolve"
    best, fit = yolo_train.main(_argv(
        cfg, weights, example_data, out, "darknet", "--device", "cpu",
        "--epochs", "1", "--evolve", "2", "--img-size", "64"))
    rows = np.loadtxt(out / "evolve.txt", ndmin=2)
    assert rows.shape == (2, 7 + len(V3_EVOLVE_META))
    for g in range(2):
        hyp = yaml.safe_load((out / f"gen{g}-hyp.yaml").read_text())
        assert set(hyp) == set(V3_EVOLVE_META) - {
            "giou", "cls", "obj", "iou_t", "lr0", "lrf", "momentum",
            "weight_decay", "fl_gamma"}
    evolved = yaml.safe_load((out / "hyp_evolved.yaml").read_text())
    assert evolved == best and set(best) == set(V3_EVOLVE_META)
    assert np.isfinite(fit)
