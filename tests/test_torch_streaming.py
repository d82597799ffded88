"""The port's streaming paths against the JAX package's, on the CPU.

- ``cli/realtime_inference.py`` against JAX's on a directory of seeded PNG
  frames, with seeded JAX weights carried over as ``.npz`` (``--weights``)
  and as a saved engine directory (``--engine``), fp32: every frame's class
  equal to JAX's and its confidence equal to JAX's printed two decimals
  within 0.005 + 1e-4; and equal, exactly, to the port's ``Engine`` on the
  same cv2-resized frames.
- ``cli/cascade_stream.py``: the port's cascade on the committed
  yolov4-tiny-mini cfg with its seeded init, on the 10 golden frames,
  against ``tests/goldens/torch_port/cascade.npz`` (the JAX ``build_cascade``
  on the same weights; a test regenerates it and checks it is current):
  probabilities within ``REL_TOL`` of max |prob| (fp32 1e-4, bf16 2e-2,
  ``tests/test_torch_engine.py``), argmax equal, detections by
  ``eval/detection.py::compare_detections`` with both runs' candidates
  (fp32 to its strict gates as well). With random weights NMS keeps rows
  whose objectness passes ``CASCADE_CONF`` = 0.65, and every frame has
  detections there. bf16 rounds as the compiled program does but its convs
  sum in another order, which flips rare bf16 roundings. The classifier's
  input differs from XLA's by up to 5 fp32 ulps of 255: XLA sums the
  resize's dot and its weights' normalising sum in another order. Then
  JAX live on a narrow darknet cfg at 160 (both ``main``s on an image
  dir, and ``build_cascade`` with NMS left out for the candidates).
- ``utils/profiler.py``: the energy model, ``StepTimer`` and ``FpsMeter``
  against JAX's under one fake clock, exactly; the CPU's default watts.
- ``cli/power_usage.py`` against JAX's on a seeded AIDER-layout directory.
"""

import os
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from rtdm_tpu_torch.eval.detection import (candidates, compare_detections,
                                           meets_strict, per_frame, summary)

ROOT = Path(__file__).resolve().parents[1]
GOLDEN_DET = ROOT / "tests" / "goldens" / "torch_port" / "detector_int8.npz"
GOLDEN_CASCADE = GOLDEN_DET.with_name("cascade.npz")
CLS_WEIGHTS = str(ROOT / "artifacts" / "engines" / "squeeze-ernet_bf16" /
                  "params.npz")
REL_TOL = {"fp32": 1e-4, "bf16": 2e-2}
# narrow darknet: two heads, 2 classes, at 160 (a downscale to the
# classifier's 140, as at 416)
NARROW_CFG = """[net]
width=160
height=160
channels=3

[convolutional]
filters=8
size=3
stride=2
pad=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
filters=16
size=3
stride=1
pad=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
filters=16
size=3
stride=1
pad=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
filters=21
size=1
stride=1
pad=1
activation=linear

[yolo]
mask = 3,4,5
anchors = 10,14,  23,27,  37,58,  81,82,  135,169,  344,319
classes=2
num=6

[route]
layers = -3

[upsample]
stride=2

[route]
layers = -1, -8

[convolutional]
filters=21
size=1
stride=1
pad=1
activation=linear

[yolo]
mask = 0,1,2
anchors = 10,14,  23,27,  37,58,  81,82,  135,169,  344,319
classes=2
num=6
"""


@pytest.fixture(autouse=True)
def few_threads():
    """Two torch threads a test: the test run's workers share the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    """Seeded PNG frames of several sizes."""
    d = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(0)
    for i, (h, w) in enumerate(((120, 160), (200, 150), (96, 96),
                                (130, 210), (160, 120))):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                        ).save(d / f"f{i}.png")
    return str(d)


@pytest.fixture(scope="module")
def classifier_weights(tmp_path_factory):
    """A seeded JAX Squeeze_ErNET init as .npz, and an fp32 engine of it
    at batch 4 saved by JAX."""
    import jax
    import jax.numpy as jnp
    from rtdm_tpu.export.engine import build_engine
    from rtdm_tpu.models import create_model
    from rtdm_tpu.models.io import save_variables
    d = tmp_path_factory.mktemp("cls")
    model = create_model("squeeze-ernet")
    v = jax.device_get(model.init(jax.random.key(0),
                                  jnp.zeros((1, 140, 140, 3))))
    build_engine("squeeze-ernet", v, "fp32", 4).save(str(d / "engine"))
    return save_variables(str(d / "w.npz"), v), str(d / "engine")


def _jax_labels(monkeypatch, argv):
    """JAX realtime_inference's per-frame (class name, printed conf)."""
    import rtdm_tpu.cli.realtime_inference as jax_rt
    seen = []
    monkeypatch.setattr(jax_rt, "_annotate_and_save",
                        lambda frame, label, path: seen.append(label))
    n = jax_rt.main(argv)
    assert n == len(seen)
    return [(m.group(1), float(m.group(2))) for m in
            (re.match(r"(\S+) ([0-9.]+) \|", s) for s in seen)]


@pytest.mark.parametrize("source", ["weights", "engine"])
def test_realtime_inference_matches_jax(image_dir, classifier_weights,
                                        tmp_path, monkeypatch, capsys,
                                        source):
    import cv2

    from rtdm_tpu_torch.cli.realtime_inference import main
    from rtdm_tpu_torch.data.camera import FrameSource
    from rtdm_tpu_torch.export.engine import Engine
    from rtdm_tpu_torch.models.ernet import CLASS_NAMES
    weights, engine_dir = classifier_weights
    src = (["--weights", weights, "--quant", "fp32", "--batch", "2"]
           if source == "weights" else ["--engine", engine_dir,
                                        "--batch", "3"])
    argv = ["--source", image_dir] + src
    want = _jax_labels(monkeypatch, argv + ["--save-dir",
                                            str(tmp_path / "jax")])
    report = main(argv + ["--power", "--device", "cpu",
                          "--save-dir", str(tmp_path / "port")])
    out = capsys.readouterr().out
    assert report["frames"] == len(want) == 5
    assert "FPS avg" in out and "energy/frame" in out
    assert report["chip_watts"] == 65.0 and report["mj_per_frame"] > 0
    assert os.path.exists(tmp_path / "port" / "frame_00004.jpg")
    got = report["predictions"]
    for (idx, conf), (name, jconf) in zip(got, want):
        assert CLASS_NAMES[idx] == name
        assert abs(conf - jconf) <= 0.005 + 1e-4
    # the same frames, resized as the CLI does, through the engine
    eng = Engine.load(engine_dir, device="cpu")
    frames = [cv2.resize(f, (140, 140), interpolation=cv2.INTER_LINEAR)
              for f in FrameSource.open(image_dir).start()]
    direct = np.concatenate([eng(np.stack(frames[i:i + 4]))
                             for i in range(0, len(frames), 4)])
    assert [i for i, _ in got] == direct.argmax(1).tolist()
    np.testing.assert_array_equal([c for _, c in got], direct.max(1))


def test_realtime_inference_options(image_dir, classifier_weights):
    from rtdm_tpu_torch.cli.realtime_inference import main
    weights, engine_dir = classifier_weights
    report = main(["--source", image_dir, "--engine", engine_dir,
                   "--max-frames", "3", "--device", "cpu"])
    assert report["frames"] == 3 and len(report["predictions"]) == 3
    # without a launcher --data-parallel is one rank: the same frames
    dp = main(["--source", image_dir, "--engine", engine_dir,
               "--max-frames", "3", "--data-parallel", "--device", "cpu"])
    assert dp["predictions"] == report["predictions"]
    with pytest.raises(SystemExit):  # neither --engine nor --weights
        main(["--source", image_dir, "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["--source", image_dir, "--engine", engine_dir])


@pytest.fixture(scope="module")
def cascade_golden():
    with np.load(GOLDEN_CASCADE) as g:
        golden = dict(g)
    with np.load(GOLDEN_DET) as g:
        golden["frames_416"] = g["frames_416"]
    return golden


@pytest.fixture(scope="module")
def cascade_cfg(tmp_path_factory):
    from tests.torch_port_goldens import cascade_cfg as write_cfg
    return write_cfg(str(tmp_path_factory.mktemp("cascade")))


def _run_cascade(cascade, frames):
    """(probs, det, count, candidates per frame) of the port's cascade."""
    out = [cascade(frames[i:i + 1]) for i in range(len(frames))]
    with torch.inference_mode():
        cand = [candidates(cascade.detector.decoded(
            cascade.detector._upload(frames[i:i + 1])[0]).float().numpy(),
            cascade.detector.spec.conf_thres)[0]
            for i in range(len(frames))]
    return tuple(np.concatenate([o[k].numpy() for o in out])
                 for k in range(3)) + (cand,)


def _hold_probs(got, want, quant):
    assert got.shape == want.shape
    assert (got.argmax(1) == want.argmax(1)).all()
    assert np.abs(got - want).max() <= REL_TOL[quant] * np.abs(want).max()


def test_cascade_golden_is_current(cascade_golden):
    from tests import torch_port_goldens as gen
    assert gen.GOLDEN_CASCADE == GOLDEN_CASCADE
    fresh = gen.make_cascade_golden()
    assert fresh.keys() == set(cascade_golden) - {"frames_416"}
    for key, val in fresh.items():
        np.testing.assert_array_equal(val, cascade_golden[key], err_msg=key)


@pytest.mark.parametrize("quant", ["fp32", "bf16"])
def test_cascade_matches_golden(cascade_golden, cascade_cfg, quant):
    from rtdm_tpu_torch.cli.cascade_stream import build_cascade
    from rtdm_tpu_torch.export.detector import load_detection_model
    from rtdm_tpu_torch.models.io import tree_digest
    from tests.torch_port_goldens import (CASCADE_CONF, CASCADE_IOU,
                                          DETECTOR_SIZE)
    # the port's init without weights is the golden's detector
    assert tree_digest(load_detection_model(cascade_cfg, None,
                                            DETECTOR_SIZE)[1]) == \
        cascade_golden["det_weights_digest"]
    cascade = build_cascade(cascade_cfg, None, "squeeze-ernet", CLS_WEIGHTS,
                            DETECTOR_SIZE, CASCADE_CONF, CASCADE_IOU, quant,
                            device="cpu")
    probs, det, count, cand = _run_cascade(cascade,
                                           cascade_golden["frames_416"])
    _hold_probs(probs, cascade_golden[f"probs_{quant}"], quant)
    assert (count > 0).all() and (cascade_golden[f"count_{quant}"] > 0).all()
    rep = compare_detections(
        cascade_golden[f"det_{quant}"], cascade_golden[f"count_{quant}"],
        det, count, CASCADE_CONF, CASCADE_IOU,
        per_frame(cascade_golden[f"cand_{quant}"], range(len(count))), cand)
    assert rep["ok"], summary(rep)
    if quant == "fp32":
        assert meets_strict(rep), summary(rep)


def test_cascade_control_fails_the_gate(cascade_golden, cascade_cfg):
    """The gate can fail: the golden's fp32 boxes moved 3.5 px."""
    from tests.torch_port_goldens import CASCADE_CONF, CASCADE_IOU
    det, count = cascade_golden["det_fp32"], cascade_golden["count_fp32"]
    moved = det.copy()
    moved[..., :4] += 3.5
    rep = compare_detections(det, count, moved, count, CASCADE_CONF,
                             CASCADE_IOU)
    assert not rep["ok"]


def test_cascade_matches_jax_on_narrow_cfg(tmp_path, image_dir):
    """JAX live: the narrow cfg with the port's seeded init, both
    ``build_cascade``s at batch 2 on letterboxed frames, and both ``main``s
    on an image directory."""
    from rtdm_tpu.cli.cascade_stream import build_cascade as jax_build
    from rtdm_tpu.cli.cascade_stream import main as jax_main
    from rtdm_tpu_torch.cli.cascade_stream import build_cascade, main
    from rtdm_tpu_torch.data.camera import FrameSource
    from rtdm_tpu_torch.data.odder import letterbox_image
    from rtdm_tpu_torch.export.detector import load_detection_model
    from rtdm_tpu_torch.models.io import save_variables
    from tests.torch_port_goldens import jax_nms_left_out
    cfg = tmp_path / "narrow.cfg"
    cfg.write_text(NARROW_CFG)
    weights = save_variables(str(tmp_path / "det.npz"), load_detection_model(
        str(cfg), None, 160)[1])
    frames = np.stack([letterbox_image(f, 160)[0] for f in
                       FrameSource.open(image_dir).start()][:4])
    conf, iou = 0.5, 0.45
    for quant in ("fp32", "bf16"):
        args = (str(cfg), weights, "squeeze-ernet", CLS_WEIGHTS, 160, conf,
                iou, quant, 2)
        jfn = jax_build(*args)
        with jax_nms_left_out():
            jpred = jax_build(*args)
        want = [jfn(frames[i:i + 2]) for i in (0, 2)]
        jcand = [c for i in (0, 2) for c in candidates(
            np.asarray(jpred(frames[i:i + 2])[1]), conf)]
        port = build_cascade(*args, device="cpu")
        got = _run_cascade(port, frames)
        _hold_probs(got[0], np.concatenate([np.asarray(w[0]) for w in want]),
                    quant)
        wdet = np.concatenate([np.asarray(w[1]) for w in want])
        wcount = np.concatenate([np.asarray(w[2]) for w in want])
        assert wcount.sum() > 0
        rep = compare_detections(wdet, wcount, got[1], got[2], conf, iou,
                                 jcand, got[3],
                                 box_rel=0.06 if quant == "bf16" else 0.0)
        assert rep["ok"], summary(rep)
        if quant == "fp32":
            assert meets_strict(rep), summary(rep)
    argv = ["--source", image_dir, "--det-cfg", str(cfg), "--det-weights",
            weights, "--cls-weights", CLS_WEIGHTS, "--img-size", "160",
            "--quant", "fp32", "--conf-thres", str(conf), "--max-frames",
            "4"]
    want = jax_main(argv)
    got = main(argv + ["--device", "cpu", "--save-dir",
                       str(tmp_path / "out")])
    assert len(got) == len(want) == 4
    assert os.path.exists(tmp_path / "out" / "frame_00003.jpg")
    for (gs, gd), (ws, wd) in zip(got, want):
        assert gs == ws and gd.shape == wd.shape
        np.testing.assert_allclose(gd, wd, rtol=0, atol=1e-2)


def _fake_clock(monkeypatch):
    ticks = iter(np.arange(0.0, 1000.0, 0.125))
    monkeypatch.setattr("time.perf_counter", lambda: float(next(ticks)))


def _drive(mod, monkeypatch, **kwargs):
    _fake_clock(monkeypatch)
    pm = mod.PowerMonitor(chip_watts=100.0, idle_watts=10.0, **kwargs)
    pm.start()
    for busy in (0.05, 0.05, 0.2, 0.01):
        pm.record_busy(busy)
        pm.mark_event("step")
    pm.stop()
    timer, fps = mod.StepTimer(), mod.FpsMeter()
    for _ in range(4):
        timer.start()
        timer.stop()
        fps.tick(3)
    return ([(s.t, s.watts) for s in pm.samples], pm.get_total_energy(),
            pm.energy_per_frame(10), timer.mean, timer.total, fps.fps)


def test_profiler_matches_jax(monkeypatch):
    import rtdm_tpu.utils.profiler as jax_prof
    import rtdm_tpu_torch.utils.profiler as prof
    got = _drive(prof, monkeypatch, device="cpu")
    want = _drive(jax_prof, monkeypatch)
    assert got == want
    # 0.31 s busy at 100 W over 10 frames
    np.testing.assert_allclose(got[2], 3100.0, rtol=1e-12)
    assert prof.PowerMonitor(device="cpu").chip_watts == \
        jax_prof.DEFAULT_CHIP_WATTS["cpu"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            prof.PowerMonitor()


def test_step_timer_waits_for_tensors_and_trace(tmp_path):
    from rtdm_tpu_torch.utils.profiler import StepTimer, trace
    timer = StepTimer()
    for result in (torch.ones(3), (torch.ones(2), [torch.zeros(1)]),
                   np.ones(2)):
        timer.start()
        assert timer.stop(result) >= 0
    assert len(timer.times) == 3
    with trace(str(tmp_path / "tb")):
        torch.ones(8, 8) @ torch.ones(8, 8)
    assert list((tmp_path / "tb").glob("*.pt.trace.json"))


@pytest.fixture(scope="module")
def aider_dir(tmp_path_factory):
    """An AIDER-layout directory: class folders of seeded PNGs and a CSV
    split of (relative path, label)."""
    root = tmp_path_factory.mktemp("aider")
    rng = np.random.default_rng(1)
    rows = []
    for label, name in enumerate(("collapsed_building", "fire",
                                  "flooded_areas", "normal",
                                  "traffic_incident")):
        (root / name).mkdir()
        for i in range(3):
            rel = f"{name}/img_{i}.png"
            Image.fromarray(rng.integers(0, 256, (150, 180, 3),
                                         dtype=np.uint8)).save(root / rel)
            rows.append(f"{rel},{label}")
    (root / "split.csv").write_text("\n".join(rows) + "\n")
    return root


def test_power_usage_matches_jax(aider_dir, classifier_weights, capsys):
    from rtdm_tpu.cli.power_usage import main as jax_main
    from rtdm_tpu_torch.cli.power_usage import main
    weights, engine_dir = classifier_weights
    base = ["--root-dir", str(aider_dir), "--test-split",
            str(aider_dir / "split.csv"), "--test-data-pc", "60",
            "--batch-size", "4", "--chip-watts", "100", "--idle-watts",
            "10"]
    for src in (["--weights", weights, "--precision", "fp32"],
                ["--engine", engine_dir]):
        want = jax_main(base + src)
        got = main(base + src + ["--device", "cpu"])
        assert got["frames"] == want["frames"] == 9
        assert got["total_j"] > 0 and got["mj_per_frame"] > 0
    out = capsys.readouterr().out
    assert "energy/frame" in out and "cpu" in out
    got = main(base[:-4] + ["--weights", weights, "--device", "cpu"])
    assert got["frames"] == 9
