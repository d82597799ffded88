"""The port's tooling CLIs on the CPU against the JAX package:
``pth_to_weights``, ``build_int8_engines``, ``profile_model`` and
``export_model``.

- ``pth_to_weights``: the committed yolov4-tiny as ``.npz`` -> ``.weights``
  (byte-equal to the JAX CLI's file), ``.weights`` -> ``.npz`` and the
  fork's ``.pt`` -> ``.npz`` (trees equal to the JAX CLI's, tolerance 0).
- ``build_int8_engines``: the weights resolve as in JAX; one int8 engine
  per cfg, whose ``act_scales`` equal ``build_engine``'s for the same
  inputs (tolerance 0) and the JAX ``build_int8_engines``' within the
  percentile calibration's rtol 1e-4 (``tests/test_torch_quant.py``).
- ``profile_model``: one row per layer with the JAX package's parameter
  counts (exact), FLOPs that sum to the whole forward's count, and a
  time per layer.
- ``export_model``: the committed Squeeze_ErNET engines (bf16, int8, and
  fp32 from the bf16 weights) and a detector exported with
  ``--dynamic-batch``; the loaded programs hold one ``rtdm::acff_infer``
  node a block and equal the eager forward bit for bit at batch 1 and 5.
  On the same uint8 frames they are held to the JAX package too, at
  ``tests/test_torch_engine.py``'s tolerance for each precision (of the
  largest output, here a softmax probability in both packages: fp32
  1e-4, bf16 2e-2, int8 3e-2; argmax equal) and the
  detector's (rtol 1e-4, atol 1e-4 of max |box|): the fp32 classifier and
  the detector against the JAX ``export_model``'s StableHLO module with a
  dynamic batch, the bf16 and int8 classifiers against the JAX engines.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from rtdm_tpu_torch.models.io import flatten_tree, load_variables

ROOT = Path(__file__).resolve().parents[1]
ENGINES = ROOT / "artifacts" / "engines"
V4 = ENGINES / "yolov4-tiny-mini_int8"


@pytest.fixture(autouse=True)
def two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _assert_trees_equal(got, want):
    got, want = flatten_tree(got), flatten_tree(want)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def v4_files(tmp_path_factory):
    """The committed yolov4-tiny as cfg, ``.npz``, ``.weights`` and the
    fork's ``.pt``."""
    from rtdm_tpu_torch.models.darknet import save_darknet_weights
    from tests.torch_checkpoints import darknet_fork_state_dict
    d = tmp_path_factory.mktemp("v4")
    cfg = d / "yolov4-tiny.cfg"
    cfg.write_text((V4 / "model.txt").read_text())
    variables = load_variables(str(V4 / "params.npz"))
    npz = d / "v4.npz"
    np.savez(npz, **flatten_tree(variables))
    weights = d / "v4.weights"
    save_darknet_weights(variables, cfg.read_text(), str(weights))
    pt = d / "v4.pt"
    torch.save({"model": darknet_fork_state_dict(variables,
                                                 cfg.read_text())}, pt)
    return cfg, npz, weights, pt, variables


def test_pth_to_weights_matches_jax(v4_files, tmp_path):
    from rtdm_tpu.cli import pth_to_weights as jax_cli
    from rtdm_tpu_torch.cli import pth_to_weights
    cfg, npz, weights, pt, variables = v4_files
    got, want = tmp_path / "port.weights", tmp_path / "jax.weights"
    pth_to_weights.main(["--cfg", str(cfg), "--input", str(npz),
                         "--output", str(got)])
    jax_cli.main(["--cfg", str(cfg), "--input", str(npz),
                  "--output", str(want)])
    assert got.read_bytes() == want.read_bytes() == weights.read_bytes()
    for src in (weights, pt):
        out = tmp_path / f"{src.suffix[1:]}_port.npz"
        ref = tmp_path / f"{src.suffix[1:]}_jax.npz"
        pth_to_weights.main(["--cfg", str(cfg), "--input", str(src),
                             "--output", str(out)])
        jax_cli.main(["--cfg", str(cfg), "--input", str(src),
                      "--output", str(ref)])
        _assert_trees_equal(load_variables(str(out)),
                            load_variables(str(ref)))
        _assert_trees_equal(load_variables(str(out)), variables)
    with pytest.raises(SystemExit, match="unsupported output"):
        pth_to_weights.main(["--cfg", str(cfg), "--input", str(npz),
                             "--output", str(tmp_path / "x.onnx")])


def test_resolve_weights_matches_jax(tmp_path):
    from rtdm_tpu.cli.build_int8_engines import \
        resolve_weights as jax_resolve
    from rtdm_tpu_torch.cli.build_int8_engines import resolve_weights
    for name in ("a.npz", "a.pth", "a.pt", "b.npz", "c.weights", "c.pt"):
        (tmp_path / name).write_bytes(b"")
    for stem, want in (("a", "a.pt"), ("b", "b.npz"), ("c", "c.weights"),
                       ("d", None)):
        got = resolve_weights(str(tmp_path), stem)
        assert got == jax_resolve(str(tmp_path), stem)
        assert got == (None if want is None else str(tmp_path / want))


# a narrow darknet cfg and its calibration frames, small enough for the CPU
CALIB_SIZE = 64


def test_build_int8_engines_matches_build_engine_and_jax(tmp_path):
    from rtdm_tpu.cli import build_int8_engines as jax_cli
    from rtdm_tpu_torch.cli import build_engine, build_int8_engines
    from tests.test_torch_detector import CFG
    from tests.torch_checkpoints import randomized_tree
    from PIL import Image
    import jax
    import jax.numpy as jnp
    from rtdm_tpu.models.darknet import Darknet as JaxDarknet

    cfg = tmp_path / "narrow.cfg"
    cfg.write_text(CFG)
    init = jax.device_get(JaxDarknet(cfg_text=CFG).init(
        jax.random.key(0), jnp.zeros((1, CALIB_SIZE, CALIB_SIZE, 3))))
    wdir = tmp_path / "weights"
    wdir.mkdir()
    # an .npz: a .weights file leaves the [acff] block at each package's
    # own init
    np.savez(wdir / "narrow.npz", **flatten_tree(randomized_tree(init, 3)))
    calib = tmp_path / "calib"
    calib.mkdir()
    rng = np.random.default_rng(4)
    for i in range(6):
        Image.fromarray(rng.integers(0, 256, (80, 96, 3), dtype=np.uint8)) \
            .save(calib / f"{i}.png")
    common = ["--cfgs", str(cfg), "--weights-dir", str(wdir),
              "--calib-dir", str(calib), "--img-size", str(CALIB_SIZE),
              "--batch-size", "2", "--calib-method", "percentile"]
    built = build_int8_engines.main(common + ["--output",
                                              str(tmp_path / "port"),
                                              "--device", "cpu"])
    assert [Path(b).name for b in built] == [f"narrow-int8-{CALIB_SIZE}"]
    single = tmp_path / "single"
    build_engine.main(["--cfg", str(cfg), "--weights",
                       str(wdir / "narrow.npz"), "--quant", "int8",
                       "--calib-dir", str(calib), "--calib-method",
                       "percentile", "--img-size", str(CALIB_SIZE),
                       "--batch-size", "2", "--output", str(single),
                       "--device", "cpu"])
    jax_built = jax_cli.main(common + ["--output", str(tmp_path / "jax")])
    with np.load(Path(built[0]) / "act_scales.npz") as a, \
            np.load(single / "act_scales.npz") as b, \
            np.load(Path(jax_built[0]) / "act_scales.npz") as c:
        assert a.files and sorted(a.files) == sorted(b.files) \
            == sorted(c.files)
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
            np.testing.assert_allclose(a[key], c[key], rtol=1e-4,
                                       err_msg=key)
    spec = json.loads((Path(built[0]) / "spec.json").read_text())
    assert spec["quant"] == "int8" and spec["img_size"] == CALIB_SIZE
    with pytest.raises(SystemExit, match="no weights"):
        build_int8_engines.main(["--cfgs", str(cfg), "--weights-dir",
                                 str(calib), "--calib-dir", str(calib),
                                 "--device", "cpu"])


def test_profile_model_rows(tmp_path, capsys):
    """The rows of the narrow v5 yaml of ``tests/test_torch_detector.py``:
    JAX's per-layer parameter counts, the FLOPs of the whole forward in
    sum (convolutions only where a layer has them), a time a layer."""
    import jax
    import jax.numpy as jnp
    from torch.utils.flop_counter import FlopCounterMode
    from rtdm_tpu.models.yolov5 import YoloV5 as JaxYoloV5
    from rtdm_tpu.utils.layer_profile import _params_of_layer
    from rtdm_tpu_torch.cli import profile_model
    from rtdm_tpu_torch.export.detector import load_detection_model
    from tests.test_torch_detector import YAML

    path = tmp_path / "narrow.yaml"
    path.write_text(YAML)
    rows = profile_model.main(["--cfg", str(path), "--img-size", "64",
                               "--iters", "2", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert printed.splitlines()[-1].endswith("total")
    jax_params = JaxYoloV5(yaml_text=YAML).init(
        jax.random.key(0), jnp.zeros((1, 64, 64, 3)))["params"]
    model, _, _ = load_detection_model(str(path), None, 64)
    assert [r["module"] for r in rows] == [e["module"] for e in model.plan]
    assert [r["params"] for r in rows] == [
        _params_of_layer(jax_params, k) for k in range(len(rows))]
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        model.eval()(torch.zeros((1, 64, 64, 3)))
    assert sum(r["flops"] for r in rows) == counter.get_total_flops()
    for r in rows:
        assert (r["flops"] > 0) == (r["module"] not in
                                    ("nn.Upsample", "Concat"))
        assert r["dt_ms"] >= 0


REL_TOL = {"fp32": 1e-4, "bf16": 2e-2, "int8": 3e-2}   # test_torch_engine


def _jax_export(tmp_path, argv):
    """The JAX ``export_model`` CLI's StableHLO module, loaded."""
    from rtdm_tpu.cli import export_model as jax_cli
    from rtdm_tpu.export.serialize import load_exported as jax_load
    out = str(tmp_path / "jax.stablehlo")
    jax_cli.main(argv + ["--output", out, "--dynamic-batch"])
    return jax_load(out)


def _jax_engine(engine, frames):
    """The JAX engine of the committed directory ``engine`` (its spec at
    the frames' batch, its act_scales) on ``frames``."""
    from rtdm_tpu.export.engine import Engine as JaxEngine
    from rtdm_tpu.export.engine import EngineSpec as JaxSpec
    from rtdm_tpu.models.io import load_variables as jax_load_variables
    d = ENGINES / engine
    spec = json.loads((d / "spec.json").read_text())
    spec.update(batch_size=len(frames))
    scales = None
    if (d / "act_scales.npz").exists():
        with np.load(d / "act_scales.npz") as archive:
            scales = dict(archive)
    return JaxEngine(JaxSpec(**spec),
                     jax_load_variables(str(d / "params.npz")),
                     scales)(frames)


@pytest.fixture(scope="module")
def example_frames_140():
    from tests.torch_port_goldens import example_frames
    return example_frames(140)


@pytest.mark.parametrize("engine", ["squeeze-ernet_bf16",
                                    "squeeze-ernet_int8", "fp32"])
def test_export_model_classifier_equals_eager(tmp_path, engine,
                                              example_frames_140):
    """Exported with ``--dynamic-batch`` at batch 1, loaded back, equal to
    the eager engine forward at batch 1 and 5; four ACFF op nodes; within
    the precision's tolerance of the JAX package on the example frames
    (fp32: its exported module; bf16, int8: its engines)."""
    from rtdm_tpu_torch.cli import export_model
    from rtdm_tpu_torch.export.engine import Engine, build_engine
    from rtdm_tpu_torch.export.serialize import load_exported
    bf16 = ENGINES / "squeeze-ernet_bf16"
    out = str(tmp_path / "c.pt2")
    frames = example_frames_140
    if engine == "fp32":
        quant = "fp32"
        eager = build_engine("squeeze-ernet",
                             load_variables(str(bf16 / "params.npz")),
                             "fp32", batch_size=1, verify=False,
                             device="cpu")
        flags = ["--model", "squeeze-ernet", "--weights",
                 str(bf16 / "params.npz")]
        jax_call = _jax_export(tmp_path, flags)
        jax_out = lambda x: np.asarray(jax_call(x))  # noqa: E731
    else:
        quant = engine.rsplit("_", 1)[1]
        eager = Engine.load(str(ENGINES / engine), device="cpu")
        flags = ["--engine", str(ENGINES / engine)]
        want_all = _jax_engine(engine, frames)
        jax_out = lambda x: want_all[:len(x)]  # noqa: E731
    export_model.main(flags + ["--output", out, "--dynamic-batch",
                               "--device", "cpu"])
    program = torch.export.load(out)
    assert sum(n.target is torch.ops.rtdm.acff_infer.default
               for n in program.graph.nodes) == 4
    call = load_exported(out)
    for b in (1, 5):
        x = frames[:b]
        u8 = torch.from_numpy(x)
        with torch.no_grad():
            got = call(u8)
            want = eager._forward(u8)
        assert got.shape == (b, 5)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        ref = jax_out(x)
        np.testing.assert_array_equal(got.numpy().argmax(1), ref.argmax(1))
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=REL_TOL[quant] * np.abs(ref).max())


def test_export_model_detector_equals_eager(v4_files, tmp_path):
    """The detector's forward + ``decode_all`` exported with a dynamic
    batch, loaded back: bit-equal to eager at batch 1 and 5, and within
    rtol 1e-4 / atol 1e-4 of max |box| of the JAX ``export_model``'s
    module on the same frames."""
    from rtdm_tpu_torch.cli import export_model
    from rtdm_tpu_torch.export.detector import load_detection_model
    from rtdm_tpu_torch.export.serialize import load_exported
    from rtdm_tpu_torch.models.io import torch_state_dict_from_variables
    from rtdm_tpu_torch.ops.yolo import decode_all
    cfg, npz, _, _, _ = v4_files
    out = str(tmp_path / "d.pt2")
    export_model.main(["--cfg", str(cfg), "--weights", str(npz),
                       "--img-size", "128", "--batch-size", "2",
                       "--dynamic-batch", "--output", out,
                       "--device", "cpu"])
    jax_call = _jax_export(tmp_path, ["--cfg", str(cfg), "--weights",
                                      str(npz), "--img-size", "128"])
    model, variables, heads = load_detection_model(str(cfg), str(npz), 128)
    model.load_state_dict(torch_state_dict_from_variables(variables))
    model.eval()
    call = load_exported(out)
    for b in (1, 5):
        x = np.random.default_rng(b).integers(0, 256, (b, 128, 128, 3),
                                              dtype=np.uint8)
        u8 = torch.from_numpy(x)
        with torch.no_grad():
            got = call(u8)
            want = decode_all(model(u8.float() / 255.0), heads, 128)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        ref = np.asarray(jax_call(x))
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max())


def test_export_model_refuses_onnx(tmp_path):
    from rtdm_tpu_torch.cli import export_model
    with pytest.raises(SystemExit, match="onnx"):
        export_model.main(["--model", "squeeze-ernet", "--weights", "w.npz",
                           "--output", str(tmp_path / "m.onnx"),
                           "--device", "cpu"])
