"""The port's detector graphs and engine against the JAX package.

Small models with seeded random weights: a darknet cfg that covers
conv/BN/leaky, both max-pools (the size-2 stride-1 one pads with zeros),
``route`` with groups and a route whose sources differ in size (30 -> 32,
a nearest resize with half-pixel centres), a weighted shortcut, upsample,
the additive ``[acff]`` and two ``[yolo]`` heads; and a yolov5 yaml cut to
width 0.125 that covers Focus, Conv, C3 (with and without shortcut), SPP,
Upsample, Concat, an n>1 plain-module repeat and a two-level Detect. Raw
maps in fp32: rtol 1e-4 / atol 1e-4 of max |map| (the convs' sums in
another order). Detector outputs (fp32, bf16, int8) and the committed int8
engines against the JAX golden are held by
``rtdm_tpu_torch.eval.detection.compare_detections``, with both runs' NMS
candidates: two runs whose convolutions sum in another order flip rare
bf16 roundings and int8 codes, and the flips spread (the engine against
itself with float64 sums differs as much as it differs from JAX), so
detections are matched one by one with the gates that module states.
fp32 engines: every matched confidence within 1e-4. The committed
yolov4-tiny engine on the CPU meets the strict gates (equal counts and
classes, boxes within 1 px, confidences within 5e-3).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from rtdm_tpu_torch.eval.detection import (candidates, compare_detections,
                                           meets_strict, per_frame, summary)
from rtdm_tpu_torch.models.io import torch_state_dict_from_variables

# tests/torch_port_goldens.py's paths, named here so that the ``cuda`` test
# imports nothing of ``tests`` (a ``tests`` package elsewhere on the path
# can shadow this directory)
ROOT = Path(__file__).resolve().parents[1]
GOLDEN_DET = ROOT / "tests" / "goldens" / "torch_port" / "detector_int8.npz"
DETECTORS = ("yolov4-tiny-mini_int8", "yolov5s-mini_int8")
EXAMPLES = tuple(sorted((ROOT / "docs" / "examples").glob("*.jpg")))

CFG = """[net]
width=64
height=64
channels=3

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

[route]
layers=-1
groups=2
group_id=1

[convolutional]
batch_normalize=1
filters=8
size=3
stride=1
pad=1
activation=leaky

[shortcut]
from=-2
weights_type=per_feature
activation=linear

[acff]
filters=16
size=3

[maxpool]
size=2
stride=1

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
layers=-4

[convolutional]
batch_normalize=1
filters=8
size=3
stride=2
pad=1
activation=leaky

[upsample]
stride=2

[route]
layers=-1, 2

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

YAML = """# a yolov5s-like graph cut to width 0.125
nc: 2  # classes
depth_multiple: 0.33
width_multiple: 0.125
anchors:
  - [10,13, 16,30, 33,23]  # P2/4
  - [30,61, 62,45, 59,119]  # P3/8
backbone:
  [[-1, 1, Focus, [64, 3]],
   [-1, 1, Conv, [128, 3, 2]],
   [-1, 3, C3, [128]],
   [-1, 1, Conv, [256, 3, 2]],
   [-1, 1, SPP, [256, [5, 9, 13]]],
   [-1, 3, C3, [256, False]],
  ]
head:
  [[-1, 1, Conv, [128, 1, 1]],
   [-1, 1, nn.Upsample, [None, 2, 'nearest']],
   [[-1, 2], 1, Concat, [1]],
   [-1, 1, C3, [128, False]],
   [-1, 6, Conv, [128, 3, 1]],
   [[10, 5], 1, Detect, [nc, anchors]],
  ]
"""

IMG = 64


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    return jax, jnp


def _randomized(jax, variables, seed):
    """The init's tree with random BN statistics, scales and biases, and
    shortcut weights, so that every leaf matters."""
    from rtdm_tpu.models.io import flatten_tree, unflatten_tree
    rng = np.random.default_rng(seed)
    flat = flatten_tree(jax.device_get(variables))
    for key, val in flat.items():
        leaf = key.rsplit("/", 1)[-1]
        if leaf == "var":
            flat[key] = rng.uniform(0.5, 2.0, val.shape).astype(np.float32)
        elif leaf in ("mean", "bias"):
            flat[key] = (0.1 * rng.normal(size=val.shape)).astype(np.float32)
        elif leaf == "scale":
            flat[key] = rng.uniform(0.5, 1.5, val.shape).astype(np.float32)
        elif val.ndim == 1:                       # l{i}_w
            flat[key] = rng.normal(size=val.shape).astype(np.float32)
    return unflatten_tree(flat)


@pytest.fixture(scope="module")
def darknet(jx):
    jax, jnp = jx
    from rtdm_tpu.models.darknet import Darknet
    model = Darknet(cfg_text=CFG)
    variables = model.init(jax.random.key(0), jnp.zeros((1, IMG, IMG, 3)))
    return model, _randomized(jax, variables, 1)


@pytest.fixture(scope="module")
def yolov5(jx):
    jax, jnp = jx
    from rtdm_tpu.models.yolov5 import YoloV5
    model = YoloV5(yaml_text=YAML)
    variables = model.init(jax.random.key(0), jnp.zeros((1, IMG, IMG, 3)))
    return model, _randomized(jax, variables, 2)


@pytest.fixture(scope="module")
def frames():
    from PIL import Image
    imgs = [np.asarray(Image.open(p).convert("RGB").resize((IMG, IMG),
                                                          Image.BILINEAR))
            for p in EXAMPLES[:4]]
    return np.stack(imgs).astype(np.uint8)


def _port_model(family, variables):
    from rtdm_tpu_torch.models.darknet import Darknet
    from rtdm_tpu_torch.models.yolov5 import YoloV5
    net = YoloV5(YAML) if family == "yolov5" else Darknet(CFG)
    net.load_state_dict(torch_state_dict_from_variables(variables),
                        strict=True)
    return net.eval()


@pytest.mark.parametrize("family", ["darknet", "yolov5"])
def test_raw_maps_match_jax_fp32(jx, darknet, yolov5, frames, family):
    jax, jnp = jx
    model, variables = darknet if family == "darknet" else yolov5
    x = frames.astype(np.float32) / 255.0
    want = jax.jit(lambda v, x: model.apply(v, x))(variables, x)
    with torch.inference_mode():
        got = _port_model(family, variables)(torch.from_numpy(x))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())


ACT_CFG = """[net]
width=32
height=32
channels=3

[convolutional]
batch_normalize=1
filters=16
size=3
stride=1
pad=1
activation=frelu

[convolutional]
batch_normalize=1
filters=16
size=3
stride=1
pad=1
groups=2
activation=aconc

[convolutional]
batch_normalize=1
filters=16
size=1
stride=1
pad=1
activation=meta_aconc

[convolutional]
filters=14
size=1
stride=1
pad=1
activation=mish

[yolo]
mask=0,1
anchors=10,14, 23,27
classes=2
"""


def test_parametric_activations_and_groups_match_jax(jx):
    """FReLU, AconC and MetaAconC (their p1/p2/beta and inner convs map by
    name), a grouped conv and mish, in fp32: rtol 1e-4 / atol 1e-4 of max
    |map|."""
    jax, jnp = jx
    from rtdm_tpu.models.darknet import Darknet as JaxDarknet
    from rtdm_tpu_torch.models.darknet import Darknet
    model = JaxDarknet(cfg_text=ACT_CFG)
    variables = _randomized(jax, model.init(jax.random.key(3),
                                            jnp.zeros((1, 32, 32, 3))), 4)
    x = np.random.default_rng(5).uniform(0, 1, (2, 32, 32, 3)).astype(
        np.float32)
    want = np.asarray(jax.jit(lambda v, x: model.apply(v, x))(variables, x)[0])
    net = Darknet(ACT_CFG)
    net.load_state_dict(torch_state_dict_from_variables(variables),
                        strict=True)
    with torch.inference_mode():
        got = net.eval()(torch.from_numpy(x))[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def test_heads_match_jax(darknet, yolov5):
    from rtdm_tpu.export.detector import model_heads as jax_heads
    from rtdm_tpu_torch.export.detector import model_heads
    for family, (model, variables) in (("darknet", darknet),
                                       ("yolov5", yolov5)):
        got = model_heads(_port_model(family, variables))
        want = jax_heads(model, variables)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.anchors_px, w.anchors_px)
            assert (g.num_classes, g.scale_x_y, g.new_coords, g.v5) == (
                w.num_classes, w.scale_x_y, w.new_coords,
                getattr(w, "v5", False))


def test_parsers_match_jax():
    import yaml

    from rtdm_tpu.models.darknet import parse_darknet_cfg as jax_cfg
    from rtdm_tpu_torch.models.darknet import parse_darknet_cfg
    from rtdm_tpu_torch.models.yolov5 import build_plan, parse_v5_yaml
    assert parse_darknet_cfg(CFG) == jax_cfg(CFG)
    engines = ROOT / "artifacts" / "engines"
    v4 = (engines / "yolov4-tiny-mini_int8" / "model.txt").read_text()
    assert parse_darknet_cfg(v4) == jax_cfg(v4)
    v5 = (engines / "yolov5s-mini_int8" / "model.txt").read_text()
    for text in (YAML, v5):
        assert parse_v5_yaml(text) == yaml.safe_load(text)
        assert parse_v5_yaml(text, 3)["nc"] == 3
    from rtdm_tpu.models.yolov5 import build_plan as jax_plan
    got = build_plan(parse_v5_yaml(v5, 2))
    want = jax_plan(yaml.safe_load(v5) | {"nc": 2})
    assert [{k: v for k, v in e.items() if k != "c1"} for e in got] == want


def test_route_resize_is_nearest_with_half_pixel_centres(jx):
    jax, jnp = jx
    from rtdm_tpu.models.darknet import _concat_with_resize as jax_cat
    from rtdm_tpu_torch.models.darknet import _concat_with_resize
    rng = np.random.default_rng(0)
    for small, big in ((15, 32), (13, 26), (7, 9)):
        a = rng.normal(size=(1, small, small, 3)).astype(np.float32)
        b = rng.normal(size=(1, big, big, 2)).astype(np.float32)
        want = np.asarray(jax_cat([jnp.asarray(a), jnp.asarray(b)]))
        got = _concat_with_resize([torch.from_numpy(a), torch.from_numpy(b)])
        np.testing.assert_array_equal(got.numpy(), want)


def _jax_detector(jx, family, variables, spec, act_scales=None):
    from rtdm_tpu.export.detector import Detector, DetectorSpec
    from rtdm_tpu.models.darknet import Darknet
    from rtdm_tpu.models.yolov5 import YoloV5
    model = (YoloV5(yaml_text=YAML) if family == "yolov5"
             else Darknet(cfg_text=CFG))
    return Detector(model, variables, DetectorSpec(**spec), 4,
                    act_scales=act_scales)


def _port_detector(family, variables, spec, act_scales=None):
    from rtdm_tpu_torch.export.detector import Detector, DetectorSpec
    from rtdm_tpu_torch.models.darknet import Darknet
    from rtdm_tpu_torch.models.yolov5 import YoloV5
    model = YoloV5(YAML) if family == "yolov5" else Darknet(CFG)
    return Detector(model, variables, DetectorSpec(**spec), 4,
                    act_scales=act_scales, device="cpu")


SPEC = dict(cfg_name="small", img_size=IMG, conf_thres=0.3, iou_thres=0.45,
            max_det=50, top_k=128)
# Random weights put the small darknet's boxes at 3-14x its 64-px input
# (the exp of large raw w/h logits), where one bf16 step of a logit moves a
# corner by up to 4.4% of the box's side and an int8 code flip by up to
# 10.3% (seed 1, the four frames); so the pixel gate of the committed
# engines gets this share of the side on top, per precision.
BOX_REL = {"fp32": 0.0, "bf16": 0.06, "int8": 0.12}


def _jax_candidates(jx, family, variables, spec, frames, act_scales=None):
    """The rows the JAX detector's NMS sees on ``frames`` (its batch)."""
    from tests.torch_port_goldens import jax_nms_left_out
    with jax_nms_left_out():
        det = _jax_detector(jx, family, variables, spec, act_scales)
    return candidates(np.asarray(det._fn(frames)[0]), spec["conf_thres"])


@pytest.mark.parametrize("quant", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("family", ["darknet", "yolov5"])
def test_detector_matches_jax(jx, darknet, yolov5, frames, family, quant):
    from rtdm_tpu.quant.calibrate import calibrate_detector
    model, variables = darknet if family == "darknet" else yolov5
    scales = (calibrate_detector(model, variables, frames)
              if quant == "int8" else None)
    spec = dict(SPEC, quant=quant)
    want = _jax_detector(jx, family, variables, spec, scales)(frames)
    port = _port_detector(family, variables, spec, scales)
    got = port(frames)
    assert got[0].shape == want[0].shape and got[1].shape == want[1].shape
    assert want[1].sum() > 0
    rep = compare_detections(
        *want, *got, SPEC["conf_thres"], SPEC["iou_thres"],
        _jax_candidates(jx, family, variables, spec, frames, scales),
        candidates(port.predictions(frames), SPEC["conf_thres"]),
        box_rel=BOX_REL[quant])
    assert rep["ok"], rep["failures"]
    if quant == "fp32":
        assert rep["max_conf_diff"] <= 1e-4


@pytest.mark.parametrize("family", ["darknet", "yolov5"])
def test_calibrate_detector_matches_jax(jx, darknet, yolov5, frames, family):
    from rtdm_tpu.quant.calibrate import calibrate_detector as jax_cal
    from rtdm_tpu_torch.quant.calibrate import calibrate_detector
    model, variables = darknet if family == "darknet" else yolov5
    want = jax_cal(model, variables, frames)
    got = calibrate_detector(_port_model(family, variables), frames)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                   err_msg=key)


@pytest.mark.parametrize("family", ["darknet", "yolov5"])
def test_sealed_save_load_round_trip_in_both_packages(
        jx, darknet, yolov5, frames, family, tmp_path):
    """A sealed int8 engine saved by each package loads in both, with the
    same files, and every load gives the live engine's detections."""
    from rtdm_tpu.export.detector import load_detector as jax_load
    from rtdm_tpu.export.detector import save_detector as jax_save
    from rtdm_tpu.quant.calibrate import calibrate_detector
    from rtdm_tpu_torch.export.detector import load_detector, save_detector
    model, variables = darknet if family == "darknet" else yolov5
    scales = calibrate_detector(model, variables, frames)
    spec = dict(SPEC, quant="int8")
    jdet = _jax_detector(jx, family, variables, spec, scales)
    jdet._variables = variables
    pdet = _port_detector(family, variables, spec, scales)
    pdet._variables = variables
    live = pdet(frames)
    jax_save(jdet, str(tmp_path / "jax"), sealed=True)
    save_detector(pdet, str(tmp_path / "port"), sealed=True)
    for name in ("spec.json", "model.txt"):
        j = (tmp_path / "jax" / name).read_text()
        p = (tmp_path / "port" / name).read_text()
        assert (json.loads(p) == json.loads(j)) if name == "spec.json" \
            else p == j
    with np.load(tmp_path / "jax" / "params.npz") as j, \
            np.load(tmp_path / "port" / "params.npz") as p:
        assert sorted(j.files) == sorted(p.files)
        for key in j.files:
            np.testing.assert_array_equal(p[key], j[key], err_msg=key)
    from tests.torch_port_goldens import jax_nms_left_out
    for d in ("jax", "port"):
        port = load_detector(str(tmp_path / d), device="cpu")
        got = port(frames)
        np.testing.assert_array_equal(got[0], live[0])
        np.testing.assert_array_equal(got[1], live[1])
        want = jax_load(str(tmp_path / d), precompiled_ok=False)(frames)
        with jax_nms_left_out():
            decode = jax_load(str(tmp_path / d), precompiled_ok=False)
        rep = compare_detections(
            *want, *got, SPEC["conf_thres"], SPEC["iou_thres"],
            candidates(np.asarray(decode._fn(frames)[0]), SPEC["conf_thres"]),
            candidates(port.predictions(frames), SPEC["conf_thres"]),
            box_rel=BOX_REL["int8"])
        assert rep["ok"], rep["failures"]


def test_load_detector_overrides_and_batch(tmp_path):
    from rtdm_tpu_torch.export.detector import load_detector
    d = str(ROOT / "artifacts" / "engines" / "yolov4-tiny-mini_int8")
    det = load_detector(d, device="cpu", batch_size=2,
                        spec_overrides={"conf_thres": 0.5, "max_det": 7})
    assert det.batch_size == 2 and det.spec.conf_thres == 0.5
    out, count = det(np.zeros((1, 416, 416, 3), np.uint8))
    assert out.shape == (1, 7, 6) and count.shape == (1,)
    with pytest.raises(ValueError):
        det(np.zeros((3, 416, 416, 3), np.uint8))


def test_rectangular_input_matches_jax(jx):
    """An (h, w) letterbox shape other than the square, decoded at its own
    per-axis strides."""
    from rtdm_tpu.export.detector import load_detector as jax_load
    from rtdm_tpu_torch.export.detector import load_detector
    d = str(ROOT / "artifacts" / "engines" / "yolov4-tiny-mini_int8")
    with np.load(GOLDEN_DET) as g:
        x = g["frames_416"][:2, 64:352]                 # (2, 288, 416, 3)
    want = jax_load(d, batch_size=2, precompiled_ok=False)(x)
    got = load_detector(d, device="cpu", batch_size=2)(x)
    rep = compare_detections(*want, *got, 0.25, 0.45)
    assert rep["ok"], rep["failures"]


def test_detector_entry_points_need_cuda_by_default():
    from rtdm_tpu_torch.export.detector import build_detector, load_detector
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    d = str(ROOT / "artifacts" / "engines" / "yolov4-tiny-mini_int8")
    with pytest.raises(RuntimeError, match="CUDA"):
        load_detector(d)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_detector(str(ROOT / "artifacts/engines/yolov4-tiny-mini_int8/"
                           "model.txt"))


def test_left_out_options_raise():
    from rtdm_tpu_torch.export.detector import load_detector
    d = str(ROOT / "artifacts" / "engines" / "yolov4-tiny-mini_int8")
    # TTA is ported (tests/test_torch_detect_cli.py holds it to JAX)
    assert load_detector(d, device="cpu", spec_overrides={"tta": True}
                         ).spec.tta
    # the mesh is ported (tests/test_torch_parallel.py holds 2 ranks to
    # one process); a device that is not the mesh's raises
    from rtdm_tpu_torch.core.mesh import local_mesh
    mesh = local_mesh(device="cpu")
    assert load_detector(d, device="cpu", mesh=mesh).mesh is mesh
    with pytest.raises(ValueError, match="not the mesh's"):
        load_detector(d, device="cuda", mesh=mesh)


def test_build_engine_cli_builds_a_sealed_detector(jx, darknet, tmp_path):
    """--cfg on the small cfg: the port's engine directory against the JAX
    CLI's on the same weights and calibration images."""
    from rtdm_tpu.cli import build_engine as jax_cli
    from rtdm_tpu.models.io import save_variables
    from rtdm_tpu_torch.cli import build_engine as cli
    from rtdm_tpu_torch.export.detector import load_detector
    cfg = tmp_path / "small.cfg"
    cfg.write_text(CFG)
    weights = save_variables(str(tmp_path / "w.npz"), darknet[1])
    calib = tmp_path / "calib"
    calib.mkdir()
    from PIL import Image
    for p in EXAMPLES[:3]:
        # PNGs: the JAX CLI decodes a directory of JPEGs with its native
        # decoder (not ported yet), other images with PIL as the port does
        Image.open(p).convert("RGB").save(calib / (p.stem + ".png"))
    common = ["--cfg", str(cfg), "--weights", weights, "--quant", "int8",
              "--img-size", str(IMG), "--batch-size", "4", "--calib-dir",
              str(calib), "--sealed"]
    cli.main([*common, "--output", str(tmp_path / "port"), "--device", "cpu"])
    jax_cli.main([*common, "--output", str(tmp_path / "jax")])
    with np.load(tmp_path / "port" / "act_scales.npz") as g, \
            np.load(tmp_path / "jax" / "act_scales.npz") as w:
        assert sorted(g.files) == sorted(w.files)
        for key in w.files:
            np.testing.assert_allclose(g[key], w[key], rtol=1e-4)
    with np.load(tmp_path / "port" / "params.npz") as g:
        assert any(k.endswith("kernel.q") for k in g.files)
    det = load_detector(str(tmp_path / "port"), device="cpu")
    assert det.batch_size == 4 and det.spec.quant == "int8"


@pytest.mark.parametrize("case", ["sealed-classifier", "sealed-bf16",
                                  "missing-cfg"])
def test_build_engine_cli_fails_fast(tmp_path, case):
    from rtdm_tpu_torch.cli import build_engine as cli
    cfg = tmp_path / "small.cfg"
    cfg.write_text(CFG)
    extra = {"sealed-classifier": ["--sealed"],
             "sealed-bf16": ["--cfg", str(cfg), "--sealed"],
             "missing-cfg": ["--cfg", str(tmp_path / "missing.cfg")]}[case]
    with pytest.raises(SystemExit):
        cli.main(["--weights", "none.npz", "--output", str(tmp_path / "x"),
                  "--device", "cpu", *extra])


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN_DET) as g:
        return dict(g)


def _golden_run(golden, engine, n):
    """det, count and candidates of the JAX golden on n frames (the 10
    repeated)."""
    frames = [k % len(golden["names"]) for k in range(n)]
    return (golden[f"det_{engine}"][frames], golden[f"count_{engine}"][frames],
            per_frame(golden[f"cand_{engine}"], frames))


def _port_run(det, x):
    return (*det(x), candidates(det.predictions(x), det.spec.conf_thres))


@pytest.mark.parametrize("engine", DETECTORS)
def test_committed_engine_on_the_cpu_matches_the_jax_golden(golden, engine):
    """yolov4-tiny meets the strict gates (equal counts and classes, boxes
    within 1 px, confidences within 5e-3); yolov5s, whose int8 codes flip
    under another summation order, meets compare_detections' gates."""
    from rtdm_tpu_torch.export.detector import load_detector
    det = load_detector(str(ROOT / "artifacts" / "engines" / engine),
                        device="cpu", batch_size=len(golden["names"]))
    want = _golden_run(golden, engine, len(golden["names"]))
    got = _port_run(det, golden["frames_416"])
    rep = compare_detections(*want[:2], *got[:2], 0.25, 0.45, want[2],
                             got[2])
    assert rep["ok"], rep["failures"]
    if engine.startswith("yolov4-tiny"):
        assert meets_strict(rep), summary(rep)


def test_the_gates_fail_the_engine_without_its_qdq(golden):
    """The control that sets the gates' upper side: yolov5s with its
    activation QDQ left out differs from the JAX int8 golden by more than
    the convolutions' summation order can explain; yolov4-tiny without it
    misses the strict gates."""
    from rtdm_tpu_torch.export.detector import load_detector
    for engine in DETECTORS:
        det = load_detector(str(ROOT / "artifacts" / "engines" / engine),
                            device="cpu", batch_size=len(golden["names"]))
        for mod in det.net.modules():
            mod._forward_pre_hooks.clear()
        det._input_scale = None
        want = _golden_run(golden, engine, len(golden["names"]))
        got = _port_run(det, golden["frames_416"])
        rep = compare_detections(*want[:2], *got[:2], 0.25, 0.45, want[2],
                                 got[2])
        assert not meets_strict(rep), summary(rep)
        if engine.startswith("yolov5s"):
            assert not rep["ok"], summary(rep)


def test_detector_golden_is_current(golden):
    from tests import torch_port_goldens as gen
    assert (gen.GOLDEN_DET, gen.DETECTORS, gen.EXAMPLES) == (
        GOLDEN_DET, DETECTORS, EXAMPLES)
    detector_frames, jax_detections = gen.detector_frames, gen.jax_detections
    assert list(golden["names"]) == [p.name for p in EXAMPLES]
    np.testing.assert_array_equal(golden["frames_416"], detector_frames())
    for engine in DETECTORS:
        det, count = jax_detections(engine, golden["frames_416"])
        np.testing.assert_array_equal(det, golden[f"det_{engine}"])
        np.testing.assert_array_equal(count, golden[f"count_{engine}"])
        np.testing.assert_array_equal(
            gen.jax_candidates(engine, golden["frames_416"]),
            golden[f"cand_{engine}"])


def test_letterbox_matches_jax():
    from rtdm_tpu.cli.aider_predict import load_image_rgb
    from rtdm_tpu.data.odder import letterbox_image as jax_letterbox
    from rtdm_tpu_torch.data.odder import PAD_COLOR, letterbox_image
    assert PAD_COLOR == 114
    img = load_image_rgb(str(EXAMPLES[0]))
    for size, cap in ((416, None), ((320, 416), None), (416, 0.5)):
        got, want = letterbox_image(img, size, cap), jax_letterbox(img, size,
                                                                   cap)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]


def test_detector_io_names_round_trip(darknet, yolov5):
    """The detectors' trees (l{i}_conv, the shortcut's l{i}_w, m{i}_{j},
    m{i}/cv1/conv, the Detect convs) map to the port's state_dict and
    back."""
    from rtdm_tpu.models.io import flatten_tree
    from rtdm_tpu_torch.models.io import variables_from_torch_state_dict
    for family, (_, variables) in (("darknet", darknet), ("yolov5", yolov5)):
        net = _port_model(family, variables)
        back = flatten_tree(variables_from_torch_state_dict(net.state_dict()))
        want = flatten_tree(variables)
        assert sorted(back) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(back[key], want[key])
    params = dict(_port_model("darknet", darknet[1]).named_parameters())
    assert "l5_w" in params
    names = dict(_port_model("yolov5", yolov5[1]).named_modules())
    assert {"m10_0", "m10_1", "m11_m0", "m11_m1", "m2.m0.cv1.conv"} <= set(
        names)


@pytest.mark.cuda
def test_cuda_committed_engines_match_the_cpu_port_and_the_golden():
    """On the card: both committed engines against the port on the CPU and
    the JAX golden, by compare_detections' gates (with each run's NMS
    candidates), and yolov4-tiny with equal counts in every frame."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    from rtdm_tpu_torch.export.detector import load_detector
    with np.load(GOLDEN_DET) as g:
        golden = dict(g)
    x = golden["frames_416"]
    for engine in DETECTORS:
        d = str(ROOT / "artifacts" / "engines" / engine)
        card = _port_run(load_detector(d, batch_size=len(x)), x)
        cpu = _port_run(load_detector(d, device="cpu", batch_size=len(x)), x)
        for want in (cpu, _golden_run(golden, engine, len(x))):
            rep = compare_detections(*want[:2], *card[:2], 0.25, 0.45,
                                     want[2], card[2])
            assert rep["ok"], (engine, rep["failures"])
            if engine.startswith("yolov4-tiny"):
                assert rep["count_equal_frames"] == len(x), summary(rep)


def _dets(rows):
    """One frame's detections -> det (1, 32, 6), count (1,)."""
    det = np.zeros((1, 32, 6), np.float32)
    det[0, :len(rows)] = rows
    return det, np.array([len(rows)], np.int32)


P = [100.0, 100.0, 200.0, 180.0, 0.80, 1.0]
Q = [112.0, 104.0, 214.0, 186.0, 0.79, 1.0]        # IoU 0.69 with P
R = [300.0, 40.0, 340.0, 90.0, 0.60, 0.0]
# eight more detections that every case keeps, so that one unmatched pair
# stays within the floor on matched detections
S = [[20.0 + 45 * i, 300.0, 60.0 + 45 * i, 380.0, 0.5 + 0.04 * i, i % 2]
     for i in range(8)]


@pytest.mark.parametrize("case,ok", [
    ("equal", True),
    ("moved_2px", True),
    ("moved_3.5px", False),
    ("conf_0.09", False),
    ("extra_at_conf_edge", True),
    ("extra_confident", False),
    ("nms_flip_in_both_candidate_sets", True),
    ("nms_flip_missing_candidate", False),
    ("too_few_matched", False),
])
def test_compare_detections_gates(case, ok):
    """Each gate of eval/detection.py on one frame: a box moved past BOX_PX,
    a confidence past CONF_TOL, a confident detection one run lacks, an NMS
    decision excused only when both candidates exist in both runs, and the
    floor on matched detections."""
    a, b = [P, R], [P, R]
    cand_a = cand_b = None
    if case == "moved_2px":
        b = [[P[0] + 2, P[1] - 2, P[2] + 2, P[3], P[4], P[5]], R]
    elif case == "moved_3.5px":
        b = [[P[0] + 3.5, P[1], P[2] + 3.5, P[3], P[4], P[5]], R]
    elif case == "conf_0.09":
        b = [P, R[:4] + [R[4] - 0.09, R[5]]]
    elif case == "extra_at_conf_edge":
        b = [P, R, [10.0, 10.0, 40.0, 50.0, 0.27, 1.0]]
    elif case == "extra_confident":
        b = [P, R, [10.0, 10.0, 40.0, 50.0, 0.70, 1.0]]
    elif case.startswith("nms_flip"):
        # run a kept P over Q, run b kept Q (0.81) over P (0.80)
        b = [Q[:4] + [0.81, 1.0], R]
        cand_a = [np.array([P, Q, R])]
        cand_b = [np.array([P, Q[:4] + [0.81, 1.0], R])]
        if case == "nms_flip_missing_candidate":
            cand_b = [np.array([Q[:4] + [0.81, 1.0], R])]
    elif case == "too_few_matched":
        edge = [[i * 20.0, 0.0, i * 20 + 10.0, 10.0, 0.27, 1.0]
                for i in range(6)]
        a, b = [P] + edge, [P]
    a, b = a + S, b + S
    if cand_a is not None:
        cand_a, cand_b = ([np.concatenate([c[0], S])] for c in (cand_a,
                                                                cand_b))
    rep = compare_detections(*_dets(a), *_dets(b), 0.25, 0.45, cand_a, cand_b)
    assert rep["ok"] == ok, summary(rep)
    assert meets_strict(rep) == (case == "equal"), summary(rep)
