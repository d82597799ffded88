"""JAX reference logits for the PyTorch/CUDA port.

Writes ``tests/goldens/torch_port/classifier_logits.npz``: the JAX fp32
engine's logits (``with_softmax=False``) of the three classifiers, built
from the committed ``artifacts/engines/<model>_bf16/params.npz``, on the 10
example JPEGs in ``docs/examples/``, together with the preprocessed uint8
frames they were computed on; and
``tests/goldens/torch_port/classifier_int8_logits.npz``: the JAX int8
engines' logits (``with_softmax=False``) on the same frames, each built
from the committed ``artifacts/engines/<model>_int8`` directory with its
``act_scales.npz``; and ``tests/goldens/torch_port/detector_int8.npz``: the
10 examples letterboxed to 416 by the JAX package (``frames_416``), the
JAX ``load_detector`` ``det`` and ``count`` of both committed detector
engines on them at batch 1 (``det_<engine>``, ``count_<engine>``), and the
candidates its NMS saw (``cand_<engine>``, rows frame, x1, y1, x2, y2,
score, cls: ``rtdm_tpu_torch.eval.detection.candidates`` of the engine's
compiled decode); and ``tests/goldens/torch_port/detect_cli.npz``: the JAX
detection CLIs on the committed detector engines (``make_cli_golden``):
``yolo_detect --engine`` rows on ``docs/examples`` with and without the
``--classify`` veto and the veto classifier's logits of each row, TTA
detections and candidates, and ``yolo_test`` metrics on the labelled
example set (``rtdm_tpu_torch/data/example_set.py``); and
``tests/goldens/torch_port/cascade.npz``: the JAX ``build_cascade``
(``rtdm_tpu/cli/cascade_stream.py``) on ``frames_416`` of
``detector_int8.npz``, one frame a call, in fp32 and bf16
(``probs_<q>``, ``det_<q>``, ``count_<q>`` and its NMS candidates
``cand_<q>``) at ``conf_thres`` and ``iou_thres``, with the cfg text of
the committed yolov4-tiny-mini engine, detector weights from the port's
seeded init (``init_darknet``, seed ``CASCADE_SEED``, what the port's
``load_detection_model`` gives without weights, so a run on the card
makes them again without JAX; their ``tree_digest`` is stored) and
Squeeze_ErNET from ``artifacts/engines/squeeze-ernet_bf16/params.npz``;
and ``tests/goldens/torch_port/train.npz``: the JAX classifier trainer
(``make_train_step(mesh=None)``) on Squeeze_ErNET at 140 initialised from
``jax.random.key(TRAIN_SEED)`` (dropout 0; its ``init/`` params and batch
stats), one seeded uint8 batch of ``TRAIN_BATCH`` with its labels, and for
each case of ``TRAIN_CASES`` (policy, optimizer, peak lr; all with weight
decay 0.01, the kernel-only mask, clip 1.0, grad accumulation 2, onecycle
over ``TRAIN_TOTAL`` steps with warmup ``TRAIN_WARMUP``, label smoothing
0.1, no mixing) the per-step ``loss``, ``accuracy`` and ``grad_norm`` of
``TRAIN_STEPS`` steps and the ``final/`` params and batch stats; ``spec``
holds these settings as JSON.
``chip_smoke.py`` reads the files as plain data, which holds a run on the
card against the reference without JAX there; ``tests/test_torch_engine.py``,
``tests/test_torch_detector.py`` and ``tests/test_torch_streaming.py``
regenerate them in memory and check that they are current
(``tests/test_torch_trainer.py`` the train golden's start and case a).

And ``tests/goldens/torch_port/yolo_train.npz``: the JAX detector train
step as ``rtdm_tpu/cli/yolo_train.py::train`` builds it, YOLO_STEPS steps
in each case of ``YOLO_CASES`` from the committed detector engines'
dequantized weights on the 10 example frames (PNG, letterboxed to
YOLO_SIZE by the JAX package; ``images``, ``labels``, ``num_labels``): per
step the loss, its (box, obj, cls) components and the gradients' global
norm, and the leaves ``yolo_leaves`` picks (``<case>/leaves``): the
parameters that moved most, a few BatchNorm statistics and EMA leaves;
``spec`` holds the settings as JSON.

And ``tests/goldens/torch_port/native_io.npz``: the JAX package's native
JPEG paths (``rtdm_tpu/data/native_io.py``) on the 10 example JPEGs
(``make_native_golden``), each output as its shape and the sha256 of its
bytes (``digest``), with the gain, the pads (w, h) and the original (h, w)
where the call returns them: the square letterbox at ``NATIVE_SQUARE``
(``square/``), the rect letterbox at the bucket ``NATIVE_RECT`` with gain
cap 1.0 (``rect/``), ``DetectionDataset.load_scaled`` at each of
``NATIVE_SCALED`` on the set of ``write_example_set(jpeg=True)``
(``scaled_<s>/``), ``decode_batch`` at ``NATIVE_SQUARE`` (``batch/``),
and rtdm-serve's classify frames at ``NATIVE_SERVE_SIZE`` in full
(``serve_frames``) with the probabilities, class and top probability the
JAX server's engine, ``artifacts/engines/squeeze-ernet_bf16``, gives them
(``serve_probs``, ``serve_class``, ``serve_top``).

And ``tests/goldens/torch_port/layout_experiments.npz``
(``make_layout_golden``): the jitted JAX outputs of the layout experiments
on the example frames of ``classifier_logits.npz`` (only outputs; the
inputs are those frames), each from the committed weights: ``split_<model>_
<quant>``, the logits of ``create_model(model, split_fuse=True)`` in fp32
and bf16 on the 10 frames (``jax_split_logits``); ``packed_<model>_<layout>_
<quant>``, the probabilities of ``packed_forward`` at k = ``LAYOUT_K`` on
the first ``LAYOUT_K`` frames, Squeeze_ErNET and ErNET, both layouts,
fp32 and bf16 (``jax_packed_probs``); ``int8_<model>``, the probabilities
of ``int8_classifier_forward`` of each committed ``*_int8`` engine (its
params and act_scales) on the 10 frames (``jax_int8_forward_probs``).

Regenerate: JAX_PLATFORMS=cpu python -m tests.torch_port_goldens
[classifier|detector|cli|cascade|train|yolo_train|native_io|layout] (all
without an argument)
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import tempfile
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "goldens" / "torch_port" / "classifier_logits.npz"
GOLDEN_INT8 = GOLDEN.with_name("classifier_int8_logits.npz")
GOLDEN_DET = GOLDEN.with_name("detector_int8.npz")
GOLDEN_CLI = GOLDEN.with_name("detect_cli.npz")
GOLDEN_CASCADE = GOLDEN.with_name("cascade.npz")
VETO = ("squeeze-ernet",
        str(ROOT / "artifacts" / "engines" / "squeeze-ernet_bf16" /
            "params.npz"))
# yolo_test runs of the golden: (engine, quant, rect, augment)
CLI_TESTS = tuple((e, q, r, False) for e in ("yolov4-tiny-mini_int8",
                                              "yolov5s-mini_int8")
                  for q in ("bf16", "int8") for r in (False, True)) + (
    ("yolov4-tiny-mini_int8", "bf16", False, True),)
CLI_TEST_BATCH = 10
DETECTORS = ("yolov4-tiny-mini_int8", "yolov5s-mini_int8")
DETECTOR_SIZE = 416
MODELS = ("squeeze-ernet", "squeeze-redconv", "ernet")
EXAMPLES = tuple(sorted((ROOT / "docs" / "examples").glob("*.jpg")))
GOLDEN_BATCH = 16
# the cascade: the cfg text of this engine, the port's init at this seed
# (random weights), the threshold at which every frame has detections
# (NMS keeps rows with objectness over it), the classifier's weights
CASCADE_ENGINE = "yolov4-tiny-mini_int8"
CASCADE_SEED = 0
CASCADE_CONF = 0.65
CASCADE_IOU = 0.45
CASCADE_QUANTS = ("fp32", "bf16")
CASCADE_CLS = ("squeeze-ernet", VETO[1])
# the train golden: Squeeze_ErNET at 140 from this key, one batch, and per
# case (precision, optimizer, peak lr)
GOLDEN_TRAIN = GOLDEN.with_name("train.npz")
TRAIN_SEED = 0
TRAIN_BATCH = 16
TRAIN_STEPS = 3
TRAIN_TOTAL = 4          # onecycle: lr peak/25, peak, ~peak/2
TRAIN_WARMUP = 0.5
TRAIN_CASES = {"a": ("fp32", "sgd", 0.05), "b": ("fp32", "adamw", 1e-3),
               "c": ("bf16", "adamw", 1e-3)}
TRAIN_SPEC = {"model": "squeeze-ernet", "image_size": 140, "dropout": 0.0,
              "weight_decay": 0.01, "grad_clip": 1.0, "grad_accum_steps": 2,
              "total_steps": TRAIN_TOTAL, "warmup_ratio": TRAIN_WARMUP,
              "loss": "label_smoothing", "label_smoothing": 0.1,
              "steps": TRAIN_STEPS, "cases": TRAIN_CASES}


def image_size(model: str) -> int:
    return 240 if model == "ernet" else 140


def params_path(model: str) -> str:
    return str(ROOT / "artifacts" / "engines" / f"{model}_bf16" / "params.npz")


def port_model(model: str, variables, quant: str = "fp32",
               split_fuse: bool = True, device="cpu"):
    """The port's classifier on ``device`` in eval mode with the tree's
    weights, its parameters cast to the precision's dtype. The split model
    is ``create_model(model, split_fuse=True)`` given the unsplit model's
    state dict, whose keys it shares."""
    import torch
    from rtdm_tpu_torch.export.engine import EngineSpec, load_model
    from rtdm_tpu_torch.models import create_model
    dtype = {"fp32": torch.float32, "bf16": torch.bfloat16}[quant]
    net = load_model(EngineSpec(model, image_size=image_size(model)),
                     variables, device, dtype)
    if not split_fuse:
        return net
    split = create_model(model, device=device, image_size=image_size(model),
                         split_fuse=True)
    split.load_state_dict(net.state_dict(), strict=True, assign=True)
    return split.eval()


@pytest.fixture(autouse=True)
def two_threads():
    """2 torch threads a test, for the test modules that import this
    fixture: under the parallel test workers, torch on every core of each
    worker slows the float64 and training passes down by two orders of
    magnitude."""
    import torch
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def int8_dir(model: str) -> Path:
    return ROOT / "artifacts" / "engines" / f"{model}_int8"


def example_frames(size: int) -> np.ndarray:
    """The examples through the JAX package's eval transform, (10,s,s,3)."""
    from rtdm_tpu.cli.aider_predict import load_image_rgb, preprocess
    return np.concatenate([preprocess(load_image_rgb(str(p)), size)
                           for p in EXAMPLES])


def jax_logits(model: str, quant: str, frames: np.ndarray) -> np.ndarray:
    """Logits of the JAX engine at ``quant`` on ``frames``."""
    from rtdm_tpu.export.engine import Engine, EngineSpec
    from rtdm_tpu.models.io import load_variables
    spec = EngineSpec(model, quant, GOLDEN_BATCH, image_size(model),
                      with_softmax=False)
    return Engine(spec, load_variables(params_path(model)))(frames)


def jax_int8_logits(model: str, frames: np.ndarray) -> np.ndarray:
    """Logits of the JAX int8 engine of ``int8_dir(model)`` (its params and
    act_scales) on ``frames``."""
    from rtdm_tpu.export.engine import Engine, EngineSpec
    from rtdm_tpu.models.io import load_variables
    d = int8_dir(model)
    spec = json.loads((d / "spec.json").read_text())
    spec.update(batch_size=GOLDEN_BATCH, with_softmax=False)
    with np.load(d / "act_scales.npz") as archive:
        scales = dict(archive)
    return Engine(EngineSpec(**spec), load_variables(str(d / "params.npz")),
                  scales)(frames)


def detector_frames() -> np.ndarray:
    """The examples letterboxed to 416 by the JAX package, (10,416,416,3)."""
    from rtdm_tpu.cli.aider_predict import load_image_rgb
    from rtdm_tpu.data.odder import letterbox_image
    return np.stack([letterbox_image(load_image_rgb(str(p)),
                                     DETECTOR_SIZE)[0] for p in EXAMPLES])


def jax_detections(engine: str, frames: np.ndarray):
    """(det, count) of the JAX ``load_detector`` of the committed engine
    directory at batch 1, one frame a call."""
    from rtdm_tpu.export.detector import load_detector
    det = load_detector(str(ROOT / "artifacts" / "engines" / engine),
                        batch_size=1, precompiled_ok=False)
    out = [det(frames[i:i + 1]) for i in range(len(frames))]
    return (np.concatenate([d for d, _ in out]),
            np.concatenate([c for _, c in out]))


@contextlib.contextmanager
def jax_nms_left_out():
    """A JAX ``Detector`` built inside the ``with`` compiles its program
    without ``batched_nms`` (it binds the function when it is built): the
    program returns the decoded rows NMS would take, and a dummy count."""
    import rtdm_tpu.ops.nms as nms
    plain = nms.batched_nms
    nms.batched_nms = lambda pred, *args, **kwargs: (pred, pred[:, 0, 0])
    try:
        yield
    finally:
        nms.batched_nms = plain


def jax_candidates(engine: str, frames: np.ndarray,
                   overrides=None) -> np.ndarray:
    """The rows the JAX engine's NMS sees, (M, 7) frame, x1, y1, x2, y2,
    score, cls: the committed engine's program compiled as
    ``load_detector`` compiles it at batch 1 (with ``overrides`` of its
    spec), with ``batched_nms`` left out, one frame a call."""
    from rtdm_tpu.export.detector import load_detector
    from rtdm_tpu_torch.eval.detection import candidates
    with jax_nms_left_out():
        det = load_detector(str(ROOT / "artifacts" / "engines" / engine),
                            batch_size=1, precompiled_ok=False,
                            spec_overrides=overrides)
    rows = [candidates(np.asarray(det._fn(frames[i:i + 1])[0]),
                       det.spec.conf_thres)[0] for i in range(len(frames))]
    return np.concatenate([np.c_[np.full(len(r), i), r]
                           for i, r in enumerate(rows)]).astype(np.float32)


def padded_rows(rows) -> tuple:
    """A list of (n_i, 6) arrays -> ((len, max n, 6) zero-padded, counts)."""
    counts = np.array([len(r) for r in rows], np.int32)
    out = np.zeros((len(rows), max(int(counts.max()), 1), 6), np.float32)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out, counts


def jax_yolo_detect(engine: str, out_dir: str, classify: bool) -> list:
    """``rtdm_tpu.cli.yolo_detect.main`` on ``docs/examples`` with the
    committed engine (``--save-txt --txt-format map --nosave``, and the
    veto with ``classify``): one (n, 6) array of rows in original-image
    pixels a frame."""
    from rtdm_tpu.cli.yolo_detect import main
    argv = ["--engine", str(ROOT / "artifacts" / "engines" / engine),
            "--source", str(ROOT / "docs" / "examples"), "--output",
            out_dir, "--save-txt", "--txt-format", "map", "--nosave"]
    if classify:
        argv += ["--classify", VETO[0], "--classifier-weights", VETO[1]]
    return [np.asarray(d, np.float32) for _, d in main(argv)]


def jax_veto_logits(engine: str) -> list:
    """The veto classifier's fp32 logits (bf16 network, as ``yolo_detect
    --classify`` builds it) of each valid row the JAX engine gives a frame
    at batch 1, as ``SecondStageClassifier`` computes them: boxes squared
    and padded, crops resized from the letterboxed frame, normalized."""
    import jax
    import jax.numpy as jnp

    from rtdm_tpu.cli.aider_predict import load_image_rgb
    from rtdm_tpu.core.precision import _cast_floating
    from rtdm_tpu.data.aider import normalize_batch
    from rtdm_tpu.data.odder import letterbox_image
    from rtdm_tpu.export.detector import load_detector
    from rtdm_tpu.export.second_stage import (crop_resize_bilinear,
                                              square_pad_boxes)
    from rtdm_tpu.models import create_model
    from rtdm_tpu.models.io import infer_num_classes, load_variables
    variables = load_variables(VETO[1])
    model = create_model(VETO[0],
                         num_classes=infer_num_classes(variables) or 5)
    vars_c = {"params": _cast_floating(variables["params"], jnp.bfloat16),
              "batch_stats": variables.get("batch_stats", {})}
    size = int(model.image_size)

    @jax.jit
    def logits(frame, det):
        crops = crop_resize_bilinear(frame, square_pad_boxes(det[:, :4]),
                                     (size, size))
        x = normalize_batch(crops).astype(jnp.bfloat16)
        return model.apply(vars_c, x, train=False,
                           apply_softmax=False).astype(jnp.float32)
    det = load_detector(str(ROOT / "artifacts" / "engines" / engine),
                        batch_size=1, precompiled_ok=False)
    out = []
    for p in EXAMPLES:
        frame = letterbox_image(load_image_rgb(str(p)), DETECTOR_SIZE)[0]
        d, c = det(frame[None])
        out.append(np.asarray(logits(jnp.asarray(frame), jnp.asarray(d[0])))
                   [:int(c[0])])
    return out


def jax_yolo_test(engine: str, quant: str, rect: bool, augment: bool,
                  work: str) -> dict:
    """``rtdm_tpu.cli.yolo_test.evaluate`` of the committed engine, written
    as a cfg and dequantized weights, on the labelled example set at batch
    ``CLI_TEST_BATCH``: mp, mr, map50, map, the mean F1 of the classes
    present and, with ``rect``, the bucket shapes."""
    from rtdm_tpu.cli.yolo_test import evaluate
    from rtdm_tpu.data.odder import DetectionDataset, load_data_spec
    from rtdm_tpu_torch.data.example_set import (write_engine_as_cfg,
                                                 write_example_set)
    data = write_example_set(os.path.join(work, "set"))
    cfg, weights = write_engine_as_cfg(ROOT / "artifacts" / "engines" /
                                       engine, os.path.join(work, "models"))
    res = evaluate(cfg, data, weights, DETECTOR_SIZE, CLI_TEST_BATCH,
                   quant=quant, rect=rect, augment=augment,
                   full_map_range=cfg.endswith(".yaml"), num_workers=2)
    pc = res["per_class"]
    out = {"metrics": np.array([res["mp"], res["mr"], res["map50"],
                                res["map"],
                                pc["f1"][pc["classes"]].mean()], np.float64)}
    if rect:
        spec = load_data_spec(data)
        v5 = cfg.endswith(".yaml")
        ds = DetectionDataset(spec["valid"], DETECTOR_SIZE,
                              base_dir=str(spec["base"]), rect=True,
                              batch_size=CLI_TEST_BATCH,
                              rect_pad=0.5 if v5 else 0.0, eval_scaleup=v5)
        out["shapes"] = np.array(ds.rect_shapes, np.int32)
    return out


def cli_test_key(engine: str, quant: str, rect: bool, augment: bool) -> str:
    return (f"test_{engine}_{quant}" + ("_rect" if rect else "")
            + ("_augment" if augment else ""))


def make_cli_golden() -> dict:
    import tempfile

    from rtdm_tpu.cli.aider_predict import load_image_rgb
    from rtdm_tpu.data.odder import letterbox_image
    out = {"names": np.array([p.name for p in EXAMPLES])}
    lb = [letterbox_image(load_image_rgb(str(p)), DETECTOR_SIZE)
          for p in EXAMPLES]
    out["letterbox"] = np.array([[g, *pad] for _, g, pad in lb], np.float32)
    frames = np.stack([f for f, _, _ in lb])
    with tempfile.TemporaryDirectory() as work:
        for engine in DETECTORS:
            out[f"rows_{engine}"], out[f"count_{engine}"] = padded_rows(
                jax_yolo_detect(engine, os.path.join(work, engine), False))
            out[f"veto_rows_{engine}"], out[f"veto_count_{engine}"] = \
                padded_rows(jax_yolo_detect(
                    engine, os.path.join(work, engine + "_veto"), True))
            logits = jax_veto_logits(engine)
            top = max(len(v) for v in logits)
            out[f"veto_logits_{engine}"] = np.stack([
                np.pad(v, ((0, top - len(v)), (0, 0))) for v in logits])
            out[f"tta_det_{engine}"], out[f"tta_count_{engine}"] = \
                jax_tta_detections(engine, frames)
            out[f"tta_cand_{engine}"] = jax_candidates(
                engine, frames, {"tta": True})
        for run in CLI_TESTS:
            res = jax_yolo_test(*run, os.path.join(work, "test"))
            key = cli_test_key(*run)
            out[key] = res["metrics"]
            if "shapes" in res:
                out[key + "_shapes"] = res["shapes"]
    return out


def jax_tta_detections(engine: str, frames: np.ndarray):
    """(det, count) of the JAX engine with TTA at batch 1 on ``frames``."""
    from rtdm_tpu.export.detector import load_detector
    det = load_detector(str(ROOT / "artifacts" / "engines" / engine),
                        batch_size=1, precompiled_ok=False,
                        spec_overrides={"tta": True})
    out = [det(frames[i:i + 1]) for i in range(len(frames))]
    return (np.concatenate([d for d, _ in out]),
            np.concatenate([c for _, c in out]))


def make_detector_golden() -> dict:
    out = {"names": np.array([p.name for p in EXAMPLES]),
           "frames_416": detector_frames()}
    for engine in DETECTORS:
        out[f"det_{engine}"], out[f"count_{engine}"] = jax_detections(
            engine, out["frames_416"])
        out[f"cand_{engine}"] = jax_candidates(engine, out["frames_416"])
    return out


def make_int8_golden() -> dict:
    out = {"names": np.array([p.name for p in EXAMPLES])}
    for model in MODELS:
        out[model] = jax_int8_logits(model, example_frames(image_size(model)))
    return out


GOLDEN_LAYOUT = GOLDEN.with_name("layout_experiments.npz")
LAYOUT_K = 8
PACKED_MODELS = ("squeeze-ernet", "ernet")
LAYOUTS = ("grouped", "dense")
LAYOUT_QUANTS = ("fp32", "bf16")


def _jax_dtype(quant: str):
    import jax.numpy as jnp
    return {"fp32": jnp.float32, "bf16": jnp.bfloat16}[quant]


def jax_split_logits(model: str, quant: str, variables,
                     frames: np.ndarray) -> np.ndarray:
    """Logits of the jitted JAX ``create_model(model, split_fuse=True)`` in
    eval mode, its params cast to ``quant`` (batch statistics fp32, as the
    JAX engine casts them), on uint8 ``frames``."""
    import jax
    import jax.numpy as jnp
    from rtdm_tpu.core.precision import _cast_floating
    from rtdm_tpu.data.aider import normalize_batch
    from rtdm_tpu.models import create_model
    net, dtype = create_model(model, split_fuse=True), _jax_dtype(quant)
    fn = jax.jit(lambda v, u8: net.apply(
        v, normalize_batch(u8).astype(dtype), train=False,
        apply_softmax=False).astype(jnp.float32))
    cast = {"params": _cast_floating(variables["params"], dtype),
            "batch_stats": variables["batch_stats"]}
    return np.asarray(fn(cast, jnp.asarray(frames)))


def jax_packed_probs(model: str, k: int, layout: str, quant: str, variables,
                     frames: np.ndarray) -> np.ndarray:
    """Probabilities of the jitted JAX ``packed_forward`` (the variables an
    argument) on uint8 ``frames``."""
    import jax
    import jax.numpy as jnp
    from rtdm_tpu.models.packed import packed_forward
    fn = jax.jit(packed_forward, static_argnames=(
        "k", "model", "layout", "compute_dtype"))
    return np.asarray(fn(variables, jnp.asarray(frames), k=k, model=model,
                         layout=layout, compute_dtype=_jax_dtype(quant)))


def int8_engine_tree(model: str):
    """(variables, act_scales) of the committed ``int8_dir(model)``."""
    from rtdm_tpu.models.io import load_variables
    with np.load(int8_dir(model) / "act_scales.npz") as archive:
        scales = dict(archive)
    return load_variables(str(int8_dir(model) / "params.npz")), scales


def jax_int8_forward(model: str):
    """The jitted JAX ``int8_classifier_forward`` of the committed int8
    engine of ``model``: uint8 frames -> probabilities."""
    import jax
    from rtdm_tpu.data.aider import normalize_batch
    from rtdm_tpu.models import create_model
    from rtdm_tpu.quant.int8 import int8_classifier_forward
    fwd = int8_classifier_forward(create_model(model),
                                  *int8_engine_tree(model))
    return jax.jit(lambda u8: fwd(normalize_batch(u8)))


def jax_int8_forward_probs(model: str, frames: np.ndarray) -> np.ndarray:
    import jax.numpy as jnp
    return np.asarray(jax_int8_forward(model)(jnp.asarray(frames)))


def make_layout_golden() -> dict:
    from rtdm_tpu.models.io import load_variables
    with np.load(GOLDEN) as g:
        frames = {s: g[f"frames_{s}"] for s in (140, 240)}
    out = {"names": np.array([p.name for p in EXAMPLES])}
    for model in MODELS:
        variables = load_variables(params_path(model))
        x = frames[image_size(model)]
        for quant in LAYOUT_QUANTS:
            out[f"split_{model}_{quant}"] = jax_split_logits(
                model, quant, variables, x)
            if model in PACKED_MODELS:
                for layout in LAYOUTS:
                    out[f"packed_{model}_{layout}_{quant}"] = \
                        jax_packed_probs(model, LAYOUT_K, layout, quant,
                                         variables, x[:LAYOUT_K])
        out[f"int8_{model}"] = jax_int8_forward_probs(model, x)
    return out


def make_golden() -> dict:
    out = {"names": np.array([p.name for p in EXAMPLES])}
    for size in (140, 240):
        out[f"frames_{size}"] = example_frames(size)
    for model in MODELS:
        out[model] = jax_logits(model, "fp32",
                                out[f"frames_{image_size(model)}"])
    return out


def cascade_cfg(directory: str) -> str:
    """The committed yolov4-tiny-mini engine's cfg text, as a .cfg file in
    ``directory``."""
    path = os.path.join(directory, "yolov4-tiny-mini.cfg")
    Path(path).write_text(
        (ROOT / "artifacts" / "engines" / CASCADE_ENGINE / "model.txt")
        .read_text())
    return path


def cascade_det_weights(cfg: str, path: str) -> str:
    """Write the port's seeded init of ``cfg`` to ``path`` (.npz); returns
    its ``tree_digest``."""
    from rtdm_tpu_torch.export.detector import load_detection_model
    from rtdm_tpu_torch.models.io import save_variables, tree_digest
    variables = load_detection_model(cfg, None, DETECTOR_SIZE)[1]
    assert CASCADE_SEED == 0  # load_detection_model's init seed
    save_variables(path, variables)
    return tree_digest(variables)


def jax_cascade(quant: str, cfg: str, det_weights: str,
                frames: np.ndarray) -> dict:
    """The JAX ``build_cascade`` at batch 1, one frame a call: probs, det,
    count, and the candidates its NMS saw (the same program compiled with
    ``batched_nms`` left out), rows frame, x1, y1, x2, y2, score, cls."""
    from rtdm_tpu.cli.cascade_stream import build_cascade
    from rtdm_tpu_torch.eval.detection import candidates
    args = (cfg, det_weights, CASCADE_CLS[0], CASCADE_CLS[1], DETECTOR_SIZE,
            CASCADE_CONF, CASCADE_IOU, quant)
    fn = build_cascade(*args)
    out = [fn(frames[i:i + 1]) for i in range(len(frames))]
    with jax_nms_left_out():
        pred_fn = build_cascade(*args)
    rows = [candidates(np.asarray(pred_fn(frames[i:i + 1])[1]),
                       CASCADE_CONF)[0] for i in range(len(frames))]
    return {f"probs_{quant}": np.concatenate([np.asarray(o[0]) for o in out]),
            f"det_{quant}": np.concatenate([np.asarray(o[1]) for o in out]),
            f"count_{quant}": np.concatenate([np.asarray(o[2])
                                              for o in out]),
            f"cand_{quant}": np.concatenate(
                [np.c_[np.full(len(r), i), r] for i, r in enumerate(rows)]
            ).astype(np.float32)}


def make_cascade_golden() -> dict:
    with np.load(GOLDEN_DET) as g:
        frames = g["frames_416"]
    with tempfile.TemporaryDirectory() as tmp:
        cfg = cascade_cfg(tmp)
        weights = os.path.join(tmp, "det.npz")
        out = {"det_weights_digest": np.array(
            cascade_det_weights(cfg, weights)),
            "conf_thres": np.array(CASCADE_CONF),
            "iou_thres": np.array(CASCADE_IOU)}
        for quant in CASCADE_QUANTS:
            out.update(jax_cascade(quant, cfg, weights, frames))
    return out


def train_batch() -> tuple:
    """The train golden's seeded uint8 batch and int32 labels."""
    rng = np.random.default_rng(TRAIN_SEED)
    images = rng.integers(0, 256, (TRAIN_BATCH, 140, 140, 3), np.uint8)
    return images, rng.integers(0, 5, TRAIN_BATCH).astype(np.int32)


def jax_train_init() -> dict:
    """Squeeze_ErNET's variables from ``jax.random.key(TRAIN_SEED)``."""
    import jax
    import jax.numpy as jnp
    from rtdm_tpu.models import create_model
    model = create_model("squeeze-ernet", dropout_rate=0.0)
    variables = model.init(jax.random.key(TRAIN_SEED),
                           jnp.zeros((1, 140, 140, 3), jnp.float32))
    return jax.device_get(dict(variables))


def jax_train_case(case: str, variables: dict, images: np.ndarray,
                   labels: np.ndarray) -> dict:
    """TRAIN_STEPS steps of the JAX train step in one case: per-step
    metrics and the final variables."""
    import jax
    import jax.numpy as jnp
    from rtdm_tpu.core.precision import policy_from_name
    from rtdm_tpu.data.aider import normalize_batch
    from rtdm_tpu.models import create_model
    from rtdm_tpu.train.losses import make_classification_loss
    from rtdm_tpu.train.schedules import make_optimizer, make_schedule
    from rtdm_tpu.train.trainer import TrainState, make_train_step
    precision, opt, lr = TRAIN_CASES[case]
    sp = TRAIN_SPEC
    model = create_model(sp["model"], dropout_rate=sp["dropout"])
    tx = make_optimizer(opt, make_schedule("onecycle", lr, TRAIN_TOTAL,
                                           TRAIN_WARMUP),
                        sp["weight_decay"], grad_clip=sp["grad_clip"])
    step = make_train_step(
        model, tx, make_classification_loss(
            sp["loss"], label_smoothing=sp["label_smoothing"]),
        policy_from_name(precision), sp["grad_accum_steps"], mesh=None,
        donate=False)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=jax.tree_util.tree_map(
                           jnp.asarray, variables["batch_stats"]),
                       opt_state=tx.init(params))
    x = jax.jit(normalize_batch)(jnp.asarray(images))
    y = jnp.asarray(labels)
    metrics = {"loss": [], "accuracy": [], "grad_norm": []}
    for _ in range(TRAIN_STEPS):
        state, m = step(state, x, y, jax.random.key(1))
        for k in metrics:
            metrics[k].append(float(m[k]))
    out = {k: np.array(v, np.float32) for k, v in metrics.items()}
    out["final"] = jax.device_get({"params": state.params,
                                   "batch_stats": state.batch_stats})
    return out


def make_train_golden(cases=tuple(TRAIN_CASES)) -> dict:
    from rtdm_tpu_torch.models.io import flatten_tree
    variables = jax_train_init()
    images, labels = train_batch()
    out = {"spec": np.array(json.dumps(TRAIN_SPEC)), "images": images,
           "labels": labels}
    out.update({f"init/{k}": v for k, v in flatten_tree(variables).items()})
    for case in cases:
        res = jax_train_case(case, variables, images, labels)
        final = flatten_tree(res.pop("final"))
        out.update({f"{case}/{k}": v for k, v in res.items()})
        out.update({f"{case}/final/{k}": v for k, v in final.items()})
    return out


# the detector train golden: each case (engine, precision, accumulate, EMA)
# takes YOLO_STEPS steps of the JAX train step as yolo_train.train() builds
# it, from the committed engine's dequantized weights, on the 10 example
# frames (PNG, letterboxed to YOLO_SIZE, no augmentation); the optimizer's
# schedules are those of a YOLO_TOTAL-step run of YOLO_STEPS_PER_EPOCH steps
# an epoch; YOLO_FLAGS are the CLI flags of every case
GOLDEN_YOLO = GOLDEN.with_name("yolo_train.npz")
YOLO_SIZE = 416
YOLO_STEPS = 3
YOLO_TOTAL = 100
YOLO_STEPS_PER_EPOCH = 10
YOLO_SEED = 0
YOLO_FLAGS = ["--lr0", "0.01", "--momentum", "0.937", "--weight-decay",
              "0.0005", "--burn-in", "2", "--optimizer", "sgd"]
YOLO_CASES = {"a": ("yolov5s-mini_int8", "fp32", 1, True),
              "b": ("yolov4-tiny-mini_int8", "fp32", 2, False),
              "c": ("yolov5s-mini_int8", "bf16", 1, True)}
YOLO_SPEC = {"img_size": YOLO_SIZE, "steps": YOLO_STEPS,
             "total_steps": YOLO_TOTAL,
             "steps_per_epoch": YOLO_STEPS_PER_EPOCH, "seed": YOLO_SEED,
             "flags": YOLO_FLAGS, "cases": YOLO_CASES}
# what the golden keeps of each step: the largest-moving parameter leaves
# of at most YOLO_LEAF_MAX elements, the BatchNorm statistics of a few
# layers and a few EMA leaves
YOLO_PARAM_LEAVES = 4
YOLO_STAT_LEAVES = 4
YOLO_LEAF_MAX = 20000


def yolo_batch(work: str) -> dict:
    """The example set as one eval batch at YOLO_SIZE (images, labels,
    num_labels), by the JAX package."""
    from rtdm_tpu.data.odder import DetectionDataset, load_data_spec

    from rtdm_tpu_torch.data.example_set import write_example_set
    spec = load_data_spec(write_example_set(work))
    ds = DetectionDataset(spec["valid"], YOLO_SIZE, base_dir=spec["base"],
                          num_classes=2)
    samples = [ds.load(i) for i in range(len(ds))]
    return {k: np.stack([s[k] for s in samples])
            for k in ("image", "labels", "num_labels")}


def jax_yolo_optimizer(args, is_v5: bool, steps_per_epoch: int,
                       total: int, hyp_file=None):
    """The optax chain ``rtdm_tpu/cli/yolo_train.py::train`` builds
    (:363-450) for these CLI ``args``, with the run's steps per epoch and
    total steps and its hyp file."""
    import jax
    import jax.numpy as jnp
    import optax

    from rtdm_tpu.train.schedules import kernel_only_mask
    hyp_file = hyp_file or {}
    if not is_v5:
        cosine = optax.cosine_decay_schedule(
            args.lr0, max(total - args.burn_in, 1),
            alpha=10.0 ** (args.lrf if args.lrf is not None else -4.0))
        schedule = optax.join_schedules(
            [optax.linear_schedule(0.0, args.lr0, max(args.burn_in, 1)),
             cosine], [max(args.burn_in, 1)])
        if args.optimizer == "sgd":
            return optax.chain(
                optax.clip_by_global_norm(10.0),
                optax.add_decayed_weights(args.weight_decay,
                                          mask=kernel_only_mask),
                optax.sgd(schedule, momentum=args.momentum, nesterov=True))
        return optax.chain(optax.clip_by_global_norm(10.0),
                           optax.adamw(schedule,
                                       weight_decay=args.weight_decay,
                                       mask=kernel_only_mask))
    nw = int(max(round(hyp_file.get("warmup_epochs", 3.0)
                       * steps_per_epoch), 1000))
    nw = max(min(nw, total // 2), 1)
    v5_lrf = (10.0 ** args.lrf if args.lrf is not None
              else float(hyp_file.get("lrf", 0.2)))
    if args.linear_lr:
        def base_sched(step):
            x = jnp.clip(step / total, 0.0, 1.0)
            return args.lr0 * ((1.0 - x) * (1.0 - v5_lrf) + v5_lrf)
    else:
        base_sched = optax.cosine_decay_schedule(args.lr0, total,
                                                 alpha=v5_lrf)
    warm_bias_lr = float(hyp_file.get("warmup_bias_lr", 0.1))
    warm_mom = float(hyp_file.get("warmup_momentum", 0.8))

    def _warm(step, y0, y1_fn):
        w = jnp.clip(step / nw, 0.0, 1.0)
        return (1.0 - w) * y0 + w * y1_fn(step)

    def bias_lr(step):
        return _warm(step, warm_bias_lr, base_sched)

    def rest_lr(step):
        return _warm(step, 0.0, base_sched)

    def momentum_sched(step):
        return _warm(step, warm_mom, lambda _: args.momentum)

    def bias_mask(params):
        def walk(tree):
            return {k: (walk(v) if isinstance(v, dict) else k == "bias")
                    for k, v in tree.items()}
        return walk(params)

    def rest_mask(params):
        return jax.tree_util.tree_map(lambda m: not m, bias_mask(params))

    if args.optimizer == "sgd":
        sgd_inj = optax.inject_hyperparams(optax.sgd,
                                           static_args=("nesterov",))
        inner_bias = sgd_inj(learning_rate=bias_lr, momentum=momentum_sched,
                             nesterov=True)
        inner_rest = sgd_inj(learning_rate=rest_lr, momentum=momentum_sched,
                             nesterov=True)
    else:
        inner_bias = optax.adam(bias_lr)
        inner_rest = optax.adam(rest_lr)
    return optax.chain(
        optax.clip_by_global_norm(10.0),
        optax.add_decayed_weights(args.weight_decay, mask=kernel_only_mask),
        optax.masked(inner_bias, bias_mask),
        optax.masked(inner_rest, rest_mask))


def jax_yolo_case(case: str, batch: dict, work: str, steps=YOLO_STEPS,
                  mesh=None) -> dict:
    """``steps`` steps of the JAX detector train step in one case, built
    as ``rtdm_tpu/cli/yolo_train.py::train`` builds it (the loss, the
    optimizer chain of the family, the microbatch scan, BN burn-in as the
    family's default, the EMA): per step the loss, its components, the
    gradients' global norm and the flat variables (and EMA). ``mesh``: the
    step jitted over it as the JAX CLI's is, the batch sharded over its
    'data' axis and the state replicated."""
    import jax
    import jax.numpy as jnp
    import optax

    from rtdm_tpu.cli.yolo_detect import load_weights_for_cfg
    from rtdm_tpu.cli.yolo_train import parse_args
    from rtdm_tpu.export.detector import model_heads
    from rtdm_tpu.train.ema import ema_init, ema_update
    from rtdm_tpu.train.yolo_loss import (YoloHyp, YoloHypV5,
                                          scale_v5_gains, yolo_loss,
                                          yolo_loss_v5)

    from rtdm_tpu_torch.data.example_set import write_engine_as_cfg
    from rtdm_tpu_torch.models.io import flatten_tree
    engine, precision, accumulate, use_ema = YOLO_CASES[case]
    cfg, weights = write_engine_as_cfg(ROOT / "artifacts" / "engines" /
                                       engine, work)
    args = parse_args(["--cfg", cfg, "--weights", weights, "--img-size",
                       str(YOLO_SIZE), "--precision", precision]
                      + YOLO_FLAGS)
    is_v5 = cfg.endswith(".yaml")
    model, variables = load_weights_for_cfg(cfg, weights, YOLO_SIZE,
                                            num_classes=2 if is_v5 else None)
    heads = model_heads(model, variables)
    if is_v5:
        hyp = scale_v5_gains(YoloHypV5(), nl=len(heads), nc=2,
                             img_size=YOLO_SIZE)
        loss_impl = yolo_loss_v5
    else:
        hyp = YoloHyp(giou=args.giou_gain, cls=args.cls_gain,
                      obj=args.obj_gain, iou_t=args.iou_t, fl_gamma=1.5)
        loss_impl = yolo_loss
    tx = jax_yolo_optimizer(args, is_v5, YOLO_STEPS_PER_EPOCH, YOLO_TOTAL)
    update_bn = is_v5          # darknet: BN burn-in of 200 steps
    dtype = jnp.bfloat16 if precision == "bf16" else jnp.float32

    def loss_fn(params, batch_stats, images, labels, nlab, rng):
        x = images.astype(dtype) / 255.0
        raw, mutated = model.apply(
            {"params": params, "batch_stats": batch_stats}, x,
            train=True, mutable=["batch_stats"], rngs={"dropout": rng})
        loss, comps = loss_impl(raw, heads, labels, nlab, YOLO_SIZE, hyp)
        return loss, (mutated["batch_stats"], comps)

    def step(params, batch_stats, opt_state, ema, images, labels, nlab,
             rng, step_i):
        mb_i = images.reshape((accumulate, -1) + images.shape[1:])
        mb_l = labels.reshape((accumulate, -1) + labels.shape[1:])
        mb_n = nlab.reshape((accumulate, -1))

        def body(carry, mb):
            stats, gsum, lsum, comp_sum, k = carry
            im, lb, nl = mb
            (loss, (stats, comps)), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(params, stats, im, lb, nl,
                                       jax.random.fold_in(rng, k))
            gsum = jax.tree_util.tree_map(jnp.add, gsum, grads)
            comp_vec = jnp.stack([comps["box"], comps["obj"], comps["cls"]])
            return (stats, gsum, lsum + loss, comp_sum + comp_vec,
                    k + 1), None

        zeros = jax.tree_util.tree_map(jnp.zeros_like, params)
        (new_stats, grads, loss, comps, _), _ = jax.lax.scan(
            body, (batch_stats, zeros, jnp.zeros(()), jnp.zeros((3,)),
                   jnp.zeros((), jnp.int32)), (mb_i, mb_l, mb_n))
        grads = jax.tree_util.tree_map(lambda g: g / accumulate, grads)
        grad_norm = optax.global_norm(grads)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        new_stats = new_stats if update_bn else batch_stats
        if use_ema:
            ema = ema_update(ema, {"params": params,
                                   "batch_stats": new_stats}, step_i)
        return (params, new_stats, opt_state, ema, loss / accumulate,
                comps / accumulate, grad_norm)

    if mesh is None:
        step = jax.jit(step)
    else:
        from jax.sharding import NamedSharding, PartitionSpec as P
        repl, dsh = NamedSharding(mesh, P()), NamedSharding(mesh, P("data"))
        step = jax.jit(step, in_shardings=(repl,) * 4 + (dsh,) * 3
                       + (repl,) * 2, out_shardings=repl)
    params = variables["params"]
    batch_stats = variables.get("batch_stats", {})
    opt_state = tx.init(params)
    ema = ema_init({"params": params, "batch_stats": batch_stats}) \
        if use_ema else {}
    rng = jax.random.key(YOLO_SEED)
    images = jnp.asarray(batch["image"])
    labels = jnp.asarray(batch["labels"])
    nlab = jnp.asarray(batch["num_labels"])
    out = {"init": flatten_tree(jax.device_get(
        {"params": params, "batch_stats": batch_stats})),
        "loss": [], "comps": [], "grad_norm": [], "vars": [], "ema": []}
    for it in range(steps):
        params, batch_stats, opt_state, ema, loss, comps, norm = step(
            params, batch_stats, opt_state, ema, images, labels, nlab,
            jax.random.fold_in(rng, it), jnp.asarray(it, jnp.int32))
        out["loss"].append(float(loss))
        out["comps"].append(np.asarray(comps, np.float32))
        out["grad_norm"].append(float(norm))
        out["vars"].append(flatten_tree(jax.device_get(
            {"params": params, "batch_stats": batch_stats})))
        if use_ema:
            out["ema"].append(flatten_tree(jax.device_get(ema)))
    return out


def yolo_leaves(res: dict) -> dict:
    """The leaves a case keeps: the YOLO_PARAM_LEAVES params of at most
    YOLO_LEAF_MAX elements that moved most (max |final - init|), every
    4th-ranked BatchNorm statistic up to YOLO_STAT_LEAVES, and for the EMA
    the first two of those params and the first statistic."""
    init, final = res["init"], res["vars"][-1]
    params = sorted((k for k in final if k.startswith("params/")
                     and final[k].size <= YOLO_LEAF_MAX),
                    key=lambda k: -float(np.abs(final[k] - init[k]).max()))
    stats = sorted(k for k in final if k.startswith("batch_stats/"))
    stats = stats[::max(len(stats) // YOLO_STAT_LEAVES, 1)][
        :YOLO_STAT_LEAVES]
    chosen = {"params": params[:YOLO_PARAM_LEAVES], "stats": stats}
    chosen["ema"] = (chosen["params"][:2] + stats[:1]) if res["ema"] else []
    return chosen


GOLDEN_NATIVE = GOLDEN.with_name("native_io.npz")
NATIVE_SQUARE = 416
NATIVE_RECT = (320, 416)          # one rect bucket (h, w), gain cap 1.0
NATIVE_SCALED = (416, 208)
NATIVE_SERVE_SIZE = 140
NATIVE_SERVE_ENGINE = ROOT / "artifacts" / "engines" / "squeeze-ernet_bf16"


def digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def native_records(prefix: str, results) -> dict:
    """``results``: per image (frame, gain, (pad_w, pad_h), (orig_h,
    orig_w)) -> the golden's arrays under ``prefix/``."""
    return {f"{prefix}/digest": np.array([digest(r[0]) for r in results]),
            f"{prefix}/shape": np.array([r[0].shape for r in results]),
            f"{prefix}/gain": np.array([r[1] for r in results], np.float32),
            f"{prefix}/pads": np.array([r[2] for r in results], np.float32),
            f"{prefix}/orig_hw": np.array([r[3] for r in results])}


def make_native_golden() -> dict:
    from rtdm_tpu.cli.serve import _native_classify_frame
    from rtdm_tpu.data import native_io
    from rtdm_tpu.data.odder import DetectionDataset, load_data_spec
    from rtdm_tpu.export.engine import Engine

    from rtdm_tpu_torch.data.example_set import write_example_set
    assert native_io.available(), "the JAX native library does not load"
    bodies = [p.read_bytes() for p in EXAMPLES]
    out = {"names": np.array([p.name for p in EXAMPLES])}
    out.update(native_records("square", [
        native_io.decode_jpeg_letterbox(b, NATIVE_SQUARE) for b in bodies]))
    out.update(native_records("rect", [
        native_io.decode_jpeg_letterbox_rect(b, *NATIVE_RECT, gain_cap=1.0)
        for b in bodies]))
    batch, gains, pads, orig, ok = native_io.decode_batch(
        [str(p) for p in EXAMPLES], NATIVE_SQUARE)
    assert ok.all()
    out.update(native_records("batch", [
        (batch[i], gains[i], tuple(pads[i]), tuple(orig[i]))
        for i in range(len(EXAMPLES))]))
    with tempfile.TemporaryDirectory() as work:
        spec = load_data_spec(write_example_set(work, jpeg=True))
        ds = DetectionDataset(spec["valid"], NATIVE_SQUARE,
                              base_dir=str(spec["base"]))
        for size in NATIVE_SCALED:
            tiles = [ds.load_scaled(i, size) for i in range(len(ds))]
            out[f"scaled_{size}/digest"] = np.array([digest(t)
                                                     for t in tiles])
            out[f"scaled_{size}/shape"] = np.array([t.shape for t in tiles])
    frames = np.stack([_native_classify_frame(b, NATIVE_SERVE_SIZE)
                       for b in bodies])
    probs = np.asarray(Engine.load(str(NATIVE_SERVE_ENGINE))(frames),
                       np.float32)
    out.update(serve_frames=frames, serve_probs=probs,
               serve_class=probs.argmax(1), serve_top=probs.max(1))
    return out


def make_yolo_train_golden(cases=tuple(YOLO_CASES)) -> dict:
    with tempfile.TemporaryDirectory() as work:
        batch = yolo_batch(os.path.join(work, "examples"))
        out = {"spec": np.array(json.dumps(YOLO_SPEC)),
               "images": batch["image"], "labels": batch["labels"],
               "num_labels": batch["num_labels"]}
        for case in cases:
            res = jax_yolo_case(case, batch, os.path.join(work, case))
            chosen = yolo_leaves(res)
            out[f"{case}/leaves"] = np.array(json.dumps(chosen))
            out[f"{case}/loss"] = np.array(res["loss"], np.float32)
            out[f"{case}/comps"] = np.stack(res["comps"])
            out[f"{case}/grad_norm"] = np.array(res["grad_norm"], np.float32)
            for k in chosen["params"] + chosen["stats"]:
                out[f"{case}/vars/{k}"] = np.stack([v[k]
                                                    for v in res["vars"]])
            for k in chosen["ema"]:
                out[f"{case}/ema/{k}"] = np.stack([v[k] for v in res["ema"]])
    return out


def main() -> None:
    import sys
    which = sys.argv[1:] or ["classifier", "detector", "cli", "cascade",
                             "train", "yolo_train", "native_io",
                             "layout"]
    os.environ["RTDM_XLA_CACHE"] = "0"   # no persistent compile cache
    GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    if "classifier" in which:
        np.savez_compressed(GOLDEN, **make_golden())
        np.savez_compressed(GOLDEN_INT8, **make_int8_golden())
        print(f"wrote {GOLDEN} and {GOLDEN_INT8}")
    if "detector" in which:
        np.savez_compressed(GOLDEN_DET, **make_detector_golden())
        print(f"wrote {GOLDEN_DET}")
    if "cli" in which:
        np.savez_compressed(GOLDEN_CLI, **make_cli_golden())
        print(f"wrote {GOLDEN_CLI}")
    if "cascade" in which:
        np.savez_compressed(GOLDEN_CASCADE, **make_cascade_golden())
        print(f"wrote {GOLDEN_CASCADE}")
    if "train" in which:
        np.savez_compressed(GOLDEN_TRAIN, **make_train_golden())
        print(f"wrote {GOLDEN_TRAIN}")
    if "yolo_train" in which:
        np.savez_compressed(GOLDEN_YOLO, **make_yolo_train_golden())
        print(f"wrote {GOLDEN_YOLO}")
    if "native_io" in which:
        np.savez_compressed(GOLDEN_NATIVE, **make_native_golden())
        print(f"wrote {GOLDEN_NATIVE}")
    if "layout" in which:
        np.savez_compressed(GOLDEN_LAYOUT, **make_layout_golden())
        print(f"wrote {GOLDEN_LAYOUT}")


if __name__ == "__main__":
    main()
