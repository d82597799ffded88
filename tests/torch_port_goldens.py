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
compiled decode).
``chip_smoke.py`` reads the files as plain data, which holds a run on the
card against the reference without JAX there; ``tests/test_torch_engine.py``
and ``tests/test_torch_detector.py`` regenerate them in memory and check
that they are current.

Regenerate: JAX_PLATFORMS=cpu python -m tests.torch_port_goldens
[classifier|detector] (both without an argument)
"""

from __future__ import annotations

import contextlib
import json
import os
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "goldens" / "torch_port" / "classifier_logits.npz"
GOLDEN_INT8 = GOLDEN.with_name("classifier_int8_logits.npz")
GOLDEN_DET = GOLDEN.with_name("detector_int8.npz")
DETECTORS = ("yolov4-tiny-mini_int8", "yolov5s-mini_int8")
DETECTOR_SIZE = 416
MODELS = ("squeeze-ernet", "squeeze-redconv", "ernet")
EXAMPLES = tuple(sorted((ROOT / "docs" / "examples").glob("*.jpg")))
GOLDEN_BATCH = 16


def image_size(model: str) -> int:
    return 240 if model == "ernet" else 140


def params_path(model: str) -> str:
    return str(ROOT / "artifacts" / "engines" / f"{model}_bf16" / "params.npz")


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


def jax_candidates(engine: str, frames: np.ndarray) -> np.ndarray:
    """The rows the JAX engine's NMS sees, (M, 7) frame, x1, y1, x2, y2,
    score, cls: the committed engine's program compiled as
    ``load_detector`` compiles it at batch 1, with ``batched_nms`` left
    out, one frame a call."""
    from rtdm_tpu.export.detector import load_detector
    from rtdm_tpu_torch.eval.detection import candidates
    with jax_nms_left_out():
        det = load_detector(str(ROOT / "artifacts" / "engines" / engine),
                            batch_size=1, precompiled_ok=False)
    rows = [candidates(np.asarray(det._fn(frames[i:i + 1])[0]),
                       det.spec.conf_thres)[0] for i in range(len(frames))]
    return np.concatenate([np.c_[np.full(len(r), i), r]
                           for i, r in enumerate(rows)]).astype(np.float32)


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


def make_golden() -> dict:
    out = {"names": np.array([p.name for p in EXAMPLES])}
    for size in (140, 240):
        out[f"frames_{size}"] = example_frames(size)
    for model in MODELS:
        out[model] = jax_logits(model, "fp32",
                                out[f"frames_{image_size(model)}"])
    return out


def main() -> None:
    import sys
    which = sys.argv[1:] or ["classifier", "detector"]
    os.environ["RTDM_XLA_CACHE"] = "0"   # no persistent compile cache
    GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    if "classifier" in which:
        np.savez_compressed(GOLDEN, **make_golden())
        np.savez_compressed(GOLDEN_INT8, **make_int8_golden())
        print(f"wrote {GOLDEN} and {GOLDEN_INT8}")
    if "detector" in which:
        np.savez_compressed(GOLDEN_DET, **make_detector_golden())
        print(f"wrote {GOLDEN_DET}")


if __name__ == "__main__":
    main()
