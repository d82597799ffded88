"""The port's ``AutoShape`` (``rtdm_tpu_torch/export/autoshape.py``)
against JAX's, on the committed yolov4-tiny-mini int8 engine, on the CPU.

Every input kind in one call (file paths, a PIL image, HWC, CHW,
grayscale, floats in [0, 1]), 18 inputs, so the engine's batch of 16 runs
twice, the second chunk short. Each frame's detections, moved back into
its letterboxed frame, are held to JAX's by
``eval/detection.py::compare_detections``; the example photos given as
paths to its strict gates too (equal counts and classes, boxes within
1 px, confidences within 5e-3: the engine on the CPU meets them,
``tests/test_torch_detector.py``). The port's results equal its own
``Detector`` call plus the un-letterbox, exactly.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from rtdm_tpu_torch.eval.detection import (compare_detections, meets_strict,
                                           summary)

ROOT = Path(__file__).resolve().parents[1]
ENGINE = ROOT / "artifacts" / "engines" / "yolov4-tiny-mini_int8"
EXAMPLES = tuple(sorted((ROOT / "docs" / "examples").glob("*.jpg")))
CONF, IOU = 0.25, 0.45   # the engine's spec


@pytest.fixture(autouse=True)
def few_threads():
    """Two torch threads a test: the test run's workers share the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _inputs():
    """18 inputs of every kind, and how many of them are example paths."""
    rgb = [np.asarray(Image.open(p).convert("RGB")) for p in EXAMPLES[:4]]
    rng = np.random.default_rng(0)
    paths = [str(p) for p in EXAMPLES]
    others = [
        Image.open(EXAMPLES[0]),                       # PIL
        rgb[1],                                        # HWC
        np.ascontiguousarray(rgb[2].transpose(2, 0, 1)),   # CHW
        np.asarray(Image.open(EXAMPLES[3]).convert("L")),  # grayscale
        rgb[3].astype(np.float32) / 255.0,             # floats in [0, 1]
        rng.integers(0, 256, (300, 200, 3), dtype=np.uint8),
        np.asarray(Image.open(EXAMPLES[4]).convert("RGBA")),  # 4 channels
        rgb[0][::2, ::3],                              # strided view
    ]
    return paths + others, len(paths)


@pytest.fixture(scope="module")
def results():
    from rtdm_tpu.export.autoshape import AutoShape as JaxAutoShape
    from rtdm_tpu_torch.export.autoshape import AutoShape
    inputs, n_paths = _inputs()
    port = AutoShape(str(ENGINE), device="cpu")
    return (port, port(inputs), JaxAutoShape(str(ENGINE))(inputs), n_paths)


def _to_letterbox(rows, frame, size):
    from rtdm_tpu_torch.data.odder import letterbox_image
    _, gain, (pw, ph) = letterbox_image(frame, size)
    out = np.array(rows, np.float64)
    out[:, [0, 2]] = out[:, [0, 2]] * gain + pw
    out[:, [1, 3]] = out[:, [1, 3]] * gain + ph
    return out


def _padded(rows):
    out = np.zeros((1, max(len(rows), 1), 6))
    out[0, :len(rows)] = rows
    return out, np.array([len(rows)])


def test_autoshape_matches_jax(results):
    port, got, want, n_paths = results
    assert len(got) == len(want) == 18
    assert got.files == want.files and got.names == want.names
    assert got.names == ["person", "vehicle"]
    for k, (frame, wframe) in enumerate(zip(got.images, want.images)):
        np.testing.assert_array_equal(frame, wframe)
        assert frame.dtype == np.uint8 and frame.shape[2] == 3
        a = _to_letterbox(want.xyxy[k], frame, port.detector.spec.img_size)
        b = _to_letterbox(got.xyxy[k], frame, port.detector.spec.img_size)
        rep = compare_detections(*_padded(a), *_padded(b), CONF, IOU)
        assert rep["ok"], f"input {k}: {summary(rep)}"
        if k < n_paths:
            assert meets_strict(rep), f"input {k}: {summary(rep)}"
    assert sum(len(d) for d in got.xyxy) > 0
    assert len(got.summary().splitlines()) == 18


def test_autoshape_equals_detector_and_unletterbox(results):
    from rtdm_tpu_torch.data.odder import letterbox_image
    port, got, _, _ = results
    size = port.detector.spec.img_size
    boxed = [letterbox_image(f, size) for f in got.images]
    for start in (0, 16):
        chunk = boxed[start:start + 16]
        det, cnt = port.detector(np.stack([b[0] for b in chunk]))
        for j, (_, gain, (pw, ph)) in enumerate(chunk):
            h, w = got.images[start + j].shape[:2]
            want = np.array(det[j][:int(cnt[j])], np.float32)
            if want.size:
                want[:, [0, 2]] = ((want[:, [0, 2]] - pw) / gain).clip(0, w)
                want[:, [1, 3]] = ((want[:, [1, 3]] - ph) / gain).clip(0, h)
            np.testing.assert_array_equal(got.xyxy[start + j], want)


def test_detections_views(results, tmp_path):
    port, got, _, _ = results
    recs = got.to_dicts()
    assert [len(r) for r in recs] == [len(d) for d in got.xyxy]
    assert all(r["name"] in ("person", "vehicle") for rr in recs for r in rr)
    rendered = got.render()
    assert [r.shape for r in rendered] == [f.shape for f in got.images]
    saved = got.save(str(tmp_path / "out"))
    assert len(saved) == 18 and len(set(saved)) == 18
    assert all(Path(p).exists() for p in saved)


def test_single_input_and_detector_object(results):
    from rtdm_tpu_torch.export.autoshape import AutoShape
    port, got, _, _ = results
    single = AutoShape(port.detector, names=["a", "b"])(str(EXAMPLES[0]))
    assert len(single) == 1 and single.names == ["a", "b"]
    np.testing.assert_array_equal(single.xyxy[0], got.xyxy[0])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            AutoShape(str(ENGINE))
