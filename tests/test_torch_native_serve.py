"""rtdm-serve's and calibration's JPEG paths against the JAX package's.

- The classify frame (``cli/serve.py::classify_frame``) against JAX's
  ``_native_classify_frame`` and the detect frame (``detect_frame``)
  against what JAX's ``_DetectService`` hands its batcher, bit for bit, on
  the 10 committed example JPEGs and seeded random ones (portrait,
  landscape, square, grayscale, progressive); a PNG body and a JPEG body
  without the native library take PIL in both.
- Both services' handlers on the same bodies, with a stub batcher: the
  frame each batches and the JSON each returns are equal.
- The port's ``_ClassifyService`` with the committed bf16 Squeeze_ErNET
  engine on the CPU serves the golden's classes (``native_io.npz``, the JAX
  server's), ``collapsed_building_image0078`` 4 among them: a PIL decode
  serves it 3.
- ``build_engine.load_detector_calib_images`` against JAX's: a JPEG
  directory (native batch decode) with a slot the native decode fails, and
  a mixed directory (PIL).
"""

import io
import shutil
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from rtdm_tpu.cli import serve as jserve
from rtdm_tpu.data import native_io as jax_io

from rtdm_tpu_torch.cli import serve as tserve
from rtdm_tpu_torch.data import native_io
from tests.torch_native_lock import load_both
from tests.torch_port_goldens import (EXAMPLES, GOLDEN_NATIVE,
                                      NATIVE_SERVE_ENGINE, NATIVE_SERVE_SIZE)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def both_libraries(tmp_path_factory):
    """Both packages' native IO loaded before any comparison
    (``tests/torch_native_lock.py``: the JAX package's first build races
    between test workers)."""
    load_both(tmp_path_factory.getbasetemp().parent)


def _jpeg(h, w, mode="RGB", progressive=False, seed=0) -> bytes:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (127 + 100 * np.sin(xx / 13.0) * np.cos(yy / 29.0))[..., None]
    img = np.clip(base + rng.normal(0, 25, (h, w, 3)), 0, 255)
    img = img.astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img[..., 0] if mode == "L" else img).save(
        buf, "JPEG", quality=85, progressive=progressive)
    return buf.getvalue()


def _png(h, w, seed=0) -> bytes:
    img = np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "PNG")
    return buf.getvalue()


BODIES = {p.stem: p.read_bytes() for p in EXAMPLES}
BODIES.update({"portrait": _jpeg(500, 240), "landscape": _jpeg(240, 320),
               "square": _jpeg(140, 140), "gray": _jpeg(300, 400, "L"),
               "progressive": _jpeg(600, 450, progressive=True),
               "png": _png(200, 300)})


@pytest.mark.parametrize("name", list(BODIES))
@pytest.mark.parametrize("size", [140, 240])
def test_classify_frame_matches_jax(name, size):
    body = BODIES[name]
    got = tserve.classify_frame(body, size)
    want = jserve._native_classify_frame(body, size)
    if want is None:            # a PNG: the JAX server's PIL path
        from rtdm_tpu.cli.aider_predict import preprocess
        want = preprocess(jserve._decode_image(body), size)[0]
        assert name == "png"
    assert got.shape == (size, size, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert got.flags["C_CONTIGUOUS"]


class _Stub:
    """A service without an engine: the batcher records the frame and
    returns fixed rows."""

    def __init__(self, size, rows):
        self.size, self.names, self.frames = size, ["person", "vehicle"], []
        self.rows = rows

    def batcher(self, frame):
        self.frames.append(frame)
        return self.rows


@pytest.mark.parametrize("name", list(BODIES))
def test_detect_handlers_match_jax(name):
    """The frame each ``_DetectService`` batches and the JSON of two fixed
    detections un-letterboxed with the decoder's gain, pads and size."""
    det = np.array([[40, 60, 200, 220, 0.9, 1], [0, 0, 416, 416, 0.5, 0]],
                   np.float32)
    got, want = _Stub(416, (det, 2)), _Stub(416, (det, 2))
    reply = tserve._DetectService.__call__(got, BODIES[name])
    assert reply == jserve._DetectService.__call__(want, BODIES[name])
    np.testing.assert_array_equal(got.frames[0], want.frames[0])
    boxed, gain, pads, orig_hw = tserve.detect_frame(BODIES[name], 416)
    np.testing.assert_array_equal(boxed, got.frames[0])
    if name != "png":
        assert (gain, pads, tuple(orig_hw)) == \
            jax_io.decode_jpeg_letterbox(BODIES[name], 416)[1:]


@pytest.mark.parametrize("name", list(BODIES)[:3] + ["gray", "png"])
def test_classify_handlers_match_jax(name):
    probs = np.array([0.1, 0.2, 0.05, 0.6, 0.05], np.float32)
    got, want = _Stub(140, probs), _Stub(140, probs)
    reply = tserve._ClassifyService.__call__(got, BODIES[name])
    assert reply == jserve._ClassifyService.__call__(want, BODIES[name])
    np.testing.assert_array_equal(got.frames[0], want.frames[0])


@pytest.mark.parametrize("name", [EXAMPLES[0].stem, "gray"])
def test_without_native_io_both_take_pil(monkeypatch, name):
    monkeypatch.setattr(native_io, "_load", lambda: None)
    monkeypatch.setattr(jax_io, "_load", lambda: None)
    body = BODIES[name]
    assert tserve._native_classify_frame(body, 140) is None
    probs = np.ones(5, np.float32) / 5
    got, want = _Stub(140, probs), _Stub(140, probs)
    assert tserve._ClassifyService.__call__(got, body) == \
        jserve._ClassifyService.__call__(want, body)
    np.testing.assert_array_equal(got.frames[0], want.frames[0])
    det = np.zeros((1, 6), np.float32)
    got, want = _Stub(416, (det, 0)), _Stub(416, (det, 0))
    tserve._DetectService.__call__(got, body)
    jserve._DetectService.__call__(want, body)
    np.testing.assert_array_equal(got.frames[0], want.frames[0])


def test_served_classes_equal_the_jax_servers():
    """The JAX server's classes on the 10 examples, through the port's
    service (native frame, micro-batcher, the committed bf16 engine on the
    CPU), the requests sent together: collapsed_building_image0078 is
    served 4, as by JAX (PIL's frame gives 3)."""
    with np.load(GOLDEN_NATIVE) as g:
        golden = dict(g)
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    svc = tserve._ClassifyService(str(NATIVE_SERVE_ENGINE), 50.0, 2,
                                  device="cpu")
    try:
        bodies = [(ROOT / "docs" / "examples" / n).read_bytes()
                  for n in golden["names"]]
        replies = [None] * len(bodies)

        def call(i):
            replies[i] = svc(bodies[i])
        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
    finally:
        svc.batcher.close()
        torch.set_num_threads(saved)
    names = list(tserve.CLASS_NAMES)
    classes = [names.index(r["label"]) for r in replies]
    assert classes == golden["serve_class"].tolist()
    i = list(golden["names"]).index("collapsed_building_image0078.jpg")
    assert classes[i] == 4
    frames = np.stack([tserve.classify_frame(b, NATIVE_SERVE_SIZE)
                       for b in bodies])
    np.testing.assert_array_equal(frames, golden["serve_frames"])


@pytest.fixture()
def calib_dirs(tmp_path):
    """A JPEG directory (4 examples and a PNG named .jpg, which the native
    decode fails and PIL reads) and a mixed one (2 JPEGs, 1 PNG)."""
    jpegs = tmp_path / "jpegs"
    mixed = tmp_path / "mixed"
    jpegs.mkdir()
    mixed.mkdir()
    for p in EXAMPLES[:4]:
        shutil.copyfile(p, jpegs / p.name)
    (jpegs / "b_not_a_jpeg.jpg").write_bytes(BODIES["png"])
    for p in EXAMPLES[4:6]:
        shutil.copyfile(p, mixed / p.name)
    (mixed / "z.png").write_bytes(BODIES["png"])
    return jpegs, mixed


def test_detector_calib_images_match_jax(calib_dirs):
    from rtdm_tpu.cli.build_engine import \
        load_detector_calib_images as jax_calib

    from rtdm_tpu_torch.cli.build_engine import load_detector_calib_images
    for d in calib_dirs:
        for limit in (256, 3):
            got = load_detector_calib_images(str(d), 320, limit=limit)
            want = jax_calib(str(d), 320, limit=limit)
            assert got.dtype == want.dtype == np.uint8
            np.testing.assert_array_equal(got, want)
    jpegs = sorted(str(p) for p in calib_dirs[0].iterdir())
    ok = native_io.decode_batch(jpegs, 320)[4]
    assert ok.sum() == 4 and not ok[list(map(Path, jpegs)).index(
        calib_dirs[0] / "b_not_a_jpeg.jpg")]
