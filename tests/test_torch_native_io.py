"""``rtdm_tpu_torch/data/native_io.py`` against ``rtdm_tpu/data/native_io.py``.

Both load a build of the same ``rtdm_io.cpp`` (the port's copy in
``rtdm_tpu_torch/csrc/``, built into ``build/native/``), so every output is
held bit for bit (tolerance 0): the square and rect letterbox decodes at
gain caps 0, 1.0 and the header's, on the 10 committed example JPEGs and on
seeded random JPEGs (two aspects, a large frame, a square one, grayscale,
progressive); ``decode_batch`` with a corrupt and a missing slot;
``letterbox_rgb``; None for a PNG and for a corrupt body. Also: the copy of
the source equals the JAX package's, the library is built under ``build/``
(nothing in ``native/``), the Pillow-bundled libjpeg route, a first use
from 8 threads at once, and the golden ``native_io.npz`` is current.
"""

import io
import threading
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from rtdm_tpu.data import native_io as jax_io

from rtdm_tpu_torch.data import native_io
from rtdm_tpu_torch.ops import kernels
from tests.torch_native_lock import load_both
from tests.torch_port_goldens import (EXAMPLES, GOLDEN_NATIVE, NATIVE_RECT,
                                      NATIVE_SQUARE, digest)

ROOT = Path(__file__).resolve().parents[1]
# seeded random JPEGs: (h, w, mode, progressive)
RANDOM = {"372x350": (372, 350, "RGB", False),
          "1200x1600": (1200, 1600, "RGB", False),
          "416x416": (416, 416, "RGB", False),
          "gray": (300, 500, "L", False),
          "progressive": (480, 360, "RGB", True)}


@pytest.fixture(scope="module", autouse=True)
def both_libraries(tmp_path_factory):
    """Both packages' native IO loaded before any comparison
    (``tests/torch_native_lock.py``: the JAX package's first build races
    between test workers)."""
    load_both(tmp_path_factory.getbasetemp().parent)


def _jpeg(h, w, mode, progressive, seed=0) -> bytes:
    rng = np.random.default_rng(seed)
    # smooth structure plus noise, so the DCT has low and high frequencies
    yy, xx = np.mgrid[0:h, 0:w]
    base = (127 + 100 * np.sin(xx / 17.0) * np.cos(yy / 23.0))[..., None]
    img = np.clip(base + rng.normal(0, 30, (h, w, 3)), 0, 255)
    img = img.astype(np.uint8)
    im = Image.fromarray(img[..., 0] if mode == "L" else img)
    buf = io.BytesIO()
    im.save(buf, "JPEG", quality=90, progressive=progressive)
    return buf.getvalue()


BODIES = {p.stem: p.read_bytes() for p in EXAMPLES}
BODIES.update({k: _jpeg(*v) for k, v in RANDOM.items()})


def _same(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    assert a[0].shape == b[0].shape and a[0].dtype == b[0].dtype == np.uint8
    assert np.array_equal(a[0], b[0])
    assert a[1:] == b[1:]


@pytest.mark.parametrize("name", list(BODIES))
@pytest.mark.parametrize("size", [416, 208, 640])
def test_square_letterbox_matches_jax(name, size):
    body = BODIES[name]
    _same(native_io.decode_jpeg_letterbox(body, size),
          jax_io.decode_jpeg_letterbox(body, size))
    _same(native_io.decode_jpeg_letterbox(body, size, pad_value=0),
          jax_io.decode_jpeg_letterbox(body, size, pad_value=0))


@pytest.mark.parametrize("name", list(BODIES))
@pytest.mark.parametrize("cap", ["0", "1.0", "header"])
def test_rect_letterbox_matches_jax(name, cap):
    """Two buckets, one wider and one taller than most frames, at gain cap
    0 (the fit), 1.0 (v3 eval) and the header cap img_size / max(h, w)."""
    body = BODIES[name]
    w, h = Image.open(io.BytesIO(body)).size
    gain_cap = {"0": 0.0, "1.0": 1.0, "header": 416 / max(h, w)}[cap]
    for out_h, out_w in (NATIVE_RECT, (448, 288)):
        got = native_io.decode_jpeg_letterbox_rect(body, out_h, out_w,
                                                   gain_cap=gain_cap)
        _same(got, jax_io.decode_jpeg_letterbox_rect(body, out_h, out_w,
                                                     gain_cap=gain_cap))
        assert got[0].shape == (out_h, out_w, 3)
        if 0 < gain_cap < min(out_h / h, out_w / w):
            assert got[1] == np.float32(gain_cap)


def test_decode_batch_matches_jax_with_failed_slots(tmp_path):
    """A corrupt file and a missing one fail their slots (pad-filled, ok
    False) in both packages; the others are the single decodes."""
    paths = [str(p) for p in EXAMPLES[:4]]
    corrupt = tmp_path / "corrupt.jpg"
    corrupt.write_bytes(BODIES[EXAMPLES[0].stem][:600])
    paths[1:1] = [str(corrupt), str(tmp_path / "missing.jpg")]
    for nthreads in (0, 1, 3):
        got = native_io.decode_batch(paths, 320, nthreads=nthreads)
        want = jax_io.decode_batch(paths, 320, nthreads=nthreads)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    ok = got[4]
    assert ok.tolist() == [True, False, False, True, True, True]
    assert (got[0][1:3] == 114).all()
    single = native_io.decode_jpeg_letterbox(Path(paths[0]).read_bytes(), 320)
    assert np.array_equal(got[0][0], single[0])
    empty = native_io.decode_batch([], 320)
    assert empty[0].shape == (0, 320, 320, 3) and empty[4].shape == (0,)


@pytest.mark.parametrize("shape", [(240, 320), (640, 480), (100, 100)])
def test_letterbox_rgb_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    frame = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    got = native_io.letterbox_rgb(frame, 256)
    want = jax_io.letterbox_rgb(frame, 256)
    assert np.array_equal(got[0], want[0]) and got[1:] == want[1:]


def test_png_and_corrupt_bodies_give_none():
    buf = io.BytesIO()
    Image.fromarray(np.zeros((32, 48, 3), np.uint8)).save(buf, "PNG")
    body = BODIES[EXAMPLES[0].stem]
    for bad in (buf.getvalue(), body[:600], b"", b"\xff\xd8garbage"):
        for mod in (native_io, jax_io):
            assert mod.decode_jpeg_letterbox(bad, 416) is None
            assert mod.decode_jpeg_letterbox_rect(bad, 320, 416,
                                                  gain_cap=1.0) is None


def test_source_is_the_jax_packages():
    """A change to either copy of rtdm_io.cpp must reach the other."""
    port = ROOT / "rtdm_tpu_torch" / "csrc" / "rtdm_io.cpp"
    assert port.read_bytes() == (ROOT / "native" / "rtdm_io.cpp").read_bytes()


def test_library_is_built_under_build_native():
    assert native_io.available()
    lib = kernels.host_library_path("rtdm_io")
    assert lib.parent == ROOT / "build" / "native" and lib.exists()
    assert lib.name.startswith("librtdm_io-")
    log = lib.with_suffix(".log").read_text()
    assert log.startswith("command: ") and "\nlibjpeg: " in log
    # the port builds nothing in the JAX package's native/
    assert not list((ROOT / "native").glob("librtdm_io-*"))
    assert not list((ROOT / "native").glob("*.tmp"))


def _fresh(monkeypatch, tmp_path, system_headers=True):
    """native_io as a new process finds it: nothing loaded, nothing built
    (the build goes to ``tmp_path``)."""
    monkeypatch.setattr(native_io, "_lib", None)
    monkeypatch.setattr(native_io, "_tried", False)
    monkeypatch.setattr(kernels, "NATIVE_DIR", tmp_path)
    if not system_headers:
        monkeypatch.setattr(kernels, "_SYSTEM_INCLUDE", ())


def test_first_use_from_eight_threads(monkeypatch, tmp_path):
    """The loader's threads reach the first decode together: one builds,
    every thread decodes natively (none falls back), one library results."""
    _fresh(monkeypatch, tmp_path)
    body = BODIES[EXAMPLES[0].stem]
    want = jax_io.decode_jpeg_letterbox(body, 416)
    gate = threading.Barrier(8)
    results = [None] * 8

    def worker(i):
        gate.wait()
        results[i] = native_io.decode_jpeg_letterbox(body, 416)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for got in results:
        _same(got, want)
    assert [p.name for p in tmp_path.iterdir() if p.suffix == ".so"] == [
        kernels.host_library_path("rtdm_io").name]
    assert not list(tmp_path.glob("*.tmp"))


def test_pillow_bundled_libjpeg_route(monkeypatch, tmp_path):
    """Without the system's libjpeg headers the library links the
    libjpeg-turbo of Pillow's wheel, compiled with the headers in
    csrc/jpeg/, and decodes as the JAX package's build does."""
    _fresh(monkeypatch, tmp_path, system_headers=False)
    cflags, ldflags = kernels.libjpeg_flags()
    assert cflags[0] == f"-I{kernels.CSRC / 'jpeg'}"
    assert "pillow.libs" in ldflags[0] and "-ljpeg" not in ldflags
    assert native_io.available()
    log = kernels.host_library_path("rtdm_io").with_suffix(".log")
    assert "pillow.libs" in log.read_text().splitlines()[1]
    for name in (EXAMPLES[0].stem, "gray", "progressive"):
        _same(native_io.decode_jpeg_letterbox(BODIES[name], 416),
              jax_io.decode_jpeg_letterbox(BODIES[name], 416))


def test_unavailable_library_logs_and_returns_none(monkeypatch, tmp_path,
                                                   caplog):
    """A build that fails leaves available() False, with the reason
    logged, and every call None (the callers' PIL path)."""
    _fresh(monkeypatch, tmp_path)

    def no_compiler(src, lib):
        raise RuntimeError("g++ not found")
    monkeypatch.setattr(kernels, "gxx_command", no_compiler)
    with caplog.at_level("WARNING"):
        assert not native_io.available()
    assert "g++ not found" in caplog.text
    assert native_io.decode_jpeg_letterbox(BODIES["gray"], 416) is None
    assert native_io.decode_batch([str(EXAMPLES[0])], 416) is None
    assert native_io.letterbox_rgb(np.zeros((8, 8, 3), np.uint8), 16) is None


def test_golden_is_current():
    """``native_io.npz``'s digests are what the JAX package computes now,
    and the port gives them too."""
    with np.load(GOLDEN_NATIVE) as g:
        golden = dict(g)
    assert list(golden["names"]) == [p.name for p in EXAMPLES]
    bodies = [p.read_bytes() for p in EXAMPLES]
    for mod in (jax_io, native_io):
        sq = [mod.decode_jpeg_letterbox(b, NATIVE_SQUARE) for b in bodies]
        rect = [mod.decode_jpeg_letterbox_rect(b, *NATIVE_RECT, gain_cap=1.0)
                for b in bodies]
        for key, res in (("square", sq), ("rect", rect)):
            assert [digest(r[0]) for r in res] == list(golden[f"{key}/digest"])
            assert np.array_equal([r[1] for r in res],
                                  golden[f"{key}/gain"])
            assert np.array_equal([r[2] for r in res],
                                  golden[f"{key}/pads"])
            assert np.array_equal([r[3] for r in res],
                                  golden[f"{key}/orig_hw"])
        batch = mod.decode_batch([str(p) for p in EXAMPLES], NATIVE_SQUARE)
        assert [digest(f) for f in batch[0]] == list(golden["batch/digest"])
