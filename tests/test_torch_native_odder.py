"""``data/odder.py``'s JPEG paths against the JAX package's, bit for bit.

On the example set written with its JPEGs (``write_example_set(jpeg=True)``:
the 10 committed ``docs/examples/*.jpg`` copied byte for byte, with their
labels), both packages decode through their native libjpeg path:
``load_scaled`` (the mosaic tile) at 416 and 208, held to the JAX package
and to ``native_io.npz``; ``load`` in eval, v3 and ``eval_scaleup``, square
and rect; the training sample (mosaic, the warp, HSV, the flip) and the
threaded loader's batches from one seed and hyp. Then the paths that take
PIL in both: ``cache_images``, and every path when the native library is
unavailable (``native_io._load`` returning None in both packages).
Tolerance 0 everywhere.
"""

import numpy as np
import pytest

from rtdm_tpu.data import native_io as jax_io
from rtdm_tpu.data import odder as jodder

from rtdm_tpu_torch.data import native_io
from rtdm_tpu_torch.data import odder as todder
from rtdm_tpu_torch.data.example_set import write_example_set
from tests.torch_port_goldens import (GOLDEN_NATIVE, NATIVE_SCALED,
                                      NATIVE_SQUARE, digest)

HYP = {"degrees": 10.0, "translate": 0.1, "scale": 0.3, "shear": 2.0,
       "mixup": 0.5, "mosaic9": 0.3, "cutout": 0.5}


@pytest.fixture(scope="module")
def jpeg_set(tmp_path_factory):
    return write_example_set(tmp_path_factory.mktemp("jpeg"), jpeg=True)


def _datasets(data, img_size=NATIVE_SQUARE, **kw):
    out = []
    for mod in (todder, jodder):
        spec = mod.load_data_spec(data)
        out.append(mod.DetectionDataset(spec["valid"], img_size,
                                        base_dir=str(spec["base"]), **kw))
    return out


def _assert_same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_set_holds_the_example_jpegs(jpeg_set):
    got, _ = _datasets(jpeg_set)
    assert all(p.endswith(".jpg") for p in got.image_paths)
    assert len(got) == 10 and got.stats["found"] == 10


@pytest.mark.parametrize("size", NATIVE_SCALED)
def test_load_scaled_matches_jax_and_golden(jpeg_set, size):
    """The mosaic tile: the JAX package's shape, from its fp32 rounding of
    h0 * gain (a truncation is one row or column short on 4 frames at 416),
    and its bytes."""
    got, want = _datasets(jpeg_set)
    with np.load(GOLDEN_NATIVE) as g:
        shapes = g[f"scaled_{size}/shape"]
        digests = list(g[f"scaled_{size}/digest"])
    tiles = [got.load_scaled(i, size) for i in range(len(got))]
    assert [t.shape for t in tiles] == [tuple(s) for s in shapes]
    assert [digest(t) for t in tiles] == digests
    for i, t in enumerate(tiles):
        _assert_same(t, want.load_scaled(i, size))
        assert t.flags["C_CONTIGUOUS"] and max(t.shape[:2]) == size


@pytest.mark.parametrize("img_size", [416, 640])
@pytest.mark.parametrize("rect,pad,scaleup", [(False, 0.0, False),
                                              (False, 0.0, True),
                                              (True, 0.0, False),
                                              (True, 0.5, True)])
def test_eval_samples_match_jax(jpeg_set, img_size, rect, pad, scaleup):
    """Image, labels, counts, original size, gain and pad of every sample
    (v3's gain cap 1 binds on the frames smaller than img_size; rect takes
    the cap from the header size)."""
    got, want = _datasets(jpeg_set, img_size, rect=rect, batch_size=4,
                          rect_pad=pad, eval_scaleup=scaleup)
    if rect:
        assert got.rect_shapes == want.rect_shapes
    for i in range(len(want)):
        _assert_same(got.load(i), want.load(i))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_training_sample_matches_jax(jpeg_set, seed):
    """Mosaic (and mosaic9, mixup, cutout by HYP's odds) from native tiles,
    the warp, HSV and the flip, draw for draw from one generator."""
    got, want = _datasets(jpeg_set, train=True, aug_hyp=HYP, seed=seed)
    for i in range(len(got)):
        _assert_same(got.load(i, np.random.default_rng(seed * 100 + i)),
                     want.load(i, np.random.default_rng(seed * 100 + i)))


def test_rect_training_sample_matches_jax(jpeg_set):
    """--rect training: no mosaic, each sample letterboxed natively into its
    bucket at the train gain cap, then the warp."""
    got, want = _datasets(jpeg_set, train=True, rect=True, batch_size=4,
                          aug_hyp=HYP)
    for i in range(len(got)):
        _assert_same(got.load(i, np.random.default_rng(i)),
                     want.load(i, np.random.default_rng(i)))


def test_train_loader_matches_jax(jpeg_set):
    """The threaded loader's mosaic batches, 4 threads a package."""
    got, want = _datasets(jpeg_set, train=True, aug_hyp=HYP, seed=5)
    pairs = zip(todder.DetectionBatchLoader(got, 4, shuffle=True,
                                            num_workers=4, seed=3),
                jodder.DetectionBatchLoader(want, 4, shuffle=True,
                                            num_workers=4, seed=3))
    n = 0
    for (bg, vg), (bw, vw) in pairs:
        assert vg == vw
        _assert_same(bg, bw)
        n += vg
    assert n == len(want)


def test_cache_images_takes_pil_in_both(jpeg_set):
    """With the image cache both packages decode with PIL once and resize
    the cached frame; the tiles differ from the native ones."""
    got, want = _datasets(jpeg_set, cache_images=True)
    native, _ = _datasets(jpeg_set)
    differ = 0
    for i in range(len(got)):
        tile = got.load_scaled(i, 208)
        _assert_same(tile, want.load_scaled(i, 208))
        _assert_same(got.load(i), want.load(i))
        n = native.load_scaled(i, 208)
        differ += tile.shape != n.shape or not np.array_equal(tile, n)
    assert differ


@pytest.mark.parametrize("rect", [False, True])
def test_without_native_io_both_take_pil(jpeg_set, monkeypatch, rect):
    """No native library: every path is PIL's in both packages, equal."""
    monkeypatch.setattr(native_io, "_load", lambda: None)
    monkeypatch.setattr(jax_io, "_load", lambda: None)
    got, want = _datasets(jpeg_set, rect=rect, batch_size=4)
    for i in range(len(got)):
        _assert_same(got.load_scaled(i, 416), want.load_scaled(i, 416))
        _assert_same(got.load(i), want.load(i))
    train_got, train_want = _datasets(jpeg_set, train=True, aug_hyp=HYP)
    _assert_same(train_got.load(0, np.random.default_rng(9)),
                 train_want.load(0, np.random.default_rng(9)))
