"""The detector training data of the port against the JAX package, bit for
bit, on a seeded set of PNG frames of mixed sizes (64-160 px) with YOLO
labels:

- every augmentation of ``data/yolo_augment.py`` (HSV, the affine warp,
  mosaic, mosaic9, mixup, cutout) from equal generators: equal images and
  labels;
- ``DetectionDataset(train=True)``'s sample (mosaic with mixup, mosaic9,
  cutout, the warp, HSV and the flip drawn in turn; and in rect mode) and
  the RAM caches: equal;
- ``image_weights`` and ``DetectionBatchLoader``'s epoch order and batches
  (shuffled, drawn by image weight, rect) over two epochs: equal;
- the multi-scale resize (``export/detector.py::resize_bilinear`` with
  ``fused``, the antialiased bilinear of ``jax.image.resize``) against the jitted JAX
  resize at every size of ``multi_scale_sizes(128)``, one that shrinks:
  within ``RESIZE_TOL`` (3e-5 absolute on 0-255 values, two fp32 ulps
  there; read: one ulp, 1.5e-5; the weights are the jitted function's
  bit for bit at these sizes, the sums run in another order); the
  control, ``F.interpolate`` without antialiasing, misses it where the
  batch shrinks.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

RESIZE_TOL = 3e-5
SIZES = ((96, 128), (160, 120), (64, 64), (128, 72), (100, 150),
         (140, 140), (80, 112), (150, 90))
HYP = {"degrees": 10.0, "translate": 0.1, "scale": 0.3, "shear": 2.0,
       "mixup": 0.5, "mosaic9": 0.3, "cutout": 0.5}


@pytest.fixture(scope="module")
def png_set(tmp_path_factory):
    """A list file of PNG frames at SIZES with 0-4 labels each."""
    from PIL import Image
    root = tmp_path_factory.mktemp("aug")
    (root / "images").mkdir()
    (root / "labels").mkdir()
    rng = np.random.default_rng(0)
    paths = []
    for i, (h, w) in enumerate(SIZES):
        img = rng.integers(0, 256, (h, w, 3), np.uint8)
        Image.fromarray(img).save(root / "images" / f"{i}.png")
        rows = []
        for _ in range(int(rng.integers(0, 5))):
            bw, bh = rng.uniform(0.1, 0.5, 2)
            cx, cy = rng.uniform(bw / 2, 1 - bw / 2), rng.uniform(
                bh / 2, 1 - bh / 2)
            rows.append(f"{int(rng.integers(0, 2))} {cx:.6f} {cy:.6f} "
                        f"{bw:.6f} {bh:.6f}")
        (root / "labels" / f"{i}.txt").write_text("".join(
            r + "\n" for r in rows))
        paths.append(str(root / "images" / f"{i}.png"))
    listing = root / "train.txt"
    listing.write_text("".join(p + "\n" for p in paths))
    return str(listing)


def _datasets(listing, **kw):
    from rtdm_tpu.data.odder import DetectionDataset as JaxDataset

    from rtdm_tpu_torch.data.odder import DetectionDataset
    kw = {"base_dir": "/", "num_classes": 2, **kw}
    return (DetectionDataset(listing, 128, **kw),
            JaxDataset(listing, 128, **kw))


def _same(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_augmentations_are_bit_equal(png_set):
    from rtdm_tpu.data import yolo_augment as ja

    from rtdm_tpu_torch.data import yolo_augment as ta
    got_ds, want_ds = _datasets(png_set)
    hyp = {**ta.DEFAULT_AUG_HYP, **HYP}
    img = got_ds.load_scaled(3, 128)
    boxes = np.array([[10, 12, 60, 50], [30, 5, 100, 70]], np.float32)
    cls = np.array([0, 1], np.float32)
    lab = np.concatenate([cls[:, None], boxes], 1)
    calls = [
        ("augment_hsv", lambda m, r: m.augment_hsv(img, 0.0138, 0.678,
                                                   0.36, r)),
        ("random_affine", lambda m, r: m.random_affine(
            img, boxes, cls, 10.0, 0.1, 0.3, 2.0, r)),
        ("mixup", lambda m, r: m.mixup(img, lab, img[::-1].copy(), lab, r)),
        ("cutout", lambda m, r: m.cutout(img, lab, r)),
    ]
    for name, fn in calls:
        for seed in range(3):
            _same(fn(ta, np.random.default_rng(seed)),
                  fn(ja, np.random.default_rng(seed)))
    for seed in range(3):
        _same(ta.load_mosaic(got_ds, seed, np.random.default_rng(seed), hyp),
              ja.load_mosaic(want_ds, seed, np.random.default_rng(seed),
                             hyp))
        _same(ta.load_mosaic9(got_ds, seed, np.random.default_rng(seed),
                              hyp),
              ja.load_mosaic9(want_ds, seed, np.random.default_rng(seed),
                              hyp))


@pytest.mark.parametrize("rect", [False, True], ids=["square", "rect"])
def test_training_sample_is_bit_equal(png_set, rect):
    got_ds, want_ds = _datasets(png_set, train=True, aug_hyp=HYP, seed=3,
                                rect=rect, batch_size=4, cache_images=True)
    for i in range(len(got_ds)):
        for seed in range(3):
            _same(got_ds.load(i, np.random.default_rng(seed)),
                  want_ds.load(i, np.random.default_rng(seed)))
    # the dataset's own generator when none is given
    _same([got_ds.load(i) for i in range(3)],
          [want_ds.load(i) for i in range(3)])


def test_image_weights_and_loader_order_are_bit_equal(png_set):
    from rtdm_tpu.data.odder import DetectionBatchLoader as JaxLoader

    from rtdm_tpu_torch.data.odder import DetectionBatchLoader
    got_ds, want_ds = _datasets(png_set, train=True, seed=1)
    cls_w = np.array([0.3, 0.7])
    w = got_ds.image_weights(cls_w)
    _same(w, want_ds.image_weights(cls_w))
    for kw in ({"shuffle": True}, {"image_weights": w}):
        got = DetectionBatchLoader(got_ds, 3, drop_last=True, seed=5,
                                   num_workers=2, **kw)
        want = JaxLoader(want_ds, 3, drop_last=True, seed=5, num_workers=2,
                         **kw)
        for _ in range(2):
            _same(list(got), list(want))
    got_ds, want_ds = _datasets(png_set, train=True, seed=1, rect=True,
                                batch_size=3)
    _same(list(DetectionBatchLoader(got_ds, 3, num_workers=2)),
          list(JaxLoader(want_ds, 3, num_workers=2)))


def _jax_resize(x, s):
    return np.asarray(jax.jit(lambda a: jax.image.resize(
        a, (a.shape[0], s, s, a.shape[3]), method="bilinear"))(x))


def test_multi_scale_resize_matches_jax():
    from rtdm_tpu_torch.cli.yolo_train import multi_scale_sizes
    from rtdm_tpu_torch.export.detector import resize_bilinear
    x = np.random.default_rng(2).integers(0, 256, (2, 128, 128, 3)).astype(
        np.float32)
    sizes = multi_scale_sizes(128)
    assert sizes == [96, 128, 160, 192]
    for s in sizes:
        got = resize_bilinear(torch.from_numpy(x), (s, s), True).numpy()
        assert np.abs(got - _jax_resize(jnp.asarray(x), s)).max() <= \
            RESIZE_TOL, s


def test_resize_without_antialias_misses():
    import torch.nn.functional as F
    x = np.random.default_rng(2).integers(0, 256, (2, 128, 128, 3)).astype(
        np.float32)
    got = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), size=(96, 96),
                        mode="bilinear", align_corners=False,
                        antialias=False).permute(0, 2, 3, 1).numpy()
    assert np.abs(got - _jax_resize(jnp.asarray(x), 96)).max() > RESIZE_TOL
