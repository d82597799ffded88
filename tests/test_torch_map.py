"""The detection CLIs' host modules against the JAX package's.

``eval/map.py`` (matching, AP of both families, the confusion matrix, the
evaluator), ``data/odder.py`` (data specs, label files, letterbox samples
square and in rect buckets, the training sample, the batch loader),
``data/camera.py`` (image dirs, a video file), ``utils/checks.py``,
``utils/paths.py`` and ``utils/plots.py``: numpy and PIL on both sides,
so each is held bit for bit (tolerance 0) on inputs made from seeds. The
example set stores its frames as ``.png``, which both packages decode with
PIL; their native ``.jpg`` paths are held in
``tests/test_torch_native_odder.py``.
"""

import os
import shutil

import numpy as np
import pytest

from rtdm_tpu_torch.data.example_set import write_example_set

SEEDS = (0, 1, 2)


@pytest.fixture(scope="module")
def example_set(tmp_path_factory):
    return write_example_set(tmp_path_factory.mktemp("set"))


def _random_eval(seed, nc):
    """Per image: detections (P, 6) sorted by conf and labels (M, 5), with
    near and far boxes, ties in conf and empty images."""
    rng = np.random.default_rng(seed)
    images = []
    for i in range(12):
        m = int(rng.integers(0, 6)) if i % 5 else 0
        xy = rng.uniform(0, 300, (m, 2))
        wh = rng.uniform(8, 80, (m, 2))
        gt = np.c_[rng.integers(0, nc, m), xy, xy + wh].astype(np.float32)
        p = int(rng.integers(0, 9)) if i % 4 else 0
        src = gt[rng.integers(0, max(m, 1), p)] if m else np.zeros((p, 5))
        boxes = src[:, 1:5] + rng.normal(0, 6, (p, 4))
        if p and m == 0:
            boxes = rng.uniform(0, 300, (p, 4))
        conf = np.round(rng.uniform(0.001, 1, p), 2)   # ties
        cls = np.where(rng.random(p) < 0.8, src[:, 0] if m else 0,
                       rng.integers(0, nc, p))
        det = np.c_[boxes, conf, cls].astype(np.float32)
        det = det[np.argsort(-det[:, 4], kind="stable")]
        images.append((det, gt[:, 1:5], gt[:, 0].astype(np.int32)))
    return images


def _assert_same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif a is None:
        assert b is None
    elif isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("family", ["v3", "v5"])
@pytest.mark.parametrize("seed", SEEDS)
def test_evaluator_matches_jax(seed, family):
    from rtdm_tpu.eval import map as jmap

    from rtdm_tpu_torch.eval import map as tmap
    nc = 3
    got, want = (m.DetectionEvaluator(nc, family=family) for m in (tmap,
                                                                   jmap))
    for det, boxes, cls in _random_eval(seed, nc):
        for ev in (got, want):
            ev.add_image(det, boxes, cls)
    _assert_same(got.results(), want.results())
    iouv = np.array([0.5, 0.7])
    for method in ("interp101", "continuous"):
        r = np.sort(np.random.default_rng(seed).random(9))
        p = np.random.default_rng(seed + 1).random(9)
        assert tmap.compute_ap(r, p, method, family) == \
            jmap.compute_ap(r, p, method, family)
    for det, boxes, cls in _random_eval(seed, nc):
        _assert_same(tmap.match_predictions(det, boxes, cls, iouv),
                     jmap.match_predictions(det, boxes, cls, iouv))


@pytest.mark.parametrize("seed", SEEDS)
def test_confusion_and_coords_match_jax(seed):
    from rtdm_tpu.eval import map as jmap

    from rtdm_tpu_torch.eval import map as tmap
    got, want = tmap.DetectionConfusionMatrix(3), \
        jmap.DetectionConfusionMatrix(3)
    for det, boxes, cls in _random_eval(seed, 3):
        got.process_batch(det, boxes, cls)
        want.process_batch(det, boxes, cls)
        _assert_same(tmap.scale_coords_np(det, (320, 416), (480, 640)),
                     jmap.scale_coords_np(det, (320, 416), (480, 640)))
        _assert_same(tmap.scale_coords_np(det, (416, 416), (480, 640),
                                          (0.5, (3.0, 7.0))),
                     jmap.scale_coords_np(det, (416, 416), (480, 640),
                                          (0.5, (3.0, 7.0))))
        _assert_same(tmap.xywh_to_xyxy_np(det[:, :4]),
                     jmap.xywh_to_xyxy_np(det[:, :4]))
    _assert_same(got.matrix, want.matrix)


def test_pr_curve_plot_writes(tmp_path):
    from rtdm_tpu_torch.eval.map import match_predictions, plot_pr_curve
    rows = _random_eval(0, 2)
    tp = np.concatenate([match_predictions(d, b, c, np.array([0.5]))
                         for d, b, c in rows])
    conf = np.concatenate([d[:, 4] for d, _, _ in rows])
    cls = np.concatenate([d[:, 5] for d, _, _ in rows]).astype(int)
    tcls = np.concatenate([c for _, _, c in rows])
    path = plot_pr_curve(tp, conf, cls, tcls, 2, str(tmp_path / "pr.png"),
                         ["person", "vehicle"])
    assert os.path.getsize(path) > 0


def _datasets(data, **kw):
    from rtdm_tpu.data import odder as jodder

    from rtdm_tpu_torch.data import odder as todder
    out = []
    for mod in (todder, jodder):
        spec = mod.load_data_spec(data)
        out.append(mod.DetectionDataset(spec["valid"], 416,
                                        base_dir=str(spec["base"]), **kw))
    return out


def test_data_spec_and_labels_match_jax(example_set, tmp_path):
    from rtdm_tpu.data import odder as jodder

    from rtdm_tpu_torch.data import odder as todder
    assert todder.load_data_spec(example_set) == \
        jodder.load_data_spec(example_set)
    yaml_path = tmp_path / "data" / "set.yaml"
    yaml_path.parent.mkdir()
    base = os.path.dirname(os.path.dirname(example_set))
    yaml_path.write_text(f"val: {base}/valid.txt\nnc: 2\n"
                         "names: [person, vehicle]\n")
    assert todder.load_data_spec(str(yaml_path)) == \
        jodder.load_data_spec(str(yaml_path))
    for n in (2, 80, 5):
        assert todder.default_names(n) == jodder.default_names(n)
    got, want = _datasets(example_set, num_classes=2)
    assert got.image_paths == want.image_paths and got.stats == want.stats
    _assert_same(dict(enumerate(got.labels)), dict(enumerate(want.labels)))
    single = _datasets(example_set, single_cls=True)
    _assert_same(dict(enumerate(single[0].labels)),
                 dict(enumerate(single[1].labels)))


@pytest.mark.parametrize("rect,pad,scaleup", [(False, 0.0, False),
                                              (False, 0.0, True),
                                              (True, 0.0, False),
                                              (True, 0.5, True)])
def test_eval_samples_match_jax(example_set, rect, pad, scaleup):
    """Image, labels, counts, original size, gain and pad of every sample,
    and the rect plan (order and bucket shapes), bit for bit."""
    got, want = _datasets(example_set, rect=rect, batch_size=4,
                          rect_pad=pad, eval_scaleup=scaleup)
    if rect:
        _assert_same(got.rect_order, want.rect_order)
        assert got.rect_shapes == want.rect_shapes
    for i in range(len(want)):
        _assert_same(got.load(i), want.load(i))


def test_batch_loader_matches_jax(example_set):
    from rtdm_tpu.data.odder import DetectionBatchLoader as JLoader

    from rtdm_tpu_torch.data.odder import DetectionBatchLoader
    got, want = _datasets(example_set, rect=True, batch_size=4,
                          rect_pad=0.5)
    pairs = zip(DetectionBatchLoader(got, 4, num_workers=2),
                JLoader(want, 4, num_workers=2))
    n = 0
    for (bg, vg), (bw, vw) in pairs:
        assert vg == vw
        _assert_same(bg, bw)
        n += vg
    assert n == len(want)


def test_training_sample_is_not_ported(example_set):
    """The training sample is ported: on the example set it equals the JAX
    package's draw for draw (mosaic, the warp, HSV, the flip)."""
    got, want = _datasets(example_set, train=True, seed=4)
    for i in range(len(got.image_paths)):
        _assert_same(got.load(i, np.random.default_rng(i)),
                     want.load(i, np.random.default_rng(i)))


def test_rect_shapes_match_jax():
    from rtdm_tpu.data import odder as jodder

    from rtdm_tpu_torch.data import odder as todder
    rng = np.random.default_rng(0)
    for h, w in rng.integers(20, 2000, (50, 2)):
        for size in (320, 416, 640):
            assert todder.minimal_rect_shape(h, w, size) == \
                jodder.minimal_rect_shape(h, w, size)
    wh = rng.integers(50, 1500, (23, 2)).astype(np.float64)
    for pad in (0.0, 0.5):
        _assert_same(todder.rect_batch_plan(wh, 416, 4, 32, pad),
                     jodder.rect_batch_plan(wh, 416, 4, 32, pad))


def test_checks_and_paths_match_jax(tmp_path):
    from rtdm_tpu.utils.checks import check_img_size as jcheck
    from rtdm_tpu.utils.paths import increment_path as jinc

    from rtdm_tpu_torch.utils.checks import check_img_size
    from rtdm_tpu_torch.utils.paths import increment_path
    for s in (1, 31, 32, 33, 415, 416, 417, 640):
        for stride in (32, 64):
            assert check_img_size(s, stride) == jcheck(s, stride)
    base = str(tmp_path / "runs" / "exp")
    for make in range(4):
        for exist_ok in (False, True):
            assert increment_path(base, exist_ok) == jinc(base, exist_ok)
            assert increment_path(base + os.sep, exist_ok) == \
                jinc(base + os.sep, exist_ok)
        os.makedirs(increment_path(base))


def _frames(mod, uri, **kw):
    src = mod.FrameSource.open(uri, **kw).start()
    try:
        return [f for f in src]
    finally:
        src.stop()


def test_camera_image_dir_matches_jax(example_set, tmp_path):
    from rtdm_tpu.data import camera as jcam

    from rtdm_tpu_torch.data import camera as tcam
    images = os.path.join(os.path.dirname(os.path.dirname(example_set)),
                          "images")
    assert (tcam.IMG_EXTS, tcam.VID_EXTS) == (jcam.IMG_EXTS, jcam.VID_EXTS)
    for kw in ({}, {"width": 96, "height": 64}):
        got, want = _frames(tcam, images, **kw), _frames(jcam, images, **kw)
        assert len(got) == len(want) == 10
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    one = os.path.join(images, sorted(os.listdir(images))[0])
    np.testing.assert_array_equal(_frames(tcam, one)[0],
                                  _frames(jcam, one)[0])
    listing = tmp_path / "cams.streams"
    listing.write_text(f"{images}\n# a comment\n{one}\n")
    assert len(_frames(tcam, str(listing))) == len(_frames(
        jcam, str(listing))) == 11
    for make in ("gst_usb_pipeline", "gst_rtsp_pipeline"):
        args = (0,) if make == "gst_usb_pipeline" else ("rtsp://cam",)
        kw = {} if make == "gst_usb_pipeline" else {"elements": "avdec_h264"}
        assert getattr(tcam, make)(*args, **kw) == \
            getattr(jcam, make)(*args, **kw)
    assert tcam.gst_onboard_pipeline(elements="nvarguscamerasrc") == \
        jcam.gst_onboard_pipeline(elements="nvarguscamerasrc")
    with pytest.raises(ValueError):
        tcam.FrameSource.open(str(tmp_path / "clip.unknown"))


def test_camera_video_matches_jax(tmp_path):
    cv2 = pytest.importorskip("cv2")
    from rtdm_tpu.data import camera as jcam

    from rtdm_tpu_torch.data import camera as tcam
    path = str(tmp_path / "clip.avi")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10.0,
                             (64, 48))
    if not writer.isOpened():
        pytest.skip("this cv2 build writes no MJPG video")
    rng = np.random.default_rng(0)
    for _ in range(6):
        writer.write(rng.integers(0, 256, (48, 64, 3), dtype=np.uint8))
    writer.release()
    got, want = _frames(tcam, path), _frames(jcam, path)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_plots_write(example_set, tmp_path):
    from rtdm_tpu_torch.utils.plots import (plot_detection_batch,
                                            plot_label_distribution)
    got, _ = _datasets(example_set)
    samples = [got.load(i) for i in range(4)]
    images = np.stack([s["image"] for s in samples])
    labels = np.stack([s["labels"] for s in samples])
    counts = np.array([s["num_labels"] for s in samples])
    path = plot_detection_batch(images, labels, counts,
                                str(tmp_path / "batch.jpg"),
                                ["person", "vehicle"],
                                scores=np.ones(labels.shape[:2]))
    assert os.path.getsize(path) > 0
    rows = np.concatenate(got.labels)
    path = plot_label_distribution(rows, str(tmp_path / "labels.png"),
                                   ["person", "vehicle"])
    assert os.path.getsize(path) > 0
    shutil.rmtree(tmp_path)
