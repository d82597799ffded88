"""The second-stage veto and the TTA resize against the JAX package.

``export/second_stage.py``: ``square_pad_boxes`` and
``crop_resize_bilinear`` against the jitted JAX functions, bit for bit
(tolerance 0: the port computes the compiled program's arithmetic, XLA's
multiply by fp32(1/n) fused into the coordinate's add and the two-tap mix
as fma(a, 1 - f, b * f)); the whole veto, with and without a class map,
against the JAX ``SecondStageClassifier`` on random boxes (kept rows and
counts; a row may differ only where the JAX classifier's two top logits
lie within 1e-2 of max |logit|). ``export/detector.py``:
``resize_bilinear`` against the jitted ``jax.image.resize(...,
"bilinear")`` at 416 -> 352 and 416 -> 288 on uint8-valued inputs: fp32
within 4e-6 (the weights are the same; XLA sums the taps in another
order), bf16 within one bf16 step on 1e-4 of the values at most.
"""

import numpy as np
import pytest
import torch

from rtdm_tpu_torch.export import second_stage as port

ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]
VETO_WEIGHTS = str(ROOT / "artifacts" / "engines" / "squeeze-ernet_bf16" /
                   "params.npz")


def _boxes(seed, n, hw=416):
    """xyxy boxes, some reaching past the frame, some thin or tiny."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-30, hw + 30, (n, 2, 2))
    a[: n // 4, 1] = a[: n // 4, 0] + rng.uniform(0, 3, (n // 4, 2))
    lo, hi = a.min(1), a.max(1)
    return np.c_[lo, hi].astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_square_pad_and_crop_match_jitted_jax(seed):
    import jax
    import jax.numpy as jnp

    from rtdm_tpu.export.second_stage import (crop_resize_bilinear,
                                              square_pad_boxes)
    xyxy = _boxes(seed, 120)
    want_boxes = np.asarray(jax.jit(square_pad_boxes)(jnp.asarray(xyxy)))
    got_boxes = port.square_pad_boxes(torch.from_numpy(xyxy)).numpy()
    np.testing.assert_array_equal(got_boxes, want_boxes)
    img = np.random.default_rng(seed).integers(0, 256, (416, 384, 3),
                                               dtype=np.uint8)
    for out_hw in ((140, 140), (37, 53)):
        want = np.asarray(jax.jit(
            lambda i, b: crop_resize_bilinear(i, b, out_hw))(
                jnp.asarray(img), jnp.asarray(want_boxes)))
        got = port.crop_resize_bilinear(torch.from_numpy(img),
                                        torch.from_numpy(got_boxes),
                                        out_hw).numpy()
        np.testing.assert_array_equal(got, want)


def _veto_pair(class_map, max_det=6, batch=2):
    from rtdm_tpu.export.second_stage import build_second_stage as jbuild
    jv = jbuild("squeeze-ernet", VETO_WEIGHTS, (416, 416), max_det,
                batch_size=batch, class_map=class_map)
    tv = port.build_second_stage("squeeze-ernet", VETO_WEIGHTS,
                                 class_map=class_map, device="cpu")
    return jv, tv


@pytest.mark.parametrize("class_map", [None, {0: 2, 1: 1}])
def test_veto_matches_jax(class_map):
    """Kept rows in order and counts equal to the JAX veto's, frames with
    no detection and rows past the count included; class 4 lies past the
    map and passes through as itself."""
    import jax
    import jax.numpy as jnp

    from rtdm_tpu.core.precision import _cast_floating
    from rtdm_tpu.data.aider import normalize_batch
    from rtdm_tpu.export.second_stage import (crop_resize_bilinear,
                                              square_pad_boxes)
    from rtdm_tpu.models import create_model
    from rtdm_tpu.models.io import load_variables
    rng = np.random.default_rng(7)
    frames = rng.integers(0, 256, (2, 416, 416, 3), dtype=np.uint8)
    det = np.zeros((2, 6, 6), np.float32)
    det[:, :, :4] = _boxes(3, 12).reshape(2, 6, 4)
    det[:, :, 4] = rng.uniform(0.3, 1, (2, 6))
    det[:, :, 5] = rng.integers(0, 5, (2, 6))
    count = np.array([5, 0], np.int32)
    jv, tv = _veto_pair(class_map)
    want_det, want_count = jv(frames, det, count)
    got_det, got_count = tv(frames, det, count)
    # the JAX veto's own logits of each row, for the near-tie rule
    variables = load_variables(VETO_WEIGHTS)
    model = create_model("squeeze-ernet")
    vars_c = {"params": _cast_floating(variables["params"], jnp.bfloat16),
              "batch_stats": variables["batch_stats"]}
    crops = jax.jit(lambda f, d: crop_resize_bilinear(
        f, square_pad_boxes(d), (140, 140)))(frames[0], det[0, :, :4])
    logits = np.asarray(model.apply(
        vars_c, normalize_batch(crops).astype(jnp.bfloat16),
        train=False, apply_softmax=False).astype(jnp.float32))
    top2 = np.sort(logits, -1)[:, -2:]
    near = (top2[:, 1] - top2[:, 0]) <= 1e-2 * np.abs(logits).max()
    if not near.any():
        np.testing.assert_array_equal(got_count, want_count)
        np.testing.assert_array_equal(got_det, want_det)
    assert got_count[1] == want_count[1] == 0
    assert not got_det[1].any()
    torch_logits = tv.logits(torch.from_numpy(frames),
                             torch.from_numpy(det), [5, 0]).numpy()
    np.testing.assert_allclose(torch_logits, logits[:5],
                               atol=1e-2 * np.abs(logits).max(), rtol=0)


def test_veto_loads_npz_only(tmp_path):
    """The veto loads the reference's ``.pt`` as it loads the ``.npz`` it
    was written from (the same classifier weights); no weights raise."""
    from rtdm_tpu_torch.models.io import load_variables
    from tests.torch_checkpoints import save_classifier_pt
    pt = save_classifier_pt(tmp_path / "w.pt", load_variables(VETO_WEIGHTS),
                            "state_dict")
    got = port.build_second_stage("squeeze-ernet", pt, device="cpu")
    want = port.build_second_stage("squeeze-ernet", VETO_WEIGHTS,
                                   device="cpu")
    for (k, a), (k2, b) in zip(got.model.state_dict().items(),
                               want.model.state_dict().items()):
        assert k == k2
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="classifier-weights"):
        port.build_second_stage("squeeze-ernet", None, device="cpu")


def test_veto_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        port.build_second_stage("squeeze-ernet", VETO_WEIGHTS)


@pytest.mark.parametrize("size", [352, 288])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tta_resize_matches_jitted_jax(size, dtype):
    import jax
    import jax.numpy as jnp

    from rtdm_tpu_torch.export.detector import resize_bilinear
    u8 = np.random.default_rng(size).integers(0, 256, (2, 416, 416, 3),
                                              dtype=np.uint8)
    jdt = getattr(jnp, dtype)
    x = jnp.asarray(u8).astype(jdt) / 255.0
    want = np.asarray(jax.jit(lambda v: jax.image.resize(
        v, (2, size, size, 3), "bilinear"))(x).astype(jnp.float32))
    xt = torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(
        getattr(torch, dtype))
    got = resize_bilinear(xt, (size, size))
    assert got.dtype == xt.dtype and got.shape == (2, size, size, 3)
    diff = np.abs(got.float().numpy() - want)
    if dtype == "float32":
        assert diff.max() <= 4e-6
    else:
        step = 2.0 ** -8      # one bf16 step at values in [0.5, 1]
        assert diff.max() <= step and (diff > 0).mean() <= 1e-4


def test_resize_weights_match_jax():
    import jax.numpy as jnp
    from jax._src.image.scale import _kernels, compute_weight_mat

    from rtdm_tpu_torch.export.detector import resize_weights
    from jax.image import ResizeMethod
    for m, n in ((416, 352), (416, 288), (32, 64), (100, 99)):
        want = np.asarray(compute_weight_mat(
            m, n, jnp.float32(n / m), jnp.float32(0.0),
            _kernels[ResizeMethod.LINEAR], True))
        np.testing.assert_allclose(resize_weights(m, n).numpy(), want,
                                   rtol=0, atol=2e-7)
