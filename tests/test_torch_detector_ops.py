"""The port's detection post-processing and the normalize / BatchNorm
repair, against the jitted JAX functions on the same inputs (numpy seeds).

Equality is asserted where the port computes what the compiled reference
computes: ``normalize_batch`` on all 768 (value, channel) inputs, the bf16
BatchNorm, exp and sigmoid, every decode, and ``batched_nms`` fed the same
predictions for every method and flag but merge. Tolerances, with their
reasons:
- fp32 BatchNorm: XLA:CPU's rsqrt is within one ulp of the correctly
  rounded one the port takes, which moves ``(x - mean) * inv`` by 2^-23 of
  itself, and the result rounds once more: 2^-22 (|out - bias| + |out|);
- merge-NMS boxes: the score-weighted box sums are taken in another order
  than XLA's dot (counts, classes, scores and the kept set are equal):
  1e-4 px, a few ulps at coordinates under 512.
The ``cuda`` case runs where JAX is not installed:
    python -m pytest --noconftest -m cuda tests/test_torch_detector_ops.py
"""

import itertools

import numpy as np
import pytest
import torch


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    return jax, jnp


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _all_u8_by_channel():
    return np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3,
                     1).reshape(1, 16, 16, 3)


def test_normalize_batch_equals_the_jitted_jax_function(jx):
    """All 256 values in each of the 3 channels, bit for bit."""
    jax, jnp = jx
    from rtdm_tpu.data.aider import normalize_batch as jax_normalize
    from rtdm_tpu_torch.data.aider import normalize_batch
    u8 = _all_u8_by_channel()
    want = np.asarray(jax.jit(jax_normalize)(jnp.asarray(u8)))
    got = normalize_batch(_t(u8)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_cuda_normalize_batch_equals_the_cpu_port():
    """On the card too (FMA contraction is the compiler's choice): equal to
    the port on the CPU, which equals the jitted JAX function."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    from rtdm_tpu_torch.data.aider import normalize_batch
    u8 = _t(_all_u8_by_channel())
    torch.testing.assert_close(normalize_batch(u8.cuda()).cpu(),
                               normalize_batch(u8), rtol=0, atol=0)


@pytest.mark.parametrize("eps", [1e-5, 1e-4, 1e-3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_matches_the_jitted_jax_batchnorm(jx, dtype, eps):
    jax, jnp = jx
    from rtdm_tpu.models.layers import BatchNorm as JaxBN
    from rtdm_tpu_torch.models.layers import BatchNorm
    rng = np.random.default_rng(7)
    c = 64
    x = (rng.normal(size=(4, 9, 9, c)) * 3).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.normal(size=c).astype(np.float32)
    mean = rng.normal(size=c).astype(np.float32)
    var = rng.uniform(0.01, 2, c).astype(np.float32)
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    variables = {"params": {"scale": jnp.asarray(scale).astype(jdt),
                            "bias": jnp.asarray(bias).astype(jdt)},
                 "batch_stats": {"mean": mean, "var": var}}
    want = np.asarray(jax.jit(lambda v, x: JaxBN(epsilon=eps).apply(v, x))(
        variables, jnp.asarray(x).astype(jdt)).astype(jnp.float32))
    bn = BatchNorm(c, eps).eval()
    bn.load_state_dict({"weight": _t(scale).to(tdt), "bias": _t(bias).to(tdt),
                        "running_mean": _t(mean), "running_var": _t(var)})
    with torch.no_grad():
        got = bn(_t(x).to(tdt)).float().numpy()
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, want)
    else:
        b = bias.astype(np.float64)
        limit = 2.0 ** -22 * (np.abs(want - b) + np.abs(want))
        assert np.all(np.abs(got - want) <= limit)
        assert (got == want).mean() > 0.8


def test_exp_and_sigmoid_equal_the_compiled_jax_ones(jx):
    jax, jnp = jx
    from rtdm_tpu_torch.ops.numerics import exp_f32, sigmoid_f32
    rng = np.random.default_rng(1)
    v = np.concatenate([
        rng.uniform(-20, 20, 200000), rng.normal(0, 3, 200000),
        rng.uniform(-100, 100, 50000),
        [0, -0.0, 88.72, 88.8, 89, -87.3, -87.8, -90, 1e-40, np.inf,
         -np.inf]]).astype(np.float32)
    for fn, ref in ((exp_f32, jnp.exp), (sigmoid_f32, jax.nn.sigmoid)):
        np.testing.assert_array_equal(fn(_t(v)).numpy(),
                                      np.asarray(jax.jit(ref)(v)))


DECODE_MODES = {"classic": {}, "scale_x_y": {"scale_x_y": 1.05},
                "new_coords": {"new_coords": True, "scale_x_y": 2.0},
                "v5": {"v5": True}}
ANCHORS = np.array([[10, 13], [16, 30], [33, 23]], np.float32)


@pytest.mark.parametrize("img_size", [416, (320, 416)],
                         ids=["square", "hw"])
@pytest.mark.parametrize("mode", list(DECODE_MODES))
def test_decode_head_equals_jax(jx, mode, img_size):
    """A non-square (10 x 13) map; an (h, w) input gives per-axis
    strides."""
    jax, jnp = jx
    from rtdm_tpu.ops.yolo import decode_head as jax_decode
    from rtdm_tpu_torch.ops.yolo import decode_head
    kw = DECODE_MODES[mode]
    p = np.random.default_rng(0).normal(0, 2, (2, 10, 13, 21))
    if kw.get("new_coords"):
        p = 1 / (1 + np.exp(-p))
    p = p.astype(np.float32)
    want = np.asarray(jax.jit(lambda x: jax_decode(
        x, ANCHORS, img_size, 2, **kw))(p))
    got = decode_head(_t(p), ANCHORS, img_size, 2, **kw).numpy()
    np.testing.assert_array_equal(got, want)


def test_decode_all_equals_jax(jx):
    jax, jnp = jx
    from rtdm_tpu.models.darknet import YoloHead as JaxHead
    from rtdm_tpu.ops.yolo import decode_all as jax_decode_all
    from rtdm_tpu_torch.models.darknet import YoloHead
    from rtdm_tpu_torch.ops.yolo import decode_all
    rng = np.random.default_rng(3)
    maps = [rng.normal(0, 2, (2, s, s, 21)).astype(np.float32)
            for s in (13, 26)]
    heads = [(ANCHORS, 2, 0, 1.0, False, True),
             (ANCHORS * 2, 2, 1, 1.0, False, True)]
    want = np.asarray(jax.jit(lambda *m: jax_decode_all(
        m, [JaxHead(*h) for h in heads], 416))(*maps))
    got = decode_all([_t(m) for m in maps], [YoloHead(*h) for h in heads],
                     416).numpy()
    np.testing.assert_array_equal(got, want)


def _jax_decoded(jx, seed, nc=3):
    """Rows decoded by the jitted JAX ``decode_all`` (v5 heads at 13 and
    26) from random raw maps, with planted ties (duplicate rows)."""
    jax, jnp = jx
    from rtdm_tpu.models.darknet import YoloHead
    from rtdm_tpu.ops.yolo import decode_all
    rng = np.random.default_rng(seed)
    maps = [rng.normal(0, 2, (2, s, s, 3 * (5 + nc))).astype(np.float32)
            for s in (13, 26)]
    heads = [YoloHead(ANCHORS * (i + 1), nc, i, v5=True) for i in range(2)]
    p = np.array(jax.jit(lambda *m: decode_all(m, heads, 416))(*maps))
    p[:, 100:110] = p[:, 200:210]
    return p


def _predictions(seed, b=2, n=400, nc=3):
    """Decoded-like rows around 40 cluster centres, with planted ties:
    copied scores, duplicate rows and a tied class pair."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(20, 380, (b, 40, 2))
    k = rng.integers(0, 40, (b, n))
    xy = np.take_along_axis(centres, k[..., None], 1) + rng.normal(
        0, 6, (b, n, 2))
    wh = rng.uniform(1, 80, (b, n, 2))
    p = np.concatenate([xy, wh, rng.uniform(0, 1, (b, n, 1)),
                        rng.uniform(0, 1, (b, n, nc))], -1).astype(np.float32)
    p[:, 10:20, 4:] = p[:, 30:40, 4:]
    p[:, 50:55] = p[:, 60:65]
    p[:, 70, 5] = p[:, 70, 6]
    return p


@pytest.mark.parametrize(
    "method,multi_label,agnostic,classes",
    list(itertools.product(["greedy", "or", "vision_batch", "merge", "soft",
                            "and"],
                           [False, True], [False, True], [None, (0, 2)])))
def test_batched_nms_on_the_same_rows_equals_jax(
        jx, method, multi_label, agnostic, classes):
    jax, jnp = jx
    from rtdm_tpu.ops.nms import batched_nms as jax_nms
    from rtdm_tpu_torch.ops.nms import batched_nms
    for p in (_predictions(0), _predictions(1), _jax_decoded(jx, 2)):
        kw = dict(multi_label=multi_label, class_agnostic=agnostic,
                  method=method, classes=classes)
        wd, wc = jax_nms(jnp.asarray(p), 0.25, 0.45, 300, 64, **kw)
        gd, gc = batched_nms(_t(p), 0.25, 0.45, 300, 64, **kw)
        wd, wc, gd, gc = np.asarray(wd), np.asarray(wc), gd.numpy(), gc.numpy()
        np.testing.assert_array_equal(gc, wc)
        assert gd.shape == wd.shape
        if method == "merge":
            np.testing.assert_array_equal(gd[..., 4:], wd[..., 4:])
            np.testing.assert_allclose(gd[..., :4], wd[..., :4], rtol=0,
                                       atol=1e-4)
        else:
            np.testing.assert_array_equal(gd, wd)


def test_nms_candidate_ties_take_the_lower_index(jx):
    """Equal scores: lax.top_k order (lower index first), which a stable
    descending sort keeps; and argmax of tied classes is the first."""
    jax, jnp = jx
    from rtdm_tpu.ops.nms import batched_nms as jax_nms
    from rtdm_tpu_torch.ops.nms import batched_nms
    p = np.zeros((1, 6, 7), np.float32)
    p[0, :, :4] = [[i * 50 + 20, 20, 10, 10] for i in range(6)]
    p[0, :, 4] = 0.9
    p[0, :, 5:] = 0.5                      # every score and class tied
    wd, wc = jax_nms(jnp.asarray(p), 0.25, 0.45, 4, 3)
    gd, gc = batched_nms(_t(p), 0.25, 0.45, 4, 3)
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    np.testing.assert_array_equal(gd.numpy()[0, :, 0], [15, 65, 115])


def test_greedy_fixpoint_equals_the_sequential_greedy():
    """The Jacobi fixpoint keeps what the sequential loop keeps, and
    reports its steps."""
    from rtdm_tpu_torch.ops.nms import box_iou_matrix, greedy_keep
    rng = np.random.default_rng(5)
    xy = rng.uniform(0, 100, (1, 64, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 40, (1, 64, 2))], -1)
    iou = box_iou_matrix(_t(boxes.astype(np.float32)),
                         _t(boxes.astype(np.float32)))
    valid = torch.rand(1, 64, generator=torch.Generator().manual_seed(0)) > .1
    keep, steps = greedy_keep(iou, valid, 0.3)
    seq = valid.clone()
    for i in range(64):
        for j in range(i):
            if seq[0, j] and iou[0, j, i] > 0.3:
                seq[0, i] = False
    assert torch.equal(keep, seq) and 1 <= steps <= 64


def test_scale_coords_matches_jax(jx):
    jax, jnp = jx
    from rtdm_tpu.ops.nms import scale_coords as jax_scale
    from rtdm_tpu_torch.ops.nms import scale_coords
    det = np.random.default_rng(2).uniform(0, 416, (3, 5, 6)).astype(
        np.float32)
    for kw in ({}, {"letterboxed": False},
               {"ratio_pad": (0.65, (10.0, 38.0))}):
        want = np.asarray(jax_scale(jnp.asarray(det), (416, 416), (480, 640),
                                    **kw))
        got = scale_coords(_t(det), (416, 416), (480, 640), **kw).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)


def test_fuse_functions_equal_jax():
    from rtdm_tpu.ops import fuse as jax_fuse
    from rtdm_tpu_torch.ops import fuse
    rng = np.random.default_rng(4)
    k = rng.normal(size=(3, 3, 4, 6)).astype(np.float32)
    args = [rng.normal(size=6).astype(np.float32) for _ in range(3)] + [
        rng.uniform(0.1, 2, 6).astype(np.float32)]
    for bias in (None, rng.normal(size=6).astype(np.float32)):
        for a, b in zip(fuse.fuse_conv_bn(k, bias, *args, eps=1e-4),
                        jax_fuse.fuse_conv_bn(k, bias, *args, eps=1e-4)):
            np.testing.assert_array_equal(a, b)
    cfg = ("[net]\n[convolutional]\nbatch_normalize=1\nfilters=6\nsize=3\n"
           "pad=1\nactivation=leaky\n[convolutional]\nfilters=6\nsize=1\n")
    assert fuse.strip_bn_from_cfg(cfg) == jax_fuse.strip_bn_from_cfg(cfg)
    variables = {"params": {"l0_conv": {"kernel": k},
                            "l0_bn": {"scale": args[0], "bias": args[1]},
                            "l1_conv": {"kernel": k[:1, :1, :, :],
                                        "bias": args[2]}},
                 "batch_stats": {"l0_bn": {"mean": args[2], "var": args[3]}}}
    got = fuse.fuse_darknet_variables(variables, cfg)
    want = jax_fuse.fuse_darknet_variables(variables, cfg)
    from rtdm_tpu_torch.models.io import flatten_tree
    g, w = flatten_tree(got), flatten_tree(want)
    assert sorted(g) == sorted(w)
    for key in w:
        np.testing.assert_array_equal(g[key], w[key])


@pytest.mark.parametrize("k,cin,cout,stride,hw", [
    (3, 32, 64, 1, 52), (3, 32, 64, 2, 104), (1, 64, 64, 1, 52),
    (1, 512, 256, 1, 13)])
def test_cpu_bf16_conv_equals_the_jitted_jax_conv(jx, k, cin, cout, stride,
                                                   hw):
    """A bf16 ``Conv`` on the CPU (an fp32 conv of the bf16 values, rounded
    once, then the bias in bf16) equals the jitted JAX bf16 conv bit for
    bit at these shapes: 3x3 over 32 channels and 1x1. XLA:CPU sums larger
    3x3 convs in another order."""
    jax, jnp = jx
    from rtdm_tpu.models.layers import Conv as JaxConv
    from rtdm_tpu_torch.models.io import torch_state_dict_from_variables
    from rtdm_tpu_torch.models.layers import Conv
    rng = np.random.default_rng(9)
    x = (rng.normal(size=(1, hw, hw, cin)) * 0.5).astype(np.float32)
    jconv = JaxConv(cout, k, stride, k // 2)
    params = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.bfloat16),
        jconv.init(jax.random.key(0), jnp.zeros((1, hw, hw, cin))))
    params["params"]["bias"] = jnp.asarray(
        rng.normal(size=cout) * 0.1, jnp.bfloat16)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jax.jit(jconv.apply)(params, xb).astype(jnp.float32))
    conv = Conv(cin, cout, k, stride, k // 2).to(torch.bfloat16)
    conv.load_state_dict({k_: v.to(torch.bfloat16) for k_, v in
                          torch_state_dict_from_variables(
                              jax.tree_util.tree_map(
                                  lambda a: np.asarray(a.astype(jnp.float32)),
                                  params)).items()})
    with torch.no_grad():
        got = conv(_t(np.asarray(xb.astype(jnp.float32))).to(
            torch.bfloat16)).float().numpy()
    np.testing.assert_array_equal(got, want)
