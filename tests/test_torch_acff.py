"""The port's fused ACFF block against the JAX package: ``acff_infer_plain``
and the ``ACFF`` module against ``rtdm_tpu.models.acff.ACFF.apply`` and
against the Pallas kernel in interpret mode, at rtol 1e-4 / atol 1e-5 (the
bounds of tests/test_acff_pallas.py; fp32 on both sides, sums in another
order), and in bf16 against ``ACFF.apply`` run as the JAX bf16 engine runs
it. Also the host side of the kernels: the B operand layouts (bf16, and
the fp32 kernel's TF32 hi/lo split), the tile plan, the shared-memory
counts, and the 3xTF32 arithmetic of the fp32 kernel in plain torch.

JAX is imported inside the fixture that needs it, so that the test marked
``cuda`` also runs where JAX is not installed:
    python -m pytest --noconftest -m cuda tests/test_torch_acff.py
"""

import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from rtdm_tpu_torch.models.acff import ACFF
from rtdm_tpu_torch.models.io import torch_state_dict_from_variables
from rtdm_tpu_torch.ops import acff as ops

# (C, O, H=W): every C class the models use at small extents, H=6 as the
# last Squeeze_ErNET block has it (4x4 output)
SHAPES = [(8, 64, 6), (16, 64, 9), (64, 96, 6), (16, 32, 11)]
# (C, O) of every ACFF block of the three models
WIDTHS = [(8, 64), (16, 64), (64, 96), (96, 128), (48, 128), (64, 256),
          (128, 128), (128, 256)]
# input (H = W) of every ACFF block on the three models' main paths:
# Squeeze_ErNET, Squeeze_RedConv, ErNET
MAIN_PATH_HW = [69, 33, 15, 6, 69, 33, 15, 6, 119, 58, 28, 13, 11, 9]


@pytest.fixture(scope="module")
def jax_ref():
    import jax
    import jax.numpy as jnp

    from rtdm_tpu.models.acff import ACFF as JaxACFF
    from rtdm_tpu.ops.acff_pallas import fused_acff_infer, pack_acff_params
    return types.SimpleNamespace(jax=jax, jnp=jnp, ACFF=JaxACFF,
                                 fused=fused_acff_infer,
                                 pack=pack_acff_params)


def _jax_case(jr, rng, c, o, hw):
    x = rng.normal(size=(2, hw, hw, c)).astype(np.float32)
    mod = jr.ACFF(o)
    variables = jr.jax.device_get(mod.init(jr.jax.random.key(0),
                                           jr.jnp.asarray(x)))
    params = variables["params"]
    params["batch_norm"]["scale"] = rng.uniform(0.5, 1.5, (o,)).astype(
        np.float32)
    params["batch_norm"]["bias"] = rng.normal(size=(o,)).astype(np.float32)
    for i in (1, 2, 3):
        params[f"conv{i}"]["bias"] = rng.normal(size=(c,)).astype(np.float32)
    params["fused_conv"]["bias"] = rng.normal(size=(o,)).astype(np.float32)
    stats = variables["batch_stats"]["batch_norm"]
    stats["mean"] = rng.normal(size=(o,)).astype(np.float32) * 0.1
    stats["var"] = rng.uniform(0.5, 1.5, (o,)).astype(np.float32)
    return x, variables, mod


def _port_module(variables, c, o):
    mod = ACFF(c, o).eval()
    mod.load_state_dict(torch_state_dict_from_variables(variables),
                        strict=True)
    return mod


@pytest.mark.parametrize("c,o,hw", SHAPES)
def test_plain_and_module_match_jax(jax_ref, rng, c, o, hw):
    x, variables, jmod = _jax_case(jax_ref, rng, c, o, hw)
    want = np.asarray(jmod.apply(variables, jax_ref.jnp.asarray(x),
                                 train=False))
    pallas = np.asarray(jax_ref.fused(
        jax_ref.jnp.asarray(x),
        *jax_ref.pack(variables["params"], variables["batch_stats"]),
        batch_tile=1, interpret=True))
    mod = _port_module(variables, c, o)
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        got_module = mod(xt).numpy()
        got_plain = ops.acff_infer_plain(xt, *mod.packed()[:6]).numpy()
    assert got_module.shape == want.shape == (2, hw - 2, hw - 2, o)
    for ref in (want, pallas):
        np.testing.assert_allclose(got_module, ref, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got_plain, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("c,o,hw", SHAPES)
def test_bf16_plain_matches_jax_bf16(jax_ref, rng, c, o, hw):
    """bf16 as the engines run it: parameters cast to bf16, BN statistics
    fp32, x in bf16. Held at 1e-2 of max |out|: the JAX bf16 path rounds
    each branch, its bias sum, the fuse product and the activation (five
    roundings of 2^-8), the port rounds the features and the output; JAX's
    own bf16 drift from fp32 on these inputs is of the same size."""
    from rtdm_tpu.core.precision import _cast_floating
    from rtdm_tpu_torch.core.precision import cast_floating
    jnp = jax_ref.jnp
    x, variables, jmod = _jax_case(jax_ref, rng, c, o, hw)
    xb = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    vb = {"params": _cast_floating(variables["params"], jnp.bfloat16),
          "batch_stats": variables["batch_stats"]}
    want = np.asarray(jmod.apply(vb, jnp.asarray(xb).astype(jnp.bfloat16),
                                 train=False).astype(jnp.float32))
    mod = _port_module(variables, c, o)
    state = mod.state_dict()
    state.update(cast_floating({k: state[k] for k, _ in
                                mod.named_parameters()}, torch.bfloat16))
    mod.load_state_dict(state, strict=True, assign=True)
    with torch.inference_mode():
        got = mod(torch.from_numpy(xb).bfloat16())
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=1e-2 * np.abs(want).max())


def test_bf16_plain_rounds_features_and_weights(rng):
    """The bf16 plain version is the fp32 one on bf16-rounded features and
    fuse_w: with features and weights exact in bf16 the two agree."""
    x, *w = _kernel_args(rng, 2, 8, 32, 9, torch.float32, "cpu")
    w[0] = torch.zeros_like(w[0])
    w[0][0, 1, 1] = 1.0                  # branch 1 passes x through
    w[1] = torch.zeros_like(w[1])
    w[2] = w[2].bfloat16().float()
    xb = x.bfloat16()
    got = ops.acff_infer_plain(xb, *w).float()
    want = ops.acff_infer_plain(xb.float(), *w).bfloat16().float()
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("c,o", WIDTHS + [(16, 32)])
def test_fuse_operand_layout(c, o):
    rng = np.random.default_rng(c * 1000 + o)
    fuse_w = torch.from_numpy(rng.normal(size=(3 * c, o)).astype(np.float32))
    packed = ops.pack_fuse_operand(fuse_w)
    kp = ops.padded_k(c)
    assert kp % 16 == 0 and 3 * c <= kp < 3 * c + 16
    assert packed.dtype == torch.bfloat16 and packed.shape == (kp * o,)
    back = ops.unpack_fuse_operand(packed, c, o)
    assert back.shape == (kp, o)
    assert torch.equal(back[:3 * c], fuse_w.bfloat16())
    assert not back[3 * c:].float().abs().sum()
    # element (k, n) of the first chunk, at the offset the kernel reads
    kc = min(ops.K_CHUNK, kp)
    last = min(kc, 3 * c) - 1
    for k, n in ((0, 0), (last, o - 1), (last // 2, 9 % o)):
        at = ((n // 8 * (kc // 8) + k // 8) * 8 + n % 8) * 8 + k % 8
        assert packed[at] == fuse_w[k, n].bfloat16()


@pytest.mark.parametrize("b", [1, 3, 256])
def test_tile_plan_covers_each_pixel_once(b):
    """Every output pixel of every main-path shape lies in exactly one
    tile, in the tile's own image, and every input pixel it reads lies in
    that tile's box of that image (or outside the image: zero)."""
    for hw in MAIN_PATH_HW:
        plan = ops.tile_plan(b, hw, hw)
        oh = ow = hw - 2
        assert plan.th * plan.tw * plan.images <= ops.TILE_PIXELS
        t = np.arange(plan.n_tiles)[:, None]
        per_image = plan.tiles_h * plan.tiles_w
        b0 = t // per_image * plan.images
        oy0 = t % per_image // plan.tiles_w * plan.th
        ox0 = t % per_image % plan.tiles_w * plan.tw
        assert [plan.tile_origin(i) for i in (0, plan.n_tiles - 1)] == [
            (b0[i, 0], oy0[i, 0], ox0[i, 0]) for i in (0, -1)]
        p = np.arange(ops.TILE_PIXELS)[None, :]
        img, q = p // (plan.th * plan.tw), p % (plan.th * plan.tw)
        by, oy, ox = b0 + img, oy0 + q // plan.tw, ox0 + q % plan.tw
        live = (img < plan.images) & (by < b) & (oy < oh) & (ox < ow)
        seen = np.zeros((b, oh, ow), np.int64)
        np.add.at(seen, (by[live], oy[live], ox[live]), 1)
        assert (seen == 1).all(), hw
        # branch d reads rows oy-d .. oy+d+2 (likewise columns); those in
        # the image must fall in the box [oy0-origin, oy0-origin+hy)
        lo_y = np.maximum(oy - 2, 0) - (oy0 - plan.origin)
        hi_y = np.minimum(oy + 4, hw - 1) - (oy0 - plan.origin)
        lo_x = np.maximum(ox - 2, 0) - (ox0 - plan.origin)
        hi_x = np.minimum(ox + 4, hw - 1) - (ox0 - plan.origin)
        assert (lo_y[live] >= 0).all() and (hi_y[live] < plan.hy).all()
        assert (lo_x[live] >= 0).all() and (hi_x[live] < plan.hx).all()


def test_pack_matches_jax_pack(jax_ref, rng):
    _, variables, _ = _jax_case(jax_ref, rng, 16, 64, 9)
    want = jax_ref.pack(variables["params"], variables["batch_stats"])
    got = _port_module(variables, 16, 64).packed()
    for w, g in zip(want, got):
        assert g.dtype == torch.float32 and g.is_contiguous()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)


def test_packed_arguments_are_rebuilt_on_load(jax_ref, rng):
    _, variables, _ = _jax_case(jax_ref, rng, 8, 32, 6)
    mod = _port_module(variables, 8, 32)
    first = mod.packed()
    assert mod.packed() is first          # packed once per load
    state = mod.state_dict()
    state["batch_norm.running_var"] = state["batch_norm.running_var"] * 2.0
    mod.load_state_dict(state, strict=True)
    again = mod.packed()
    assert not torch.allclose(again[4], first[4])
    torch.testing.assert_close(again[4], first[4] / np.sqrt(2.0),
                               rtol=1e-4, atol=0)
    assert mod.to(torch.float32).packed() is not again   # and per move
    # the kernel's B operand is packed with the rest, for the fp32 kernel
    # as TF32 hi and lo, for the bf16 one in bf16; O=32 runs at the
    # kernels' narrowest width, 64, with zero columns past O
    wide_w = torch.nn.functional.pad(again[2], (0, 32))
    assert again[6].direct is None
    assert torch.equal(again[6].get(0, 64, False),
                       ops.pack_fuse_operand_tf32(wide_w))
    bf16 = mod.to(torch.bfloat16).packed()
    assert torch.equal(bf16[6].get(0, 64, False),
                       ops.pack_fuse_operand(wide_w))


def test_op_arguments_are_cached_until_they_may_change(jax_ref, rng):
    """The block's forward makes the op's arguments once for each input
    H x W and device, and again after any event that may change them: a
    new ``act_scales``, a load, a move, ``train()``, ``clear_packed``; a
    forward after a load reads the loaded parameters."""
    _, variables, _ = _jax_case(jax_ref, rng, 8, 32, 9)
    mod = _port_module(variables, 8, 32)
    x = torch.from_numpy(rng.standard_normal((2, 9, 9, 8), dtype=np.float32))
    with torch.no_grad():
        first = mod(x)
        args = mod._op_args[(9, 9, False)]
        assert torch.equal(mod(x), first)
        assert mod._op_args[(9, 9, False)] is args
        mod(x[:, :7, :7].contiguous())
        assert set(mod._op_args) == {(9, 9, False), (7, 7, False)}
        mod.act_scales = (0.05, 0.05, 0.05, 0.1)
        assert mod._op_args == {}
        mod.act_scales = None
        for event in (mod.clear_packed, lambda: mod.to(torch.float32),
                      lambda: mod.train().eval()):
            mod(x)
            event()
            assert mod._op_args == {}
        mod(x)
        state = mod.state_dict()
        state["batch_norm.running_var"] = state["batch_norm.running_var"] * 4
        mod.load_state_dict(state)
        assert mod._op_args == {}
        fresh = ACFF(8, 32).eval()
        fresh.load_state_dict(state)
        assert torch.equal(mod(x), fresh(x))
        assert not torch.equal(mod(x), first)


def test_training_mode_is_not_ported():
    """Training mode is ported since the training slice: the block runs
    its layers with batch statistics (no fused kernel: the reference has
    no backward), and dropout refuses to draw without a generator."""
    x = torch.randn(2, 6, 6, 8, generator=torch.Generator().manual_seed(0))
    block = ACFF(8, 32, 0.0).train()
    torch.testing.assert_close(block(x), block.forward_layers(x), rtol=0,
                               atol=0)
    with pytest.raises(RuntimeError, match="generator"):
        ACFF(8, 32).train()(x)


# (C, O, H=W) of the four Squeeze_ErNET blocks
SQUEEZE_ERNET = [(16, 64, 69), (64, 96, 33), (96, 128, 15), (128, 256, 6)]


@pytest.mark.parametrize("c,o,hw", SQUEEZE_ERNET)
def test_int8_plain_matches_jax_qdq_block(jax_ref, rng, c, o, hw):
    """``acff_infer_plain(..., act_scales)`` against a flax ``ACFF`` block
    run as the JAX int8 engine runs it: kernels QDQ'd per channel and cast
    to bf16, each Conv/DepthwiseConv input QDQ'd in fp32 by an interceptor
    written like ``rtdm_tpu/quant/int8.py``, compiled by ``jax.jit``. Held
    to one bf16 step of max |out| (2^-8; both fold BN differently, a last
    fp32 bit that can round the output the other way) with at most 0.1% of
    the outputs different; measured: 0 to a few in 10^5."""
    from flax import linen as nn

    from rtdm_tpu.core.precision import _cast_floating
    from rtdm_tpu.models.layers import Conv, DepthwiseConv
    from rtdm_tpu.quant.int8 import fake_quant_tensor, quantize_params
    from rtdm_tpu_torch.core.precision import cast_floating
    jnp = jax_ref.jnp
    x, variables, jmod = _jax_case(jax_ref, rng, c, o, hw)
    xb = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    qparams = quantize_params(variables["params"])
    feats = ops.depthwise_features(torch.from_numpy(xb).bfloat16(),
                                   *_port_module(
                                       {**variables, "params": qparams},
                                       c, o).packed()[:2])
    # scales as calibration makes them: one for the three branches
    s_x = float(np.float32(np.abs(xb).max() / 127))
    scales = {"conv1": s_x, "conv2": s_x, "conv3": s_x,
              "fused_conv": float(np.float32(
                  feats.abs().max().item() / 127))}

    def interceptor(next_fun, args, kwargs, context):
        if (isinstance(context.module, (Conv, DepthwiseConv))
                and context.method_name == "__call__"):
            s = scales[context.module.name]
            x0 = args[0]
            args = (fake_quant_tensor(x0.astype(jnp.float32), s)
                    .astype(x0.dtype),) + args[1:]
        return next_fun(*args, **kwargs)
    qv = {"params": _cast_floating(qparams, jnp.bfloat16),
          "batch_stats": variables["batch_stats"]}

    def run(v):
        with nn.intercept_methods(interceptor):
            return jmod.apply(qv, v, train=False).astype(jnp.float32)
    want = np.asarray(jax_ref.jax.jit(run)(
        jnp.asarray(xb).astype(jnp.bfloat16)))
    mod = _port_module({**variables, "params": qparams}, c, o)
    state = mod.state_dict()
    state.update(cast_floating({k: state[k] for k, _ in
                                mod.named_parameters()}, torch.bfloat16))
    mod.load_state_dict(state, strict=True, assign=True)
    mod.act_scales = tuple(scales[k] for k in
                           ("conv1", "conv2", "conv3", "fused_conv"))
    with torch.inference_mode():
        got = mod(torch.from_numpy(xb).bfloat16()).float().numpy()
    assert got.shape == want.shape == (2, hw - 2, hw - 2, o)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2.0 ** -8 * np.abs(want).max())
    assert (got != want).mean() <= 1e-3


def test_int8_plain_rounds_as_the_kernel_mode_does(rng):
    """With scales a power of two and weights and x exact in bf16, the QDQ
    plain version is the bf16 one on QDQ'd inputs: x on the 1/8 grid and
    within +-127/8 is its own QDQ, and so is a feature on the fuse scale's
    grid; and a scale too small for x clips it to +-127 codes."""
    x, *w = _kernel_args(rng, 2, 8, 64, 9, torch.float32, "cpu")
    x = (torch.round(x * 32) / 8).clamp(-15, 15).bfloat16()
    w[0] = torch.zeros_like(w[0])
    w[0][:, 1, 1] = 1.0                  # each branch passes x through
    w[1] = torch.zeros_like(w[1])
    feats = ops.depthwise_features(x, w[0], w[1], (0.125,) * 4)
    assert torch.equal(feats, x.float().permute(0, 3, 1, 2)[
        :, :, 1:-1, 1:-1].repeat(1, 3, 1, 1))
    # a QDQ that saturates: x / s beyond 127 clips
    feats = ops.depthwise_features(x, w[0], w[1], (0.0625,) * 4)
    assert feats.abs().max().item() == 127 * 0.0625


def test_layer_by_layer_matches_the_fused_block(jax_ref, rng):
    """``forward_layers`` (the calibration forward: conv1/2/3 -> concat ->
    fused_conv -> LeakyReLU -> batch_norm) equals the fused plain block in
    fp32, within 1e-5 of max |out| (sums in another order)."""
    from rtdm_tpu_torch.models.acff import layer_by_layer
    for c, o, hw in SHAPES:
        x, variables, _ = _jax_case(jax_ref, rng, c, o, hw)
        mod = _port_module(variables, c, o)
        xt = torch.from_numpy(x)
        with torch.inference_mode():
            fused = mod(xt)
            with layer_by_layer(mod):
                layers = mod(xt)
        assert not mod.unfused
        np.testing.assert_allclose(layers.numpy(), fused.numpy(), rtol=0,
                                   atol=1e-5 * fused.abs().max().item())


@pytest.mark.parametrize("bad", [(0.1, 0.1, 0.1), (0.1, 0.1, 0.0, 0.1),
                                 (0.1, float("nan"), 0.1, 0.1),
                                 (0.1, 0.1, float("inf"), 0.1),
                                 (-0.1, 0.1, 0.1, 0.1), "fp32_x"])
def test_act_scales_checks(rng, bad):
    x, *w = _kernel_args(rng, 2, 8, 64, 6, torch.bfloat16, "cpu")
    ops._check(x, *w, act_scales=(0.1, 0.1, 0.1, 0.1))
    if bad == "fp32_x":
        x, bad = x.float(), (0.1, 0.1, 0.1, 0.1)
    with pytest.raises(ValueError, match="act_scales"):
        ops._check(x, *w, act_scales=bad)
    with pytest.raises(ValueError, match="act_scales"):
        ops.acff_infer(x, *w, act_scales=bad)


@pytest.mark.parametrize("scales,want", [
    ((0.1, 0.1, 0.1, 0.2), "int8"),
    ((0.1, 0.07, 0.13, 0.2), "int8_branch"),
    ((0.1, 0.1, 0.1 * (1 + 1e-12), 0.2), "int8"),       # one fp32 value
    ((0.1, float(np.nextafter(np.float32(0.1), np.float32(1))), 0.1, 0.2),
     "int8_branch"),                                      # one fp32 ulp
    ((np.float32(0.5), 0.5, np.float64(0.5), 3.0), "int8"),
])
def test_qdq_variant_follows_the_branch_scales(scales, want):
    """The wrapper takes the shared-box QDQ variant where the three
    depthwise scales are equal as the fp32 values the C entry receives, and
    the per-branch one otherwise; s_f plays no part."""
    assert ops.qdq_variant(scales) == want
    assert ops.MODES[want] in (2, 3) and want in ops.LAUNCHES


@pytest.mark.parametrize("model", ["squeeze-ernet", "squeeze-redconv",
                                   "ernet"])
def test_int8_engines_take_the_shared_variant(model):
    """Calibration gives the three branches of every ACFF block of the
    committed int8 engines one scale (they read one x), so every block runs
    the shared-box QDQ variant; the quantized model hands each block those
    scales."""
    from rtdm_tpu_torch.export.engine import Engine
    from rtdm_tpu_torch.quant.int8 import acff_scales
    engine_dir = Path(__file__).resolve().parents[1] / "artifacts" / \
        "engines" / f"{model}_int8"
    with np.load(engine_dir / "act_scales.npz") as z:
        scales = dict(z)
    blocks = sorted({k.split("/")[0] for k in scales if "/conv1" in k})
    assert len(blocks) == (6 if model == "ernet" else 4)
    for block in blocks:
        s = [np.float32(scales[f"{block}/conv{i}"]) for i in (1, 2, 3)]
        assert s[0] == s[1] == s[2] > 0, block
        assert ops.qdq_variant(acff_scales(scales, block)) == "int8"
    eng = Engine.load(str(engine_dir), device="cpu")
    got = [m.act_scales for m in eng.model.modules() if isinstance(m, ACFF)]
    assert len(got) == len(blocks)
    assert all(ops.qdq_variant(s) == "int8" for s in got)


def test_shared_box_qdq_is_idempotent_on_every_bf16_value():
    """The shared-box variant QDQs the box once and the kernel's per-branch
    QDQ would do it again: for every finite bf16 value v and scales from
    1e-30 to 1e30, bf16(QDQ(bf16(QDQ(v, s)), s)) == bf16(QDQ(v, s)) (the
    bf16 rounding moves v / s by under 127 * 2^-9 < 1/2 a code)."""
    from rtdm_tpu_torch.quant.int8 import fake_quant_tensor
    bits = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(torch.int16)
    v = bits.view(torch.bfloat16).float()
    v = v[torch.isfinite(v)]
    rng = np.random.default_rng(5)
    scales = np.concatenate([np.logspace(-30, 30, 61),
                             10.0 ** rng.uniform(-6, 3, 40)])
    for s in scales.astype(np.float32):
        once = fake_quant_tensor(v, s).bfloat16().float()
        twice = fake_quant_tensor(once, s).bfloat16().float()
        assert torch.equal(once, twice), s


def _bf16_round_once(x: torch.Tensor) -> torch.Tensor:
    """float64 x (normal, in bf16's exponent range) rounded to bf16 once,
    to nearest even: what a bf16x2 instruction with .rn gives for the exact
    result that x holds."""
    u = x.view(torch.int64)
    u = (u + (1 << 44) - 1 + ((u >> 45) & 1)) & ~((1 << 45) - 1)
    return u.view(torch.float64)


@pytest.mark.parametrize("identity", ["add", "leaky", "rint"])
def test_qdq_kernel_arithmetic_matches_fp32_then_bf16(identity):
    """The QDQ mode's arithmetic in the kernel against the fp32 steps of the
    plain version, in plain torch: add.rn.bf16x2 of two bf16 values (one
    rounding of the exact sum) is their fp32 sum rounded to bf16, also
    where their exponents lie far apart; max(v, bf16(v * bf16(0.01))) is
    LeakyReLU's bf16(v * slope) below 0, for every finite bf16 v; and
    rounding a clamped t by adding and subtracting 1.5 * 2^23 in fp32 is
    rint(t) (half to even) over [-127.5, 127.5]."""
    rng = np.random.default_rng(7)
    if identity == "add":
        n = 1 << 20
        mant = rng.integers(128, 256, size=(2, n))
        exp = rng.integers(-60, 60, size=n)
        gap = rng.integers(0, 30, size=n)
        sign = rng.choice([-1.0, 1.0], size=(2, n))
        a = sign[0] * mant[0] * 2.0 ** (exp - 7.0)
        b = sign[1] * mant[1] * 2.0 ** (exp - gap - 7.0)
        a, b = torch.from_numpy(a), torch.from_numpy(b)
        assert torch.equal(a.bfloat16().double(), a)      # exact in bf16
        fp32 = (a.float() + b.float()).bfloat16().double()
        once = _bf16_round_once(a + b)                   # a + b exact here
        keep = (a + b) != 0
        assert torch.equal(fp32[keep], once[keep])
    elif identity == "leaky":
        bits = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32)
        v = bits.to(torch.int16).view(torch.bfloat16)
        v = v[torch.isfinite(v.float())]
        slope = torch.tensor(0.01).bfloat16()
        scaled = (v.float() * slope.float()).bfloat16()  # exact, then once
        want = torch.where(v.float() >= 0, v.float(), scaled.float())
        assert torch.equal(torch.maximum(v.float(), scaled.float()), want)
    else:
        k = torch.arange(-128, 128, dtype=torch.float32) + 0.5
        near = torch.cat([torch.nextafter(k, k + d) for d in (-1, 1)] + [k])
        t = torch.cat([near, torch.from_numpy(
            rng.uniform(-127.5, 127.5, 1 << 20).astype(np.float32))])
        t = t.clamp(-127, 127)
        magic = torch.tensor(12582912.0)
        assert torch.equal((t + magic) - magic, torch.round(t))


@pytest.mark.parametrize("seed", range(6))
def test_plain_qdq_block_is_the_same_on_a_qdq_box(seed):
    """The shared-box identity in the plain version: at act_scales (s, s,
    s, s_f), ``acff_infer_plain`` on x and on bf16(QDQ(x, s)) is bit-equal
    (features and output), at scales that spread x over +-127 codes, clip
    it, or leave it a few codes; the claim ``ACFF.kernel_input`` relies on
    too. Spatial and whole-image shapes at C = 8-64."""
    from rtdm_tpu_torch.quant.int8 import fake_quant_tensor
    rng = np.random.default_rng(100 + seed)
    c, o, hw = [(8, 64, 11), (16, 64, 9), (64, 96, 6)][seed % 3]
    x, *w = _kernel_args(rng, 2, c, o, hw, torch.bfloat16, "cpu")
    x = (x.float() * float(10.0 ** rng.uniform(-2, 2))).bfloat16()
    top = x.float().abs().max().item()
    for factor in (1.0, 0.3, 20.0):
        s = float(np.float32(top * factor / 127 * rng.uniform(0.9, 1.1)))
        s_f = float(np.float32(ops.depthwise_features(
            x, w[0], w[1]).abs().max().item() / 127))
        qs = (s, s, s, s_f)
        xq = fake_quant_tensor(x.float(), s).bfloat16()
        assert torch.equal(ops.depthwise_features(x, w[0], w[1], qs),
                           ops.depthwise_features(xq, w[0], w[1], qs))
        assert torch.equal(ops.acff_infer_plain(x, *w, act_scales=qs),
                           ops.acff_infer_plain(xq, *w, act_scales=qs))


def _kernel_args(rng, b, c, o, hw, dtype, device):
    x = torch.from_numpy(rng.normal(size=(b, hw, hw, c)).astype(np.float32))
    args = [rng.normal(size=(3, 3, 3, c)) * 0.3, rng.normal(size=(3, c)),
            rng.normal(size=(3 * c, o)) / np.sqrt(3 * c),
            rng.normal(size=(o,)), rng.uniform(0.5, 1.5, (o,)),
            rng.normal(size=(o,))]
    args = [torch.from_numpy(a.astype(np.float32)).to(device) for a in args]
    return [x.to(device=device, dtype=dtype)] + args


@pytest.mark.parametrize("bad", ["dtype", "shape", "weight_dtype",
                                 "noncontiguous", "tiny", "bf16_width",
                                 "bf16_channels", "bf16_smem",
                                 "fp32_channels", "fp32_width",
                                 "fp32_narrow", "fp32_extent"])
def test_kernel_checks_reject_what_it_does_not_take(rng, bad):
    """``_check`` rejects what no kernel call takes (a dtype, a shape, a
    layout, an image under 3x3). The shapes the kernels as they are do not
    take run too, as the reference kernel runs them: C and O that are no
    kernel step or width, and a bf16 block over ``SMEM_LIMIT``, through
    ``acff_decomposed`` (``is_direct`` is False); an extent past 256, the
    kernels' former limit, as one launch (the TMA tensor map takes it)."""
    x, *w = _kernel_args(rng, 2, 8, 64, 6, torch.float32, "cpu")
    ops._check(x, *w)             # what each case changes is what it rejects
    taken = True
    if bad == "fp32_channels":    # C=6: a TMA row of 24 bytes
        x, *w = _kernel_args(rng, 2, 6, 64, 6, torch.float32, "cpu")
    elif bad == "fp32_width":     # O=48: no width of the fp32 kernel
        x, *w = _kernel_args(rng, 2, 8, 48, 6, torch.float32, "cpu")
    elif bad == "fp32_narrow":    # O=32: no model's width, not instantiated
        x, *w = _kernel_args(rng, 2, 8, 32, 6, torch.float32, "cpu")
    elif bad == "fp32_extent":    # W=300: past the 256 the kernels took
        x, *w = _kernel_args(rng, 1, 8, 64, 6, torch.float32, "cpu")
        x = torch.zeros(1, 6, 300, 8)
    elif bad == "bf16_width":     # O=32: no wgmma width of the bf16 kernel
        x, *w = _kernel_args(rng, 2, 8, 32, 6, torch.bfloat16, "cpu")
    elif bad == "bf16_channels":  # C=12: a TMA row of 24 bytes
        x, *w = _kernel_args(rng, 2, 12, 64, 6, torch.bfloat16, "cpu")
    elif bad == "bf16_smem":      # an 8x8 tile at C=128, O=256: 236,800 B
        x, *w = _kernel_args(rng, 1, 128, 256, 16, torch.bfloat16, "cpu")
    else:
        taken = False
        if bad == "dtype":
            x = x.half()
        elif bad == "shape":
            w[2] = w[2][:, :16].contiguous()
            w[3] = w[3][:8]
        elif bad == "weight_dtype":
            w[0] = w[0].double()
        elif bad == "noncontiguous":
            x = x.transpose(1, 2)
        else:
            x = x[:, :2]
    if not taken:
        with pytest.raises(ValueError):
            ops._check(x, *w)
        return
    ops._check(x, *w)
    b, h, wd, c = x.shape
    assert ops.is_direct(x.dtype, None, c, w[2].shape[1],
                         ops.tile_plan(b, h, wd)) == (bad == "fp32_extent")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_call_without_its_operand_is_rejected(rng, dtype):
    """A CUDA call must bring fuse_w packed for its kernel: none, or the
    other kernel's operand, raises before any launch."""
    x, *w = _kernel_args(rng, 2, 16, 64, 9, dtype, "cpu")
    ops._check(x, *w)
    right, wrong = ops.pack_fuse_operand_tf32, ops.pack_fuse_operand
    if dtype == torch.bfloat16:
        right, wrong = wrong, right
    ops._check_operand(x, right(w[2]), 16, 64)
    for bad in (None, wrong(w[2]), right(w[2])[:-8]):
        with pytest.raises(ValueError):
            ops._check_operand(x, bad, 16, 64)


# bf16 kernel's dynamic shared memory at every (C, O, H=W) of the models'
# main paths, as acff_bf16_footprint of the built library gave it on an
# H100 (chip_smoke.py, which also fails where the two counts differ)
SMEM_BYTES = [(16, 64, 69, 39808), (8, 64, 69, 32512), (64, 96, 33, 110336),
              (96, 128, 15, 161280), (48, 128, 15, 97152),
              (128, 256, 6, 210176), (64, 256, 6, 168704),
              (128, 128, 13, 204032), (128, 128, 11, 204032),
              (128, 256, 9, 204032)]


@pytest.mark.parametrize("c,o,hw,want", SMEM_BYTES)
def test_bf16_smem_bytes_match_the_kernel(c, o, hw, want):
    at_256 = ops.bf16_smem_bytes(c, o, ops.tile_plan(256, hw, hw))
    assert at_256 == want <= ops.SMEM_LIMIT
    # a batch of one packs no more small images a tile: never more bytes
    assert ops.bf16_smem_bytes(c, o, ops.tile_plan(1, hw, hw)) <= want


# fp32 kernel's dynamic shared memory at every (C, O, H=W) of the models'
# main paths at batch 256, as acff_fp32_footprint of the built library gave
# it on an H100 (chip_smoke.py, which also fails where the two counts
# differ)
FP32_SMEM_BYTES = [(16, 64, 69, 84480), (8, 64, 69, 42368),
                   (64, 96, 33, 96768), (96, 128, 15, 109056),
                   (48, 128, 15, 109056), (128, 256, 6, 151552),
                   (64, 256, 6, 151552), (128, 128, 13, 109056),
                   (128, 128, 11, 109056), (128, 256, 9, 143616)]


@pytest.mark.parametrize("c,o,hw,want", FP32_SMEM_BYTES)
def test_fp32_smem_bytes_match_the_kernel(c, o, hw, want):
    at_256 = ops.fp32_smem_bytes(c, o, ops.tile_plan(256, hw, hw))
    assert at_256 == want <= ops.SMEM_LIMIT
    assert ops.fp32_smem_bytes(c, o, ops.tile_plan(1, hw, hw)) <= want


def test_fp32_smem_does_not_grow_with_channels():
    """Channels stream in chunks, so C does not bound the fp32 kernel's
    shared memory as it bounds the bf16 one: a block at C=256 takes what
    one at C=16 takes, and _check accepts it at the widest O."""
    for o in ops.WIDTHS:
        plan = ops.tile_plan(256, 69, 69)
        assert ops.fp32_smem_bytes(256, o, plan) \
            == ops.fp32_smem_bytes(16, o, plan) <= ops.SMEM_LIMIT
    x, *w = _kernel_args(np.random.default_rng(1), 1, 256, 256, 10,
                         torch.float32, "cpu")
    ops._check(x, *w)


@pytest.mark.parametrize("c,o", WIDTHS + [(16, 32), (12, 64), (4, 32)])
def test_fuse_operand_tf32_layout(c, o):
    """pack_fuse_operand_tf32 round-trips through its inverse; hi is fuse_w
    rounded to TF32 (ties away, as cvt.rna), hi + lo rebuilds fuse_w to
    within 2^-21 relative; padding channels are zero; and element (k, n)
    of chunk j, at the offset the kernel reads, is concat row
    d*C + j*KC + cl for k = d*KC + cl."""
    rng = np.random.default_rng(c * 1000 + o)
    fuse_w = torch.from_numpy(rng.normal(size=(3 * c, o)).astype(np.float32))
    packed = ops.pack_fuse_operand_tf32(fuse_w)
    kc, cp = ops.fp32_chunk(c), ops.fp32_padded_c(c)
    assert packed.dtype == torch.float32 and packed.shape == (6 * cp * o,)
    hi, lo = ops.unpack_fuse_operand_tf32(packed, c, o)
    assert hi.shape == lo.shape == (3, cp, o)
    want_hi = ops.tf32_round(fuse_w).reshape(3, c, o)
    assert torch.equal(hi[:, :c], want_hi)
    assert torch.equal(lo[:, :c], ops.tf32_round(fuse_w.reshape(3, c, o)
                                                 - want_hi))
    assert not hi[:, c:].abs().sum() and not lo[:, c:].abs().sum()
    # TF32: the low 13 bits of both halves are zero
    bits = packed.view(torch.int32)
    assert not (bits & 0x1FFF).any()
    rebuilt = (hi + lo)[:, :c].reshape(3 * c, o)
    rel = ((rebuilt - fuse_w).abs() / fuse_w.abs()).max().item()
    assert rel <= 2.0 ** -21
    # the chunk order, as the kernel reads it: chunk j is hi then lo, each
    # (3*KC) x O in K-major core matrices of 8 rows x 4 values
    k = 3 * kc
    for j in range(cp // kc):
        base = j * 2 * k * o
        for d, cl, n in ((0, 0, 0), (2, kc - 1, o - 1), (1, kc // 2, 9 % o)):
            row = d * c + j * kc + cl
            kk = d * kc + cl
            at = ((n // 8 * (k // 4) + kk // 4) * 8 + n % 8) * 4 + kk % 4
            want = (ops.tf32_round(fuse_w[row, n]) if j * kc + cl < c
                    else torch.tensor(0.0))
            assert packed[base + at] == want
            assert packed[base + k * o + at] == (
                ops.tf32_round(fuse_w[row, n] - want) if j * kc + cl < c
                else 0.0)


def test_tf32_round_to_nearest_ties_away():
    v = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -11 + 2.0 ** -20, 1.0 + 2.0 ** -12,
                      3.0], dtype=torch.float32)
    want = torch.tensor([1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10),
                         1.0 + 2.0 ** -10, 1.0, 3.0])
    assert torch.equal(ops.tf32_round(v), want)


def test_3xtf32_product_keeps_fp32_accuracy(rng):
    """The fp32 kernel's fuse product in plain torch: features and fuse_w
    split into TF32 hi and lo as the kernel splits them, products of TF32
    values exact in fp32, sums in fp32, as the tensor cores keep them. The
    three-term sum A_lo*B_hi + A_hi*B_lo + A_hi*B_hi is within 1e-6 of max
    |out| of the float64 product of the same features and fuse_w; the one
    term A_hi*B_hi (single TF32) is not. This is why the chip's float64
    gate (1e-5 of max |out|) tells full fp32 from a TF32 product."""
    c, o = 64, 96
    x, dw_w, dw_b, fuse_w, *_ = _kernel_args(rng, 2, c, o, 9, torch.float32,
                                             "cpu")
    xf = x.permute(0, 3, 1, 2)
    feat = torch.cat([torch.nn.functional.conv2d(
        xf, dw_w[d].permute(2, 0, 1).unsqueeze(1), dw_b[d], padding=d,
        dilation=d + 1, groups=c) for d in range(3)], 1)
    a = feat.permute(0, 2, 3, 1).reshape(-1, 3 * c)         # (P, 3C) fp32
    a_hi = ops.tf32_round(a)
    a_lo = ops.tf32_round(a - a_hi)
    hi, lo = ops.unpack_fuse_operand_tf32(
        ops.pack_fuse_operand_tf32(fuse_w), c, o)
    b_hi, b_lo = hi.reshape(3 * c, o), lo.reshape(3 * c, o)
    want = a.double() @ fuse_w.double()
    top = want.abs().max().item()
    three = a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi
    one = a_hi @ b_hi
    assert three.dtype == torch.float32
    assert (three.double() - want).abs().max().item() <= 1e-6 * top
    assert (one.double() - want).abs().max().item() > 1e-5 * top


def test_real_input_errors_see_rounding_toward_zero(monkeypatch):
    """chip_smoke.py's real-input gate on the CPU: ``acff_inputs`` collects
    each ACFF block's input, in forward order, at the first n images, and
    ``real_input_errors`` reads a kernel that shrinks every output by
    2^-20 (rounding toward zero) as a bias of -2^-20 of mean |out| and a
    largest error of 2^-20 of max |out| (give or take the plain fp32
    version's own); the plain version reads no bias and passes the
    gate."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    torch.manual_seed(0)
    net = torch.nn.Sequential(ACFF(8, 64), ACFF(64, 96)).eval()
    x = torch.randn(3, 11, 11, 8)
    with torch.inference_mode(), smoke.acff_inputs(net, 2) as blocks:
        out = net(x)
    assert [(n, tuple(t.shape)) for n, _, t in blocks] == [
        ("0", (2, 11, 11, 8)), ("1", (2, 9, 9, 64))]
    assert torch.equal(blocks[0][2], x[:2])
    shrink = 1 - 2.0 ** -20

    def kernel(x, *args):
        return ops.acff_infer_plain(x, *args[:6]) * shrink
    monkeypatch.setattr(ops, "acff_infer", kernel)
    with torch.inference_mode():
        rows = smoke.real_input_errors(blocks)
    assert [r["block"] for r in rows] == ["0", "1"]
    np.testing.assert_allclose(rows[1]["max_abs_out"],
                               out[:2].abs().max().item(), rtol=1e-6)
    for r in rows:
        assert abs(r["kernel_bias"] + 2.0 ** -20) < 2.0 ** -23
        assert abs(r["plain_bias"]) < 2.0 ** -25
        assert r["plain_max"] <= smoke.FP64_REL_TOL
        assert abs(r["kernel_max"] - 2.0 ** -20) <= r["plain_max"] + 2.0 ** -23


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    """fp32: rtol 1e-4 / atol 1e-5 with TF32 off for the plain version.
    bf16: 2e-2; both round the features and the output to bf16 (2^-8
    relative each), a different summation order can move either rounding by
    one step. Batches 1, 3 and 5 give ragged spatial tiles and packed small
    images with unused rows (6x6 and 9x9 inputs). An O=32 shape runs at
    O=64, the kernels' narrowest width. C=12 and C=4 run in fp32 only:
    their last fp32 channel chunk reaches past C (zero filled)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    for c, o, hw in SHAPES + [(128, 256, 6), (128, 256, 9), (48, 128, 15),
                              (96, 128, 13), (12, 64, 9), (4, 64, 7)]:
        for b in (1, 3, 5):
            for dtype, tol in ((torch.float32, (1e-4, 1e-5)),
                               (torch.bfloat16, (2e-2, 2e-2))):
                bf16 = dtype == torch.bfloat16
                if bf16 and c % 8:
                    continue
                ob = 64 if o == 32 else o
                args = _kernel_args(rng, b, c, ob, hw, dtype, "cuda")
                pack = (ops.pack_fuse_operand if bf16
                        else ops.pack_fuse_operand_tf32)
                fuse_op = pack(args[3])
                quant = "bf16" if bf16 else "fp32"
                before = dict(ops.LAUNCHES)
                got = ops.acff_infer(*args, fuse_op)
                torch.cuda.synchronize()
                assert ops.LAUNCHES[quant] == before[quant] + 1
                want = ops.acff_infer_plain(*args)
                assert got.dtype == dtype and got.shape == want.shape
                torch.testing.assert_close(got.float(), want.float(),
                                           rtol=tol[0], atol=tol[1])


def _qdq_scales(x, dw_w, dw_b, spread=(1.0, 1.3, 0.7)):
    """Scales that spread the int8 codes over +-127: s_xd = max|x| / 127
    (times a factor a branch, so that the branches' scales differ) and s_f
    from the bf16 features of the plain version."""
    top = x.float().abs().max().item()
    feat = ops.depthwise_features(x, dw_w, dw_b)
    return tuple(top * f / 127 for f in spread) + (
        feat.abs().max().item() / 127,)


@pytest.mark.cuda
def test_cuda_qdq_mode_matches_plain():
    """The bf16 kernel's int8 QDQ mode against acff_infer_plain with the
    same act_scales, at batch 1, 3 and 5: spatial tiles (C=16, 96) and
    packed whole images (C=64 and 128 at 6x6), with equal branch scales
    (the shared-box variant, ``LAUNCHES["int8"]``) and unequal ones (the
    per-branch variant, ``"int8_branch"``). Held at bf16's 2e-2: both
    round the features and the output to bf16, and the fuse product's
    sum, rounded to bf16 before the bias, can round the other way in
    another summation order; a feature that moves by one bf16 step moves
    by at most one int8 code. The C entry refuses the shared variant
    (mode 2) at unequal scales."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(1)
    for c, o, hw in [(16, 64, 11), (96, 128, 15), (64, 256, 6),
                     (128, 256, 6)]:
        for b in (1, 3, 5):
            for spread, variant in (((1.0, 1.0, 1.0), "int8"),
                                    ((1.0, 1.3, 0.7), "int8_branch")):
                args = _kernel_args(rng, b, c, o, hw, torch.bfloat16,
                                    "cuda")
                qs = _qdq_scales(args[0], args[1], args[2], spread)
                fuse_op = ops.pack_fuse_operand(args[3])
                before = dict(ops.LAUNCHES)
                got = ops.acff_infer(*args, fuse_op, act_scales=qs)
                torch.cuda.synchronize()
                assert ops.LAUNCHES == {
                    k: n + (k == variant) for k, n in before.items()}
                want = ops.acff_infer_plain(*args, act_scales=qs)
                assert got.dtype == torch.bfloat16 and got.shape == want.shape
                torch.testing.assert_close(got.float(), want.float(),
                                           rtol=2e-2, atol=2e-2)
    plan = ops.tile_plan(b, hw, hw)
    with pytest.raises(RuntimeError, match="CUDA error"):
        ops.ACFF_KERNEL.launch(
            args[0].data_ptr(), args[1].data_ptr(), args[2].data_ptr(),
            fuse_op.data_ptr(), *(a.data_ptr() for a in args[4:]),
            got.data_ptr(), b, hw, hw, c, o, ops.MODES["int8"], o,
            *plan.scalars(), *qs, torch.cuda.current_stream().cuda_stream)


# (C, O, H) that acff_decomposed cuts: C padded, O split, the wide-C
# variant, and a small image whose variant depends on the batch
DECOMPOSED = [(12, 40, 9), (8, 300, 6), (160, 128, 18), (256, 128, 6),
              (136, 96, 6)]
# the models' blocks at their main-path inputs
WIDTHS_HW = [(8, 64, 69), (16, 64, 33), (64, 96, 15), (96, 128, 6)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,o,hw", DECOMPOSED + WIDTHS_HW)
def test_for_shape_holds_every_launch_of_any_batch(c, o, hw, dtype):
    """``FuseOperands.for_shape`` gives the registered op, once for an
    H x W, every operand that a launch at any batch reads: for each batch
    1..``TILE_PIXELS`` (the plan's images a tile saturate there; over it
    the plan is the same), the direct operand, or the key of each launch
    of the decomposition."""
    fuse_w = torch.randn(3 * c, o)
    fuse = ops.FuseOperands(fuse_w, dtype)
    tensors = fuse.for_shape(hw, hw)
    keys = ops.operand_keys(c, o, dtype, hw, hw)
    assert len(tensors) == len(keys)
    for key, at in keys.items():
        assert tensors[at] is fuse.get(*key)
    for b in range(1, ops.TILE_PIXELS + 1):
        plan = ops.tile_plan(b, hw, hw)
        if ops.is_direct(dtype, None, c, o, plan):
            assert (0, o, False) in keys
            continue
        for o0, _, width in ops.o_splits(o):
            variant = ops.kernel_variant(dtype, None, fuse.c_pad, width, plan)
            assert (o0, width, variant.endswith("_wide")) in keys



def test_registered_op_is_the_plain_version_on_cpu(rng):
    """On the CPU ``rtdm::acff_infer`` is ``acff_infer_plain`` (operands
    not read), in fp32, bf16 and the int8 QDQ mode, and its fake gives the
    output's shape and dtype; the op refuses bad scales as the wrapper
    does."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    for dtype, scales in ((torch.float32, None), (torch.bfloat16, None),
                          (torch.bfloat16, [0.02, 0.02, 0.02, 0.05])):
        args = _kernel_args(rng, 3, 16, 64, 9, dtype, "cpu")
        got = torch.ops.rtdm.acff_infer(*args, [], scales)
        want = ops.acff_infer_plain(*args, act_scales=scales)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        with FakeTensorMode() as mode:
            fake = torch.ops.rtdm.acff_infer(
                *(mode.from_tensor(a) for a in args), [], scales)
        assert fake.shape == (3, 7, 7, 64) and fake.dtype == dtype
    with pytest.raises(ValueError, match="act_scales"):
        torch.ops.rtdm.acff_infer(*_kernel_args(rng, 1, 8, 64, 6,
                                                torch.float32, "cpu"),
                                  [], [0.1, 0.1, 0.1, 0.1])


@pytest.mark.cuda
def test_cuda_registered_op_equals_kernel_call():
    """On the card ``rtdm::acff_infer`` is the hand-written kernel: bit for
    bit the wrapper's direct call with ``FuseOperands``, in fp32, bf16 and
    both int8 QDQ variants, at the models' shapes and the decomposed ones,
    counting the same launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(2)
    for c, o, hw in WIDTHS_HW + DECOMPOSED:
        for dtype, spread in ((torch.float32, None), (torch.bfloat16, None),
                              (torch.bfloat16, (1.0, 1.0, 1.0)),
                              (torch.bfloat16, (1.0, 1.3, 0.7))):
            for b in (1, 5):
                args = _kernel_args(rng, b, c, o, hw, dtype, "cuda")
                qs = (None if spread is None
                      else list(_qdq_scales(*args[:3], spread)))
                fuse = ops.FuseOperands(args[3], dtype)
                tensors = fuse.for_shape(hw, hw, qs)
                before = dict(ops.LAUNCHES)
                want = ops.acff_infer(*args, fuse, act_scales=qs)
                torch.cuda.synchronize()
                direct = {k: ops.LAUNCHES[k] - n for k, n in before.items()}
                assert sum(direct.values()) >= 1
                before = dict(ops.LAUNCHES)
                got = torch.ops.rtdm.acff_infer(*args, tensors, qs)
                torch.cuda.synchronize()
                assert {k: ops.LAUNCHES[k] - n
                        for k, n in before.items()} == direct
                assert torch.equal(got, want), (c, o, hw, dtype, spread, b)
