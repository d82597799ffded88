"""The port's fused ACFF block against the JAX package: ``acff_infer_plain``
and the ``ACFF`` module against ``rtdm_tpu.models.acff.ACFF.apply`` and
against the Pallas kernel in interpret mode, at rtol 1e-4 / atol 1e-5 (the
bounds of tests/test_acff_pallas.py; fp32 on both sides, sums in another
order), and in bf16 against ``ACFF.apply`` run as the JAX bf16 engine runs
it. Also the host side of the bf16 kernel: the B operand layout and the
tile plan.

JAX is imported inside the fixture that needs it, so that the test marked
``cuda`` also runs where JAX is not installed:
    python -m pytest --noconftest -m cuda tests/test_torch_acff.py
"""

import types

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
    # the bf16 kernel's B operand is packed with the rest, for bf16 only
    assert again[6] is None
    bf16 = mod.to(torch.bfloat16).packed()
    assert torch.equal(bf16[6], ops.pack_fuse_operand(bf16[2]))


def test_training_mode_is_not_ported():
    with pytest.raises(NotImplementedError):
        ACFF(8, 32).train()(torch.zeros(1, 6, 6, 8))


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
                                 "bf16_channels", "bf16_smem"])
def test_kernel_checks_reject_what_it_does_not_take(rng, bad):
    x, *w = _kernel_args(rng, 2, 8, 32, 6, torch.float32, "cpu")
    if bad == "bf16_width":       # O=32: no wgmma width of the bf16 kernel
        x, *w = _kernel_args(rng, 2, 8, 32, 6, torch.bfloat16, "cpu")
    elif bad == "bf16_channels":  # C=12: a TMA row of 24 bytes
        x, *w = _kernel_args(rng, 2, 12, 64, 6, torch.bfloat16, "cpu")
    elif bad == "bf16_smem":      # an 8x8 tile at C=128, O=256: 236,800 B
        x, *w = _kernel_args(rng, 1, 128, 256, 16, torch.bfloat16, "cpu")
    elif bad == "dtype":
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
    with pytest.raises(ValueError):
        ops._check(x, *w)


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


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    """fp32: rtol 1e-4 / atol 1e-5 with TF32 off for the plain version.
    bf16: 2e-2; both round the features and the output to bf16 (2^-8
    relative each), a different summation order can move either rounding by
    one step. Batches 1, 3 and 5 give ragged spatial tiles and packed small
    images with unused rows (6x6 and 9x9 inputs). O=32 runs in fp32 only:
    the bf16 kernel's narrowest width is 64."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    for c, o, hw in SHAPES + [(128, 256, 6), (128, 256, 9), (48, 128, 15),
                              (96, 128, 13)]:
        for b in (1, 3, 5):
            for dtype, tol in ((torch.float32, (1e-4, 1e-5)),
                               (torch.bfloat16, (2e-2, 2e-2))):
                bf16 = dtype == torch.bfloat16
                ob = 64 if bf16 and o == 32 else o
                args = _kernel_args(rng, b, c, ob, hw, dtype, "cuda")
                fuse_op = ops.pack_fuse_operand(args[3]) if bf16 else None
                quant = "bf16" if bf16 else "fp32"
                before = dict(ops.LAUNCHES)
                got = ops.acff_infer(*args, fuse_op)
                torch.cuda.synchronize()
                assert ops.LAUNCHES[quant] == before[quant] + 1
                want = ops.acff_infer_plain(*args)
                assert got.dtype == dtype and got.shape == want.shape
                torch.testing.assert_close(got.float(), want.float(),
                                           rtol=tol[0], atol=tol[1])
