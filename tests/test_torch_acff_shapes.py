"""Every shape the reference ACFF kernel takes runs in the port.

``rtdm_tpu/ops/acff_pallas.py::fused_acff_infer`` takes any B, H, W, C and
O. The port's kernels take C in steps of 8 (bf16) or 4 (fp32), O in
``WIDTHS`` and, in bf16, a block within 227 KB; ``ops/acff.py::
acff_decomposed`` pads C, cuts and pads O and writes each launch into its
columns of one output, and the wide-C variant takes the large-C bf16
blocks. On the CPU the decomposition runs with the plain version as its
launch and must equal the whole plain call exactly (tolerance 0): the
inputs are small integers and powers of two, so every sum is exact in any
order and each output value is the same function of the same terms.
The test marked ``cuda`` holds the kernels at these shapes against the
plain version on the card:
    python -m pytest --noconftest -m cuda tests/test_torch_acff_shapes.py
"""

import numpy as np
import pytest
import torch

from rtdm_tpu_torch.ops import acff as ops

# (C, O, H=W) of every ACFF block on the three models' main paths
MAIN_PATH = [(16, 64, 69), (64, 96, 33), (96, 128, 15), (128, 256, 6),
             (8, 64, 69), (48, 128, 15), (64, 256, 6), (16, 64, 119),
             (64, 96, 58), (96, 128, 28), (128, 128, 13), (128, 128, 11),
             (128, 256, 9)]
CHANNELS = (3, 12, 150, 300)
OUTPUTS = (1, 32, 100, 320)
# (C, O, H=W) of the wide-C variant at batch 256 (chip_smoke.WIDE_SHAPES)
WIDE_SHAPES = [(160, 128, 18), (256, 128, 18), (192, 256, 18),
               (384, 128, 18)]
# mode -> act_scales (None: the kernel of x's dtype); the int8 scales are
# powers of two, under which QDQ keeps the integer inputs exact
MODES = {"fp32": None, "bf16": None, "int8": (1.0, 1.0, 1.0, 1.0),
         "int8_branch": (1.0, 2.0, 0.5, 1.0)}


def _int_args(seed, b, c, o, hw, mode):
    """Small integers (scale: powers of two), so that every product and sum
    of the block is exact in fp32 and in bf16."""
    rng = np.random.default_rng(seed)

    def ints(*shape):
        return torch.from_numpy(rng.integers(-2, 3, shape).astype(np.float32))
    x = ints(b, hw, hw, c)
    if mode != "fp32":
        x = x.bfloat16()
    scale = torch.from_numpy(
        2.0 ** rng.integers(-1, 2, (o,)).astype(np.float32))
    return [x, ints(3, 3, 3, c), ints(3, c), ints(3 * c, o), ints(o), scale,
            ints(o)]


def _plain_launch(act_scales, calls):
    def launch(x, dw_w, dw_b, fuse_w, fuse_b, scale, shift, out, o0):
        width = fuse_w.shape[1]
        calls.append((x.shape[-1], o0, width))
        out[..., o0:o0 + width] = ops.acff_infer_plain(
            x, dw_w, dw_b, fuse_w, fuse_b, scale, shift, act_scales)
    return launch


def _decomposed_equals_whole(b, c, o, hw, mode, seed=0):
    args = _int_args(seed, b, c, o, hw, mode)
    qs = MODES[mode]
    calls = []
    got = ops.acff_decomposed(*args, _plain_launch(qs, calls))
    want = ops.acff_infer_plain(*args, act_scales=qs)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert got.is_contiguous()
    assert torch.equal(got, want)
    cp = ops.padded_channels(c, args[0].dtype)
    assert calls == [(cp, o0, w) for o0, _, w in ops.o_splits(o)]
    return calls


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("o", OUTPUTS)
@pytest.mark.parametrize("c", CHANNELS)
def test_decomposition_is_exact_small_images(c, o, mode):
    _decomposed_equals_whole(2, c, o, 3, mode)


@pytest.mark.parametrize("mode", ["fp32", "bf16", "int8_branch"])
@pytest.mark.parametrize("c,o", list(zip(CHANNELS, OUTPUTS)))
def test_decomposition_is_exact_at_300(c, o, mode):
    _decomposed_equals_whole(1, c, o, 300, mode, seed=c)


@pytest.mark.parametrize("mode", ["fp32", "bf16"])
def test_decomposition_is_exact_past_65535_images(mode):
    _decomposed_equals_whole(65537, 1, 32, 3, mode)


def test_o_splits_cover_every_column_once():
    for o in range(1, 700):
        splits = ops.o_splits(o)
        assert [s[0] for s in splits] == list(range(0, o, 256))
        assert sum(s[1] for s in splits) == o
        assert all(w in ops.WIDTHS and w >= oc for _, oc, w in splits)


@pytest.mark.parametrize("b", [1, 3, 256])
@pytest.mark.parametrize("c,o,hw", MAIN_PATH)
def test_main_path_shapes_take_the_kernels_as_they_are(b, c, o, hw):
    """Each block of the models runs as one launch of today's kernels, in
    every mode: the decomposition and the wide-C variant engage only where
    the kernels as they are refuse a shape."""
    plan = ops.tile_plan(b, hw, hw)
    for dtype, qs in ((torch.float32, None), (torch.bfloat16, None),
                      (torch.bfloat16, MODES["int8"]),
                      (torch.bfloat16, MODES["int8_branch"])):
        assert ops.is_direct(dtype, qs, c, o, plan)
    assert ops.kernel_variant(torch.bfloat16, None, c, o, plan) == "bf16"


@pytest.mark.parametrize("c,o,hw,wide", [
    (144, 128, 16, False), (152, 128, 16, True), (120, 256, 16, False),
    (128, 256, 16, True), (256, 64, 16, True), (264, 64, 16, True),
    (128, 256, 6, False), (160, 128, 3, True)])
def test_wide_variant_engages_where_the_bf16_block_does_not_fit(c, o, hw,
                                                                  wide):
    plan = ops.tile_plan(256, hw, hw)
    assert (ops.bf16_smem_bytes(c, o, plan) > ops.SMEM_LIMIT
            or c > ops.TMA_BOX_MAX) == wide
    for qs, base in ((None, "bf16"), (MODES["int8"], "int8"),
                     (MODES["int8_branch"], "int8_branch")):
        assert ops.kernel_variant(torch.bfloat16, qs, c, o, plan) == \
            base + "_wide" * wide
    # the fp32 kernel streams its channels: never a wide variant
    assert ops.kernel_variant(torch.float32, None, c, o, plan) == "fp32"
    assert ops.bf16_wide_smem_bytes(
        o, ops.wide_tile_plan(256, hw, hw, o)) <= ops.SMEM_LIMIT


@pytest.mark.parametrize("o", ops.WIDTHS)
def test_wide_smem_fits_every_plan(o):
    """The wide variant's block fits 227 KB at every tile plan of
    ``wide_tile_plan`` (C does not enter it): its spatial tile (16x8 at O
    <= 128, 8x8 at O = 256) and every packing of whole small images, whose
    box is never larger than the spatial tile's."""
    plans = [ops.wide_tile_plan(b, hw, hw, o) for b in (1, 3, 256)
             for hw in list(range(3, 11)) + [11, 18, 300]]
    plans += [ops.wide_tile_plan(256, 3, w, o) for w in range(3, 11)]
    spatial = ops.wide_tile_plan(256, 18, 18, o)
    assert (spatial.th, spatial.tw) == (16 if o <= 128 else 8, 8)
    for p in plans:
        assert p.images * p.hy * p.hx <= spatial.hy * spatial.hx
        assert p.images * p.th * p.tw <= ops.wide_rows(o)
    assert max(ops.bf16_wide_smem_bytes(o, p) for p in plans) \
        == ops.bf16_wide_smem_bytes(o, spatial) <= ops.SMEM_LIMIT


def _wide_rows_pixels(plan, o, t):
    """(batch index, row, column, live) of A's rows of tile t, as the wide
    kernel's epilogue maps them: image-major, then row-major (a spatial
    tile is one image's th x 8 pixels)."""
    m = np.arange(ops.wide_rows(o))
    b0, oy0, ox0 = plan.tile_origin(t)
    img, q = divmod(m, plan.th * plan.tw)
    py, px = divmod(q, plan.tw)
    return b0 + img, oy0 + py, ox0 + px, img < plan.images


@pytest.mark.parametrize("o", [128, 256])
@pytest.mark.parametrize("b", [1, 3, 256])
@pytest.mark.parametrize("hw", [3, 6, 18, 37, 300])
def test_wide_tile_plan_covers_each_pixel_once(hw, b, o):
    """Every output pixel of the batch is one live row of one tile of
    ``wide_tile_plan``, spatial tiles and packed whole images alike, and a
    spatial tile's box holds every tap of its pixels (a (th + 6) x 15 box
    from (oy0 - 2, ox0 - 2), its rows an odd number of pixels apart)."""
    plan = ops.wide_tile_plan(b, hw, hw, o)
    oh = hw - 2
    if plan.origin == 2:
        assert plan.hy >= plan.th + ops.HALO and plan.hx >= plan.tw + ops.HALO
        assert plan.hx % 2 == 1
    seen = np.zeros(b * oh * oh, bool)
    step = max(1, (1 << 20) // ops.wide_rows(o))
    for t0 in range(0, plan.n_tiles, step):
        rows = [_wide_rows_pixels(plan, o, t)
                for t in range(t0, min(plan.n_tiles, t0 + step))]
        bi, y, x, live = (np.concatenate(a) for a in zip(*rows))
        live &= (bi < b) & (y < oh) & (x < oh)
        idx = (bi[live] * oh + y[live]) * oh + x[live]
        assert len(np.unique(idx)) == len(idx) and not seen[idx].any()
        seen[idx] = True
    assert seen.all()


@pytest.mark.parametrize("c,o", [(152, 64), (160, 128), (256, 256),
                                 (300, 96), (8, 64)])
def test_fuse_operand_wide_layout(c, o):
    """pack_fuse_operand_wide round-trips through its inverse, zero past C,
    and element (k, n) of chunk j lies where the kernel's descriptors read
    it: ((n//8 * kc//8 + k//8) * 8 + n%8) * 8 + k%8, kc = 3*WIDE_KC."""
    rng = np.random.default_rng(c + o)
    fuse_w = torch.from_numpy(rng.normal(size=(3 * c, o)).astype(np.float32))
    packed = ops.pack_fuse_operand_wide(fuse_w)
    cp = -(-c // ops.WIDE_KC) * ops.WIDE_KC
    assert packed.dtype == torch.bfloat16 and packed.numel() == 3 * cp * o
    back = ops.unpack_fuse_operand_wide(packed, c, o)
    assert torch.equal(back[:, :c],
                       fuse_w.bfloat16().reshape(3, c, o))
    assert not back[:, c:].any()
    kc = 3 * ops.WIDE_KC
    wb = fuse_w.bfloat16()
    for j, k, n in [(0, 0, 0), (0, 5, 9), (cp // ops.WIDE_KC - 1, kc - 1,
                                            o - 1), (0, 40, o // 2)]:
        d, cl = divmod(k, ops.WIDE_KC)
        ch = j * ops.WIDE_KC + cl
        want = wb[d * c + ch, n] if ch < c else 0
        at = j * kc * o + ((n // 8 * kc // 8 + k // 8) * 8 + n % 8) * 8 \
            + k % 8
        assert packed[at] == want


def test_fuse_operands_pack_each_launch_once():
    rng = np.random.default_rng(3)
    fuse_w = torch.from_numpy(rng.normal(size=(3 * 150, 320))
                              .astype(np.float32))
    ops_ = ops.FuseOperands(fuse_w, torch.bfloat16)
    assert ops_.direct is None and ops_.c_pad == 152
    first = ops_.get(256, 64, False)
    assert ops_.get(256, 64, False) is first
    padded = torch.zeros(3, 152, 320)
    padded[:, :150] = fuse_w.reshape(3, 150, 320)
    padded = padded.reshape(3 * 152, 320)
    assert torch.equal(first, ops.pack_fuse_operand(padded[:, 256:]))
    assert torch.equal(ops_.get(0, 256, True),
                       ops.pack_fuse_operand_wide(padded[:, :256]))
    direct = ops.FuseOperands(fuse_w[:3 * 16, :64].contiguous(),
                              torch.float32)
    assert torch.equal(direct.direct, ops.pack_fuse_operand_tf32(
        fuse_w[:48, :64]))


@pytest.mark.cuda
def test_cuda_shapes_past_the_kernels_match_plain():
    """Fault 2's shapes on the card, each mode, against the plain version:
    C in {3, 12, 150, 300}, O in {1, 32, 100, 320}, H = W in {3, 300}
    (batch 2 and 1), a batch of 65537 3x3 images at C = 1, and the wide-C
    variant's timed shapes at batch 3 and 256. fp32 at
    rtol 1e-4 / atol 1e-5 (TF32 off for the plain version), bf16 and int8
    at bf16's 2e-2 (the features and the output are rounded to bf16; the
    wide-C variant sums K in chunk order), as the kernels' own tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = [(2, c, o, 3) for c in CHANNELS for o in OUTPUTS]
    cases += [(1, c, o, 300) for c, o in zip(CHANNELS, OUTPUTS)]
    cases += [(65537, 1, 32, 3)]
    # the wide-C variant's timed shapes (chip_smoke.WIDE_SHAPES)
    cases += [(b, c, o, hw) for b in (3, 256) for c, o, hw in WIDE_SHAPES]
    rng = np.random.default_rng(0)
    for b, c, o, hw in cases:
        for mode, qs in MODES.items():
            dtype = torch.float32 if mode == "fp32" else torch.bfloat16
            x = torch.from_numpy(rng.normal(size=(b, hw, hw, c))
                                 .astype(np.float32)).to("cuda", dtype)
            w = [rng.normal(size=(3, 3, 3, c)) * 0.3, rng.normal(size=(3, c)),
                 rng.normal(size=(3 * c, o)) / np.sqrt(3 * c),
                 rng.normal(size=(o,)), rng.uniform(0.5, 1.5, (o,)),
                 rng.normal(size=(o,))]
            w = [torch.from_numpy(a.astype(np.float32)).cuda() for a in w]
            if qs is not None:
                top = x.float().abs().max().item() / 127
                feat = ops.depthwise_features(x, w[0], w[1])
                qs = tuple(top * f for f in qs[:3]) + (
                    feat.abs().max().item() / 127,)
            got = ops.acff_infer(x, *w, ops.FuseOperands(w[2], dtype),
                                 act_scales=qs)
            want = ops.acff_infer_plain(x, *w, act_scales=qs)
            torch.cuda.synchronize()
            tol = (1e-4, 1e-5) if mode == "fp32" else (2e-2, 2e-2)
            assert got.shape == want.shape == (b, hw - 2, hw - 2, o)
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=tol[0], atol=tol[1])
