"""Fused ACFF inference block: the Hopper kernels, their wrapper and their
plain version.

Counterpart of ``rtdm_tpu/ops/acff_pallas.py``. ``acff_infer`` computes, on
an NHWC batch, three 3x3 depthwise convs at dilation 1/2/3 with padding
0/1/2 (each with a bias), their concat to 3C channels, the 1x1 fuse as a
(P,3C)x(3C,O) product plus bias, LeakyReLU(0.01) and the folded inference
BN ``out*scale + shift``; out is (B, H-2, W-2, O) in x's dtype.

On a CUDA tensor it launches ``csrc/acff.cu`` or raises; on a CPU tensor it
runs ``acff_infer_plain``. The models call it as the registered op
``rtdm::acff_infer`` (``acff_infer_op``: its CUDA route this wrapper's
launches, its CPU route the plain version, a fake for the output's shape),
which ``torch.export`` keeps as one node; the op takes fuse_w packed for
every launch a batch may need at the input's H x W
(``FuseOperands.for_shape``, in ``operand_keys``' order). Two kernels sit
behind the one C entry point, both with the fuse product on tensor cores
(``wgmma``):

- fp32 x: 3xTF32 kernel, C a multiple of 4, O in ``WIDTHS``, a
  block's shared memory (``fp32_smem_bytes``) within ``SMEM_LIMIT``
  (channels stream in chunks, so C does not enter it); full fp32
  accuracy: the depthwise and the epilogue are fp32 FMAs, the fuse product
  sums A_lo*B_hi + A_hi*B_lo + A_hi*B_hi of TF32 halves
  (``pack_fuse_operand_tf32`` splits fuse_w);
- bf16 x: C a multiple of 8, O in
  ``WIDTHS``; C <= 256 and a block's shared memory (``bf16_smem_bytes``)
  within ``SMEM_LIMIT`` (on an 8x8 tile C <= 144 at O <= 128 and C <= 120
  at O = 256; every ACFF block of the three models fits), else its wide-C
  variant, which takes the channels in chunks of ``WIDE_KC``
  (``pack_fuse_operand_wide``, ``bf16_wide_smem_bytes``). The depthwise
  features are computed in fp32 and rounded to bf16 once, as the JAX bf16
  engine rounds each branch; the fuse product reads fuse_w rounded to bf16
  from ``pack_fuse_operand``'s layout; the epilogue is fp32 and the output
  is rounded once;
- bf16 x with ``act_scales``: the bf16 kernel's int8 QDQ mode, the ACFF
  block of the JAX int8 engine (``quant/int8.py``): x QDQ'd per branch, the
  features rounded and QDQ'd, the epilogue rounded as that engine rounds
  it (``depthwise_features``, ``acff_infer_plain``). QDQ multiplies by the
  fp32 reciprocal of the scale, as XLA compiles the JAX engine's division
  by a constant; the C entry takes the four scales and makes the
  reciprocals. Two variants compute it (``qdq_variant``): "int8", where
  the three depthwise scales are one (as calibration makes them), QDQs
  each input box element once in shared memory; "int8_branch" QDQs each
  load with its branch's scale.

Every other shape the reference kernel takes (any B >= 1, H, W >= 3, C and
O) runs through ``acff_decomposed``: C zero-padded to the kernel's multiple
(zero input, depthwise weights, biases and fuse rows), O cut into launches
of at most 256 columns, each padded to the next width in ``WIDTHS`` with
zero fuse columns, scale and shift, written into its columns of one output
(the C entry's output row stride); the result is exact. The kernels
themselves take any B, H and W. ``FuseOperands`` packs fuse_w for every
launch once (``ACFF.packed()``).

The host side of the kernels lives here, where the CPU tests reach it:
``tile_plan`` (which output pixels one thread block owns, both kernels),
``pack_fuse_operand`` / ``pack_fuse_operand_tf32`` (fuse_w in each
kernel's shared-memory B layout), ``fp32_chunk`` (the fp32 kernel's
channels a pass) and ``bf16_smem_bytes`` / ``fp32_smem_bytes`` (each
kernel's shared-memory layout, by size).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from contextlib import nullcontext
from typing import (Callable, Dict, List, Mapping, Optional, Sequence, Tuple,
                    Union)

import torch
import torch.nn.functional as F

from rtdm_tpu_torch.ops.kernels import CudaKernel
from rtdm_tpu_torch.quant.int8 import fake_quant_tensor

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
ACFF_KERNEL = CudaKernel("acff", "acff_infer_launch",
                         [_P] * 8 + [_I] * 16 + [_F] * 4 + [_P])
# Launches of each kernel behind ACFF_KERNEL, counted where the runtime
# accepted them ("bf16": the bf16 kernel, "int8" and "int8_branch": its
# QDQ mode with the box QDQ'd once or per branch, "fp32": the 3xTF32
# kernel, "*_wide": the bf16 kernel's wide-C variant in each of its modes).
LAUNCHES = {"bf16": 0, "int8": 0, "int8_branch": 0, "fp32": 0,
            "bf16_wide": 0, "int8_wide": 0, "int8_branch_wide": 0}
# the C entry's mode argument
MODES = {"fp32": 0, "bf16": 1, "int8": 2, "int8_branch": 3, "bf16_wide": 4,
         "int8_wide": 5, "int8_branch_wide": 6}

Packed = Tuple[torch.Tensor, ...]

TILE_PIXELS = 64        # one wgmma M: output pixels per thread block
TILE_SIDE = 8           # the spatial tile is 8x8 output pixels
HALO = 6                # branch 3 reaches 2 pixels before and 4 after
K_CHUNK = 64            # fuse_w rows per streamed B chunk
A_LBO = 144             # bytes between A's core matrices that follow in K
FP32_A_LBO = 160        # the same in the fp32 kernel's A
SMEM_LIMIT = 227 * 1024  # dynamic shared memory of one block on an H100
WIDTHS = (64, 96, 128, 256)   # O of both kernels: two warpgroups of N = O/2
WIDE_KC = 32            # input channels a pass of the bf16 wide-C variant
TMA_BOX_MAX = 256       # elements of one TMA box dimension: the bf16 C
MAX_TILES = 2 ** 31 - 1   # the C entry's tile count is an int


def depthwise_features(x: torch.Tensor, dw_w: torch.Tensor,
                       dw_b: torch.Tensor,
                       act_scales: Optional[Sequence[float]] = None
                       ) -> torch.Tensor:
    """The three depthwise branches concatenated, (B, 3C, H-2, W-2) NCHW,
    as the fuse product reads them: in fp32 (fp64 for a float64 x), and for
    a bf16 x rounded to bf16.

    With ``act_scales`` = (s_x1, s_x2, s_x3, s_f), x bf16, the int8 QDQ
    engine's rounding steps, in the JAX int8 engine's order: branch d reads
    bf16(QDQ(x, s_xd)); its sum without the bias is rounded to bf16, then
    the bias rounded to bf16 is added and the sum rounded again (a JAX bf16
    ``DepthwiseConv``); the concat is QDQ'd with s_f in fp32 and rounded to
    bf16."""
    c = x.shape[-1]
    ct = torch.float64 if x.dtype == torch.float64 else torch.float32
    xf = x.to(ct).permute(0, 3, 1, 2)

    def branch(d, inp, bias):
        return F.conv2d(inp, dw_w[d].to(ct).permute(2, 0, 1).unsqueeze(1),
                        bias, padding=d, dilation=d + 1, groups=c)
    if act_scales is None:
        feat = torch.cat([branch(d, xf, dw_b[d].to(ct)) for d in range(3)],
                         1)
        return feat.to(x.dtype).float() if x.dtype == torch.bfloat16 \
            else feat

    def bf16(t):
        return t.to(torch.bfloat16).float()
    feats = []
    for d in range(3):
        y = bf16(branch(d, bf16(fake_quant_tensor(xf, act_scales[d])), None))
        feats.append(bf16(y + bf16(dw_b[d].float())[:, None, None]))
    return bf16(fake_quant_tensor(torch.cat(feats, 1), act_scales[3]))


def acff_infer_plain(x: torch.Tensor, dw_w: torch.Tensor, dw_b: torch.Tensor,
                     fuse_w: torch.Tensor, fuse_b: torch.Tensor,
                     scale: torch.Tensor, shift: torch.Tensor,
                     act_scales: Optional[Sequence[float]] = None
                     ) -> torch.Tensor:
    """The kernel's function in PyTorch ops, computed in fp32 (in fp64
    for a float64 x, the reference the fp32 kernel is held to).

    x: (B,H,W,C); dw_w: (3,3,3,C) [branch, kh, kw, C]; dw_b: (3,C);
    fuse_w: (3C,O); fuse_b/scale/shift: (O,). Returns (B,H-2,W-2,O) in
    x's dtype. For a bf16 x the concatenated features and fuse_w are
    rounded to bf16 before the fuse product, as the bf16 kernel does.
    ``act_scales`` (bf16 x only) makes it the int8 QDQ block, as
    ``depthwise_features`` computes its features; fuse_w is taken as
    stored (an int8 engine's is QDQ'd and rounded to bf16 already)."""
    ct = torch.float64 if x.dtype == torch.float64 else torch.float32
    feat, w = depthwise_features(x, dw_w, dw_b, act_scales), fuse_w.to(ct)
    if x.dtype == torch.bfloat16:
        w = w.to(x.dtype).float()
    if act_scales is None:
        y = F.leaky_relu(F.conv2d(feat, w.t()[:, :, None, None],
                                  fuse_b.to(ct)), 0.01)
    else:
        def bf16(t):
            return t.to(torch.bfloat16).float()
        y = bf16(F.conv2d(feat, w.t()[:, :, None, None]))
        y = bf16(y + bf16(fuse_b.float())[:, None, None])
        y = torch.where(y >= 0, y, bf16(y * bf16(torch.tensor(0.01))))
    y = y * scale.to(ct)[:, None, None] + shift.to(ct)[:, None, None]
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def fp32_chunk(c: int) -> int:
    """Input channels the fp32 kernel takes a pass (KC): 16 where C is a
    multiple of 16, else 8. A pass reads a KC-channel input box and runs
    3*KC rows of the fuse product (a multiple of one tf32 K step, 8)."""
    return 16 if c % 16 == 0 else 8


def fp32_padded_c(c: int) -> int:
    """C rounded up to a whole number of ``fp32_chunk(c)`` channels; the
    channels past C are zero (TMA zero fill, zero weights, zero rows of
    B)."""
    kc = fp32_chunk(c)
    return -(-c // kc) * kc


def tf32_round(v: torch.Tensor) -> torch.Tensor:
    """v rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as ``cvt.rna.tf32.f32`` rounds: fp32 with the low 13 bits 0."""
    bits = v.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def pack_fuse_operand_tf32(fuse_w: torch.Tensor) -> torch.Tensor:
    """fuse_w (3C, O) as the fp32 kernel's B operand: a flat fp32 tensor
    of TF32 values, hi = tf32_round(w) and lo = tf32_round(w - hi), so
    that hi + lo is w to about 2^-22 relative.

    Chunk j holds the rows the kernel's j-th channel pass reads: local row
    k = d*KC + cl is concat row d*C + j*KC + cl (zero past C), KC =
    ``fp32_chunk(C)``, as the kernel derives it. A chunk is its hi part,
    then its lo part, each 3*KC rows of K-major core matrices of 8 rows x
    4 values: element (k, n) at
    ``((n//8 * (3*KC)//4 + k//4) * 8 + n%8) * 4 + k%4``, so core matrices
    that follow in K are 128 bytes apart and those that follow in N 3*KC*32
    bytes apart (the descriptor's leading and stride byte offsets)."""
    k3, o = fuse_w.shape
    if o % 8:
        raise ValueError(f"fuse_w width {o} is not a multiple of 8")
    c = k3 // 3
    kc, cp = fp32_chunk(c), fp32_padded_c(c)
    w = torch.zeros((3, cp, o), dtype=torch.float32, device=fuse_w.device)
    w[:, :c] = fuse_w.float().reshape(3, c, o)
    hi = tf32_round(w)
    lo = tf32_round(w - hi)
    nch, k = cp // kc, 3 * kc
    blk = (torch.stack((hi, lo))                       # (2, 3, cp, O)
           .reshape(2, 3, nch, kc, o).permute(2, 0, 4, 1, 3)
           .reshape(nch, 2, o // 8, 8, k // 4, 4))     # [j, part, n, k]
    return blk.permute(0, 1, 2, 4, 3, 5).reshape(-1).contiguous()


def unpack_fuse_operand_tf32(packed: torch.Tensor, c: int, o: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of ``pack_fuse_operand_tf32``: (hi, lo), each (3, Cp, O)
    [branch, channel, output] with Cp = ``fp32_padded_c(c)``, padding
    channels included."""
    kc, cp = fp32_chunk(c), fp32_padded_c(c)
    nch, k = cp // kc, 3 * kc
    t = (packed.reshape(nch, 2, o // 8, k // 4, 8, 4)
         .permute(0, 1, 2, 4, 3, 5).reshape(nch, 2, o, 3, kc)
         .permute(1, 3, 0, 4, 2).reshape(2, 3, cp, o))
    return t[0], t[1]


def padded_k(c: int) -> int:
    """K of the fuse product, 3C, padded with zero rows to a multiple of 16
    (one wgmma K step)."""
    return -(-3 * c // 16) * 16


def pack_fuse_operand(fuse_w: torch.Tensor) -> torch.Tensor:
    """fuse_w (3C, O) as the bf16 kernel's B operand: a flat bf16 tensor.

    K is padded to ``padded_k(C)`` with zero rows and cut into chunks of
    ``K_CHUNK`` rows (the last may be shorter), stored one after another.
    A chunk of kc rows holds B transposed (K-major) as 8x8 core matrices:
    element (k, n) of the chunk lies at
    ``((n//8 * kc//8 + k//8) * 8 + n%8) * 8 + k%8``, so core matrices that
    follow in K are 128 bytes apart and those that follow in N kc*16 bytes
    apart (the leading and stride byte offsets of the kernel's descriptor).
    """
    k3, o = fuse_w.shape
    if o % 8:
        raise ValueError(f"fuse_w width {o} is not a multiple of 8")
    kp = padded_k(k3 // 3)
    w = torch.zeros((kp, o), dtype=torch.bfloat16, device=fuse_w.device)
    w[:k3] = fuse_w.to(torch.bfloat16)
    chunks = []
    for k0 in range(0, kp, K_CHUNK):
        blk = w[k0:k0 + K_CHUNK]                    # (kc, O)
        kc = blk.shape[0]
        chunks.append(blk.t().reshape(o // 8, 8, kc // 8, 8)
                      .permute(0, 2, 1, 3).reshape(-1))
    return torch.cat(chunks).contiguous()


def unpack_fuse_operand(packed: torch.Tensor, c: int, o: int) -> torch.Tensor:
    """Inverse of ``pack_fuse_operand``: the (padded_k(c), O) bf16 matrix,
    padding rows included."""
    kp = padded_k(c)
    rows, off = [], 0
    for k0 in range(0, kp, K_CHUNK):
        kc = min(K_CHUNK, kp - k0)
        blk = packed[off:off + kc * o].reshape(o // 8, kc // 8, 8, 8)
        rows.append(blk.permute(0, 2, 1, 3).reshape(o, kc).t())
        off += kc * o
    return torch.cat(rows)


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """Which output pixels one thread block of a kernel owns.

    A tile is ``images`` images (from ``b0``) of ``th`` x ``tw`` output
    pixels at (oy0, ox0); its input box is ``images`` x ``hy`` x ``hx``
    pixels from (oy0 - origin, ox0 - origin). Pixel p of the tile (p <
    images*th*tw <= 64, or ``wide_rows(O)`` in the wide-C variant) is
    image p // (th*tw), row (p % (th*tw)) // tw, column p % tw; rows past
    the batch or the image are masked."""
    th: int
    tw: int
    images: int
    tiles_h: int
    tiles_w: int
    hy: int
    hx: int
    origin: int
    n_tiles: int

    def tile_origin(self, t: int) -> Tuple[int, int, int]:
        """(b0, oy0, ox0) of tile t, as the kernel computes it."""
        per_image = self.tiles_h * self.tiles_w
        rem = t % per_image
        return ((t // per_image) * self.images,
                (rem // self.tiles_w) * self.th,
                (rem % self.tiles_w) * self.tw)

    def scalars(self) -> Tuple[int, ...]:
        return (self.th, self.tw, self.images, self.tiles_h, self.tiles_w,
                self.hy, self.hx, self.origin, self.n_tiles)


@functools.lru_cache(maxsize=64)
def tile_plan(b: int, h: int, w: int) -> TilePlan:
    """Tile an (H-2)x(W-2) output: 8x8 spatial tiles with a 14x14 input box
    (zero outside the image, which is the branches' padding), or, where
    the whole output fits 8x8, whole images packed min(B, 64 // (OH*OW))
    a tile with the image itself as the box (the kernel zero-pads the
    taps)."""
    oh, ow = h - 2, w - 2
    if oh <= TILE_SIDE and ow <= TILE_SIDE:
        images = max(1, min(b, TILE_PIXELS // (oh * ow)))
        return TilePlan(oh, ow, images, 1, 1, h, w, 0, -(-b // images))
    tiles_h, tiles_w = -(-oh // TILE_SIDE), -(-ow // TILE_SIDE)
    side = TILE_SIDE + HALO
    return TilePlan(TILE_SIDE, TILE_SIDE, 1, tiles_h, tiles_w, side, side, 2,
                    b * tiles_h * tiles_w)


def wide_rows(o: int) -> int:
    """Output pixels one block of the wide-C variant owns at width O (A's
    rows): 128 at O <= 128 (each of two MMA warpgroups 64 rows x O), 64 at
    O = 256 (each 64 rows x 128 columns)."""
    return 128 if o <= 128 else 64


@functools.lru_cache(maxsize=64)
def wide_tile_plan(b: int, h: int, w: int, o: int) -> TilePlan:
    """The wide-C variant's tiles at width O: th x 8 output pixels (th =
    ``wide_rows(o)`` / 8: 16 at O <= 128, 8 at O = 256) with a (th + 6) x
    15 input box from (oy0 - 2, ox0 - 2), one column past the halo so that
    the box rows alternate bank halves (zero outside the image). Where the
    whole output fits 8x8 (as ``tile_plan``), whole images packed into the
    block's ``wide_rows(o)`` rows, as many as that and a spatial tile's
    box allow."""
    oh, ow = h - 2, w - 2
    th = wide_rows(o) // TILE_SIDE
    hy, hx = th + HALO, TILE_SIDE + HALO + 1
    if oh <= TILE_SIDE and ow <= TILE_SIDE:
        images = max(1, min(b, wide_rows(o) // (oh * ow),
                            hy * hx // (h * w)))
        return TilePlan(oh, ow, images, 1, 1, h, w, 0, -(-b // images))
    tiles_h, tiles_w = -(-oh // th), -(-ow // TILE_SIDE)
    return TilePlan(th, TILE_SIDE, 1, tiles_h, tiles_w, hy, hx, 2,
                    b * tiles_h * tiles_w)


def bf16_smem_bytes(c: int, o: int, plan: TilePlan) -> int:
    """Dynamic shared memory of one bf16 block, as ``Smem`` in
    ``csrc/acff.cu`` lays it out, plus the 128 bytes that align its base:
    4 mbarriers; dw_w and dw_b in fp32; two input boxes, each also the
    staged output tile; A in core matrices ``A_LBO`` apart in K; two B
    stages of up to ``K_CHUNK`` rows."""
    def up(v: int) -> int:
        return -(-v // 128) * 128
    kp = padded_k(c)
    box = plan.images * plan.hy * plan.hx * c * 2
    boxsz = up(max(box, TILE_PIXELS * (2 * o + 16)))
    a = up(128 + 30 * c * 4) + 2 * boxsz
    return up(a + kp * A_LBO) + 2 * min(kp, K_CHUNK) * o * 2 + 128


def fp32_smem_bytes(c: int, o: int, plan: TilePlan) -> int:
    """Dynamic shared memory of one fp32 block, as ``FSmem`` in
    ``csrc/acff.cu`` lays it out, plus the 128 bytes that align its base:
    3 mbarriers; two buffers of one chunk's dw_w and dw_b in fp32; two
    input boxes of ``fp32_chunk(c)`` channels; A's hi and lo parts in
    core matrices ``FP32_A_LBO`` apart in K; one B chunk, hi and lo."""
    def up(v: int) -> int:
        return -(-v // 128) * 128
    kc = fp32_chunk(c)
    box = plan.images * plan.hy * plan.hx * kc * 4
    a = up(128 + 2 * 30 * kc * 4) + 2 * up(box)
    return up(a + 2 * 8 * (3 * kc // 4) * FP32_A_LBO) + 24 * kc * o + 128


def bf16_wide_smem_bytes(o: int, plan: TilePlan) -> int:
    """Dynamic shared memory of one block of the bf16 wide-C variant on
    ``plan`` (``wide_tile_plan``), as ``WSmem`` in ``csrc/acff.cu`` lays it
    out, plus the 128 bytes that align its base: its mbarriers; two
    buffers of one chunk's dw_w and dw_b in fp32; fuse_b, scale and shift;
    a ring of 3 input boxes of ``WIDE_KC`` channels; two A buffers
    (``wide_rows(o)`` x 3 WIDE_KC bf16, core matrices ``A_LBO`` apart in
    K); two B chunks (3 WIDE_KC x O bf16); the staged output tile
    (``wide_rows(o)`` rows of O bf16 + 16 bytes). C does not enter it."""
    def up(v: int) -> int:
        return -(-v // 128) * 128
    box = plan.images * plan.hy * plan.hx * WIDE_KC * 2
    a = up(128 + 2 * 30 * WIDE_KC * 4 + 3 * o * 4) + 3 * up(box)
    a_buf = wide_rows(o) // 8 * (3 * WIDE_KC // 8) * A_LBO
    b = up(a + 2 * a_buf) + 2 * 3 * WIDE_KC * o * 2
    return b + wide_rows(o) * (2 * o + 16) + 128


def pack_fuse_operand_wide(fuse_w: torch.Tensor) -> torch.Tensor:
    """fuse_w (3C, O) as the bf16 wide-C variant's B operand: a flat bf16
    tensor, C padded to a multiple of ``WIDE_KC`` with zero rows. Chunk j
    holds the 3*WIDE_KC rows the variant's j-th channel pass reads: local
    row k = d*WIDE_KC + cl is concat row d*C + j*WIDE_KC + cl; each chunk
    is stored as ``pack_fuse_operand`` stores one of its K chunks (K-major
    8x8 core matrices, element (k, n) at
    ``((n//8 * kc//8 + k//8) * 8 + n%8) * 8 + k%8`` with kc = 3*WIDE_KC)."""
    k3, o = fuse_w.shape
    if o % 8:
        raise ValueError(f"fuse_w width {o} is not a multiple of 8")
    c = k3 // 3
    cp, k = -(-c // WIDE_KC) * WIDE_KC, 3 * WIDE_KC
    w = torch.zeros((3, cp, o), dtype=torch.bfloat16, device=fuse_w.device)
    w[:, :c] = fuse_w.to(torch.bfloat16).reshape(3, c, o)
    nch = cp // WIDE_KC
    blk = (w.reshape(3, nch, WIDE_KC, o).permute(1, 0, 2, 3)
           .reshape(nch, k, o).transpose(1, 2))          # [j, n, k]
    return (blk.reshape(nch, o // 8, 8, k // 8, 8).permute(0, 1, 3, 2, 4)
            .reshape(-1).contiguous())


def unpack_fuse_operand_wide(packed: torch.Tensor, c: int, o: int
                             ) -> torch.Tensor:
    """Inverse of ``pack_fuse_operand_wide``: (3, Cp, O) bf16 [branch,
    channel, output], Cp = C rounded up to ``WIDE_KC``."""
    cp, k = -(-c // WIDE_KC) * WIDE_KC, 3 * WIDE_KC
    nch = cp // WIDE_KC
    blk = (packed.reshape(nch, o // 8, k // 8, 8, 8).permute(0, 1, 3, 2, 4)
           .reshape(nch, o, k).transpose(1, 2))          # [j, k, n]
    return blk.reshape(nch, 3, WIDE_KC, o).permute(1, 0, 2, 3).reshape(
        3, cp, o)


def padded_channels(c: int, dtype: torch.dtype) -> int:
    """C as the kernel of ``dtype`` takes it: rounded up to 8 for bf16 (a
    TMA row of 16 bytes), to 4 for fp32."""
    m = 8 if dtype == torch.bfloat16 else 4
    return -(-c // m) * m


def o_splits(o: int) -> List[Tuple[int, int, int]]:
    """The launches an output of O channels takes: (o0, oc, width), columns
    [o0, o0 + oc) computed at the kernel width ``width`` (the next in
    ``WIDTHS``, at most 256), the columns past oc zero-padded."""
    top = WIDTHS[-1]
    return [(o0, min(top, o - o0),
             next(w for w in WIDTHS if w >= min(top, o - o0)))
            for o0 in range(0, o, top)]


def kernel_variant(dtype: torch.dtype, act_scales: Optional[Sequence[float]],
                   c: int, o: int, plan: TilePlan) -> str:
    """The ``LAUNCHES`` key of the kernel that runs a launch of C (padded)
    channels at width O on ``plan``: "fp32", or the bf16 kernel's variant
    ("bf16", or ``qdq_variant``'s) with "_wide" where C is past a TMA box
    row or the bf16 block is over ``SMEM_LIMIT``."""
    if dtype == torch.float32:
        return "fp32"
    base = "bf16" if act_scales is None else qdq_variant(act_scales)
    wide = c > TMA_BOX_MAX or bf16_smem_bytes(c, o, plan) > SMEM_LIMIT
    return base + "_wide" if wide else base


def is_direct(dtype: torch.dtype, act_scales: Optional[Sequence[float]],
              c: int, o: int, plan: TilePlan) -> bool:
    """Whether the block runs as one launch of the kernel as it is (C a
    multiple of its channel step, O in ``WIDTHS``, not the wide-C variant)
    rather than through ``acff_decomposed``."""
    return (padded_channels(c, dtype) == c and o in WIDTHS
            and not kernel_variant(dtype, act_scales, c, o,
                                   plan).endswith("_wide"))


def _column_pad(t: torch.Tensor, o0: int, oc: int, width: int
                ) -> torch.Tensor:
    """Columns [o0, o0 + oc) of t's last axis, zero-padded to ``width``."""
    return F.pad(t[..., o0:o0 + oc], (0, width - oc)).contiguous()


def _pad_rows(fuse_w: torch.Tensor, cp: int) -> torch.Tensor:
    """fuse_w (3C, O) with zero rows for channels C..cp of each branch."""
    c, o = fuse_w.shape[0] // 3, fuse_w.shape[1]
    if cp == c:
        return fuse_w
    return F.pad(fuse_w.reshape(3, c, o), (0, 0, 0, cp - c)).reshape(
        3 * cp, o)


# launch(x, dw_w, dw_b, fuse_w, fuse_b, scale, shift, out, o0): computes
# the block for the padded arguments and writes columns [o0, o0 + width)
# of out, width = fuse_w.shape[1]
Launch = Callable[..., None]


def acff_decomposed(x: torch.Tensor, dw_w: torch.Tensor, dw_b: torch.Tensor,
                    fuse_w: torch.Tensor, fuse_b: torch.Tensor,
                    scale: torch.Tensor, shift: torch.Tensor,
                    launch: Launch) -> torch.Tensor:
    """The ACFF block at any C and O through launches at the kernels'
    shapes: C zero-padded to ``padded_channels`` (zero input channels, zero
    depthwise weights and biases, zero fuse rows: the padded features are
    0 and add nothing, in every mode), O cut by ``o_splits`` (zero fuse
    columns, bias, scale and shift past each launch's columns), each
    launch writing its columns of one output of the summed widths, whose
    first O columns are returned (a copy only where a width was padded).
    Every output value is computed from the same terms as the whole call,
    so the result is exact."""
    b, h, w, c = x.shape
    o = fuse_w.shape[1]
    cp = padded_channels(c, x.dtype)
    if cp > c:
        x = F.pad(x, (0, cp - c))
        dw_w, dw_b = F.pad(dw_w, (0, cp - c)), F.pad(dw_b, (0, cp - c))
        fuse_w = _pad_rows(fuse_w, cp)
    splits = o_splits(o)
    total = splits[-1][0] + splits[-1][2]
    out = torch.empty((b, h - 2, w - 2, total), dtype=x.dtype,
                      device=x.device)
    for o0, oc, width in splits:
        launch(x, dw_w, dw_b, *(_column_pad(t, o0, oc, width)
                                for t in (fuse_w, fuse_b, scale, shift)),
               out, o0)
    return out if total == o else out[..., :o].contiguous()


@functools.lru_cache(maxsize=256)
def operand_keys(c: int, o: int, dtype: torch.dtype, h: int, w: int,
                 act_scales: Optional[Tuple[float, ...]] = None
                 ) -> Dict[Tuple[int, int, bool], int]:
    """The fuse_w operands that a launch at input H x W may read, for any
    batch, each key (o0, width, wide) (``FuseOperands.get``) mapped to its
    place in the list the ``rtdm::acff_infer`` op takes. The tile plan
    depends on the batch only through the images packed into a tile (1 up
    to ``TILE_PIXELS``), and a block's shared memory grows with them, so
    the plans at batch 1 and ``TILE_PIXELS`` bound every variant."""
    keys: Dict[Tuple[int, int, bool], int] = {}
    for b in (1, TILE_PIXELS):
        plan = tile_plan(b, h, w)
        if is_direct(dtype, act_scales, c, o, plan):
            keys.setdefault((0, o, False), len(keys))
            continue
        cp = padded_channels(c, dtype)
        for o0, _, width in o_splits(o):
            variant = kernel_variant(dtype, act_scales, cp, width, plan)
            keys.setdefault((o0, width, variant.endswith("_wide")), len(keys))
    return keys


class FuseOperands:
    """fuse_w (3C, O) packed once for every launch that ``acff_infer``
    makes at this block's shape on the kernel of ``dtype``: ``direct``, the
    operand of the one launch at C and O as they are (None where C or O
    needs ``acff_decomposed``), and the operand of each launch of the
    decomposition (``get``), packed at its first use and kept; the wide-C
    variant's (``pack_fuse_operand_wide``), which the tile plan picks, too.
    """

    def __init__(self, fuse_w: torch.Tensor, dtype: torch.dtype):
        self.fuse_w, self.dtype = fuse_w, dtype
        c, o = fuse_w.shape[0] // 3, fuse_w.shape[1]
        self.c, self.o = c, o
        self.c_pad = padded_channels(c, dtype)
        self._packed: Dict[Tuple[int, int, bool], torch.Tensor] = {}
        self.direct = (self.get(0, o, False)
                       if self.c_pad == c and o in WIDTHS else None)

    def get(self, o0: int, width: int, wide: bool) -> torch.Tensor:
        """The operand of the launch that computes columns [o0, o0 +
        width) (zero past O) of the C-padded block, in the wide-C variant's
        layout if ``wide``."""
        key = (o0, width, wide)
        if key not in self._packed:
            w = _column_pad(_pad_rows(self.fuse_w, self.c_pad), o0,
                            min(width, self.o - o0), width)
            pack = (pack_fuse_operand_wide if wide
                    else pack_fuse_operand if self.dtype == torch.bfloat16
                    else pack_fuse_operand_tf32)
            self._packed[key] = pack(w)
        return self._packed[key]

    def for_shape(self, h: int, w: int,
                  act_scales: Optional[Sequence[float]] = None
                  ) -> List[torch.Tensor]:
        """Every operand that a launch at input H x W may read, for any
        batch, in ``operand_keys``' order: the list the ``rtdm::acff_infer``
        op takes."""
        keys = operand_keys(self.c, self.o, self.dtype, h, w,
                            None if act_scales is None else tuple(act_scales))
        return [self.get(*k) for k in keys]


def _check_act_scales(x: torch.Tensor,
                      act_scales: Optional[Sequence[float]]) -> None:
    """Raises unless ``act_scales`` is None or four finite scales > 0
    for a bf16 x."""
    if act_scales is None:
        return
    if x.dtype != torch.bfloat16:
        raise ValueError(f"act_scales (int8 QDQ) need a bfloat16 x, got "
                         f"{x.dtype}")
    if len(act_scales) != 4 or not all(
            math.isfinite(s) and s > 0 for s in map(float, act_scales)):
        raise ValueError(f"act_scales must be 4 finite scales > 0 "
                         f"(s_x1, s_x2, s_x3, s_f), got {act_scales!r}")


def qdq_variant(act_scales: Sequence[float]) -> str:
    """The QDQ mode's variant for ``act_scales`` = (s_x1, s_x2, s_x3, s_f):
    "int8" (the input box QDQ'd once for the three branches) where the
    three depthwise scales are equal as the fp32 values the C entry takes,
    else "int8_branch" (each branch QDQs its own loads)."""
    s1, s2, s3 = (_F(v).value for v in act_scales[:3])
    return "int8" if s1 == s2 == s3 else "int8_branch"


def _check(x: torch.Tensor, dw_w, dw_b, fuse_w, fuse_b, scale, shift,
           act_scales: Optional[Sequence[float]] = None) -> None:
    if x.dim() != 4 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be (B,H,W,C) float32 or bfloat16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    _check_act_scales(x, act_scales)
    b, h, w, c = x.shape
    o = fuse_w.shape[-1]
    if h < 3 or w < 3 or b < 1 or c < 1 or o < 1:
        raise ValueError(f"x {tuple(x.shape)}, O={o}: need H, W >= 3 and "
                         f"B, C, O >= 1")
    want = {"dw_w": (3, 3, 3, c), "dw_b": (3, c), "fuse_w": (3 * c, o),
            "fuse_b": (o,), "scale": (o,), "shift": (o,)}
    for name, t in zip(want, (dw_w, dw_b, fuse_w, fuse_b, scale, shift)):
        if tuple(t.shape) != want[name] or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {want[name]}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous NHWC")
    if tile_plan(b, h, w).n_tiles > MAX_TILES:
        raise ValueError(f"x {tuple(x.shape)}: over {MAX_TILES} tiles")
    if x.data_ptr() % 16:
        raise ValueError("x must start on a 16-byte boundary")


def _check_operand(x: torch.Tensor, fuse_operand: Optional[torch.Tensor],
                   c: int, o: int) -> None:
    """Raises unless ``fuse_operand`` is fuse_w (3C, O) packed for the
    kernel of x's dtype: ``pack_fuse_operand`` for bf16,
    ``pack_fuse_operand_tf32`` for fp32."""
    if x.dtype == torch.bfloat16:
        name, dtype, n = "pack_fuse_operand", torch.bfloat16, padded_k(c) * o
    else:
        name, dtype = "pack_fuse_operand_tf32", torch.float32
        n = 6 * fp32_padded_c(c) * o
    if (fuse_operand is None or fuse_operand.dtype != dtype
            or fuse_operand.numel() != n
            or fuse_operand.device != x.device
            or not fuse_operand.is_contiguous()
            or fuse_operand.data_ptr() % 16):
        raise ValueError(f"fuse_operand is not {name}(fuse_w)")


def _launch(x: torch.Tensor, dw_w, dw_b, operand: torch.Tensor, fuse_b,
            scale, shift, out: torch.Tensor, o0: int, width: int,
            quant: str, act_scales: Optional[Sequence[float]]) -> None:
    """One launch of the kernel ``quant`` names: columns [o0, o0 + width)
    of out (its row stride is out's last dimension)."""
    b, h, w, c = x.shape
    plan = tile_plan(b, h, w)
    if quant.endswith("_wide"):
        plan = wide_tile_plan(b, h, w, width)
        smem = bf16_wide_smem_bytes(width, plan)
    elif quant == "fp32":
        smem = fp32_smem_bytes(c, width, plan)
    else:
        smem = bf16_smem_bytes(c, width, plan)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{quant} kernel: a block at C={c} O={width} H={h} "
                         f"W={w} needs {smem} B of shared memory, over "
                         f"{SMEM_LIMIT}")
    qs = [0.0] * 4 if act_scales is None else [float(v) for v in act_scales]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        ACFF_KERNEL.launch(
            x.data_ptr(), dw_w.data_ptr(), dw_b.data_ptr(),
            operand.data_ptr(), fuse_b.data_ptr(), scale.data_ptr(),
            shift.data_ptr(), out.data_ptr() + o0 * out.element_size(), b, h,
            w, c, width, MODES[quant], out.shape[-1], *plan.scalars(), *qs,
            stream)
    LAUNCHES[quant] += 1


def acff_infer(x: torch.Tensor, dw_w: torch.Tensor, dw_b: torch.Tensor,
               fuse_w: torch.Tensor, fuse_b: torch.Tensor, scale: torch.Tensor,
               shift: torch.Tensor,
               fuse_operand: Union[torch.Tensor, FuseOperands, None] = None,
               act_scales: Optional[Sequence[float]] = None) -> torch.Tensor:
    """Fused ACFF block; arguments as ``acff_infer_plain``, weights fp32.

    ``fuse_operand`` is fuse_w packed for the kernel of x's dtype, which
    reads it in place of fuse_w; required on CUDA, not read on the CPU:
    ``FuseOperands(fuse_w, x.dtype)`` (what ``ACFF.packed()`` holds) for
    any shape, or for a shape that runs as one launch of the kernel as it
    is (C a multiple of 8 for bf16, of 4 for fp32, O in ``WIDTHS``, and for
    bf16 C <= 256 and the block within ``SMEM_LIMIT``) the packed tensor
    itself: ``pack_fuse_operand(fuse_w)`` for bf16,
    ``pack_fuse_operand_tf32(fuse_w)`` for fp32. ``act_scales`` (s_x1,
    s_x2, s_x3, s_f), with a bf16 x, runs the bf16 kernel's int8 QDQ mode,
    in the variant ``qdq_variant`` picks. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel on the current stream (the
    other shapes through ``acff_decomposed``), and a failed build or launch
    raises."""
    if x.device.type == "cpu":
        _check_act_scales(x, act_scales)
        return acff_infer_plain(x, dw_w, dw_b, fuse_w, fuse_b, scale, shift,
                                act_scales)
    if x.device.type != "cuda":
        raise ValueError(f"no ACFF kernel for device {x.device}")
    if not isinstance(fuse_operand, FuseOperands):
        return _infer_cuda(x, dw_w, dw_b, fuse_w, fuse_b, scale, shift,
                           act_scales, direct=fuse_operand)
    c, o = x.shape[-1], fuse_w.shape[-1]
    if ((fuse_operand.c, fuse_operand.o) != (c, o)
            or fuse_operand.dtype != x.dtype):
        raise ValueError(f"fuse_operand holds C={fuse_operand.c} "
                         f"O={fuse_operand.o} {fuse_operand.dtype}, not "
                         f"C={c} O={o} {x.dtype}")
    return _infer_cuda(x, dw_w, dw_b, fuse_w, fuse_b, scale, shift,
                       act_scales, get=fuse_operand.get)


def _infer_cuda(x, dw_w, dw_b, fuse_w, fuse_b, scale, shift, act_scales,
                get: Optional[Callable[[int, int, bool], torch.Tensor]] = None,
                direct: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The block's launches on the card: the operand of each from
    ``get(o0, width, wide)`` (``FuseOperands.get``), or for a block that
    runs as one launch, ``direct``."""
    _check(x, dw_w, dw_b, fuse_w, fuse_b, scale, shift, act_scales)
    b, h, w, c = x.shape
    o = fuse_w.shape[-1]
    plan = tile_plan(b, h, w)
    if is_direct(x.dtype, act_scales, c, o, plan):
        operand = get(0, o, False) if get is not None else direct
        _check_operand(x, operand, c, o)
        out = torch.empty((b, h - 2, w - 2, o), dtype=x.dtype,
                          device=x.device)
        _launch(x, dw_w, dw_b, operand, fuse_b, scale, shift, out, 0, o,
                kernel_variant(x.dtype, act_scales, c, o, plan), act_scales)
        return out
    if get is None:
        raise ValueError(f"C={c} O={o} H={h} W={w} {x.dtype} runs through "
                         f"acff_decomposed: pass FuseOperands(fuse_w, dtype)")

    def launch(xp, dw_wp, dw_bp, fuse_wp, fuse_bp, scale_p, shift_p, out,
               o0):
        width = fuse_wp.shape[1]
        quant = kernel_variant(x.dtype, act_scales, xp.shape[-1], width, plan)
        _launch(xp, dw_wp, dw_bp, get(o0, width, quant.endswith("_wide")),
                fuse_bp, scale_p, shift_p, out, o0, width, quant, act_scales)
    return acff_decomposed(x, dw_w, dw_b, fuse_w, fuse_b, scale, shift,
                           launch)


@torch.library.custom_op("rtdm::acff_infer", mutates_args=(),
                         device_types="cpu")
def acff_infer_op(x: torch.Tensor, dw_w: torch.Tensor, dw_b: torch.Tensor,
                  fuse_w: torch.Tensor, fuse_b: torch.Tensor,
                  scale: torch.Tensor, shift: torch.Tensor,
                  operands: List[torch.Tensor],
                  act_scales: Optional[List[float]] = None) -> torch.Tensor:
    """The fused ACFF block as the registered op ``rtdm::acff_infer``, which
    ``torch.export`` keeps as one node: on the CPU ``acff_infer_plain``; on
    CUDA (``_acff_infer_cuda``) the hand-written kernel's launches, which
    count ``LAUNCHES``, so the replays of an exported program count too.
    ``operands`` is ``FuseOperands.for_shape``'s packed fuse_w (not read on
    the CPU)."""
    _check_act_scales(x, act_scales)
    return acff_infer_plain(x, dw_w, dw_b, fuse_w, fuse_b, scale, shift,
                            act_scales)


@acff_infer_op.register_kernel("cuda")
def _acff_infer_cuda(x, dw_w, dw_b, fuse_w, fuse_b, scale, shift, operands,
                     act_scales=None):
    index = operand_keys(x.shape[-1], fuse_w.shape[-1], x.dtype, x.shape[1],
                         x.shape[2],
                         None if act_scales is None else tuple(act_scales))
    if len(operands) != len(index):
        raise ValueError(f"{len(operands)} operands, {len(index)} expected: "
                         f"pass FuseOperands.for_shape")
    return _infer_cuda(x, dw_w, dw_b, fuse_w, fuse_b, scale, shift,
                       act_scales, get=lambda *k: operands[index[k]])


@acff_infer_op.register_fake
def _acff_infer_fake(x, dw_w, dw_b, fuse_w, fuse_b, scale, shift, operands,
                     act_scales=None):
    b, h, w, _ = x.shape
    return x.new_empty((b, h - 2, w - 2, fuse_w.shape[1]))


def pack_acff_params(state: Mapping[str, torch.Tensor],
                     eps: float = 1e-5) -> Packed:
    """Fold an ACFF module's tensors into the kernel's fp32 arguments.

    ``state`` holds the module's names: ``conv{1,2,3}.weight`` (C,1,3,3) and
    ``.bias``, ``fused_conv.weight`` (O,3C,1,1) and ``.bias``, and
    ``batch_norm.{weight,bias,running_mean,running_var}``. Weights are taken
    as stored (a bf16 engine's are already rounded to bf16) and folded in
    fp32: scale = gamma * rsqrt(var + eps), shift = beta - mean * scale, with
    the running variance as stored."""
    s = {k: v.detach().float() for k, v in state.items()}
    dw_w = torch.stack([s[f"conv{i}.weight"][:, 0].permute(1, 2, 0)
                        for i in (1, 2, 3)]).contiguous()   # (3, 3, 3, C)
    dw_b = torch.stack([s[f"conv{i}.bias"] for i in (1, 2, 3)]).contiguous()
    fuse_w = s["fused_conv.weight"][:, :, 0, 0].t().contiguous()  # (3C, O)
    fuse_b = s["fused_conv.bias"].contiguous()
    scale = s["batch_norm.weight"] * torch.rsqrt(
        s["batch_norm.running_var"] + eps)
    shift = s["batch_norm.bias"] - s["batch_norm.running_mean"] * scale
    return dw_w, dw_b, fuse_w, fuse_b, scale.contiguous(), shift.contiguous()


def fused_classifier_forward(model: torch.nn.Module
                             ) -> Callable[[torch.Tensor], torch.Tensor]:
    """``forward(x_normalized) -> probs`` (softmax in fp32) over a loaded
    classifier of the ErNET family in eval mode, every ACFF block through
    ``rtdm::acff_infer`` (the kernel on the card, the plain version on the
    CPU; 4 launches a Squeeze_ErNET or Squeeze_RedConv forward, 6 an ErNET
    one), the other layers as the model's own. x is cast to the model's
    dtype, as the engines do; an fp32 model runs with TF32 off. The JAX
    function's ``fused_batch_tile`` and ``interpret`` are Pallas knobs with
    no counterpart here, and JAX keeps blocks of C < 32 out of its kernel
    (a Mosaic compile limit) where this kernel takes them. Raises
    ``TypeError`` for any other model, and at a call in training mode or
    inside ``models/acff.py::layer_by_layer``."""
    from rtdm_tpu_torch.core.precision import tf32
    from rtdm_tpu_torch.models.acff import ACFF
    from rtdm_tpu_torch.models.ernet import (ErNET, SqueezeErNET,
                                             SqueezeRedConv)
    if not isinstance(model, (SqueezeErNET, SqueezeRedConv, ErNET)):
        raise TypeError(f"unsupported model {type(model)}")
    blocks = [m for m in model.modules() if isinstance(m, ACFF)]
    dtype = model.conv1.weight.dtype

    @torch.inference_mode()
    def forward(x: torch.Tensor) -> torch.Tensor:
        if model.training or any(b.unfused for b in blocks):
            raise RuntimeError("fused_classifier_forward runs the model in "
                               "eval mode with its ACFF blocks fused")
        # as the Engine: only fp32 takes tf32's process-wide lock
        with (tf32(False) if dtype == torch.float32 else nullcontext()):
            return model(x.to(dtype), apply_softmax=True).float()
    return forward
