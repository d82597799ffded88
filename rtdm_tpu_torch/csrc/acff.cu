// Fused ACFF inference block for Hopper (sm_90a), CUDA C++.
//
// Replaces rtdm_tpu/ops/acff_pallas.py::_acff_kernel (launched by
// fused_acff_infer). Same function: three 3x3 depthwise convs at dilation
// 1/2/3 with padding 0/1/2 (each with a bias) over an NHWC batch, their
// concat to 3C channels, the 1x1 fuse as a (P,3C)x(3C,O) product plus bias,
// LeakyReLU(0.01), then the folded inference BN out*scale+shift.
// x: (B,H,W,C) fp32 or bf16; out: (B,H-2,W-2,O) in x's dtype; dw_w, dw_b,
// fuse_b, scale, shift fp32. One C entry point dispatches on x's dtype to
// one of two kernels (the bf16 one with a wide-C variant for blocks that
// outgrow shared memory, below); any B, H and W run, and the host cuts
// other C and O to the kernels' steps (ops/acff.py::acff_decomposed).
//
// What bounds it on an H100: the first blocks of the ErNET family read a
// wide, shallow input and write a 4-16x wider output (acff1: C=16 -> O=64).
// In bf16 at batch 256 every block of the three models is bound by
// device-memory bytes: 2*P*(27C + 3C*O) operations over 989 TFLOP/s of
// bf16 tensor cores is below bytes over 3.35 TB/s everywhere. The
// Squeeze_ErNET blocks move 186, 83, 22 and 5 MB, a bound of 0.056,
// 0.025, 0.007 and 0.0015 ms; the first FMA design took 0.745, 1.233,
// 0.411 and 0.273 ms there (chip_smoke.py, H100 80GB HBM3 at 700 W), held
// by its own instruction and shared-memory traffic, not by bytes.
//
// bf16 kernel (acff_bf16_kernel), what the design does about it:
// - one thread block owns 64 output pixels (one wgmma M) and all O
//   channels, so each depthwise feature is computed once. The pixels are
//   an 8x8 spatial tile, or whole small images packed into the 64 rows;
//   the plan (ops/acff.py::tile_plan) is made on the host and passed in.
// - the tile's input box is read once by TMA (a 4-D tensor map over NHWC,
//   encoded per call); out-of-bounds zero fill is the branches' padding.
// - the depthwise weights and biases sit in shared memory; the 3C features
//   are computed in fp32 FMAs, a thread taking a row segment of 8, 4 or 2
//   pixels (by C) x 4 channels and loading each box column once for every
//   tap that reads it, and rounded once to bf16 into the wgmma A layout
//   (K padded to 16).
// - the 1x1 fuse runs on tensor cores: wgmma m64nNk16, A and B from shared
//   memory, fp32 sums in registers, two warpgroups of N = O/2 each. B is
//   fuse_w packed on the host (ops/acff.py::pack_fuse_operand) and streams
//   through a two-stage ring in K chunks of 64 rows by cp.async.bulk.
// - the epilogue (bias, LeakyReLU, scale/shift in fp32) stages the bf16
//   tile in shared memory and stores it with 16-byte coalesced stores.
// - blocks are persistent: as many as fit walk the tiles, with the next
//   tile's box double-buffered. Several are resident per SM at the small-C
//   blocks, which overlaps one block's phases with another's; a
//   warp-specialised schedule that overlaps them within a block is later
//   work. This design took 0.233, 0.107, 0.056 and 0.021 ms at the four
//   Squeeze_ErNET blocks (chip_smoke.py, same card): the depthwise pass,
//   bound by shared-memory loads, is the largest phase.
// - int8 QDQ mode (the ACFF block of the int8 engine; the JAX int8 engine
//   runs the unfused flax block under QDQ interception): the same tile,
//   product and stores, with the rounding steps of that engine where the
//   features are staged: branch d reads bf16(QDQ(x, s_xd)), the sums start
//   at 0, each feature goes to A as QDQ(bf16(bf16(sum) + bf16(bias)), s_f),
//   and the epilogue rounds the product, the bias sum and LeakyReLU to
//   bf16 before BN. QDQ adds no bytes, so the bound is the bf16 one. Two
//   variants (QMode):
//   * QSHARED, s_x1 == s_x2 == s_x3 (calibration gives the three branches,
//     which read one x, one scale: every committed int8 engine): once TMA
//     has landed a box, the block rewrites it in place as bf16(QDQ(v,
//     s_x)), 16 bytes a thread (the next tile's box while this tile's
//     product runs on the tensor cores), and the depthwise then runs the
//     bf16 kernel's loads on it. Each box element is QDQ'd once, where a
//     QDQ at every load does it 9 times on a spatial tile and 27 on whole
//     images. QDQ(0) = 0, so the zero fill stays the padding; the stores
//     are generic ones like the epilogue's staging in the same buffer,
//     which the fence before the next TMA load already orders. The result
//     is bit for bit the per-branch variant's at equal scales
//     (chip_smoke.py holds them equal at every shape and batch).
//   * QBRANCH, unequal scales: each box column is QDQ'd with its branch's
//     scale where dw_row/dw_pixel load it.
//   Both round the features and the epilogue in bf16x2 pairs (add, mul
//   and max on bf16x2, each rounded once: the same values as fp32 steps
//   rounded to bf16) and round a QDQ's code by adding and subtracting 1.5
//   * 2^23, which cut their instructions and registers (96 at O = 96 and
//   128, 147-150 at O = 256). The per-load design with the roundings one
//   value at a time took 217 registers at O = 96-256 (one block per SM at
//   acff2) and 2.7x, 3.3x, 2.6x and 1.7x the bf16 time at the four
//   Squeeze_ErNET blocks, 1.173 ms in all at batch 256; the shared-box
//   variant takes 0.321, 0.153, 0.080 and 0.024 ms there, 0.578 ms in
//   all, 1.39, 1.40, 1.43 and 1.10x the bf16 time, and the per-branch one
//   0.937 ms (chip_smoke.py, H100 80GB HBM3 at 700 W). The rest of the gap to the
//   bf16 kernel is ALU work: the pass over the box and the features' QDQ
//   (scripts/acff_phase_times.py --quant int8).
//
// fp32 kernel (acff_fp32_kernel<O/2>), full fp32 accuracy: the fp32
// engine turns TF32 off, so the fuse product runs as 3xTF32. Bound: at
// batch 256 the first Squeeze_ErNET block by bytes, the others by the
// tensor cores (3 x 2*P*3C*O operations over 495 TFLOP/s of TF32); the
// first design (an 8x8 tile x a slice of O on fp32 FMAs) took 0.751,
// 1.234, 0.424 and 0.276 ms at the four blocks against a bound of 0.111,
// 0.055, 0.019 and 0.0049 ms (chip_smoke.py, H100 80GB HBM3 at 700 W),
// recomputing every feature for each slice of O. The design:
// - the bf16 kernel's tile: 64 output pixels (tile_plan) and all O a
//   block, persistent blocks, two warpgroups of N = O/2.
// - the input channels go in chunks of KC = 16 (8 where C is not a
//   multiple of 16; ops/acff.py::fp32_chunk), since a whole fp32 box, A
//   and B do not fit 227 KB. Per chunk a 4-D TMA box of KC channels
//   arrives (double-buffered across chunks and tiles; zero fill is the
//   padding and the channels past C), and its 3*KC depthwise features are
//   computed once per pixel in fp32 from the chunk's weights in shared
//   memory (loaded during the previous chunk's product; interleaved row
//   segments that load each box column once for its taps) and split into
//   TF32 hi = rna(v) and lo = rna(v - hi) in A.
// - the fuse product: D += A_lo*B_hi + A_hi*B_lo + A_hi*B_hi, wgmma
//   m64nNk8 tf32 from shared memory, fp32 sums in registers (A_lo*B_lo,
//   ~2^-22 relative, is dropped). The tensor cores round each sum they
//   carry toward zero, a bias of the sum's sign that real activations
//   carry from block to block (summed over a whole chunk it read -1.6e-7
//   to -3.6e-7 of mean |out| on the golden frames' activations, and the
//   fp32 engines' logits 2.5-20x further from the JAX golden than with
//   the first FMA kernel). So each k step (8 rows) is a run of its own,
//   summed from zero and added to the total in fp32, rounded to nearest:
//   -3.2e-8 to -4.5e-8, the logits within 1.5x of the FMA kernel's
//   distance (chip_smoke.py, scripts/acff_phase_times.py). Two runs are
//   in flight in two register sets (chunk_product), so that one run's add
//   overlaps the next run's product. B's hi and lo are made on the host
//   (ops/acff.py::pack_fuse_operand_tf32) in chunk order, and a chunk
//   (3KC x O, hi then lo) arrives by cp.async.bulk into one buffer during
//   the next chunk's depthwise; where C is one chunk it is loaded once.
// - the epilogue (bias, LeakyReLU, scale/shift in fp32) stores from the
//   accumulators: four lanes fill each 32-byte sector of a pixel's row
//   (staging in shared memory and 16-byte stores measured slower,
//   PERF.md).
// This design took 0.325, 0.252, 0.102 and 0.044 ms at the four
// Squeeze_ErNET blocks (chip_smoke.py, same card; 5% over whole-chunk
// runs), max |out - fp64| under 4e-7 of max |out|; the depthwise pass is
// still its largest phase (scripts/acff_phase_times.py --quant fp32).
// ops/acff.py::fp32_smem_bytes mirrors the shared-memory layout (FSmem).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

// ------------------------------------------------------------- bf16 kernel

constexpr int BM = 64;        // output pixels per block: one wgmma M
constexpr int KCHUNK = 64;    // fuse_w rows per streamed B chunk
constexpr int BTHREADS = 256; // two warpgroups, N = O/2 each
// A's core matrices (8 rows x 16 bytes) that follow in K lie 144 bytes
// apart, not 128: the 16 spare bytes put neighbouring K groups on other
// banks, so threads that store different channel groups of one pixel row
// do not collide.
constexpr int A_LBO = 144;

// Which output pixels a block owns (ops/acff.py::TilePlan): tile t holds
// `images` images from b0 = t / (tiles_h*tiles_w) * images, each th x tw
// pixels at (oy0, ox0); its input box is images x hy x hx pixels from
// (oy0 - origin, ox0 - origin).
struct Plan {
  int th, tw, images, tiles_h, tiles_w, hy, hx, origin;
};

// Dynamic shared memory, in bytes from a 128-byte aligned base:
// 4 mbarriers | dw_w (27C) and dw_b (3C) fp32 | two input boxes, each also
// the output tile's staging (64 rows of O bf16 + 16 bytes) | A (64 x kp
// bf16 in core matrices, A_LBO apart in K) | B ring (2 stages of up to
// 64 x O bf16).
struct Smem {
  int kp, stage, wts, box, boxsz, a, ring, total;
  __host__ __device__ Smem(int C, int O, int box_bytes) {
    kp = (3 * C + 15) / 16 * 16;
    stage = (kp < KCHUNK ? kp : KCHUNK) * O * 2;
    const int out_tile = BM * (O * 2 + 16);
    boxsz = up128(box_bytes > out_tile ? box_bytes : out_tile);
    wts = 128;
    box = up128(wts + 30 * C * 4);
    a = box + 2 * boxsz;
    ring = up128(a + kp * A_LBO);   // 8 row groups x kp/8 core matrices
    total = ring + 2 * stage;
  }
  __host__ __device__ static int up128(int v) { return (v + 127) & ~127; }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.b32 %0, 1, 0, P1;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// A transfer that never lands traps (a launch error) instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t n = 0; !mbar_try_wait(bar, parity); ++n)
    if (n == (1u << 26)) __trap();
}

__device__ __forceinline__ void tma_load_box(uint32_t dst,
                                             const CUtensorMap* map,
                                             uint32_t bar, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// wgmma shared-memory descriptor, no swizzle: the operand is 8x8 core
// matrices of 128 contiguous bytes; lbo is the byte distance between core
// matrices that follow in K, sbo between those that follow in M (or N).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// D(64 x N, fp32 registers) += A(64 x 16) * B(16 x N), both bf16 and
// K-major in shared memory.
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n48(float (&d)[24], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int NH>
__device__ __forceinline__ void wgmma(float (&d)[NH / 2], uint64_t da,
                                      uint64_t db) {
  if constexpr (NH == 32) wgmma_n32(d, da, db);
  else if constexpr (NH == 48) wgmma_n48(d, da, db);
  else if constexpr (NH == 64) wgmma_n64(d, da, db);
  else wgmma_n128(d, da, db);
}

template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Byte offset of A[m][8*k8 .. 8*k8+7] (one core-matrix row).
__device__ __forceinline__ int a_offset(int m, int k8, int kp8) {
  return (m >> 3) * kp8 * A_LBO + k8 * A_LBO + (m & 7) * 16;
}

__device__ __forceinline__ float2 bf16x2_to_float2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// ------------------------------------------------------- int8 QDQ mode
// The bf16 kernel's variants: plain bf16, and the int8 QDQ mode with the
// box QDQ'd once for the three branches (one scale) or at each load with
// each branch's scale. The C entry's modes are these plus one.
enum QMode : int { QNONE = 0, QSHARED = 1, QBRANCH = 2 };

// The int8 engine's activation QDQ, as XLA compiles the JAX int8 engine:
// q = clamp(rint(v * inv), -127, 127), value q * s, with inv the fp32
// reciprocal of s (XLA turns the division by a constant scale into that
// multiply) and rint rounding half to even, like jnp.round. The kernel
// clamps first and rounds the clamped value by adding and subtracting
// 1.5 * 2^23 (two adds at the full FP32 rate, where FRND is slower): the
// same q, since the bounds are integers.
struct Qdq {
  float s[4], inv[4];   // the three depthwise inputs, then the fuse input
};

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float qdq(float v, float s, float inv) {
  constexpr float RINT = 12582912.f;   // 1.5 * 2^23: its ulp is 1
  const float t = fminf(fmaxf(__fmul_rn(v, inv), -127.f), 127.f);
  return __fsub_rn(__fadd_rn(t, RINT), RINT) * s;
}

// bf16x2 arithmetic, each half rounded once to nearest even. On bf16
// operands this is the fp32 operation rounded to bf16, as the JAX int8
// engine and the plain version compute it: a sum or product of two bf16
// values is exact in fp32, or (a sum whose exponents lie 17 or more
// apart) rounds to the larger one either way.
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t max_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("max.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// Two bf16 values, each as bf16(QDQ(v, s)).
__device__ __forceinline__ uint32_t qdq_bf16x2(uint32_t v, float s,
                                               float inv) {
  const float2 f = bf16x2_to_float2(v);
  return bf16x2(qdq(f.x, s, inv), qdq(f.y, s, inv));
}

// x as branch D reads it: in QBRANCH, bf16(QDQ(x, s_D)) (QDQ(0) = 0, so the
// TMA zero fill stays the padding); in QSHARED the box holds that value
// already.
template <int QM, int D>
__device__ __forceinline__ float2 x_in(float2 v, const Qdq& qd) {
  if constexpr (QM == QBRANCH) {
    v.x = bf16r(qdq(v.x, qd.s[D], qd.inv[D]));
    v.y = bf16r(qdq(v.y, qd.s[D], qd.inv[D]));
  }
  return v;
}

// Two neighbouring depthwise features as A holds them (bf16x2), from their
// sums without the bias in QDQ mode, as the JAX int8 engine rounds a bf16
// depthwise conv and its concat: bf16(bf16(sum) + bf16(bias)), QDQ'd with
// the fuse input's scale and rounded to bf16. In bf16 the sums already
// hold the bias.
template <int QM>
__device__ __forceinline__ uint32_t features(float sum0, float sum1,
                                             float bias0, float bias1,
                                             const Qdq& qd) {
  if constexpr (QM != QNONE) {
    const float2 v =
        bf16x2_to_float2(add_bf16x2(bf16x2(sum0, sum1), bf16x2(bias0, bias1)));
    return bf16x2(qdq(v.x, qd.s[3], qd.inv[3]), qdq(v.y, qd.s[3], qd.inv[3]));
  }
  return bf16x2(sum0, sum1);
}

// Depthwise branch D of a spatial tile (8x8 pixels, 14x14 box from
// (oy0-2, ox0-2)) for SEG pixels px0.. of tile row py and channels
// 4q..4q+3, into A. Dilation S = D+1: pixel px, tap (kh, kw) reads box row
// py+2-D+kh*S, column px+2-D+kw*S. The SEG+2S columns of a box row are
// loaded once each and feed every (px, kw) that reads them: SEG pixels x 4
// channels of fp32 sums in registers; at SEG = 8, 1.5 bytes of
// shared-memory loads per FMA.
template <int D, int SEG, int QM>
__device__ __forceinline__ void dw_row(const __nv_bfloat16* box,
                                       const float* wts, unsigned char* a_s,
                                       int C, int q, int py, int px0,
                                       int kp8, const Qdq& qd) {
  constexpr int S = D + 1, NCOL = SEG + 2 * S, HX = 14;
  float acc[SEG][4];
  const float4 bias = *reinterpret_cast<const float4*>(wts + 27 * C + D * C +
                                                       q * 4);
  const float4 init = QM != QNONE ? make_float4(0.f, 0.f, 0.f, 0.f) : bias;
#pragma unroll
  for (int px = 0; px < SEG; ++px) {
    acc[px][0] = init.x; acc[px][1] = init.y;
    acc[px][2] = init.z; acc[px][3] = init.w;
  }
#pragma unroll
  for (int kh = 0; kh < 3; ++kh) {
    const __nv_bfloat16* row =
        box + ((py + 2 - D + kh * S) * HX + px0 + 2 - D) * C + q * 4;
    float4 w[3];
#pragma unroll
    for (int kw = 0; kw < 3; ++kw)
      w[kw] = *reinterpret_cast<const float4*>(
          wts + ((D * 3 + kh) * 3 + kw) * C + q * 4);
#pragma unroll
    for (int c = 0; c < NCOL; ++c) {
      const uint2 v = *reinterpret_cast<const uint2*>(row + c * C);
      const float2 lo = x_in<QM, D>(bf16x2_to_float2(v.x), qd);
      const float2 hi = x_in<QM, D>(bf16x2_to_float2(v.y), qd);
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        const int px = c - kw * S;
        if (px < 0 || px >= SEG) continue;
        acc[px][0] = fmaf(lo.x, w[kw].x, acc[px][0]);
        acc[px][1] = fmaf(lo.y, w[kw].y, acc[px][1]);
        acc[px][2] = fmaf(hi.x, w[kw].z, acc[px][2]);
        acc[px][3] = fmaf(hi.y, w[kw].w, acc[px][3]);
      }
    }
  }
  // A[py*8 + px0 + px][D*C + 4q ..]: half a core-matrix row.
  const int k = D * C + q * 4;
  unsigned char* dst =
      a_s + a_offset(py * 8 + px0, k >> 3, kp8) + (k & 7) * 2;
#pragma unroll
  for (int px = 0; px < SEG; ++px)
    *reinterpret_cast<uint2*>(dst + px * 16) = make_uint2(
        features<QM>(acc[px][0], acc[px][1], bias.x, bias.y, qd),
        features<QM>(acc[px][2], acc[px][3], bias.z, bias.w, qd));
}

// Branch d of the spatial depthwise, its rows cut into 8/SEG segments.
template <int SEG, int QM>
__device__ __forceinline__ void dw_rows(const __nv_bfloat16* box,
                                        const float* wts, unsigned char* a_s,
                                        int C, int kp8, int tid,
                                        const Qdq& qd) {
  constexpr int NSEG = 8 / SEG;
  const int C4 = C >> 2;
  for (int i = tid; i < 3 * 8 * NSEG * C4; i += BTHREADS) {
    const int q = i % C4, r = i / C4, seg = r % NSEG, py = (r / NSEG) & 7;
    const int d = r / (8 * NSEG), px0 = seg * SEG;
    if (d == 0) dw_row<0, SEG, QM>(box, wts, a_s, C, q, py, px0, kp8, qd);
    else if (d == 1) dw_row<1, SEG, QM>(box, wts, a_s, C, q, py, px0, kp8, qd);
    else dw_row<2, SEG, QM>(box, wts, a_s, C, q, py, px0, kp8, qd);
  }
}

// Tile pixel p -> (image slot, row, column); false where it is masked.
__device__ __forceinline__ bool tile_pixel(const Plan& pl, int p, int b0,
                                           int oy0, int ox0, int B, int OH,
                                           int OW, int& img, int& py,
                                           int& px) {
  const int tpx = pl.th * pl.tw;
  img = p / tpx;
  const int q = p - img * tpx;
  py = q / pl.tw;
  px = q - py * pl.tw;
  return img < pl.images && b0 + img < B && oy0 + py < OH && ox0 + px < OW;
}

// Depthwise branch D of one pixel of a whole-image tile (the box is the
// image itself) for channels 8g..8g+7; taps outside the image are zero.
template <int D, int QM>
__device__ __forceinline__ uint4 dw_pixel(const __nv_bfloat16* box,
                                          const float* wts, const Plan& pl,
                                          int C, int img, int py, int px,
                                          int g, const Qdq& qd) {
  constexpr int d = D;
  float acc[8];
  const float* bias = wts + 27 * C + d * C + g * 8;
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = QM != QNONE ? 0.f : bias[e];
  const int step = d + 1;
  const __nv_bfloat16* src = box + (size_t)img * pl.hy * pl.hx * C + g * 8;
#pragma unroll
  for (int kh = 0; kh < 3; ++kh) {
    const int ly = py - d + kh * step;
    if ((unsigned)ly >= (unsigned)pl.hy) continue;
#pragma unroll
    for (int kw = 0; kw < 3; ++kw) {
      const int lx = px - d + kw * step;
      if ((unsigned)lx >= (unsigned)pl.hx) continue;
      const uint4 v =
          *reinterpret_cast<const uint4*>(src + (ly * pl.hx + lx) * C);
      const float4* wk = reinterpret_cast<const float4*>(
          wts + ((d * 3 + kh) * 3 + kw) * C + g * 8);
      const float4 w0 = wk[0], w1 = wk[1];
      const float2 x0 = x_in<QM, D>(bf16x2_to_float2(v.x), qd);
      const float2 x1 = x_in<QM, D>(bf16x2_to_float2(v.y), qd);
      const float2 x2 = x_in<QM, D>(bf16x2_to_float2(v.z), qd);
      const float2 x3 = x_in<QM, D>(bf16x2_to_float2(v.w), qd);
      acc[0] = fmaf(x0.x, w0.x, acc[0]);
      acc[1] = fmaf(x0.y, w0.y, acc[1]);
      acc[2] = fmaf(x1.x, w0.z, acc[2]);
      acc[3] = fmaf(x1.y, w0.w, acc[3]);
      acc[4] = fmaf(x2.x, w1.x, acc[4]);
      acc[5] = fmaf(x2.y, w1.y, acc[5]);
      acc[6] = fmaf(x3.x, w1.z, acc[6]);
      acc[7] = fmaf(x3.y, w1.w, acc[7]);
    }
  }
  return make_uint4(features<QM>(acc[0], acc[1], bias[0], bias[1], qd),
                    features<QM>(acc[2], acc[3], bias[2], bias[3], qd),
                    features<QM>(acc[4], acc[5], bias[4], bias[5], qd),
                    features<QM>(acc[6], acc[7], bias[6], bias[7], qd));
}

template <int QM>
__device__ __forceinline__ uint4 dw_pixel_branch(const __nv_bfloat16* box,
                                                 const float* wts,
                                                 const Plan& pl, int C,
                                                 int img, int py, int px,
                                                 int d, int g,
                                                 const Qdq& qd) {
  if (d == 0) return dw_pixel<0, QM>(box, wts, pl, C, img, py, px, g, qd);
  if (d == 1) return dw_pixel<1, QM>(box, wts, pl, C, img, py, px, g, qd);
  return dw_pixel<2, QM>(box, wts, pl, C, img, py, px, g, qd);
}

// Two of the fuse product's sums plus their biases, through
// LeakyReLU(0.01). In QDQ mode rounded as the JAX int8 engine's bf16 1x1
// conv, bias add and LeakyReLU are (its slope is bf16(0.01), and
// max(v, bf16(v * slope)) is LeakyReLU for a slope in (0, 1)); BN follows
// in fp32.
template <int QM>
__device__ __forceinline__ float2 epilogue(float sum0, float sum1,
                                           float2 bias) {
  if constexpr (QM != QNONE) {
    const uint32_t v = add_bf16x2(bf16x2(sum0, sum1), bf16x2(bias.x, bias.y));
    constexpr uint32_t SLOPE = 0x3C243C24u;   // bf16(0.01) = 0.0100097656
    return bf16x2_to_float2(max_bf16x2(v, mul_bf16x2(v, SLOPE)));
  }
  const float v0 = sum0 + bias.x, v1 = sum1 + bias.y;
  return make_float2(v0 > 0.f ? v0 : 0.01f * v0, v1 > 0.f ? v1 : 0.01f * v1);
}

// At O = 64 (the first, widest blocks: C = 8 or 16, the most tiles) four
// blocks share an SM; 64 registers a thread hold their 4- and 2-pixel
// depthwise segments without spills.
// QM (QMode), the int8 QDQ mode (ops/acff.py::acff_infer_plain with
// act_scales): x QDQ'd once in the box (QSHARED) or per branch where the
// box columns are read (QBRANCH), each feature's sum without the bias
// rounded and QDQ'd where A is written (feature), and the epilogue rounded
// as the JAX int8 engine rounds its fuse conv, bias, LeakyReLU and BN
// (epilogue). In QNONE, qd is not read and the kernel is the plain bf16
// one.
template <int NH, int QM>
__global__ void __launch_bounds__(BTHREADS, NH == 32 ? 4 : 1)
acff_bf16_kernel(const __grid_constant__ CUtensorMap xmap,
                 const float* __restrict__ dw_w, const float* __restrict__ dw_b,
                 const __nv_bfloat16* __restrict__ fuse_op,
                 const float* __restrict__ fuse_b,
                 const float* __restrict__ scale,
                 const float* __restrict__ shift,
                 __nv_bfloat16* __restrict__ out, int B, int H, int W, int C,
                 int ostride, const Plan pl, int n_tiles, const Qdq qd) {
  constexpr int O = 2 * NH;
  constexpr int SROW = O * 2 + 16;   // output tile row, padded: no conflicts
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* sm = smem_raw + (((raw + 127u) & ~127u) - raw);
  const int box_bytes = pl.images * pl.hy * pl.hx * C * 2;
  const Smem L(C, O, box_bytes);
  float* wts = reinterpret_cast<float*>(sm + L.wts);
  unsigned char* a_s = sm + L.a;
  unsigned char* ring = sm + L.ring;
  // mbarriers: box buffers 0 and 1, then B stages 0 and 1
  const uint32_t bar_box = smem_u32(sm), bar_b = bar_box + 16;

  const int tid = threadIdx.x;
  const int OH = H - 2, OW = W - 2;
  const int per_image = pl.tiles_h * pl.tiles_w;
  const int C8 = C >> 3, kp8 = L.kp >> 3;
  // B streams as a cycle of chunks, one use per chunk per tile, through
  // two stages, across tile boundaries.
  const int nchunks = (L.kp + KCHUNK - 1) / KCHUNK;
  const int my_tiles = (n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int uses = my_tiles * nchunks;

  auto issue_box = [&](int it) {   // one thread: the box of tile number it
    const int t = blockIdx.x + it * gridDim.x, rem = t % per_image;
    const uint32_t bar = bar_box + 8 * (it & 1);
    const uint32_t dst = smem_u32(sm + L.box + (it & 1) * L.boxsz);
    const int x0 = rem % pl.tiles_w * pl.tw - pl.origin;
    const int y0 = rem / pl.tiles_w * pl.th - pl.origin;
    mbar_expect_tx(bar, box_bytes);
    tma_load_box(dst, &xmap, bar, 0, x0, y0, t / per_image * pl.images);
  };
  // QSHARED, all threads: once box `it` has landed, rewrite it in place as
  // bf16(QDQ(x, s_x)), each element once; the depthwise then reads it as
  // the bf16 kernel does. Box it + 1 is done while tile it's product runs
  // on the tensor cores, and the epilogue's barriers order it before that
  // tile's depthwise.
  auto qdq_box = [&](int it) {
    mbar_wait(bar_box + 8 * (it & 1), (it >> 1) & 1);
    uint4* v = reinterpret_cast<uint4*>(sm + L.box + (it & 1) * L.boxsz);
    for (int i = tid; i < box_bytes / 16; i += BTHREADS) {
      uint4 e = v[i];
      e.x = qdq_bf16x2(e.x, qd.s[0], qd.inv[0]);
      e.y = qdq_bf16x2(e.y, qd.s[0], qd.inv[0]);
      e.z = qdq_bf16x2(e.z, qd.s[0], qd.inv[0]);
      e.w = qdq_bf16x2(e.w, qd.s[0], qd.inv[0]);
      v[i] = e;
    }
  };
  auto issue_chunk = [&](int u) {  // one thread: B for chunk use u
    const int c = u % nchunks, kc = min(KCHUNK, L.kp - c * KCHUNK);
    const uint32_t bytes = kc * O * 2, bar = bar_b + 8 * (u & 1);
    mbar_expect_tx(bar, bytes);
    bulk_load(smem_u32(ring + (u & 1) * L.stage),
              fuse_op + (size_t)c * KCHUNK * O, bytes, bar);
  };

  if (tid == 0) {
    for (int i = 0; i < 4; ++i) mbar_init(bar_box + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    fence_async_smem();
    for (int it = 0; it < 2 && it < my_tiles; ++it) issue_box(it);
    for (int u = 0; u < 2 && u < uses; ++u) issue_chunk(u);
  }
  // Depthwise weights and biases: dw_w[d][kh][kw][c], then dw_b[d][c].
  for (int i = tid; i < 30 * C; i += BTHREADS)
    wts[i] = i < 27 * C ? __ldg(dw_w + i) : __ldg(dw_b + i - 27 * C);
  // Zero the K padding of A (3C is a multiple of 8, kp of 16).
  for (int i = tid; i < BM * (kp8 - 3 * C8); i += BTHREADS)
    *reinterpret_cast<uint4*>(a_s + a_offset(i % BM, 3 * C8 + i / BM, kp8)) =
        make_uint4(0, 0, 0, 0);
  __syncthreads();

  const int wg = tid >> 7;
  const uint32_t a_base = smem_u32(a_s), ring_base = smem_u32(ring);
  int u = 0;   // chunk uses so far
  for (int it = 0; it < my_tiles; ++it) {
    const int t = blockIdx.x + it * gridDim.x, rem = t % per_image;
    const int b0 = t / per_image * pl.images;
    const int oy0 = rem / pl.tiles_w * pl.th, ox0 = rem % pl.tiles_w * pl.tw;
    unsigned char* buf = sm + L.box + (it & 1) * L.boxsz;
    const __nv_bfloat16* box = reinterpret_cast<const __nv_bfloat16*>(buf);
    mbar_wait(bar_box + 8 * (it & 1), (it >> 1) & 1);
    if constexpr (QM == QSHARED) {
      if (it == 0) {
        qdq_box(0);
        __syncthreads();
      }
    }

    if (pl.origin == 2) {
      // Spatial tile: one (branch, row segment, 4-channel group) an item;
      // shorter segments where C is small, so that most threads get one.
      if (C >= 48) dw_rows<8, QM>(box, wts, a_s, C, kp8, tid, qd);
      else if (C >= 16) dw_rows<4, QM>(box, wts, a_s, C, kp8, tid, qd);
      else dw_rows<2, QM>(box, wts, a_s, C, kp8, tid, qd);
    } else {
      // Whole images: one (branch d, pixel p, 8-channel group g) an item.
      // Eight neighbouring threads take the eight pixels of one A
      // core-matrix row block and rotate g, so that their box reads spread
      // over the banks.
      for (int i = tid; i < 3 * BM * C8; i += BTHREADS) {
        const int j = i & 7, pr = (i >> 3) & 7, r = i >> 6;
        const int d = r / C8, g = (r % C8 + j) % C8, p = pr * 8 + j;
        int img, py, px;
        const bool live = tile_pixel(pl, p, b0, oy0, ox0, B, OH, OW, img,
                                     py, px);
        // A[p][k], k = d*C + 8g: core matrix (p/8, k/8), row p%8.
        *reinterpret_cast<uint4*>(a_s + a_offset(p, d * C8 + g, kp8)) =
            live ? dw_pixel_branch<QM>(box, wts, pl, C, img, py, px, d, g, qd)
                 : make_uint4(0, 0, 0, 0);
      }
    }
    fence_async_smem();   // A's generic stores, then wgmma's async reads
    __syncthreads();

    // Fuse product: warpgroup wg computes output channels [wg*NH, +NH).
    float acc[NH / 2];
#pragma unroll
    for (int i = 0; i < NH / 2; ++i) acc[i] = 0.f;
    for (int c = 0; c < nchunks; ++c, ++u) {
      const int kc = min(KCHUNK, L.kp - c * KCHUNK);
      const uint32_t b_base =
          ring_base + (u & 1) * L.stage + wg * (NH / 8) * kc * 16;
      mbar_wait(bar_b + 8 * (u & 1), (u >> 1) & 1);
      fence_operands(acc);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
      for (int s = 0; s < kc / 16; ++s)
        wgmma<NH>(acc,
                  gmma_desc(a_base + (c * KCHUNK / 8 + 2 * s) * A_LBO, A_LBO,
                            kp8 * A_LBO),
                  gmma_desc(b_base + 2 * s * 128, 128, kc * 16));
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      if constexpr (QM == QSHARED) {
        if (c == nchunks - 1 && it + 1 < my_tiles) qdq_box(it + 1);
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      fence_operands(acc);
      if (u + 2 < uses) {   // both warpgroups are done with this stage
        __syncthreads();
        if (tid == 0) issue_chunk(u + 2);
      }
    }

    // Epilogue into this tile's box buffer, free since the depthwise pass.
    // Accumulator d[4n + 2i + e] is row warp*16 + lane/4 + 8i, column
    // 8n + 2*(lane%4) + e of this warpgroup's N.
    const int lane = tid & 31, row0 = ((tid & 127) >> 5) * 16 + (lane >> 2);
#pragma unroll
    for (int n = 0; n < NH / 8; ++n) {
      const int col = wg * NH + n * 8 + (lane & 3) * 2;
      const float2 fb = *reinterpret_cast<const float2*>(fuse_b + col);
      const float2 sc = *reinterpret_cast<const float2*>(scale + col);
      const float2 sh = *reinterpret_cast<const float2*>(shift + col);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float2 v =
            epilogue<QM>(acc[4 * n + 2 * i], acc[4 * n + 2 * i + 1], fb);
        *reinterpret_cast<uint32_t*>(buf + (row0 + 8 * i) * SROW + col * 2) =
            bf16x2(fmaf(v.x, sc.x, sh.x), fmaf(v.y, sc.y, sh.y));
      }
    }
    __syncthreads();
    // 16-byte stores; a tile row of 8 pixels is 8*O*2 contiguous bytes.
    constexpr int O8 = O / 8;
    for (int i = tid; i < BM * O8; i += BTHREADS) {
      const int p = i / O8, j = i - p * O8;
      int img, py, px;
      if (!tile_pixel(pl, p, b0, oy0, ox0, B, OH, OW, img, py, px)) continue;
      __nv_bfloat16* dst =
          out + (((size_t)(b0 + img) * OH + oy0 + py) * OW + ox0 + px) *
                    ostride + j * 8;
      *reinterpret_cast<uint4*>(dst) =
          *reinterpret_cast<const uint4*>(buf + p * SROW + j * 16);
    }
    __syncthreads();   // the buffer is read: the box two tiles on goes there
    if (tid == 0 && it + 2 < my_tiles) {
      fence_async_smem();
      issue_box(it + 2);
    }
  }
}

// ---------------------------------------------------- bf16 wide-C variant
// acff_bf16_wide_kernel<NH, QM> replaces rtdm_tpu/ops/acff_pallas.py::
// _acff_kernel at the bf16 shapes past acff_bf16_kernel: a whole bf16 box,
// A and B over one block's 227 KB (C > 144 at O <= 128 on an 8x8 tile, C >
// 120 at O = 256), or C past a TMA box row (C > 256). It takes the input
// channels in chunks of WKC = 32 (per chunk a 4-D TMA box of 32 channels,
// zero fill the padding and the channels past C; the chunk's 3*32 features;
// its 96 rows of B, ops/acff.py::pack_fuse_operand_wide), and sums the fuse
// product over the chunks in order into fp32 accumulators.
//
// What bounds it on an H100: at C = 160 / 256, O = 128, 18^2, batch 256 it
// moves 43 / 59 MB (0.0130 / 0.0178 ms at 3.35 TB/s), and its fuse product
// (8.1 / 12.9 GFLOP on the bf16 tensor cores) and depthwise (283 / 453 M
// fp32 FMAs) take about as long: only a kernel that overlaps all three
// comes near the bound. Its first design (one 64-pixel tile a block, every
// chunk's box wait, depthwise into one A, product and wait in turn by all
// 256 threads, two blocks an SM) ran at 14-15% of it, 0.0865 / 0.1264 ms:
// its depthwise, in turn with the rest, was the largest phase (removing
// it saved 45-51%; B read again for every tile, 5%;
// scripts/acff_phase_times.py). This design takes 0.0600 / 0.0861 ms
// there (21.6% / 20.6% of the bound; int8 0.0881 / 0.1332, per branch
// 0.1397 / 0.2135; chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W), 1.54x
// / 1.51x the first in turns on one card; its depthwise's shared-memory
// box loads now bind it.
//
// The design (PERF.md has the designs measured on the way):
// - a block owns M = 128 output pixels at O <= 128 (a 16x8 tile, box 22 x
//   15) or M = 64 at O = 256 (8x8, box 14 x 15), or whole small images
//   packed into its M rows (ops/acff.py::wide_tile_plan). At O <= 128 each
//   B chunk feeds two m64nO products (one a warpgroup), so B's L2 traffic
//   halves; at O = 256 the two warpgroups take 128 columns each of one m64
//   tile. The box is one column wider than the halo needs, so that its
//   rows alternate bank halves.
// - warp specialisation: two MMA warpgroups (64 fp32 accumulators a
//   thread) and depthwise warps, 384 to 640 threads. The depthwise warps
//   wait for a box (full mbarrier), QDQ it in place (QSHARED), compute the
//   chunk's 96 features into one of two A buffers (the MMA side frees a
//   buffer on an empty mbarrier), arrive on its full mbarrier, and issue
//   the TMA box two chunks ahead (a ring of three). In bf16 at O <= 128
//   twelve warps take one branch of four tile rows each, a lane 8 pixels
//   x 4 channels; elsewhere a warp takes all three branches of two rows, a
//   lane 4 pixels (the QDQ modes' per-load work wants the registers that
//   640 threads leave too few of). A half warp pairs neighbouring rows, so
//   that its 8-byte box loads and A stores fall on 32 distinct banks. The
//   chunk's depthwise weights are fetched into registers one chunk ahead
//   and put into a second buffer.
// - the MMA warpgroups issue chunk c's wgmmas, commit, and wait with
//   wait_group 1, so chunk c's product runs while chunk c + 1's features
//   are computed; the chunk c - 1 they then free gives its B stage the B
//   chunk two on (cp.async.bulk). The epilogue (bias, LeakyReLU, BN from
//   fuse_b, scale and shift kept in shared memory) stages the output tile
//   in shared memory and stores it in 16-byte pieces, while the depthwise
//   warps go on into the next tile. The role branch is on a value
//   broadcast by __shfl_sync: on threadIdx itself ptxas serialized every
//   wgmma (C7518), which cost the overlap.
// - numerics as before: each feature summed in fp32 from zero (bf16: from
//   its bias) and rounded once; K summed in chunk order in fp32; QSHARED
//   QDQs each box element once in place, QBRANCH at each load with its
//   branch's scale; the epilogue rounds as epilogue<QM>.
constexpr int WKC = 32;          // input channels a chunk
constexpr int WK = 3 * WKC;      // fuse rows (features) a chunk
constexpr int WKP8 = WK / 8;     // A's core matrices a row group, in K
constexpr int W_SBO = WKP8 * A_LBO;   // bytes between A's row groups
constexpr int WNW = 30 * WKC;    // depthwise weights and biases a chunk
constexpr int WMMA = 256;        // two MMA warpgroups
constexpr int WTW = 8;           // columns of a spatial tile
constexpr int WHX = WTW + 7;     // columns of its box: odd

// Output pixels a block owns (A's rows, M): 128 at O <= 128, 64 at O = 256.
__host__ __device__ constexpr int wide_rows(int O) {
  return O <= 128 ? 128 : 64;
}

// How the depthwise warps split a chunk's features. bf16 at O <= 128: a
// warp takes one branch of four tile rows (3 M / 32 warps, 96 registers a
// thread at 640 threads), each lane 8 pixels; else (the QDQ modes, whose
// per-load QDQ wants the registers, and O = 256) a warp takes the three
// branches of two tile rows (M / 16 warps), each lane 4 pixels.
__host__ __device__ constexpr bool wide_by_branch(int O, int QM) {
  return O <= 128 && QM == QNONE;
}

// Threads of a block: the MMA warpgroups and the depthwise warps.
__host__ __device__ constexpr int wide_threads(int O, int QM) {
  return WMMA + (wide_by_branch(O, QM) ? 3 * wide_rows(O)
                                       : 2 * wide_rows(O));
}

// Stages of the input box ring (a box is loaded two chunks before its
// use) and of the B ring (one chunk before).
constexpr int WNBOX = 3, WNB = 2;

// Dynamic shared memory of the wide variant, in bytes from a 128-byte
// aligned base: mbarriers | two buffers of one chunk's dw_w (27 WKC) and
// dw_b (3 WKC) fp32 | fuse_b, scale and shift (3 O fp32) | the box ring
// (input boxes of WKC channels) | two A buffers (M x 3 WKC bf16 in core
// matrices, A_LBO apart in K, W_SBO in M) | the B ring (chunks of 3 WKC x
// O bf16) | the output tile, staged (M rows of O bf16 + 16 bytes).
struct WSmem {
  int wts, par, box, boxsz, a, asz, b, bsz, out, total;
  __host__ __device__ WSmem(int O, int box_bytes) {
    wts = 128;
    par = wts + 2 * WNW * 4;
    box = Smem::up128(par + 3 * O * 4);
    boxsz = Smem::up128(box_bytes);
    a = box + WNBOX * boxsz;
    asz = wide_rows(O) / 8 * W_SBO;
    b = Smem::up128(a + 2 * asz);
    bsz = WK * O * 2;
    out = b + WNB * bsz;
    total = out + wide_rows(O) * (O * 2 + 16);
  }
};

__device__ __forceinline__ void mbar_init_count(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// A barrier of `count` threads (a multiple of 32) on hardware barrier id.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void wgmma_n96(float (&d)[48], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(1));
}

// D(64 x N) += A(64 x 16) * B(16 x N) for the wide variant's N: O, or
// half of O = 256.
template <int N>
__device__ __forceinline__ void wgmma_full(float (&d)[N / 2], uint64_t da,
                                           uint64_t db) {
  if constexpr (N == 64) wgmma_n64(d, da, db);
  else if constexpr (N == 96) wgmma_n96(d, da, db);
  else wgmma_n128(d, da, db);
}

// Depthwise branch D of a spatial tile for SEG pixels px0.. of tile row py
// and channels 4q..4q+3 of the chunk, into A. The box is hx pixels wide,
// from (oy0-2, ox0-2); pixel px, tap (kh, kw) reads box row py+2-D+kh*S,
// column px+2-D+kw*S, S = D+1. The SEG+2S columns of a box row are loaded
// once each and feed every (px, kw) that reads them. A's row of pixel
// (py, px) is py*8 + px.
template <int D, int SEG, int QM>
__device__ __forceinline__ void wide_dw_row(const __nv_bfloat16* box,
                                            const float* wts,
                                            unsigned char* a_s, int hx,
                                            int q, int py, int px0,
                                            const Qdq& qd) {
  constexpr int S = D + 1, NCOL = SEG + 2 * S;
  float acc[SEG][4];
  const float4 bias =
      *reinterpret_cast<const float4*>(wts + 27 * WKC + D * WKC + q * 4);
  const float4 init = QM != QNONE ? make_float4(0.f, 0.f, 0.f, 0.f) : bias;
#pragma unroll
  for (int px = 0; px < SEG; ++px) {
    acc[px][0] = init.x; acc[px][1] = init.y;
    acc[px][2] = init.z; acc[px][3] = init.w;
  }
#pragma unroll
  for (int kh = 0; kh < 3; ++kh) {
    const __nv_bfloat16* row =
        box + ((py + 2 - D + kh * S) * hx + px0 + 2 - D) * WKC + q * 4;
    float4 w[3];
#pragma unroll
    for (int kw = 0; kw < 3; ++kw)
      w[kw] = *reinterpret_cast<const float4*>(
          wts + ((D * 3 + kh) * 3 + kw) * WKC + q * 4);
#pragma unroll
    for (int c = 0; c < NCOL; ++c) {
      const uint2 v = *reinterpret_cast<const uint2*>(row + c * WKC);
      const float2 lo = x_in<QM, D>(bf16x2_to_float2(v.x), qd);
      const float2 hi = x_in<QM, D>(bf16x2_to_float2(v.y), qd);
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        const int px = c - kw * S;
        if (px < 0 || px >= SEG) continue;
        acc[px][0] = fmaf(lo.x, w[kw].x, acc[px][0]);
        acc[px][1] = fmaf(lo.y, w[kw].y, acc[px][1]);
        acc[px][2] = fmaf(hi.x, w[kw].z, acc[px][2]);
        acc[px][3] = fmaf(hi.y, w[kw].w, acc[px][3]);
      }
    }
  }
  // A[m][D*WKC + 4q ..]: half a core-matrix row a pixel
  const int k = D * WKC + q * 4;
  unsigned char* dst =
      a_s + a_offset(py * WTW + px0, k >> 3, WKP8) + (k & 7) * 2;
#pragma unroll
  for (int px = 0; px < SEG; ++px)
    *reinterpret_cast<uint2*>(dst + px * 16) = make_uint2(
        features<QM>(acc[px][0], acc[px][1], bias.x, bias.y, qd),
        features<QM>(acc[px][2], acc[px][3], bias.z, bias.w, qd));
}

template <int NH, int QM>
__global__ void __launch_bounds__(wide_threads(2 * NH, QM), 1)
acff_bf16_wide_kernel(const __grid_constant__ CUtensorMap xmap,
                      const float* __restrict__ dw_w,
                      const float* __restrict__ dw_b,
                      const __nv_bfloat16* __restrict__ fuse_op,
                      const float* __restrict__ fuse_b,
                      const float* __restrict__ scale,
                      const float* __restrict__ shift,
                      __nv_bfloat16* __restrict__ out, int B, int H, int W,
                      int C, int ostride, const Plan pl, int n_tiles,
                      const Qdq qd) {
  constexpr int O = 2 * NH, M = wide_rows(O);
  constexpr int WDW = wide_threads(O, QM) - WMMA;   // depthwise threads
  constexpr int WREG = (WNW + WDW - 1) / WDW;
  // each MMA warpgroup: 64 of A's rows x all O (O <= 128), or all 64 rows
  // x half of O = 256
  constexpr int NW = O <= 128 ? O : 128;
  constexpr int NBOX = WNBOX, NB = WNB;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* sm = smem_raw + (((raw + 127u) & ~127u) - raw);
  const int nchunks = (C + WKC - 1) / WKC;
  const int box_bytes = pl.images * pl.hy * pl.hx * WKC * 2;
  const WSmem L(O, box_bytes);
  float* wbuf = reinterpret_cast<float*>(sm + L.wts);
  // mbarriers, one a stage: box (and TMA bytes) landed, B landed, A
  // written (one arrival a depthwise warp), A read (the MMA side)
  const uint32_t full_box = smem_u32(sm), full_b = full_box + 8 * NBOX;
  const uint32_t full_a = full_b + 8 * NB, empty_a = full_a + 16;

  const int tid = threadIdx.x;
  const int OH = H - 2, OW = W - 2;
  const int per_image = pl.tiles_h * pl.tiles_w;
  const int my_tiles = (n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  // a use is one (tile, chunk) of this block, in order; use u reads box
  // u % NBOX, weights and A u % 2, B u % NB
  const int uses = my_tiles * nchunks;

  auto issue_box = [&](int u) {   // one thread: the box of use u
    const int it = u / nchunks, c = u - it * nchunks;
    const int t = blockIdx.x + it * gridDim.x, rem = t % per_image;
    const uint32_t bar = full_box + 8 * (u % NBOX);
    mbar_expect_tx(bar, box_bytes);
    tma_load_box(smem_u32(sm + L.box + u % NBOX * L.boxsz), &xmap, bar,
                 c * WKC, rem % pl.tiles_w * pl.tw - pl.origin,
                 rem / pl.tiles_w * pl.th - pl.origin,
                 t / per_image * pl.images);
  };
  auto issue_b = [&](int u) {     // one thread: B chunk of use u
    const uint32_t bar = full_b + 8 * (u % NB);
    mbar_expect_tx(bar, L.bsz);
    bulk_load(smem_u32(sm + L.b + u % NB * L.bsz),
              fuse_op + (size_t)(u % nchunks) * WK * O, L.bsz, bar);
  };
  // One chunk's depthwise weights and biases, rows dw_w[d][kh][kw] then
  // dw_b[d] of its WKC channels, zero past C (depthwise thread dt).
  auto fetch_weights = [&](float (&w)[WREG], int c, int dt) {
#pragma unroll
    for (int k = 0; k < WREG; ++k) {
      const int i = dt + k * WDW, r = i / WKC;
      const int ch = c * WKC + i - r * WKC;
      w[k] = i >= WNW || ch >= C ? 0.f
             : r < 27 ? __ldg(dw_w + r * C + ch)
                      : __ldg(dw_b + (r - 27) * C + ch);
    }
  };
  auto put_weights = [&](const float (&w)[WREG], int buf, int dt) {
#pragma unroll
    for (int k = 0; k < WREG; ++k)
      if (dt + k * WDW < WNW) wbuf[buf * WNW + dt + k * WDW] = w[k];
  };

  if (tid == 0) {
    for (int i = 0; i < NBOX; ++i) mbar_init(full_box + 8 * i);
    for (int i = 0; i < NB; ++i) mbar_init(full_b + 8 * i);
    for (int i = 0; i < 2; ++i) {
      mbar_init_count(full_a + 8 * i, WDW / 32);
      mbar_init(empty_a + 8 * i);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    fence_async_smem();
    for (int u = 0; u < NBOX && u < uses; ++u) issue_box(u);
    for (int u = 0; u < NB && u < uses; ++u) issue_b(u);
  }
  // the thread's warpgroup, as a value ptxas knows to be warp-uniform: a
  // role branch on threadIdx itself makes it serialize the wgmmas
  const int role = __shfl_sync(0xffffffffu, tid >> 7, 0);
  if (role >= WMMA / 128) {
    float w[WREG];
    fetch_weights(w, 0, tid - WMMA);
    put_weights(w, 0, tid - WMMA);
  } else {
    float* par = reinterpret_cast<float*>(sm + L.par);
    for (int i = tid; i < 3 * O; i += WMMA)
      par[i] = i < O ? fuse_b[i] : i < 2 * O ? scale[i - O] : shift[i - 2 * O];
  }
  __syncthreads();

  if (role >= WMMA / 128) {
    // ------------------------------------------------ depthwise warps
    const int dt = tid - WMMA, warp = dt >> 5, lane = dt & 31;
    float wnext[WREG];
    int it = 0, c = 0, sb = 0, pb = 0;   // box stage and its phase
    for (int u = 0; u < uses; ++u) {
      const int s = u & 1;
      unsigned char* buf = sm + L.box + sb * L.boxsz;
      const __nv_bfloat16* box = reinterpret_cast<const __nv_bfloat16*>(buf);
      const float* wts = wbuf + s * WNW;
      unsigned char* a_s = sm + L.a + s * L.asz;
      const bool more = u + 1 < uses;
      if (more) fetch_weights(wnext, c + 1 == nchunks ? 0 : c + 1, dt);
      mbar_wait(full_box + 8 * sb, pb);
      if constexpr (QM == QSHARED) {
        // the box as bf16(QDQ(x, s_x)), each element once, in place
        uint4* v = reinterpret_cast<uint4*>(buf);
        for (int i = dt; i * 16 < box_bytes; i += WDW) {
          uint4 e = v[i];
          e.x = qdq_bf16x2(e.x, qd.s[0], qd.inv[0]);
          e.y = qdq_bf16x2(e.y, qd.s[0], qd.inv[0]);
          e.z = qdq_bf16x2(e.z, qd.s[0], qd.inv[0]);
          e.w = qdq_bf16x2(e.w, qd.s[0], qd.inv[0]);
          v[i] = e;
        }
        named_sync(2, WDW);
      }
      if (u >= 2) mbar_wait(empty_a + 8 * s, ((u >> 1) + 1) & 1);
      if (pl.origin == 2) {
        const int q = lane & 7;   // channels 4q..
        if constexpr (wide_by_branch(O, QM)) {
          // warp w: branch w / NQ of tile rows 4 (w % NQ) .. + 3, a lane
          // the 8 pixels of row lane / 8 of them
          constexpr int NQ = M / 32;
          const int py = 4 * (warp % NQ) + (lane >> 3);
          if (warp < NQ)
            wide_dw_row<0, 8, QM>(box, wts, a_s, WHX, q, py, 0, qd);
          else if (warp < 2 * NQ)
            wide_dw_row<1, 8, QM>(box, wts, a_s, WHX, q, py, 0, qd);
          else
            wide_dw_row<2, 8, QM>(box, wts, a_s, WHX, q, py, 0, qd);
        } else {
          // warp w: tile rows 2w, 2w + 1, a lane pixels 4 (lane / 16) .. + 3
          // of row lane / 8 % 2 of them
          const int py = 2 * warp + ((lane >> 3) & 1), px0 = (lane >> 4) * 4;
          wide_dw_row<0, 4, QM>(box, wts, a_s, WHX, q, py, px0, qd);
          wide_dw_row<1, 4, QM>(box, wts, a_s, WHX, q, py, px0, qd);
          wide_dw_row<2, 4, QM>(box, wts, a_s, WHX, q, py, px0, qd);
        }
      } else {
        // Whole images: one (branch d, pixel p, 8-channel group g) an item,
        // eight neighbouring threads on the eight pixels of one A
        // core-matrix row block, rotating g.
        const int t = blockIdx.x + it * gridDim.x;
        const int b0 = t / per_image * pl.images;
        constexpr int C8 = WKC / 8;
        for (int i = dt; i < 3 * M * C8; i += WDW) {
          const int j = i & 7, pr = (i >> 3) % (M / 8), r = i / M;
          const int d = r / C8, g = (r % C8 + j) % C8, p = pr * 8 + j;
          int img, py, px;
          const bool live = tile_pixel(pl, p, b0, 0, 0, B, OH, OW, img, py,
                                       px);
          *reinterpret_cast<uint4*>(a_s + a_offset(p, d * C8 + g, WKP8)) =
              live ? dw_pixel_branch<QM>(box, wts, pl, WKC, img, py, px, d,
                                         g, qd)
                   : make_uint4(0, 0, 0, 0);
        }
      }
      fence_async_smem();   // A's (and the box's) generic stores, then the
      __syncwarp();         // async proxy: wgmma reads A, TMA refills the box
      if (lane == 0) mbar_arrive(full_a + 8 * s);
      if (more) put_weights(wnext, s ^ 1, dt);
      named_sync(2, WDW);   // the box and weights of use u are read
      if (dt == 0 && u + NBOX < uses) issue_box(u + NBOX);
      if (++sb == NBOX) {
        sb = 0;
        pb ^= 1;
      }
      if (++c == nchunks) {
        c = 0;
        ++it;
      }
    }
    return;
  }

  // ---------------------------------------------------- MMA warpgroups
  const int wg = role, lane = tid & 31, warp = (tid & 127) >> 5;
  const int arow = O <= 128 ? 64 * wg : 0;      // this warpgroup's rows
  const int col0 = O <= 128 ? 0 : NW * wg;      // and output columns
  const uint32_t a_base = smem_u32(sm + L.a) + arow / 8 * W_SBO;
  const uint32_t b_base = smem_u32(sm + L.b) + col0 / 8 * WK * 16;
  float acc[NW / 2];
  int u = 0, sb = 0, pb = 0;   // B stage and its phase
  // Use r has run its product in both warpgroups: free its A buffer and
  // load the B chunk NB uses on into its B stage.
  auto release = [&](int r) {
    named_sync(1, WMMA);
    if (tid == 0) {
      mbar_arrive(empty_a + 8 * (r & 1));
      if (r + NB < uses) issue_b(r + NB);
    }
  };
  for (int it = 0; it < my_tiles; ++it) {
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
    for (int c = 0; c < nchunks; ++c, ++u) {
      const int s = u & 1;
      mbar_wait(full_a + 8 * s, (u >> 1) & 1);
      mbar_wait(full_b + 8 * sb, pb);
      const uint32_t a_st = a_base + s * L.asz, b_st = b_base + sb * L.bsz;
      if (++sb == NB) {
        sb = 0;
        pb ^= 1;
      }
      fence_operands(acc);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int k = 0; k < WK / 16; ++k)
        wgmma_full<NW>(acc, gmma_desc(a_st + 2 * k * A_LBO, A_LBO, W_SBO),
                       gmma_desc(b_st + 2 * k * 128, 128, WK * 16));
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      // chunk u's product runs while use u - 1 is freed (that of a tile's
      // first chunk was freed after the tile before)
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      fence_operands(acc);
      if (c > 0) release(u - 1);
      if (c + 1 == nchunks) {
        asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
        fence_operands(acc);
        release(u);
      }
    }

    // Epilogue: bias, LeakyReLU and the BN affine from the accumulators
    // into the staged output tile (acc[4n + 2i + e] is A's row arow +
    // warp*16 + lane/4 + 8i, column col0 + 8n + 2*(lane%4) + e; rows
    // padded by 16 bytes: no bank conflicts), then 16-byte stores of its
    // pixels' rows. A's row m is pixel (m / 8, m % 8) of a spatial tile,
    // or pixel m of the packed whole images.
    constexpr int SROW = O * 2 + 16, O8 = O / 8;
    const float* par = reinterpret_cast<const float*>(sm + L.par);
    unsigned char* stage = sm + L.out;
    const int row = arow + warp * 16 + (lane >> 2);
#pragma unroll
    for (int n = 0; n < NW / 8; ++n) {
      const int col = col0 + n * 8 + (lane & 3) * 2;
      const float2 fb = *reinterpret_cast<const float2*>(par + col);
      const float2 sc = *reinterpret_cast<const float2*>(par + O + col);
      const float2 sh = *reinterpret_cast<const float2*>(par + 2 * O + col);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float2 v =
            epilogue<QM>(acc[4 * n + 2 * i], acc[4 * n + 2 * i + 1], fb);
        *reinterpret_cast<uint32_t*>(stage + (row + 8 * i) * SROW + col * 2) =
            bf16x2(fmaf(v.x, sc.x, sh.x), fmaf(v.y, sc.y, sh.y));
      }
    }
    named_sync(1, WMMA);
    const int t = blockIdx.x + it * gridDim.x, rem = t % per_image;
    const int b0 = t / per_image * pl.images;
    const int oy0 = rem / pl.tiles_w * pl.th, ox0 = rem % pl.tiles_w * pl.tw;
    for (int i = tid; i < M * O8; i += WMMA) {
      const int p = i / O8, j = i - p * O8;
      int img = 0, py = p >> 3, px = p & 7;
      const bool keep =
          pl.origin == 0
              ? tile_pixel(pl, p, b0, oy0, ox0, B, OH, OW, img, py, px)
              : oy0 + py < OH && ox0 + px < OW;
      if (keep)
        *reinterpret_cast<uint4*>(
            out + (((size_t)(b0 + img) * OH + oy0 + py) * OW + ox0 + px) *
                      ostride + j * 8) =
            *reinterpret_cast<const uint4*>(stage + p * SROW + j * 16);
    }
  }
}

// ------------------------------------------------------------- fp32 kernel

// Dynamic shared memory of the fp32 kernel, in bytes from a 128-byte
// aligned base: 3 mbarriers | two buffers of one chunk's depthwise weights
// and biases, dw_w (27 KC) then dw_b (3 KC) fp32, zero past C | two input
// boxes of KC channels | A, its hi part then its lo part (64
// x 3KC TF32 values each, in core matrices F_LBO apart in K) | one B
// chunk, hi then lo (3KC x O TF32 values each).
// A's core matrices that follow in K lie 160 bytes apart: a quarter warp
// of the depthwise stores 4 channel groups x 2 interleaved pixel sets,
// which then fall on 8 distinct 16-byte bank groups.
constexpr int F_LBO = 160;

struct FSmem {
  int kc4, apart, wts, box, boxsz, a, b, bsz, total;
  __host__ __device__ FSmem(int KC, int O, int box_bytes) {
    kc4 = 3 * KC / 4;
    apart = 8 * kc4 * F_LBO;
    wts = 128;
    box = Smem::up128(wts + 2 * 30 * KC * 4);
    boxsz = Smem::up128(box_bytes);
    a = box + 2 * boxsz;
    b = Smem::up128(a + 2 * apart);
    bsz = 3 * KC * O * 8;
    total = b + bsz;
  }
};

__device__ __forceinline__ void wgmma_tf32_n32(float (&d)[16], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_n48(float (&d)[24], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D(64 x P) = A*B (scale_d 0) or D + A*B (scale_d 1), A (64 x 8) and B
// (8 x P) TF32, both K-major in shared memory.
template <int P>
__device__ __forceinline__ void wgmma_tf32(float (&d)[P / 2], uint64_t da,
                                           uint64_t db, int scale_d) {
  if constexpr (P == 32) wgmma_tf32_n32(d, da, db, scale_d);
  else if constexpr (P == 48) wgmma_tf32_n48(d, da, db, scale_d);
  else if constexpr (P == 64) wgmma_tf32_n64(d, da, db, scale_d);
  else wgmma_tf32_n128(d, da, db, scale_d);
}

// v as hi + lo, both TF32 (fp32 bit patterns with the low 13 bits zero):
// hi = v rounded to nearest (ties away), lo = the rest, rounded alike.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(v));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(v - __uint_as_float(hi)));
}

// Four features of one pixel into A's hi and lo parts: one core-matrix
// row (16 bytes) each.
__device__ __forceinline__ void store_split(unsigned char* dst, int apart,
                                            float a, float b, float c,
                                            float d) {
  uint4 hi, lo;
  split_tf32(a, hi.x, lo.x);
  split_tf32(b, hi.y, lo.y);
  split_tf32(c, hi.z, lo.z);
  split_tf32(d, hi.w, lo.w);
  *reinterpret_cast<uint4*>(dst) = hi;
  *reinterpret_cast<uint4*>(dst + apart) = lo;
}

// One run of the 3xTF32 product, committed as one wgmma group: one k step
// (8 rows) of A, its lo part `apart` bytes after its hi part, times one k
// step of B over P columns, its lo part `blo` bytes after its hi part,
// summed on the tensor cores from zero, the two small lo terms first:
// d = A_lo*B_hi + A_hi*B_lo + A_hi*B_hi.
template <int P>
__device__ __forceinline__ void tf32x3_run(float (&d)[P / 2], uint32_t a,
                                           uint32_t b, int apart, int blo,
                                           uint32_t a_sbo, uint32_t b_sbo) {
  fence_operands(d);
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
  wgmma_tf32<P>(d, gmma_desc(a + apart, F_LBO, a_sbo),
                gmma_desc(b, 128, b_sbo), 0);
  wgmma_tf32<P>(d, gmma_desc(a, F_LBO, a_sbo),
                gmma_desc(b + blo, 128, b_sbo), 1);
  wgmma_tf32<P>(d, gmma_desc(a, F_LBO, a_sbo), gmma_desc(b, 128, b_sbo), 1);
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// Waits until at most PENDING wgmma groups of the warpgroup are in flight,
// then adds the finished run d to acc in fp32, rounded to nearest.
template <int PENDING, int N>
__device__ __forceinline__ void retire_run(float (&acc)[N], float (&d)[N]) {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(PENDING)
               : "memory");
  fence_operands(d);
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] += d[i];
}

// The 3xTF32 product of one channel chunk, STEPS k steps (3*KC/8), into a
// warpgroup's acc (64 x NH): one run a k step, summed from zero on the
// tensor cores and added to acc in fp32. Two runs are in flight, in two
// register sets, so that one run's add overlaps the next run's product.
template <int NH, int STEPS>
__device__ __forceinline__ void chunk_product(float (&acc)[NH / 2],
                                              uint32_t a, uint32_t b,
                                              int apart, int blo,
                                              uint32_t a_sbo,
                                              uint32_t b_sbo) {
  float pa[NH / 2], pb[NH / 2];
#pragma unroll
  for (int s = 0; s < STEPS; s += 2) {
    tf32x3_run<NH>(pa, a + 2 * s * F_LBO, b + 2 * s * 128, apart, blo,
                   a_sbo, b_sbo);
    if (s > 0) retire_run<1>(acc, pb);
    if (s + 1 < STEPS) {
      tf32x3_run<NH>(pb, a + 2 * (s + 1) * F_LBO, b + 2 * (s + 1) * 128,
                     apart, blo, a_sbo, b_sbo);
      retire_run<1>(acc, pa);
    } else {
      retire_run<0>(acc, pa);
    }
  }
  if (STEPS % 2 == 0) retire_run<0>(acc, pb);
}

// Byte offset of A[m][4*k4 .. 4*k4+3] (one core-matrix row) in a part.
__device__ __forceinline__ int af_offset(int m, int k4, int kc4) {
  return (m >> 3) * kc4 * F_LBO + k4 * F_LBO + (m & 7) * 16;
}

// Depthwise branch D of a spatial tile (8x8 pixels, a 14x14 box of KC
// channels from (oy0-2, ox0-2)) for the SEG pixels px0, px0 + 8/SEG, ...
// of tile row py and chunk channels 4q..4q+3, split into A; wts holds the
// chunk's weights, rows of KC. Pixel px, tap
// (kh, kw) reads box row py+2-D+kh*S, column px+2-D+kw*S (S = D+1); each
// box column of a tap row is loaded once (16 bytes) for every (pixel, kw)
// that reads it. The pixels are interleaved, not contiguous, so that
// neighbouring threads (the other pixel sets of the row) read columns 64
// or 32 bytes apart: no bank conflicts, at about the same loads per FMA.
template <int D, int SEG>
__device__ __forceinline__ void dw_row_f32(const float* box, const float* wts,
                                           unsigned char* a_s, int apart,
                                           int KC, int q, int py, int px0,
                                           int kc4) {
  constexpr int S = D + 1, ST = 8 / SEG, HX = 14;
  constexpr int NCOL = (SEG - 1) * ST + 2 * S + 1;
  const int ch = q * 4;
  float acc[SEG][4];
  const float4 bias =
      *reinterpret_cast<const float4*>(wts + (27 + D) * KC + ch);
#pragma unroll
  for (int j = 0; j < SEG; ++j) {
    acc[j][0] = bias.x; acc[j][1] = bias.y;
    acc[j][2] = bias.z; acc[j][3] = bias.w;
  }
#pragma unroll
  for (int kh = 0; kh < 3; ++kh) {
    const float* row =
        box + ((py + 2 - D + kh * S) * HX + px0 + 2 - D) * KC + q * 4;
    float4 w[3];
#pragma unroll
    for (int kw = 0; kw < 3; ++kw)
      w[kw] = *reinterpret_cast<const float4*>(
          wts + ((D * 3 + kh) * 3 + kw) * KC + ch);
#pragma unroll
    for (int c = 0; c < NCOL; ++c) {
      bool used = false;
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        const int t = c - kw * S;
        used |= t >= 0 && t % ST == 0 && t / ST < SEG;
      }
      if (!used) continue;
      const float4 v = *reinterpret_cast<const float4*>(row + c * KC);
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        const int t = c - kw * S, j = t / ST;
        if (t < 0 || t % ST != 0 || j >= SEG) continue;
        acc[j][0] = fmaf(v.x, w[kw].x, acc[j][0]);
        acc[j][1] = fmaf(v.y, w[kw].y, acc[j][1]);
        acc[j][2] = fmaf(v.z, w[kw].z, acc[j][2]);
        acc[j][3] = fmaf(v.w, w[kw].w, acc[j][3]);
      }
    }
  }
  // A[py*8 + px0 + j*ST][D*KC + 4q ..]: one core-matrix row each.
  unsigned char* dst = a_s + af_offset(py * 8 + px0, D * (KC >> 2) + q, kc4);
#pragma unroll
  for (int j = 0; j < SEG; ++j)
    store_split(dst + j * ST * 16, apart, acc[j][0], acc[j][1], acc[j][2],
                acc[j][3]);
}

// The three branches of a spatial tile for one channel chunk: 192 items of
// (branch, row, pixel set, 4 channels), the channel groups and then the
// pixel sets on neighbouring threads.
template <int SEG>
__device__ __forceinline__ void dw_rows_f32(const float* box,
                                            const float* wts,
                                            unsigned char* a_s, int apart,
                                            int KC, int kc4, int tid) {
  constexpr int ST = 8 / SEG;
  const int KC4 = KC >> 2;
  for (int i = tid; i < 3 * 8 * ST * KC4; i += BTHREADS) {
    const int q = i % KC4, r = i / KC4, px0 = r % ST, py = (r / ST) & 7;
    const int d = r / (8 * ST);
    if (d == 0)
      dw_row_f32<0, SEG>(box, wts, a_s, apart, KC, q, py, px0, kc4);
    else if (d == 1)
      dw_row_f32<1, SEG>(box, wts, a_s, apart, KC, q, py, px0, kc4);
    else
      dw_row_f32<2, SEG>(box, wts, a_s, apart, KC, q, py, px0, kc4);
  }
}

// Depthwise branch d of one pixel of a whole-image tile (the box is the
// image, KC channels) for chunk channels 4g..4g+3; taps outside the image
// are zero.
__device__ __forceinline__ float4 dw_pixel_f32(const float* box,
                                               const float* wts,
                                               const Plan& pl, int KC,
                                               int img, int py, int px, int d,
                                               int g) {
  const int ch = g * 4;
  float4 acc = *reinterpret_cast<const float4*>(wts + (27 + d) * KC + ch);
  const int step = d + 1;
  const float* src = box + (size_t)img * pl.hy * pl.hx * KC + g * 4;
#pragma unroll
  for (int kh = 0; kh < 3; ++kh) {
    const int ly = py - d + kh * step;
    if ((unsigned)ly >= (unsigned)pl.hy) continue;
#pragma unroll
    for (int kw = 0; kw < 3; ++kw) {
      const int lx = px - d + kw * step;
      if ((unsigned)lx >= (unsigned)pl.hx) continue;
      const float4 v =
          *reinterpret_cast<const float4*>(src + (ly * pl.hx + lx) * KC);
      const float4 w = *reinterpret_cast<const float4*>(
          wts + ((d * 3 + kh) * 3 + kw) * KC + ch);
      acc.x = fmaf(v.x, w.x, acc.x);
      acc.y = fmaf(v.y, w.y, acc.y);
      acc.z = fmaf(v.z, w.z, acc.z);
      acc.w = fmaf(v.w, w.w, acc.w);
    }
  }
  return acc;
}

// One block owns 64 output pixels and all O, and walks the input channels
// in chunks of KC (8 or 16): per chunk, the chunk's box arrives by TMA,
// its 3*KC features are computed once per pixel and split into A (hi,
// lo), and the chunk's B (hi, lo) is multiplied in as 3xTF32:
// D += A_lo*B_hi + A_hi*B_lo + A_hi*B_hi. The next box is in flight
// during a chunk (two buffers), the next B chunk during the next
// depthwise (one buffer; loaded once where C is one chunk).
template <int NH>
__global__ void __launch_bounds__(BTHREADS, NH <= 64 ? 2 : 1)
acff_fp32_kernel(const __grid_constant__ CUtensorMap xmap,
                 const float* __restrict__ dw_w, const float* __restrict__ dw_b,
                 const float* __restrict__ fuse_op,
                 const float* __restrict__ fuse_b,
                 const float* __restrict__ scale,
                 const float* __restrict__ shift, float* __restrict__ out,
                 int B, int H, int W, int C, int KC, int ostride,
                 const Plan pl, int n_tiles) {
  constexpr int O = 2 * NH;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* sm = smem_raw + (((raw + 127u) & ~127u) - raw);
  const int nchunks = (C + KC - 1) / KC, KC4 = KC >> 2;
  const int box_bytes = pl.images * pl.hy * pl.hx * KC * 4;
  const FSmem L(KC, O, box_bytes);
  float* wbuf = reinterpret_cast<float*>(sm + L.wts);
  unsigned char* a_s = sm + L.a;
  // mbarriers: box buffers 0 and 1, then the B chunk
  const uint32_t bar_box = smem_u32(sm), bar_b = bar_box + 16;

  const int tid = threadIdx.x;
  const int OH = H - 2, OW = W - 2;
  const int per_image = pl.tiles_h * pl.tiles_w;
  const int my_tiles = (n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  // a use is one (tile, chunk) of this block, in order; use u reads box
  // buffer u & 1 and, where C is more than one chunk, B load number u
  const int uses = my_tiles * nchunks;

  auto issue_box = [&](int u) {   // one thread: the box of use u
    const int it = u / nchunks, c = u - it * nchunks;
    const int t = blockIdx.x + it * gridDim.x, rem = t % per_image;
    const uint32_t bar = bar_box + 8 * (u & 1);
    const uint32_t dst = smem_u32(sm + L.box + (u & 1) * L.boxsz);
    mbar_expect_tx(bar, box_bytes);
    tma_load_box(dst, &xmap, bar, c * KC, rem % pl.tiles_w * pl.tw - pl.origin,
                 rem / pl.tiles_w * pl.th - pl.origin,
                 t / per_image * pl.images);
  };
  auto issue_b = [&](int c) {     // one thread: B chunk c
    mbar_expect_tx(bar_b, L.bsz);
    bulk_load(smem_u32(sm + L.b), fuse_op + (size_t)c * (L.bsz / 4), L.bsz,
              bar_b);
  };

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bar_box + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    fence_async_smem();
    for (int u = 0; u < 2 && u < uses; ++u) issue_box(u);
    if (uses > 0) issue_b(0);
  }
  // One chunk's depthwise weights and biases, rows dw_w[d][kh][kw] then
  // dw_b[d] of its KC channels, zero past C: 30*KC <= 480 values, thread
  // t fetches values t and t + 256 into registers, and puts them into a
  // buffer later. Where C is more than one chunk, the next use's are
  // fetched before a use's product and put after it, into the other
  // buffer, so that the product hides their latency.
  auto fetch_weights = [&](float (&w)[2], int c) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int i = tid + k * BTHREADS, r = i / KC;
      const int ch = c * KC + i - r * KC;
      w[k] = i >= 30 * KC || ch >= C ? 0.f
             : r < 27 ? __ldg(dw_w + r * C + ch)
                      : __ldg(dw_b + (r - 27) * C + ch);
    }
  };
  auto put_weights = [&](const float (&w)[2], int buf) {
#pragma unroll
    for (int k = 0; k < 2; ++k)
      if (tid + k * BTHREADS < 30 * KC)
        wbuf[buf * 30 * KC + tid + k * BTHREADS] = w[k];
  };
  float wnext[2];
  fetch_weights(wnext, 0);
  put_weights(wnext, 0);
  __syncthreads();

  const int wg = tid >> 7;
  const uint32_t a_base = smem_u32(a_s);
  const uint32_t b_base = smem_u32(sm + L.b) + wg * (NH / 8) * L.kc4 * 128;
  const uint32_t a_sbo = L.kc4 * F_LBO, b_sbo = L.kc4 * 128;
  int u = 0;
  for (int it = 0; it < my_tiles; ++it) {
    const int t = blockIdx.x + it * gridDim.x, rem = t % per_image;
    const int b0 = t / per_image * pl.images;
    const int oy0 = rem / pl.tiles_w * pl.th, ox0 = rem % pl.tiles_w * pl.tw;
    float acc[NH / 2];
#pragma unroll
    for (int i = 0; i < NH / 2; ++i) acc[i] = 0.f;

    for (int c = 0; c < nchunks; ++c, ++u) {
      const float* box =
          reinterpret_cast<const float*>(sm + L.box + (u & 1) * L.boxsz);
      const float* wts = wbuf + (nchunks > 1 ? (u & 1) * 30 * KC : 0);
      mbar_wait(bar_box + 8 * (u & 1), (u >> 1) & 1);
      if (pl.origin == 2) {
        if (KC == 16)
          dw_rows_f32<4>(box, wts, a_s, L.apart, KC, L.kc4, tid);
        else
          dw_rows_f32<2>(box, wts, a_s, L.apart, KC, L.kc4, tid);
      } else {
        // Whole images: one (branch d, pixel p, 4 channels g) an item, the
        // eight pixels of a core-matrix row block on neighbouring threads.
        for (int i = tid; i < 3 * BM * KC4; i += BTHREADS) {
          const int j = i & 7, pr = (i >> 3) & 7, r = i >> 6;
          const int d = r / KC4, g = (r % KC4 + j) % KC4, p = pr * 8 + j;
          int img, py, px;
          const float4 v =
              tile_pixel(pl, p, b0, oy0, ox0, B, OH, OW, img, py, px)
                  ? dw_pixel_f32(box, wts, pl, KC, img, py, px, d, g)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
          store_split(a_s + af_offset(p, d * KC4 + g, L.kc4), L.apart, v.x,
                      v.y, v.z, v.w);
        }
      }
      fence_async_smem();   // A's generic stores, then wgmma's async reads
      __syncthreads();      // and the box and weights of use u are read
      if (tid == 0 && u + 2 < uses) issue_box(u + 2);
      const bool next_weights = nchunks > 1 && u + 1 < uses;
      if (next_weights) fetch_weights(wnext, (c + 1) % nchunks);

      // 3xTF32 over this chunk's 3*KC rows, warpgroup wg computing output
      // channels [wg*NH, +NH). The tensor cores round each sum they carry
      // toward zero: a bias of the sign of the sum, which real activations
      // (not centred on zero) carry from block to block. So the product
      // runs one k step a run, each summed from zero and added to acc in
      // fp32, rounded to nearest (chunk_product).
      mbar_wait(bar_b, nchunks > 1 ? (u & 1) : 0);
      if (KC == 16)
        chunk_product<NH, 6>(acc, a_base, b_base, L.apart, L.bsz / 2, a_sbo,
                             b_sbo);
      else
        chunk_product<NH, 3>(acc, a_base, b_base, L.apart, L.bsz / 2, a_sbo,
                             b_sbo);
      if (next_weights) put_weights(wnext, (u + 1) & 1);
      __syncthreads();      // both warpgroups are done with A and B
      if (tid == 0 && nchunks > 1 && u + 1 < uses) issue_b((c + 1) % nchunks);
    }

    // Epilogue from the accumulators, stored straight to device memory:
    // accumulator d[4n + 2i + e] is row warp*16 + lane/4 + 8i, column
    // 8n + 2*(lane%4) + e of this warpgroup's N, so the four lanes of a
    // row write one whole 32-byte sector with 8-byte stores. No staging:
    // no shared-memory pass and no barrier (A is free once both
    // warpgroups' products are done, the barrier above).
    const int lane = tid & 31, row0 = ((tid & 127) >> 5) * 16 + (lane >> 2);
    float* dst[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      int img, py, px;
      dst[i] = tile_pixel(pl, row0 + 8 * i, b0, oy0, ox0, B, OH, OW, img, py,
                          px)
                   ? out + (((size_t)(b0 + img) * OH + oy0 + py) * OW + ox0 +
                            px) * ostride
                   : nullptr;
    }
#pragma unroll
    for (int n = 0; n < NH / 8; ++n) {
      const int col = wg * NH + n * 8 + (lane & 3) * 2;
      const float2 fb = *reinterpret_cast<const float2*>(fuse_b + col);
      const float2 sc = *reinterpret_cast<const float2*>(scale + col);
      const float2 sh = *reinterpret_cast<const float2*>(shift + col);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float v0 = acc[4 * n + 2 * i] + fb.x;
        float v1 = acc[4 * n + 2 * i + 1] + fb.y;
        v0 = v0 > 0.f ? v0 : 0.01f * v0;
        v1 = v1 > 0.f ? v1 : 0.01f * v1;
        if (dst[i] != nullptr)
          *reinterpret_cast<float2*>(dst[i] + col) =
              make_float2(fmaf(v0, sc.x, sh.x), fmaf(v1, sc.y, sh.y));
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so the library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Allows `bytes` of dynamic shared memory (above 48 KB once per kernel)
// and gives the blocks of `Threads` threads that fit on one SM; the last
// answer is kept, since one model calls each width at one or two sizes.
template <auto Kernel, int Threads = BTHREADS>
cudaError_t configure(int bytes, int* per_sm) {
  if (bytes > 227 * 1024) return cudaErrorInvalidValue;
  static int allowed = 48 * 1024, last_bytes = -1, last_per_sm = 0;
  if (bytes > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    if (e != cudaSuccess) return e;
    allowed = 227 * 1024;
  }
  if (bytes != last_bytes) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &last_per_sm, Kernel, Threads, bytes);
    if (e != cudaSuccess) return e;
    if (last_per_sm < 1) return cudaErrorInvalidConfiguration;
    last_bytes = bytes;
  }
  *per_sm = last_per_sm;
  return cudaSuccess;
}

// SMs of the current device, asked once per device.
cudaError_t sm_count(int* sms) {
  static int dev_seen = -1, sms_seen = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && dev != dev_seen) {
    e = cudaDeviceGetAttribute(&sms_seen, cudaDevAttrMultiProcessorCount,
                               dev);
    if (e == cudaSuccess) dev_seen = dev;
  }
  *sms = sms_seen;
  return e;
}

// The input box as a TMA tensor map over NHWC x: images x hy x hx pixels
// of `inner` channels from channel c0 (given at each load), channels
// innermost (`inner` * esize bytes, a multiple of 16). A box start outside
// the image or past C is zero filled.
cudaError_t encode_box(CUtensorMap* map, CUtensorMapDataType type, int esize,
                       const void* x, int B, int H, int W, int C, int inner,
                       const Plan& pl) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * esize,
                                 (cuuint64_t)W * C * esize,
                                 (cuuint64_t)H * W * C * esize};
  const cuuint32_t boxdim[4] = {(cuuint32_t)inner, (cuuint32_t)pl.hx,
                                (cuuint32_t)pl.hy, (cuuint32_t)pl.images};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  if (encode(map, type, 4, const_cast<void*>(x), dims, strides, boxdim, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// Persistent grid: as many blocks as fit on the card at once (at most one
// a tile), each walking the tiles t = blockIdx.x, + gridDim.x, ...
template <auto Kernel, int Threads = BTHREADS>
cudaError_t persistent_grid(int bytes, int n_tiles, int* grid) {
  int sms = 0, per_sm = 0;
  cudaError_t e = configure<Kernel, Threads>(bytes, &per_sm);
  if (e == cudaSuccess) e = sm_count(&sms);
  *grid = n_tiles < sms * per_sm ? n_tiles : sms * per_sm;
  return e;
}

template <int NH, int QM>
cudaError_t launch_bf16(const void* x, const float* dw_w, const float* dw_b,
                        const void* fuse_op, const float* fuse_b,
                        const float* scale, const float* shift, void* out,
                        int B, int H, int W, int C, int ostride,
                        const Plan& pl, int n_tiles, const Qdq& qd,
                        cudaStream_t stream) {
  CUtensorMap map;
  cudaError_t e = encode_box(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, B,
                             H, W, C, C, pl);
  const int bytes =
      Smem(C, 2 * NH, pl.images * pl.hy * pl.hx * C * 2).total + 128;
  int grid = 0;
  if (e == cudaSuccess)
    e = persistent_grid<acff_bf16_kernel<NH, QM>>(bytes, n_tiles, &grid);
  if (e != cudaSuccess) return e;
  acff_bf16_kernel<NH, QM><<<grid, BTHREADS, bytes, stream>>>(
      map, dw_w, dw_b, static_cast<const __nv_bfloat16*>(fuse_op), fuse_b,
      scale, shift, static_cast<__nv_bfloat16*>(out), B, H, W, C, ostride,
      pl, n_tiles, qd);
  return cudaGetLastError();
}

int bf16_wide_smem(int O, const Plan& pl) {
  return WSmem(O, pl.images * pl.hy * pl.hx * WKC * 2).total + 128;
}

template <int NH, int QM>
cudaError_t launch_bf16_wide(const void* x, const float* dw_w,
                             const float* dw_b, const void* fuse_op,
                             const float* fuse_b, const float* scale,
                             const float* shift, void* out, int B, int H,
                             int W, int C, int ostride, const Plan& pl,
                             int n_tiles, const Qdq& qd, cudaStream_t stream) {
  CUtensorMap map;
  cudaError_t e = encode_box(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, B,
                             H, W, C, WKC, pl);
  const int bytes = bf16_wide_smem(2 * NH, pl);
  int grid = 0;
  if (e == cudaSuccess)
    e = persistent_grid<acff_bf16_wide_kernel<NH, QM>,
                        wide_threads(2 * NH, QM)>(bytes, n_tiles, &grid);
  if (e != cudaSuccess) return e;
  acff_bf16_wide_kernel<NH, QM>
      <<<grid, wide_threads(2 * NH, QM), bytes, stream>>>(
      map, dw_w, dw_b, static_cast<const __nv_bfloat16*>(fuse_op), fuse_b,
      scale, shift, static_cast<__nv_bfloat16*>(out), B, H, W, C, ostride,
      pl, n_tiles, qd);
  return cudaGetLastError();
}

// The fp32 kernel's channel chunk: 16 where C is a multiple of 16, else 8
// (ops/acff.py::fp32_chunk, which packs B for it).
int fp32_chunk(int C) { return C % 16 ? 8 : 16; }

int fp32_smem(int C, int O, const Plan& pl) {
  const int KC = fp32_chunk(C);
  return FSmem(KC, O, pl.images * pl.hy * pl.hx * KC * 4).total + 128;
}

template <int NH>
cudaError_t launch_fp32(const void* x, const float* dw_w, const float* dw_b,
                        const void* fuse_op, const float* fuse_b,
                        const float* scale, const float* shift, void* out,
                        int B, int H, int W, int C, int ostride,
                        const Plan& pl, int n_tiles, cudaStream_t stream) {
  const int KC = fp32_chunk(C);
  CUtensorMap map;
  cudaError_t e = encode_box(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, x, B,
                             H, W, C, KC, pl);
  const int bytes = fp32_smem(C, 2 * NH, pl);
  int grid = 0;
  if (e == cudaSuccess)
    e = persistent_grid<acff_fp32_kernel<NH>>(bytes, n_tiles, &grid);
  if (e != cudaSuccess) return e;
  acff_fp32_kernel<NH><<<grid, BTHREADS, bytes, stream>>>(
      map, dw_w, dw_b, static_cast<const float*>(fuse_op), fuse_b, scale,
      shift, static_cast<float*>(out), B, H, W, C, KC, ostride, pl, n_tiles);
  return cudaGetLastError();
}

// f(std::integral_constant<int, O/2>) for the widths the kernels have: O =
// 64, 96, 128 and 256.
template <class F>
cudaError_t by_width(int O, F&& f) {
  switch (O) {
    case 64: return f(std::integral_constant<int, 32>{});
    case 96: return f(std::integral_constant<int, 48>{});
    case 128: return f(std::integral_constant<int, 64>{});
    case 256: return f(std::integral_constant<int, 128>{});
    default: return cudaErrorInvalidValue;
  }
}

// f(std::integral_constant<int, qm>) for the bf16 kernel's variants (QMode).
template <class F>
cudaError_t by_qmode(int qm, F&& f) {
  switch (qm) {
    case QNONE: return f(std::integral_constant<int, QNONE>{});
    case QSHARED: return f(std::integral_constant<int, QSHARED>{});
    case QBRANCH: return f(std::integral_constant<int, QBRANCH>{});
    default: return cudaErrorInvalidValue;
  }
}

// configure<Kernel, Threads> for `bytes` of dynamic shared memory, and the
// kernel's registers a thread.
template <auto Kernel, int Threads = BTHREADS>
cudaError_t footprint(int bytes, int* per_sm, int* regs) {
  cudaFuncAttributes attr;
  cudaError_t e = configure<Kernel, Threads>(bytes, per_sm);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, Kernel);
  if (e == cudaSuccess) *regs = attr.numRegs;
  return e;
}

}  // namespace

// Plain C interface, loaded with ctypes. Launches on `stream`, allocates
// nothing, does not synchronise; returns a CUDA error code (0 on success).
// mode (ops/acff.py::MODES): 0 fp32 x, 1 bf16 x, and bf16 x in int8 QDQ
// mode with the activation scales s_x1, s_x2, s_x3 (depthwise inputs) and
// s_f (fuse input), finite and > 0: 2 with the box QDQ'd once (s_x1 ==
// s_x2 == s_x3, else cudaErrorInvalidValue), 3 QDQ'd per branch (any
// scales); 4, 5 and 6 are modes 1, 2 and 3 in the wide-C variant. The
// scales are not read in modes 0, 1 and 4.
// fuse_op is fuse_w packed for the kernel of the mode
// (ops/acff.py::pack_fuse_operand for bf16, pack_fuse_operand_wide for the
// wide variant, pack_fuse_operand_tf32 for fp32); th .. n_tiles are the
// tile plan (ops/acff.py::tile_plan; wide_tile_plan in modes 4-6). Output
// pixel p's O values go to out[p * ostride ..] (ostride >= O, a multiple
// of 8), so that launches of slices of O write their columns of one
// output.
// Sizes: the TMA tensor map takes any B, H and W (its dimensions go to
// 2^32; the boxes stay 14x14, 22x15 or 14x15, or a whole image of at most
// 10x10), and the tile count is an int.
extern "C" int acff_infer_launch(const void* x, const float* dw_w,
                                 const float* dw_b, const void* fuse_op,
                                 const float* fuse_b, const float* scale,
                                 const float* shift, void* out, int B, int H,
                                 int W, int C, int O, int mode, int ostride,
                                 int th, int tw, int images, int tiles_h,
                                 int tiles_w, int hy, int hx, int origin,
                                 int n_tiles, float s_x1, float s_x2,
                                 float s_x3, float s_f, void* stream) {
  const Plan pl{th, tw, images, tiles_h, tiles_w, hy, hx, origin};
  const long long per_batch = (B + images - 1) / (images > 0 ? images : 1);
  const bool wide = mode >= 4;
  // The two tile shapes of tile_plan: 8x8 spatial tiles with a 14x14 box
  // from (oy0-2, ox0-2), or whole th x tw images with the image as the box;
  // in the wide variant those of wide_tile_plan: wth x 8 tiles (wth = M /
  // 8) with a (wth + 6) x 15 box, or whole images in its M rows, their box
  // no larger.
  const int wth = wide_rows(O) / WTW;
  const bool spatial =
      wide ? origin == 2 && th == wth && tw == WTW && images == 1 &&
                 hy == wth + 6 && hx == WHX
           : origin == 2 && th == 8 && tw == 8 && images == 1 && hy == 14 &&
                 hx == 14;
  const bool whole = origin == 0 && tiles_h == 1 && tiles_w == 1 &&
                     th == H - 2 && tw == W - 2 && hy == H && hx == W &&
                     th * tw * images <= (wide ? wide_rows(O) : BM) &&
                     (!wide || images * hy * hx <= (wth + 6) * WHX);
  if (B < 1 || H < 3 || W < 3 || C < 1 || fuse_op == nullptr ||
      images < 1 || !(spatial || whole) || ostride < O || ostride % 8 ||
      (long long)n_tiles != per_batch * tiles_h * tiles_w)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode < 0 || mode > 6) return static_cast<int>(cudaErrorInvalidValue);
  if (mode == 0) {
    if (C % 4) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(by_width(O, [&](auto nh) {
      return launch_fp32<decltype(nh)::value>(x, dw_w, dw_b, fuse_op, fuse_b,
                                              scale, shift, out, B, H, W, C,
                                              ostride, pl, n_tiles, s);
    }));
  }
  const int qm = (wide ? mode - 3 : mode) - 1;
  // a TMA box row holds at most 256 elements: the whole C, or WKC
  if (C % 8 || (!wide && C > 256)) return static_cast<int>(cudaErrorInvalidValue);
  Qdq qd{{s_x1, s_x2, s_x3, s_f}, {}};
  for (int i = 0; i < 4 && qm >= 1; ++i) {
    const float v = qd.s[i];
    if (!(v > 0.f && v <= 3.4e38f)) return static_cast<int>(cudaErrorInvalidValue);
    qd.inv[i] = 1.0f / v;   // IEEE division on the host: the fp32 reciprocal
  }
  if (qm == QSHARED && !(s_x1 == s_x2 && s_x2 == s_x3))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(by_width(O, [&](auto nh) {
    constexpr int NH = decltype(nh)::value;
    return by_qmode(qm, [&](auto q) {
      constexpr int QM = decltype(q)::value;
      return wide ? launch_bf16_wide<NH, QM>(x, dw_w, dw_b, fuse_op, fuse_b,
                                             scale, shift, out, B, H, W, C,
                                             ostride, pl, n_tiles, qd, s)
                  : launch_bf16<NH, QM>(x, dw_w, dw_b, fuse_op, fuse_b, scale,
                                        shift, out, B, H, W, C, ostride, pl,
                                        n_tiles, qd, s);
    });
  }));
}

// The wide-C variant's dynamic shared memory for O and the tile plan's box
// (images x hy x hx pixels), how many of its blocks fit on one SM and its
// registers a thread, in the variant of `mode` (4, 5 or 6, as
// acff_infer_launch takes it).
extern "C" int acff_bf16_wide_footprint(int O, int images, int hy, int hx,
                                        int mode, int* smem_bytes,
                                        int* blocks_per_sm, int* regs) {
  const Plan pl{0, 0, images, 0, 0, hy, hx, 0};
  return static_cast<int>(by_width(O, [&](auto nh) {
    constexpr int NH = decltype(nh)::value;
    *smem_bytes = bf16_wide_smem(2 * NH, pl);
    return by_qmode(mode - 4, [&](auto qm) {
      constexpr int QM = decltype(qm)::value;
      return footprint<acff_bf16_wide_kernel<NH, QM>,
                       wide_threads(2 * NH, QM)>(*smem_bytes, blocks_per_sm,
                                                 regs);
    });
  }));
}

// The bf16 kernel's dynamic shared memory for C, O and an input box of
// box_bytes, how many of its blocks fit on one SM and its registers a
// thread, in the variant of `mode` (1 bf16, 2 and 3 the int8 QDQ ones, as
// acff_infer_launch takes it).
extern "C" int acff_bf16_footprint(int C, int O, int box_bytes, int mode,
                                   int* smem_bytes, int* blocks_per_sm,
                                   int* regs) {
  return static_cast<int>(by_width(O, [&](auto nh) {
    constexpr int NH = decltype(nh)::value;
    *smem_bytes = Smem(C, 2 * NH, box_bytes).total + 128;
    return by_qmode(mode - 1, [&](auto qm) {
      return footprint<acff_bf16_kernel<NH, decltype(qm)::value>>(
          *smem_bytes, blocks_per_sm, regs);
    });
  }));
}

// The fp32 kernel's dynamic shared memory for C, O and the tile plan's box
// (images x hy x hx pixels), how many of its blocks fit on one SM and its
// registers a thread.
extern "C" int acff_fp32_footprint(int C, int O, int images, int hy, int hx,
                                   int* smem_bytes, int* blocks_per_sm,
                                   int* regs) {
  const Plan pl{0, 0, images, 0, 0, hy, hx, 0};
  return static_cast<int>(by_width(O, [&](auto nh) {
    constexpr int NH = decltype(nh)::value;
    *smem_bytes = fp32_smem(C, 2 * NH, pl);
    return footprint<acff_fp32_kernel<NH>>(*smem_bytes, blocks_per_sm, regs);
  }));
}

extern "C" const char* acff_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
