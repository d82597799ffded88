// Fused ACFF inference block for Hopper (sm_90a), CUDA C++.
//
// Replaces rtdm_tpu/ops/acff_pallas.py::_acff_kernel (launched by
// fused_acff_infer). Same function: three 3x3 depthwise convs at dilation
// 1/2/3 with padding 0/1/2 (each with a bias) over an NHWC batch, their
// concat to 3C channels, the 1x1 fuse as a (P,3C)x(3C,O) product plus bias,
// LeakyReLU(0.01), then the folded inference BN out*scale+shift.
// x: (B,H,W,C) fp32 or bf16; out: (B,H-2,W-2,O) in x's dtype; dw_w, dw_b,
// fuse_b, scale, shift fp32. One C entry point dispatches on x's dtype to
// one of two kernels.
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
//
// fp32 kernel (acff_fp32_kernel), the first design, kept because the fp32
// engine must stay full fp32 (no TF32): a block owns an 8x8 tile and a
// slice of OT output channels and walks the input channels in chunks of
// KC, staging the chunk's halo, computing its 3*KC features into shared
// memory and accumulating their product with fuse_w on fp32 FMAs.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

// ------------------------------------------------------------- fp32 kernel

constexpr int TH = 8;                // output tile rows
constexpr int TW = 8;                // output tile columns
constexpr int TP = TH * TW;          // output pixels per block
constexpr int HH = TH + 6;           // halo rows: branch 3 reaches 2 up, 4 down
constexpr int HW = TW + 6;           // halo columns
constexpr int PLANE = HH * HW + 1;   // odd stride: channel planes on distinct banks
constexpr int KC = 16;               // input channels per chunk
constexpr int KF = 3 * KC;           // features per chunk (three branches)
constexpr int THREADS = 256;         // 16 pixel groups x 16 channel groups

template <int OT>
__global__ void __launch_bounds__(THREADS)
acff_fp32_kernel(const float* __restrict__ x, const float* __restrict__ dw_w,
                 const float* __restrict__ dw_b,
                 const float* __restrict__ fuse_w,
                 const float* __restrict__ fuse_b,
                 const float* __restrict__ scale,
                 const float* __restrict__ shift, float* __restrict__ out,
                 int H, int W, int C, int O, int tiles_w) {
  constexpr int CPT = OT / 16;  // output channels per thread
  __shared__ float xs[KC * PLANE];               // [channel][halo pixel]
  __shared__ __align__(16) float feat[KF * TP];  // [feature][pixel]
  __shared__ __align__(16) float ws[KF * OT];    // [feature][output channel]

  const int OH = H - 2, OW = W - 2;
  const int oy0 = (blockIdx.x / tiles_w) * TH;
  const int ox0 = (blockIdx.x % tiles_w) * TW;
  const int o0 = blockIdx.y * OT;
  const int t = threadIdx.x;
  const int pg = t / 16;  // pixels pg*4 .. pg*4+3 of the tile
  const int cg = t % 16;  // channels o0 + cg*CPT .. + CPT-1

  const float* xb = x + (size_t)blockIdx.z * H * W * C;
  float acc[4][CPT];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[q][j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += KC) {
    // Halo of this channel chunk; the tile's input origin is (oy0-2, ox0-2).
    for (int i = t; i < HH * HW * KC; i += THREADS) {
      const int cl = i % KC, pix = i / KC;
      const int iy = oy0 - 2 + pix / HW, ix = ox0 - 2 + pix % HW;
      const int c = c0 + cl;
      float v = 0.f;
      if (iy >= 0 && iy < H && ix >= 0 && ix < W && c < C)
        v = __ldg(xb + ((size_t)iy * W + ix) * C + c);
      xs[cl * PLANE + pix] = v;
    }
    // fuse_w rows of this chunk: feature d*KC + cl is concat row d*C + c.
    for (int i = t; i < KF * OT; i += THREADS) {
      const int o = i % OT, k = i / OT;
      const int c = c0 + k % KC;
      ws[i] = (c < C && o0 + o < O)
                  ? __ldg(fuse_w + (size_t)((k / KC) * C + c) * O + o0 + o)
                  : 0.f;
    }
    __syncthreads();

    // Depthwise features: branch d has dilation d+1 and padding d, so output
    // pixel (py, px) reads halo row py + 2 - d + kh*(d+1), likewise columns.
    for (int i = t; i < KF * TP; i += THREADS) {
      const int p = i % TP, k = i / TP;
      const int d = k / KC, cl = k % KC, c = c0 + cl;
      float v = 0.f;
      if (c < C) {
        const int dil = d + 1;
        const int ly = p / TW + 2 - d, lx = p % TW + 2 - d;
        const float* plane = xs + cl * PLANE;
        const float* wk = dw_w + (size_t)d * 9 * C + c;  // dw_w[d][kh][kw][c]
        v = __ldg(dw_b + d * C + c);
#pragma unroll
        for (int kh = 0; kh < 3; ++kh)
#pragma unroll
          for (int kw = 0; kw < 3; ++kw)
            v = fmaf(plane[(ly + kh * dil) * HW + lx + kw * dil],
                     __ldg(wk + (kh * 3 + kw) * C), v);
      }
      feat[k * TP + p] = v;
    }
    __syncthreads();

    // acc[pixel][channel] += feat[pixel][k] * ws[k][channel]
#pragma unroll 4
    for (int k = 0; k < KF; ++k) {
      const float4 f = *reinterpret_cast<const float4*>(feat + k * TP + pg * 4);
      float wv[CPT];
      if constexpr (CPT == 4) {
        const float4 w4 =
            *reinterpret_cast<const float4*>(ws + k * OT + cg * 4);
        wv[0] = w4.x; wv[1] = w4.y; wv[2] = w4.z; wv[3] = w4.w;
      } else {
        const float2 w2 =
            *reinterpret_cast<const float2*>(ws + k * OT + cg * 2);
        wv[0] = w2.x; wv[1] = w2.y;
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        acc[0][j] = fmaf(f.x, wv[j], acc[0][j]);
        acc[1][j] = fmaf(f.y, wv[j], acc[1][j]);
        acc[2][j] = fmaf(f.z, wv[j], acc[2][j]);
        acc[3][j] = fmaf(f.w, wv[j], acc[3][j]);
      }
    }
    __syncthreads();
  }

  // Epilogue: bias, LeakyReLU(0.01), folded BN; ragged tile edges masked.
  float* ob = out + (size_t)blockIdx.z * OH * OW * O;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int p = pg * 4 + q;
    const int oy = oy0 + p / TW, ox = ox0 + p % TW;
    if (oy >= OH || ox >= OW) continue;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int o = o0 + cg * CPT + j;
      if (o >= O) continue;
      float v = acc[q][j] + __ldg(fuse_b + o);
      v = v > 0.f ? v : 0.01f * v;
      ob[((size_t)oy * OW + ox) * O + o] = fmaf(v, __ldg(scale + o),
                                                __ldg(shift + o));
    }
  }
}

template <int OT>
void launch_fp32(const float* x, const float* dw_w, const float* dw_b,
                 const float* fuse_w, const float* fuse_b, const float* scale,
                 const float* shift, float* out, int B, int H, int W, int C,
                 int O, cudaStream_t stream) {
  const int tiles_h = (H - 2 + TH - 1) / TH;
  const int tiles_w = (W - 2 + TW - 1) / TW;
  const dim3 grid(tiles_h * tiles_w, (O + OT - 1) / OT, B);
  acff_fp32_kernel<OT><<<grid, THREADS, 0, stream>>>(
      x, dw_w, dw_b, fuse_w, fuse_b, scale, shift, out, H, W, C, O, tiles_w);
}

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

// Depthwise branch D of a spatial tile (8x8 pixels, 14x14 box from
// (oy0-2, ox0-2)) for SEG pixels px0.. of tile row py and channels
// 4q..4q+3, into A. Dilation S = D+1: pixel px, tap (kh, kw) reads box row
// py+2-D+kh*S, column px+2-D+kw*S. The SEG+2S columns of a box row are
// loaded once each and feed every (px, kw) that reads them: SEG pixels x 4
// channels of fp32 sums in registers; at SEG = 8, 1.5 bytes of
// shared-memory loads per FMA.
template <int D, int SEG>
__device__ __forceinline__ void dw_row(const __nv_bfloat16* box,
                                       const float* wts, unsigned char* a_s,
                                       int C, int q, int py, int px0,
                                       int kp8) {
  constexpr int S = D + 1, NCOL = SEG + 2 * S, HX = 14;
  float acc[SEG][4];
  const float4 bias = *reinterpret_cast<const float4*>(wts + 27 * C + D * C +
                                                       q * 4);
#pragma unroll
  for (int px = 0; px < SEG; ++px) {
    acc[px][0] = bias.x; acc[px][1] = bias.y;
    acc[px][2] = bias.z; acc[px][3] = bias.w;
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
      const float2 lo = bf16x2_to_float2(v.x), hi = bf16x2_to_float2(v.y);
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
    *reinterpret_cast<uint2*>(dst + px * 16) =
        make_uint2(bf16x2(acc[px][0], acc[px][1]),
                   bf16x2(acc[px][2], acc[px][3]));
}

// Branch d of the spatial depthwise, its rows cut into 8/SEG segments.
template <int SEG>
__device__ __forceinline__ void dw_rows(const __nv_bfloat16* box,
                                        const float* wts, unsigned char* a_s,
                                        int C, int kp8, int tid) {
  constexpr int NSEG = 8 / SEG;
  const int C4 = C >> 2;
  for (int i = tid; i < 3 * 8 * NSEG * C4; i += BTHREADS) {
    const int q = i % C4, r = i / C4, seg = r % NSEG, py = (r / NSEG) & 7;
    const int d = r / (8 * NSEG), px0 = seg * SEG;
    if (d == 0) dw_row<0, SEG>(box, wts, a_s, C, q, py, px0, kp8);
    else if (d == 1) dw_row<1, SEG>(box, wts, a_s, C, q, py, px0, kp8);
    else dw_row<2, SEG>(box, wts, a_s, C, q, py, px0, kp8);
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

// Depthwise branch d of one pixel of a whole-image tile (the box is the
// image itself) for channels 8g..8g+7; taps outside the image are zero.
__device__ __forceinline__ uint4 dw_pixel(const __nv_bfloat16* box,
                                          const float* wts, const Plan& pl,
                                          int C, int img, int py, int px,
                                          int d, int g) {
  float acc[8];
  const float* bias = wts + 27 * C + d * C + g * 8;
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = bias[e];
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
      const float2 x0 = bf16x2_to_float2(v.x), x1 = bf16x2_to_float2(v.y);
      const float2 x2 = bf16x2_to_float2(v.z), x3 = bf16x2_to_float2(v.w);
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
  return make_uint4(bf16x2(acc[0], acc[1]), bf16x2(acc[2], acc[3]),
                    bf16x2(acc[4], acc[5]), bf16x2(acc[6], acc[7]));
}

// At O = 64 (the first, widest blocks: C = 8 or 16, the most tiles) four
// blocks share an SM; 64 registers a thread hold their 4- and 2-pixel
// depthwise segments without spills.
template <int NH>
__global__ void __launch_bounds__(BTHREADS, NH == 32 ? 4 : 1)
acff_bf16_kernel(const __grid_constant__ CUtensorMap xmap,
                 const float* __restrict__ dw_w, const float* __restrict__ dw_b,
                 const __nv_bfloat16* __restrict__ fuse_op,
                 const float* __restrict__ fuse_b,
                 const float* __restrict__ scale,
                 const float* __restrict__ shift,
                 __nv_bfloat16* __restrict__ out, int B, int H, int W, int C,
                 const Plan pl, int n_tiles) {
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

    if (pl.origin == 2) {
      // Spatial tile: one (branch, row segment, 4-channel group) an item;
      // shorter segments where C is small, so that most threads get one.
      if (C >= 48) dw_rows<8>(box, wts, a_s, C, kp8, tid);
      else if (C >= 16) dw_rows<4>(box, wts, a_s, C, kp8, tid);
      else dw_rows<2>(box, wts, a_s, C, kp8, tid);
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
            live ? dw_pixel(box, wts, pl, C, img, py, px, d, g)
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
        float v0 = acc[4 * n + 2 * i] + fb.x;
        float v1 = acc[4 * n + 2 * i + 1] + fb.y;
        v0 = v0 > 0.f ? v0 : 0.01f * v0;
        v1 = v1 > 0.f ? v1 : 0.01f * v1;
        *reinterpret_cast<uint32_t*>(buf + (row0 + 8 * i) * SROW + col * 2) =
            bf16x2(fmaf(v0, sc.x, sh.x), fmaf(v1, sc.y, sh.y));
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
          out + (((size_t)(b0 + img) * OH + oy0 + py) * OW + ox0 + px) * O +
          j * 8;
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
// and gives the blocks that fit on one SM; the last answer is kept, since
// one model calls each width at one or two sizes.
template <int NH>
cudaError_t configure(int bytes, int* per_sm) {
  if (bytes > 227 * 1024) return cudaErrorInvalidValue;
  static int allowed = 48 * 1024, last_bytes = -1, last_per_sm = 0;
  if (bytes > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        acff_bf16_kernel<NH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        227 * 1024);
    if (e != cudaSuccess) return e;
    allowed = 227 * 1024;
  }
  if (bytes != last_bytes) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &last_per_sm, acff_bf16_kernel<NH>, BTHREADS, bytes);
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

template <int NH>
cudaError_t launch_bf16(const void* x, const float* dw_w, const float* dw_b,
                        const void* fuse_op, const float* fuse_b,
                        const float* scale, const float* shift, void* out,
                        int B, int H, int W, int C, const Plan& pl,
                        int n_tiles, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  // The box: images x hy x hx pixels of C channels, C innermost (a row of
  // C*2 bytes, at least 16). A box start outside the image is zero filled.
  CUtensorMap map;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                 (cuuint64_t)H * W * C * 2};
  const cuuint32_t boxdim[4] = {(cuuint32_t)C, (cuuint32_t)pl.hx,
                                (cuuint32_t)pl.hy, (cuuint32_t)pl.images};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x),
             dims, strides, boxdim, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  const int bytes =
      Smem(C, 2 * NH, pl.images * pl.hy * pl.hx * C * 2).total + 128;
  int sms = 0, per_sm = 0;
  cudaError_t e = configure<NH>(bytes, &per_sm);
  if (e == cudaSuccess) e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  // Persistent: as many blocks as fit on the card at once, each walking
  // the tiles t = blockIdx.x, + gridDim.x, ...
  const int grid = n_tiles < sms * per_sm ? n_tiles : sms * per_sm;
  acff_bf16_kernel<NH><<<grid, BTHREADS, bytes, stream>>>(
      map, dw_w, dw_b, static_cast<const __nv_bfloat16*>(fuse_op), fuse_b,
      scale, shift, static_cast<__nv_bfloat16*>(out), B, H, W, C, pl,
      n_tiles);
  return cudaGetLastError();
}

// f(std::integral_constant<int, O/2>) for the widths the bf16 kernel has.
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

}  // namespace

// Plain C interface, loaded with ctypes. Launches on `stream`, allocates
// nothing, does not synchronise; returns a CUDA error code (0 on success).
// fp32 x reads fuse_w; bf16 x reads fuse_op (ops/acff.py::pack_fuse_operand)
// and the tile plan (th .. n_tiles, ops/acff.py::tile_plan), which fp32
// ignores.
extern "C" int acff_infer_launch(const void* x, const float* dw_w,
                                 const float* dw_b, const float* fuse_w,
                                 const void* fuse_op, const float* fuse_b,
                                 const float* scale, const float* shift,
                                 void* out, int B, int H, int W, int C, int O,
                                 int x_is_bf16, int th, int tw, int images,
                                 int tiles_h, int tiles_w, int hy, int hx,
                                 int origin, int n_tiles, void* stream) {
  if (B < 1 || B > 65535 || H < 3 || W < 3 || C < 1 || O < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!x_is_bf16) {
    const float* xf = static_cast<const float*>(x);
    float* of = static_cast<float*>(out);
    if (O % 64 == 0)
      launch_fp32<64>(xf, dw_w, dw_b, fuse_w, fuse_b, scale, shift, of, B, H,
                      W, C, O, s);
    else
      launch_fp32<32>(xf, dw_w, dw_b, fuse_w, fuse_b, scale, shift, of, B, H,
                      W, C, O, s);
    return static_cast<int>(cudaGetLastError());
  }
  const Plan pl{th, tw, images, tiles_h, tiles_w, hy, hx, origin};
  const int per_batch = (B + images - 1) / (images > 0 ? images : 1);
  // The two tile shapes of tile_plan: 8x8 spatial tiles with a 14x14 box
  // from (oy0-2, ox0-2), or whole th x tw images with the image as the box.
  const bool spatial = origin == 2 && th == 8 && tw == 8 && images == 1 &&
                       hy == 14 && hx == 14;
  const bool whole = origin == 0 && tiles_h == 1 && tiles_w == 1 &&
                     th == H - 2 && tw == W - 2 && hy == H && hx == W &&
                     th * tw * images <= BM;
  if (fuse_op == nullptr || C % 8 || C > 256 || H > 256 || W > 256 ||
      images < 1 || !(spatial || whole) ||
      n_tiles != per_batch * tiles_h * tiles_w)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(by_width(O, [&](auto nh) {
    return launch_bf16<decltype(nh)::value>(x, dw_w, dw_b, fuse_op, fuse_b,
                                            scale, shift, out, B, H, W, C, pl,
                                            n_tiles, s);
  }));
}

// The bf16 kernel's dynamic shared memory for C, O and an input box of
// box_bytes, and how many of its blocks fit on one SM.
extern "C" int acff_bf16_footprint(int C, int O, int box_bytes,
                                   int* smem_bytes, int* blocks_per_sm) {
  return static_cast<int>(by_width(O, [&](auto nh) {
    constexpr int NH = decltype(nh)::value;
    *smem_bytes = Smem(C, 2 * NH, box_bytes).total + 128;
    return configure<NH>(*smem_bytes, blocks_per_sm);
  }));
}

extern "C" const char* acff_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
