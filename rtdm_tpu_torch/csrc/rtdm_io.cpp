// rtdm_io — native image-decode + letterbox runtime for rtdm_tpu.
//
// The TPU-native counterpart of the reference's native runtime layer: where
// the reference spends C++/CUDA on the TensorRT plugin and buffer plumbing
// (tensorrt_inference/plugins/, common/), the TPU build's native budget goes
// where the host actually burns time — JPEG decode + resize + letterbox on
// the streaming/data path (the per-frame PIL round trip called out in
// real-time-inference.py's hot loop).
//
// Design:
//  - libjpeg with DCT-domain prescaling: decode directly at ~target size
//    (scale_num/8) instead of full-res + downsample — typically 3-6x less
//    decode work for aerial stills.
//  - fixed-point bilinear resize (16.16) to the exact target, then
//    letterbox-pad with gray 114 (data/odder.py letterbox semantics) or
//    stretch-resize (classifier eval path does its own crop).
//  - plain C ABI (ctypes-friendly), caller-owned output buffers, no Python
//    objects held during work so Python threads overlap fully.
//
// Build: see native/Makefile (g++ -O3 -fPIC -shared, links -ljpeg).

#include <cstddef>
#include <cstdio>
// jpeglib.h needs size_t/FILE declared first (it does not include them)
#include <jpeglib.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <csetjmp>
#include <cstdio>
#include <thread>
#include <vector>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* mgr = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(mgr->jump, 1);
}

// Bilinear resize RGB u8 (h,w) -> (oh,ow), 16.16 fixed point.
// Half-pixel-center coordinate mapping (src = (dst+0.5)*scale - 0.5), the
// cv2.INTER_LINEAR convention the reference's letterbox uses
// (yolov3/utils/datasets.py:599-630) — no antialiasing.
void resize_bilinear(const uint8_t* src, int h, int w, uint8_t* dst, int oh,
                     int ow) {
  if (h == oh && w == ow) {
    std::memcpy(dst, src, static_cast<size_t>(h) * w * 3);
    return;
  }
  const int64_t x_ratio = ((int64_t)w << 16) / ow;
  const int64_t y_ratio = ((int64_t)h << 16) / oh;
  for (int oy = 0; oy < oh; ++oy) {
    int64_t sy = ((2 * oy + 1) * y_ratio - (1 << 16)) / 2;
    if (sy < 0) sy = 0;
    int y0 = static_cast<int>(sy >> 16);
    if (y0 > h - 1) y0 = h - 1;
    const int y1 = std::min(y0 + 1, h - 1);
    const int fy = static_cast<int>(sy & 0xffff);
    const uint8_t* row0 = src + static_cast<size_t>(y0) * w * 3;
    const uint8_t* row1 = src + static_cast<size_t>(y1) * w * 3;
    uint8_t* out = dst + static_cast<size_t>(oy) * ow * 3;
    for (int ox = 0; ox < ow; ++ox) {
      int64_t sx = ((2 * ox + 1) * x_ratio - (1 << 16)) / 2;
      if (sx < 0) sx = 0;
      int x0 = static_cast<int>(sx >> 16);
      if (x0 > w - 1) x0 = w - 1;
      const int x1 = std::min(x0 + 1, w - 1);
      const int fx = static_cast<int>(sx & 0xffff);
      for (int c = 0; c < 3; ++c) {
        const int p00 = row0[x0 * 3 + c], p01 = row0[x1 * 3 + c];
        const int p10 = row1[x0 * 3 + c], p11 = row1[x1 * 3 + c];
        const int top = p00 + (((p01 - p00) * fx) >> 16);
        const int bot = p10 + (((p11 - p10) * fx) >> 16);
        out[ox * 3 + c] =
            static_cast<uint8_t>(top + (((bot - top) * fy) >> 16));
      }
    }
  }
}

}  // namespace

extern "C" {

// Decode a JPEG from memory, resize+letterbox into out (out_h*out_w*3,
// RGB) — rectangular targets supported (the rect-batch bucket shapes,
// yolov3/utils/datasets.py:285-316). gain_cap > 0 bounds the resize
// factor: buckets larger than the nominal image size (v5's +pad term,
// stride rounding) render the surplus as BORDER, not extra resolution
// (the reference's load_image-then-scaleup=False geometry,
// datasets.py:430-431,548); pass 0 for the unconstrained fit. Returns 0
// on success; fills gain (resize factor) and pad_w/pad_h. letterbox=0
// stretches to out_h x out_w instead (no padding; gain/pads are per-axis
// meaningless and set to 0; gain_cap ignored).
int rtdm_decode_jpeg_letterbox_rect(const uint8_t* data, long len,
                                    int out_h, int out_w, int letterbox,
                                    float gain_cap, uint8_t pad_value,
                                    uint8_t* out, float* gain,
                                    float* pad_w, float* pad_h,
                                    int* orig_h, int* orig_w) {
  jpeg_decompress_struct cinfo;
  ErrorMgr err;
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = error_exit;
  // Buffers are declared BEFORE setjmp: longjmp must not skip the
  // constructor/destructor of a live std::vector (UB + a leak of the
  // decode buffer on every corrupt JPEG); declared here, they unwind
  // normally when the handler returns.
  std::vector<uint8_t> decoded;
  std::vector<uint8_t> resized;
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  cinfo.out_color_space = JCS_RGB;
  *orig_h = static_cast<int>(cinfo.image_height);
  *orig_w = static_cast<int>(cinfo.image_width);

  // DCT prescale: decode at the smallest n/8 >= target coverage.
  // Letterbox: the CONSTRAINING axis (the one with the smaller
  // target/orig ratio) must reach its target; stretch mode resizes both
  // axes, so the axis with the LARGER required gain drives coverage —
  // undershooting it would upscale (blur).
  // Axis selection by cross-multiplication (exact in int64):
  // th/oh <= tw/ow  <=>  th*ow <= tw*oh.
  const int64_t h_cross = static_cast<int64_t>(out_h) * *orig_w;
  const int64_t w_cross = static_cast<int64_t>(out_w) * *orig_h;
  const bool height_binds = letterbox ? (h_cross <= w_cross)
                                      : (h_cross >= w_cross);
  const int big = height_binds ? *orig_h : *orig_w;
  const int target = height_binds ? out_h : out_w;
  const float g_fit = std::min(static_cast<float>(out_h) / *orig_h,
                               static_cast<float>(out_w) / *orig_w);
  const bool capped = letterbox && gain_cap > 0.f && gain_cap < g_fit;
  int num = 8;
  if (capped) {
    // coverage keyed on the capped gain (decode big*num/8 >= big*gain)
    while (num > 1 && static_cast<float>(num - 1) / 8.0f >= gain_cap)
      --num;
  } else {
    // exact integer formulation (bit-identical to the square-only path)
    while (num > 1 && (big * (num - 1)) / 8 >= target) --num;
  }
  cinfo.scale_num = num;
  cinfo.scale_denom = 8;

  jpeg_start_decompress(&cinfo);
  const int dh = static_cast<int>(cinfo.output_height);
  const int dw = static_cast<int>(cinfo.output_width);
  decoded.resize(static_cast<size_t>(dh) * dw * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = decoded.data() +
                   static_cast<size_t>(cinfo.output_scanline) * dw * 3;
    JSAMPROW rows[1] = {row};
    jpeg_read_scanlines(&cinfo, rows, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);

  if (!letterbox) {
    resize_bilinear(decoded.data(), dh, dw, out, out_h, out_w);
    *gain = 0.f;
    *pad_w = 0.f;
    *pad_h = 0.f;
    return 0;
  }
  // letterbox relative to the ORIGINAL image (odder.py semantics)
  const float g = capped ? gain_cap : g_fit;
  const int nw = std::max(static_cast<int>(*orig_w * g + 0.5f), 1);
  const int nh = std::max(static_cast<int>(*orig_h * g + 0.5f), 1);
  resized.resize(static_cast<size_t>(nh) * nw * 3);
  resize_bilinear(decoded.data(), dh, dw, resized.data(), nh, nw);
  std::memset(out, pad_value, static_cast<size_t>(out_h) * out_w * 3);
  const int pw = (out_w - nw) / 2;
  const int ph = (out_h - nh) / 2;
  for (int y = 0; y < nh; ++y) {
    std::memcpy(out + (static_cast<size_t>(y + ph) * out_w + pw) * 3,
                resized.data() + static_cast<size_t>(y) * nw * 3,
                static_cast<size_t>(nw) * 3);
  }
  *gain = g;
  *pad_w = static_cast<float>(pw);
  *pad_h = static_cast<float>(ph);
  return 0;
}

// Square-target compatibility entry (the original ABI).
int rtdm_decode_jpeg_letterbox(const uint8_t* data, long len, int size,
                               int letterbox, uint8_t pad_value,
                               uint8_t* out, float* gain, float* pad_w,
                               float* pad_h, int* orig_h, int* orig_w) {
  return rtdm_decode_jpeg_letterbox_rect(data, len, size, size, letterbox,
                                         0.f, pad_value, out, gain, pad_w,
                                         pad_h, orig_h, orig_w);
}

// Decode + letterbox a BATCH of JPEG files into one contiguous NHWC u8
// buffer using an internal std::thread pool — the data-loader hot path as
// ONE ctypes call (file read, decode, resize, letterbox all native; no
// Python-thread scheduling per image). Per-image status in rcs (0 = ok;
// nonzero slots are left pad_value-filled so the caller can fall back).
// nthreads <= 0 means hardware concurrency. Returns the failure count.
int rtdm_decode_batch(const char** paths, int n, int size, int letterbox,
                      uint8_t pad_value, uint8_t* out, float* gains,
                      float* pads_wh, int* orig_hw, int* rcs,
                      int nthreads) {
  if (n <= 0) return 0;
  int workers = nthreads > 0
                    ? nthreads
                    : static_cast<int>(std::thread::hardware_concurrency());
  workers = std::max(1, std::min(workers, n));
  std::atomic<int> next(0);
  std::atomic<int> failures(0);
  const size_t frame = static_cast<size_t>(size) * size * 3;

  auto work = [&]() {
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
      uint8_t* dst = out + static_cast<size_t>(i) * frame;
      rcs[i] = 10;  // file error until proven otherwise
      gains[i] = 0.f;
      pads_wh[2 * i] = pads_wh[2 * i + 1] = 0.f;
      orig_hw[2 * i] = orig_hw[2 * i + 1] = 0;
      FILE* f = std::fopen(paths[i], "rb");
      if (!f) {
        std::memset(dst, pad_value, frame);
        failures.fetch_add(1);
        continue;
      }
      std::fseek(f, 0, SEEK_END);
      const long len = std::ftell(f);
      std::fseek(f, 0, SEEK_SET);
      std::vector<uint8_t> buf(static_cast<size_t>(std::max(len, 0L)));
      const bool ok =
          len > 0 && std::fread(buf.data(), 1, static_cast<size_t>(len),
                                f) == static_cast<size_t>(len);
      std::fclose(f);
      if (!ok) {
        std::memset(dst, pad_value, frame);
        failures.fetch_add(1);
        continue;
      }
      rcs[i] = rtdm_decode_jpeg_letterbox(
          buf.data(), len, size, letterbox, pad_value, dst, &gains[i],
          &pads_wh[2 * i], &pads_wh[2 * i + 1], &orig_hw[2 * i],
          &orig_hw[2 * i + 1]);
      if (rcs[i] != 0) {
        std::memset(dst, pad_value, frame);
        failures.fetch_add(1);
      }
    }
  };

  if (workers == 1) {
    work();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(workers);
    for (int t = 0; t < workers; ++t) pool.emplace_back(work);
    for (auto& th : pool) th.join();
  }
  return failures.load();
}

// Resize+letterbox an already-decoded RGB u8 frame (for camera streams).
int rtdm_letterbox_rgb(const uint8_t* src, int h, int w, int size,
                       uint8_t pad_value, uint8_t* out, float* gain,
                       float* pad_w, float* pad_h) {
  const float g = std::min(static_cast<float>(size) / h,
                           static_cast<float>(size) / w);
  const int nw = std::max(static_cast<int>(w * g + 0.5f), 1);
  const int nh = std::max(static_cast<int>(h * g + 0.5f), 1);
  std::vector<uint8_t> resized(static_cast<size_t>(nh) * nw * 3);
  resize_bilinear(src, h, w, resized.data(), nh, nw);
  std::memset(out, pad_value, static_cast<size_t>(size) * size * 3);
  const int pw = (size - nw) / 2;
  const int ph = (size - nh) / 2;
  for (int y = 0; y < nh; ++y) {
    std::memcpy(out + (static_cast<size_t>(y + ph) * size + pw) * 3,
                resized.data() + static_cast<size_t>(y) * nw * 3,
                static_cast<size_t>(nw) * 3);
  }
  *gain = g;
  *pad_w = static_cast<float>(pw);
  *pad_h = static_cast<float>(ph);
  return 0;
}

}  // extern "C"
