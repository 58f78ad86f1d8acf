// Native face-sequence loader: multithreaded JPEG decode + resize.
//
// The host-side hot path of the framework is decoding thousands of face-crop
// JPEGs per training step (the reference does this one image at a time in
// Python DataLoader workers with cv2/PIL — reference utils/dataset.py:47-69).
// This library decodes and resizes a whole batch with a std::thread pool:
//
//   * decode: libjpeg, BGR channel order (cv2.imread parity — the released
//     checkpoints were trained on BGR-as-RGB, see data/meld.py);
//   * resize: area-average when shrinking (cv2 INTER_AREA), Catmull-Rom-style
//     bicubic with a=-0.75 when enlarging (cv2 INTER_CUBIC);
//   * one malloc-free output buffer provided by the caller (numpy array).
//
// C ABI for ctypes:
//   int decode_resize_batch(const char** paths, int n, int target,
//                           unsigned char* out /* n*target*target*3 */,
//                           int num_threads);
// returns number of successfully decoded images; failed slots are zeroed.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode a JPEG file into a BGR uint8 buffer.  Returns false on any failure.
bool decode_jpeg_bgr(const char* path, std::vector<unsigned char>* out,
                     int* width, int* height) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;

  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
#if defined(JCS_EXTENSIONS)
  // libjpeg-turbo: decode straight to BGR (cv2.imread parity) — skips the
  // per-pixel channel swap below entirely.  JCS_EXT_BGR itself is an ENUM
  // constant, not a macro, so `#ifdef JCS_EXT_BGR` is always false; the
  // feature-test macro libjpeg-turbo provides is JCS_EXTENSIONS
  // (jpeglib.h: "#define JCS_EXTENSIONS 1").
  cinfo.out_color_space = JCS_EXT_BGR;
#else
  cinfo.out_color_space = JCS_RGB;
#endif
  jpeg_start_decompress(&cinfo);

  const int w = cinfo.output_width;
  const int h = cinfo.output_height;
  const int stride = w * 3;
  out->resize(static_cast<size_t>(h) * stride);
#if defined(JCS_EXTENSIONS)
  for (int y = 0; y < h; ++y) {
    unsigned char* dst = out->data() + static_cast<size_t>(y) * stride;
    jpeg_read_scanlines(&cinfo, &dst, 1);
  }
#else
  std::vector<unsigned char> row(stride);
  unsigned char* rowptr = row.data();
  for (int y = 0; y < h; ++y) {
    jpeg_read_scanlines(&cinfo, &rowptr, 1);
    unsigned char* dst = out->data() + static_cast<size_t>(y) * stride;
    // RGB -> BGR (cv2.imread parity)
    for (int x = 0; x < w; ++x) {
      dst[x * 3 + 0] = row[x * 3 + 2];
      dst[x * 3 + 1] = row[x * 3 + 1];
      dst[x * 3 + 2] = row[x * 3 + 0];
    }
  }
#endif
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  *width = w;
  *height = h;
  return true;
}

inline unsigned char clamp_u8(float v) {
  return static_cast<unsigned char>(std::min(255.f, std::max(0.f, v + 0.5f)));
}

// cv2 INTER_AREA: box average over the source footprint of each dest pixel.
void resize_area(const unsigned char* src, int sw, int sh, unsigned char* dst,
                 int tw, int th) {
  const float sx = static_cast<float>(sw) / tw;
  const float sy = static_cast<float>(sh) / th;
  for (int y = 0; y < th; ++y) {
    const float fy0 = y * sy, fy1 = (y + 1) * sy;
    const int y0 = static_cast<int>(fy0);
    const int y1 = std::min(sh, static_cast<int>(std::ceil(fy1)));
    for (int x = 0; x < tw; ++x) {
      const float fx0 = x * sx, fx1 = (x + 1) * sx;
      const int x0 = static_cast<int>(fx0);
      const int x1 = std::min(sw, static_cast<int>(std::ceil(fx1)));
      for (int c = 0; c < 3; ++c) {
        float acc = 0.f, area = 0.f;
        for (int yy = y0; yy < y1; ++yy) {
          const float wy = std::min(fy1, static_cast<float>(yy + 1)) -
                           std::max(fy0, static_cast<float>(yy));
          for (int xx = x0; xx < x1; ++xx) {
            const float wx = std::min(fx1, static_cast<float>(xx + 1)) -
                             std::max(fx0, static_cast<float>(xx));
            acc += wy * wx * src[(static_cast<size_t>(yy) * sw + xx) * 3 + c];
            area += wy * wx;
          }
        }
        dst[(static_cast<size_t>(y) * tw + x) * 3 + c] =
            clamp_u8(area > 0 ? acc / area : 0.f);
      }
    }
  }
}

// Bicubic kernel, cv2's a = -0.75.
inline float cubic_w(float t) {
  const float a = -0.75f;
  t = std::fabs(t);
  if (t <= 1.f) return ((a + 2.f) * t - (a + 3.f)) * t * t + 1.f;
  if (t < 2.f) return (((t - 5.f) * t + 8.f) * t - 4.f) * a;
  return 0.f;
}

// Precomputed 4-tap table for one axis: clamped source indices + weights.
struct CubicTaps {
  std::vector<int> idx;     // 4 per output coord
  std::vector<float> wgt;   // 4 per output coord
};

CubicTaps cubic_taps(int src_n, int dst_n) {
  CubicTaps t;
  t.idx.resize(static_cast<size_t>(dst_n) * 4);
  t.wgt.resize(static_cast<size_t>(dst_n) * 4);
  const float s = static_cast<float>(src_n) / dst_n;
  for (int o = 0; o < dst_n; ++o) {
    const float f = (o + 0.5f) * s - 0.5f;
    const int i0 = static_cast<int>(std::floor(f));
    const float d = f - i0;
    for (int k = 0; k < 4; ++k) {
      t.idx[o * 4 + k] = std::min(src_n - 1, std::max(0, i0 + k - 1));
      t.wgt[o * 4 + k] = cubic_w(d - (k - 1));
    }
  }
  return t;
}

// Separable bicubic (same kernel as the old per-pixel form — identical math,
// float-rounding-level differences only): a horizontal pass into a float
// intermediate, then a vertical pass.  8 MACs/px instead of 16, contiguous
// access, no per-tap clamping in the inner loops — the compiler vectorizes
// it, which took the measured single-core rate from ~409 to the multi-
// thousand imgs/s range (see experiments/loader_bench.py / BASELINE.md).
// `tmp` is a caller-provided per-thread scratch of sh*tw*3 floats.
void resize_cubic(const unsigned char* src, int sw, int sh, unsigned char* dst,
                  int tw, int th, std::vector<float>* tmp) {
  const CubicTaps tx = cubic_taps(sw, tw);
  const CubicTaps ty = cubic_taps(sh, th);
  tmp->resize(static_cast<size_t>(sh) * tw * 3);
  float* mid = tmp->data();
  for (int y = 0; y < sh; ++y) {
    const unsigned char* srow = src + static_cast<size_t>(y) * sw * 3;
    float* mrow = mid + static_cast<size_t>(y) * tw * 3;
    for (int x = 0; x < tw; ++x) {
      const int* ix = &tx.idx[x * 4];
      const float* wx = &tx.wgt[x * 4];
      for (int c = 0; c < 3; ++c) {
        mrow[x * 3 + c] = wx[0] * srow[ix[0] * 3 + c] +
                          wx[1] * srow[ix[1] * 3 + c] +
                          wx[2] * srow[ix[2] * 3 + c] +
                          wx[3] * srow[ix[3] * 3 + c];
      }
    }
  }
  const int row_elems = tw * 3;
  for (int y = 0; y < th; ++y) {
    const int* iy = &ty.idx[y * 4];
    const float* wy = &ty.wgt[y * 4];
    const float* r0 = mid + static_cast<size_t>(iy[0]) * row_elems;
    const float* r1 = mid + static_cast<size_t>(iy[1]) * row_elems;
    const float* r2 = mid + static_cast<size_t>(iy[2]) * row_elems;
    const float* r3 = mid + static_cast<size_t>(iy[3]) * row_elems;
    unsigned char* drow = dst + static_cast<size_t>(y) * row_elems;
    for (int e = 0; e < row_elems; ++e) {
      drow[e] = clamp_u8(wy[0] * r0[e] + wy[1] * r1[e] + wy[2] * r2[e] +
                         wy[3] * r3[e]);
    }
  }
}

}  // namespace

extern "C" {

int decode_resize_batch(const char** paths, int n, int target,
                        unsigned char* out, int num_threads) {
  if (num_threads <= 0) {
    num_threads = std::max(1u, std::thread::hardware_concurrency());
  }
  num_threads = std::min(num_threads, n > 0 ? n : 1);
  std::atomic<int> next(0), ok(0);
  const size_t img_bytes = static_cast<size_t>(target) * target * 3;

  auto worker = [&]() {
    std::vector<unsigned char> buf;
    std::vector<float> scratch;
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      unsigned char* dst = out + i * img_bytes;
      int w = 0, h = 0;
      if (!paths[i] || !decode_jpeg_bgr(paths[i], &buf, &w, &h)) {
        std::memset(dst, 0, img_bytes);
        continue;
      }
      if (w == target && h == target) {
        std::memcpy(dst, buf.data(), img_bytes);
      } else if (w >= target && h >= target) {
        resize_area(buf.data(), w, h, dst, target, target);
      } else {
        resize_cubic(buf.data(), w, h, dst, target, target, &scratch);
      }
      ok.fetch_add(1);
    }
  };

  std::vector<std::thread> threads;
  threads.reserve(num_threads);
  for (int t = 0; t < num_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return ok.load();
}

}  // extern "C"
