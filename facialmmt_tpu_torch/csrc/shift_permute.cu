// Shifted-window permutation in window layout: out = x[:, perm] (or x[:, inv]
// for the inverse), perm / inv from ops/swin.py::shifted_window_perms(h, w,
// ws, shift).  x (B, H*W, C) of any dtype, rows of C elements in window
// layout (window-major, ws x ws rows a window, raster inside a window).  The
// copy is of bytes, so every dtype comes back bit for bit.
//
// Replaces: facialmmt_tpu/ops/pallas/shift_permute.py::shift_permute.
//
// The mapping (window grid nw_h x nw_w, s = shift; forward = the cyclic shift
// before attention, rolled(i, j) = orig(i + s, j + s)):
//
//   target (wi, wj, r, c) <- source ((wi + da + (r + s) / ws) % nw_h,
//                                    (wj + da + (c + s) / ws) % nw_w,
//                                    (r + s) % ws, (c + s) % ws)
//
// with da = 0; the inverse is the same template with s' = ws - s and both
// window offsets da = -1 (taken as nw - 1).  Every target window is built
// from slices of the four windows of its 2x2 neighbourhood in the same image.
//
// What bounds it on the H100: pure data movement, 2 * B*H*W*C*itemsize bytes
// (each element read once and written once), no arithmetic.  The design:
// one block per target window; its threads walk the window's rows as a flat
// run of 16-byte chunks (or the widest chunk that divides the row and both
// base addresses), so neighbouring threads move neighbouring bytes of one row
// and a warp covers several rows.  The source row of a chunk is computed from
// the template above with a few integer operations; nothing is staged in
// shared memory, since no element is read twice.
#include "common.cuh"

#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
shift_permute_kernel(const T* __restrict__ x, T* __restrict__ out,
                     int nw_h, int nw_w, int ws, int s, int da_r, int da_c,
                     int row_chunks) {
  const int win = blockIdx.x;                  // global target window
  const int nwin = nw_h * nw_w;
  const int b = win / nwin;
  const int t = win % nwin;
  const int wi = t / nw_w;
  const int wj = t % nw_w;
  const int rows = ws * ws;
  const size_t image = (size_t)b * nwin;
  T* dst = out + (size_t)win * rows * row_chunks;
  for (int e = threadIdx.x; e < rows * row_chunks; e += kThreads) {
    const int row = e / row_chunks;
    const int k = e % row_chunks;
    const int r = row / ws;
    const int c = row % ws;
    const int sr = r + s;
    const int sc = c + s;
    const int src_wi = (wi + da_r + sr / ws) % nw_h;
    const int src_wj = (wj + da_c + sc / ws) % nw_w;
    const size_t src_row =
        (image + (size_t)src_wi * nw_w + src_wj) * rows + (sr % ws) * ws +
        sc % ws;
    dst[e] = x[src_row * row_chunks + k];
  }
}

template <typename T>
int launch(const void* x, void* out, int B, int nw_h, int nw_w, int ws, int s,
           int da_r, int da_c, int row_bytes, void* stream) {
  shift_permute_kernel<T><<<B * nw_h * nw_w, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<T*>(out), nw_h, nw_w, ws, s, da_r,
      da_c, row_bytes / (int)sizeof(T));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x / out: B images of (h/ws * w/ws) windows of ws*ws rows of row_bytes
// bytes.  inverse != 0 applies the inverse permutation.  Requires
// 0 < shift < ws, h and w multiples of ws with at least two windows each way
// (shift_permute_ok); returns cudaErrorInvalidValue otherwise.
FMMT_API int fmmt_shift_permute(const void* x, void* out, int B, int h, int w,
                                int ws, int shift, int inverse, int row_bytes,
                                void* stream) {
  if (!(0 < shift && shift < ws) || h % ws != 0 || w % ws != 0 ||
      h / ws < 2 || w / ws < 2 || B <= 0 || row_bytes <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nw_h = h / ws;
  const int nw_w = w / ws;
  const int s = inverse ? ws - shift : shift;
  const int da_r = inverse ? nw_h - 1 : 0;
  const int da_c = inverse ? nw_w - 1 : 0;
  // the widest chunk that divides the row and both base addresses
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) |
                          reinterpret_cast<uintptr_t>(out) |
                          static_cast<uintptr_t>(row_bytes);
  if (align % 16 == 0)
    return launch<uint4>(x, out, B, nw_h, nw_w, ws, s, da_r, da_c, row_bytes,
                         stream);
  if (align % 8 == 0)
    return launch<uint64_t>(x, out, B, nw_h, nw_w, ws, s, da_r, da_c,
                            row_bytes, stream);
  if (align % 4 == 0)
    return launch<uint32_t>(x, out, B, nw_h, nw_w, ws, s, da_r, da_c,
                            row_bytes, stream);
  if (align % 2 == 0)
    return launch<uint16_t>(x, out, B, nw_h, nw_w, ws, s, da_r, da_c,
                            row_bytes, stream);
  return launch<uint8_t>(x, out, B, nw_h, nw_w, ws, s, da_r, da_c, row_bytes,
                         stream);
}
