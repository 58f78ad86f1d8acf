// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel library entry point has a plain C signature (pointers and the
// stream as void*, sizes as int) so Python binds it with ctypes, and returns
// cudaGetLastError() right after the launch: a refused launch (too many
// threads, too much shared memory) never runs, and a later synchronize would
// not report it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define FMMT_API extern "C" __attribute__((visibility("default")))

namespace fmmt {

__device__ __forceinline__ float bf(const __nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Round an fp32 value through bf16, as the JAX kernels' .astype(bf16) does.
__device__ __forceinline__ float round_bf16(const float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Dot product of two bf16 rows of even length n, fp32 accumulation.  Both
// pointers must be 4-byte aligned (even element offsets).
__device__ __forceinline__ float dot_bf16(const __nv_bfloat16* a,
                                          const __nv_bfloat16* b, int n) {
  const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(a);
  const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(b);
  float acc = 0.f;
  for (int i = 0; i < n / 2; ++i) {
    const float2 x = __bfloat1622float2(a2[i]);
    const float2 y = __bfloat1622float2(b2[i]);
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
  }
  return acc;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// LayerNorm of one row of c bf16 values by one warp: fp32 statistics
// (two-pass mean / biased variance), affine, result rounded to bf16 into dst.
// The row's mean and reciprocal standard deviation come back through
// mean / rstd (every lane holds them): the backward kernels keep them.
__device__ __forceinline__ void warp_layernorm_row_stats(
    const __nv_bfloat16* __restrict__ src, const __nv_bfloat16* __restrict__ g,
    const __nv_bfloat16* __restrict__ b, __nv_bfloat16* dst, int c, float eps,
    int lane, float& mean, float& rstd) {
  float s = 0.f;
  for (int i = lane; i < c; i += 32) s += bf(src[i]);
  mean = warp_sum(s) / c;
  float q = 0.f;
  for (int i = lane; i < c; i += 32) {
    const float d = bf(src[i]) - mean;
    q = fmaf(d, d, q);
  }
  rstd = rsqrtf(warp_sum(q) / c + eps);
  for (int i = lane; i < c; i += 32)
    dst[i] = __float2bfloat16((bf(src[i]) - mean) * rstd * bf(g[i]) + bf(b[i]));
}

__device__ __forceinline__ void warp_layernorm_row(
    const __nv_bfloat16* __restrict__ src, const __nv_bfloat16* __restrict__ g,
    const __nv_bfloat16* __restrict__ b, __nv_bfloat16* dst, int c, float eps,
    int lane) {
  float mean, rstd;
  warp_layernorm_row_stats(src, g, b, dst, c, eps, lane, mean, rstd);
}

// Add four consecutive fp32 values to 16-byte aligned device memory.  On
// sm_90 with CUDA >= 12.1 this is one vector reduction; elsewhere four scalar
// ones.  Sums formed with atomics are not bit-reproducible run to run.
__device__ __forceinline__ void atomic_add4(float* addr, const float* v) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900 && \
    (__CUDACC_VER_MAJOR__ > 12 ||                      \
     (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 1))
  atomicAdd(reinterpret_cast<float4*>(addr),
            make_float4(v[0], v[1], v[2], v[3]));
#else
  atomicAdd(addr + 0, v[0]);
  atomicAdd(addr + 1, v[1]);
  atomicAdd(addr + 2, v[2]);
  atomicAdd(addr + 3, v[3]);
#endif
}

// Add a warp's 16x16 fp32 tile (row-major, stride 16, in shared memory) to a
// device-memory matrix with row stride ld; dst points at the tile's corner
// and must be 16-byte aligned, ld a multiple of 4.
__device__ __forceinline__ void warp_atomic_add_tile(float* dst, size_t ld,
                                                     const float* tile,
                                                     int lane) {
  for (int e = lane; e < 64; e += 32) {
    const int r = e / 4;
    const int c4 = (e % 4) * 4;
    atomic_add4(dst + (size_t)r * ld + c4, tile + r * 16 + c4);
  }
}

}  // namespace fmmt
