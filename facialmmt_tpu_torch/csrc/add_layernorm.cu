// Residual add and TF-style LayerNorm in one pass over rows of width H:
//
//   s   = round_T(x + residual)        (x alone when residual is null)
//   mu  = mean(s),  var = mean((s - mu)^2)            fp32, biased
//   out = round_T(gamma * ((s - mu) * rsqrt(var + eps)) + beta)
//
// x, residual and out of one token type T (bf16 or fp32), gamma and beta of
// one parameter type P (bf16 or fp32), read as fp32.  The rounding points are
// those of ops/layers.py's plain chain: the sum rounded to T as the eager add
// rounds it, every statistic and product in fp32, one rounding at the end;
// gamma * y and + beta are kept apart (no fused multiply-add), as the chain's
// two elementwise launches compute them.
//
// Replaces: no TPU kernel.  The JAX package leaves its LayerNorms to XLA,
// which fuses the add, the statistics and the affine map into the producer's
// epilogue.  The port's eager chain (x.float(), mean, sub, square, mean,
// rsqrt, mul, mul, add, .to) launched about eleven kernels and made about
// eight fp32 passes over the activations for each of the text tower's 49
// LayerNorms and the fusion stacks'; this kernel is that chain at inference.
//
// What bounds it on the H100: memory.  (2 or 3) * rows * H * sizeof(T) bytes
// (x, the residual, out; gamma and beta stay in L2) against a handful of
// fp32 operations an element.  The design moves each of them once: a row
// lives in registers between its load and its store.  One warp takes a row
// (two warps above 2,048 values), each lane loading V runs of 8 values of x
// and of the residual (one 16-byte load of bf16, two of fp32); the mean and
// the centred variance are warp-shuffle sums over the registers (a row split
// over warps adds its warps' sums through shared memory in a fixed order, so
// every launch gives the same bits); gamma and beta are read from L2 as the
// row is stored with 16-byte stores.
#include "common.cuh"

#include <stdint.h>

namespace {

constexpr int kThreads = 128;      // four warps a block
constexpr int kMaxVectors = 8;     // runs of 8 values a lane holds
constexpr int kMaxWidth = 4096;

// Eight values of T from 16-byte-aligned p, as fp32: one 16-byte load of
// bf16, two of fp32.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&f)[8]) {
  uint4 u;
  u.x = fmmt::pack_bf16(f[0], f[1]);
  u.y = fmmt::pack_bf16(f[2], f[3]);
  u.z = fmmt::pack_bf16(f[4], f[5]);
  u.w = fmmt::pack_bf16(f[6], f[7]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store8(float* p, const float (&f)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float round_to(float v, const float*) { return v; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The sum of v over the warps_per_row warps of this warp's row, the same
// value in every lane; `slot` is a shared array of one float a warp.  Every
// thread of the block calls it (it synchronises when a row spans warps).
__device__ __forceinline__ float row_sum(float v, int warps_per_row,
                                         float* slot) {
  v = warp_sum(v);
  if (warps_per_row == 1) return v;
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) slot[warp] = v;
  __syncthreads();
  const int first = warp - warp % warps_per_row;
  float s = 0.f;
  for (int w = 0; w < warps_per_row; ++w) s += slot[first + w];
  return s;
}

// One row a warps_per_row warps; V: the 8-element vectors a lane holds
// (ceil(H / 8 / (32 * warps_per_row))).
template <typename T, typename P, int V>
__global__ void __launch_bounds__(kThreads)
add_layernorm_kernel(const T* __restrict__ x, const T* __restrict__ res,
                     const P* __restrict__ gamma, const P* __restrict__ beta,
                     T* __restrict__ out, int rows, int H, int warps_per_row,
                     float inv_h, float eps) {
  __shared__ float slots[2][kThreads / 32];
  const int warp = threadIdx.x / 32;
  const int row = blockIdx.x * (kThreads / 32 / warps_per_row) +
                  warp / warps_per_row;
  const int first = (warp % warps_per_row) * 32 + threadIdx.x % 32;
  const int stride = 32 * warps_per_row;
  const int nvec = H / 8;
  const bool live = row < rows;
  const size_t base = (size_t)(live ? row : 0) * H;

  float v[V][8];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = first + i * stride;
    if (live && c < nvec) {
      load8(x + base + c * 8, v[i]);
      if (res != nullptr) {
        float r[8];
        load8(res + base + c * 8, r);
#pragma unroll
        for (int j = 0; j < 8; ++j) v[i][j] = round_to(v[i][j] + r[j], x);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) sum += v[i][j];
    }
  }
  const float mean = row_sum(sum, warps_per_row, slots[0]) * inv_h;

  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = first + i * stride;
    if (live && c < nvec) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = v[i][j] - mean;
        sq += d * d;
      }
    }
  }
  const float var = row_sum(sq, warps_per_row, slots[1]) * inv_h;
  const float rs = rsqrtf(var + eps);

#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = first + i * stride;
    if (live && c < nvec) {
      float g[8], b[8], o[8];
      load8(gamma + c * 8, g);
      load8(beta + c * 8, b);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        o[j] = __fadd_rn(__fmul_rn(g[j], __fmul_rn(v[i][j] - mean, rs)),
                         b[j]);
      store8(out + base + c * 8, o);
    }
  }
}

template <typename T, typename P, int V>
int launch(const void* x, const void* res, const void* gamma,
           const void* beta, void* out, int rows, int H, int warps_per_row,
           float eps, void* stream) {
  const int rows_per_block = kThreads / 32 / warps_per_row;
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  add_layernorm_kernel<T, P, V><<<blocks, kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(res),
      static_cast<const P*>(gamma), static_cast<const P*>(beta),
      static_cast<T*>(out), rows, H, warps_per_row, 1.0f / (float)H, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename P>
int dispatch(const void* x, const void* res, const void* gamma,
             const void* beta, void* out, int rows, int H, int warps_per_row,
             int V, float eps, void* stream) {
#define FMMT_ADD_LN_CASE(n)                                                  \
  case n:                                                                    \
    return launch<T, P, n>(x, res, gamma, beta, out, rows, H, warps_per_row, \
                           eps, stream);
  switch (V) {
    FMMT_ADD_LN_CASE(1)
    FMMT_ADD_LN_CASE(2)
    FMMT_ADD_LN_CASE(3)
    FMMT_ADD_LN_CASE(4)
    FMMT_ADD_LN_CASE(5)
    FMMT_ADD_LN_CASE(6)
    FMMT_ADD_LN_CASE(7)
    FMMT_ADD_LN_CASE(8)
  }
#undef FMMT_ADD_LN_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// out = LayerNormTF(x + res) over `rows` rows of H values (res may be null:
// LayerNormTF(x)).  x_f32 / p_f32: 1 for fp32 tokens / parameters, 0 for
// bf16.  Requires H a multiple of 8 in [8, 4096] and every pointer 16-byte
// aligned; returns cudaErrorInvalidValue otherwise.  Nothing is launched for
// rows == 0.
FMMT_API int fmmt_add_layernorm(const void* x, const void* res,
                                const void* gamma, const void* beta, void* out,
                                int rows, int H, int x_f32, int p_f32,
                                float eps, void* stream) {
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(res) |
      reinterpret_cast<uintptr_t>(gamma) | reinterpret_cast<uintptr_t>(beta) |
      reinterpret_cast<uintptr_t>(out);
  if (H % 8 != 0 || H < 8 || H > kMaxWidth || rows < 0 || align % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const int nvec = H / 8;
  int warps_per_row = 1;
  while (nvec > 32 * warps_per_row * kMaxVectors) warps_per_row *= 2;
  const int V = (nvec + 32 * warps_per_row - 1) / (32 * warps_per_row);
  using bf16 = __nv_bfloat16;
  if (x_f32)
    return p_f32 ? dispatch<float, float>(x, res, gamma, beta, out, rows, H,
                                          warps_per_row, V, eps, stream)
                 : dispatch<float, bf16>(x, res, gamma, beta, out, rows, H,
                                         warps_per_row, V, eps, stream);
  return p_f32 ? dispatch<bf16, float>(x, res, gamma, beta, out, rows, H,
                                       warps_per_row, V, eps, stream)
               : dispatch<bf16, bf16>(x, res, gamma, beta, out, rows, H,
                                      warps_per_row, V, eps, stream);
}
