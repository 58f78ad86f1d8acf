// Row kernels shared by the two Swin block backwards (kernel 4,
// csrc/block_mlp_bwd.cu; kernel 5, csrc/attention_block_bwd.cu), and the
// scratch arena their wrappers hand in.  Both backwards are sequences of
// tile_gemm.cuh products between these passes:
//   prep_rows      xn = bf16(LN(x)) and dyk = bf16(dy keep), (T, C) each,
//                  from the rows' statistics (launch_row_stats);
//   ln_bwd_rows    the LayerNorm backward of each row from the fp32 dxn,
//                    dx = dy + rstd (dxhat - mean(dxhat) - xh mean(dxhat xh)),
//                  and per-block column partials of dgamma = sum dxn xh,
//                  dbeta = sum dxn and the bias sum of the unrounded dy keep,
//                  which sum_rows adds in a fixed order.
// Rounding as the JAX kernels: xn and dyk are bf16 matmul operands; the LN
// backward and every sum are fp32.
#pragma once

#include "tile_gemm.cuh"

namespace fmmt {
namespace bwd {

// A bump allocator over one scratch buffer.  Run once with base = nullptr it
// counts the bytes a call needs (the wrapper's query), then hands out the
// same offsets over the buffer the wrapper allocated.
struct Arena {
  unsigned char* base;
  size_t used;
  template <typename T>
  T* take(size_t n) {
    used = (used + 255) / 256 * 256;
    T* p = base ? reinterpret_cast<T*>(base + used) : nullptr;
    used += n * sizeof(T);
    return p;
  }
};

// 8 elements a thread: xn = bf16((x rstd - mean rstd) gamma + beta), the
// forward's normalise in tile_gemm.cuh, and dyk = bf16(dy keep[t / keep_div]).
static __global__ void __launch_bounds__(256)
prep_rows_kernel(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ dy,
                 const float2* __restrict__ st,
                 const __nv_bfloat16* __restrict__ gamma,
                 const __nv_bfloat16* __restrict__ beta,
                 const float* __restrict__ keep, int keep_div,
                 __nv_bfloat16* __restrict__ xn,
                 __nv_bfloat16* __restrict__ dyk, long long pieces, int C) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= pieces) return;
  const long long e = i * 8;
  const long long t = e / C;
  const int c = (int)(e % C);
  const float2 sc = st[t];
  const float kf = keep ? keep[t / keep_div] : 1.f;
  const uint4 xv = *reinterpret_cast<const uint4*>(x + e);
  const uint4 dv = *reinterpret_cast<const uint4*>(dy + e);
  const uint4 gv = *reinterpret_cast<const uint4*>(gamma + c);
  const uint4 bv = *reinterpret_cast<const uint4*>(beta + c);
  const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&xv);
  const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
  const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
  const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&bv);
  uint4 xo, dko;
  uint32_t* x32 = reinterpret_cast<uint32_t*>(&xo);
  uint32_t* d32 = reinterpret_cast<uint32_t*>(&dko);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 xf = __bfloat1622float2(x2[k]);
    const float2 gf = __bfloat1622float2(g2[k]);
    const float2 bf = __bfloat1622float2(b2[k]);
    const float2 df = __bfloat1622float2(d2[k]);
    x32[k] = pack_bf16(fmaf(fmaf(xf.x, sc.x, sc.y), gf.x, bf.x),
                       fmaf(fmaf(xf.y, sc.x, sc.y), gf.y, bf.y));
    d32[k] = pack_bf16(df.x * kf, df.y * kf);
  }
  *reinterpret_cast<uint4*>(xn + e) = xo;
  *reinterpret_cast<uint4*>(dyk + e) = dko;
}

static inline int launch_prep_rows(const __nv_bfloat16* x,
                                   const __nv_bfloat16* dy, const float2* st,
                                   const __nv_bfloat16* gamma,
                                   const __nv_bfloat16* beta,
                                   const float* keep, int keep_div,
                                   __nv_bfloat16* xn, __nv_bfloat16* dyk,
                                   int T, int C, cudaStream_t stream) {
  const long long pieces = (long long)T * C / 8;
  prep_rows_kernel<<<(unsigned)((pieces + 255) / 256), 256, 0, stream>>>(
      x, dy, st, gamma, beta, keep, keep_div, xn, dyk, pieces, C);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kLnWarps = 8;
constexpr int kLnRows = 32;   // rows a block: 4 a warp

inline int ln_bwd_blocks(int T) { return (T + kLnRows - 1) / kLnRows; }

inline size_t ln_bwd_smem(int C) {
  return (size_t)kLnWarps * 3 * C * sizeof(float);
}

// One warp a row, lane l holding columns l + 32 j (j < kCols).  Each warp
// keeps its rows' column sums in registers; the 8 warps' sums are added in
// warp order into part[block][3C] = dgamma | dbeta | sum of dy keep.
template <int kCols>
__global__ void __launch_bounds__(kLnWarps * 32)
ln_bwd_rows_kernel(const float* __restrict__ dxn,
                   const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ dy,
                   const float2* __restrict__ st,
                   const __nv_bfloat16* __restrict__ gamma,
                   const float* __restrict__ keep, int keep_div,
                   __nv_bfloat16* __restrict__ dx, float* __restrict__ part,
                   int T, int C) {
  extern __shared__ __align__(16) float red[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float sg[kCols], sb[kCols], sk[kCols], gm[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const int c = lane + 32 * j;
    sg[j] = sb[j] = sk[j] = 0.f;
    gm[j] = c < C ? bf(gamma[c]) : 0.f;
  }
  for (int i = 0; i < kLnRows / kLnWarps; ++i) {
    const long long t = (long long)blockIdx.x * kLnRows + warp + kLnWarps * i;
    if (t >= T) break;
    const float2 sc = st[t];
    const float rstd = sc.x;
    const float kf = keep ? keep[t / keep_div] : 1.f;
    float d[kCols], xh[kCols];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = lane + 32 * j;
      d[j] = xh[j] = 0.f;
      if (c < C) {
        d[j] = dxn[t * C + c];
        xh[j] = fmaf(bf(x[t * C + c]), sc.x, sc.y);
        const float dxh = d[j] * gm[j];
        s1 += dxh;
        s2 = fmaf(dxh, xh[j], s2);
      }
    }
    const float m1 = warp_sum(s1) / C;
    const float m2 = warp_sum(s2) / C;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = lane + 32 * j;
      if (c < C) {
        const float dyv = bf(dy[t * C + c]);
        dx[t * C + c] = __float2bfloat16(
            dyv + rstd * (d[j] * gm[j] - m1 - xh[j] * m2));
        sg[j] = fmaf(d[j], xh[j], sg[j]);
        sb[j] += d[j];
        sk[j] = fmaf(dyv, kf, sk[j]);
      }
    }
  }
  float* mine = red + (size_t)warp * 3 * C;
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const int c = lane + 32 * j;
    if (c < C) {
      mine[c] = sg[j];
      mine[C + c] = sb[j];
      mine[2 * C + c] = sk[j];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < 3 * C; c += kLnWarps * 32) {
    float s = 0.f;
    for (int w = 0; w < kLnWarps; ++w) s += red[(size_t)w * 3 * C + c];
    part[(size_t)blockIdx.x * 3 * C + c] = s;
  }
}

template <int kCols>
int launch_ln_bwd_cols(const float* dxn, const __nv_bfloat16* x,
                       const __nv_bfloat16* dy, const float2* st,
                       const __nv_bfloat16* gamma, const float* keep,
                       int keep_div, __nv_bfloat16* dx, float* part, int T,
                       int C, cudaStream_t stream) {
  const size_t bytes = ln_bwd_smem(C);
  cudaError_t err = cudaFuncSetAttribute(
      ln_bwd_rows_kernel<kCols>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  ln_bwd_rows_kernel<kCols><<<ln_bwd_blocks(T), kLnWarps * 32, bytes,
                              stream>>>(dxn, x, dy, st, gamma, keep, keep_div,
                                        dx, part, T, C);
  return static_cast<int>(cudaGetLastError());
}

// dx (T, C) bf16 and part (ln_bwd_blocks(T), 3C); C <= 768.
static inline int launch_ln_bwd(const float* dxn, const __nv_bfloat16* x,
                                const __nv_bfloat16* dy, const float2* st,
                                const __nv_bfloat16* gamma, const float* keep,
                                int keep_div, __nv_bfloat16* dx, float* part,
                                int T, int C, cudaStream_t stream) {
  const int cols = (C + 31) / 32;
  if (cols <= 1)
    return launch_ln_bwd_cols<1>(dxn, x, dy, st, gamma, keep, keep_div, dx,
                                 part, T, C, stream);
  if (cols <= 3)
    return launch_ln_bwd_cols<3>(dxn, x, dy, st, gamma, keep, keep_div, dx,
                                 part, T, C, stream);
  if (cols <= 6)
    return launch_ln_bwd_cols<6>(dxn, x, dy, st, gamma, keep, keep_div, dx,
                                 part, T, C, stream);
  if (cols <= 12)
    return launch_ln_bwd_cols<12>(dxn, x, dy, st, gamma, keep, keep_div, dx,
                                  part, T, C, stream);
  return launch_ln_bwd_cols<24>(dxn, x, dy, st, gamma, keep, keep_div, dx,
                                part, T, C, stream);
}

}  // namespace bwd
}  // namespace fmmt
