// Backward of the Swin block MLP half
//   out[t] = x[t] + keep[t] * fc2(GELU_erf(fc1(LN2(x[t]))))
// From x and the output gradient dy (both (T,C) bf16) the kernel recomputes
// LN2, fc1 and GELU and returns dx (T,C) bf16 and, in fp32, dgamma, dbeta
// (C), dW1 (HID,C), db1 (HID), dW2 (C,HID), db2 (C), in torch Linear layout.
// keep (T,) fp32 is optional and gets no gradient: the residual gradient is
// dy, the branch gradient dy * keep.  The fp32 outputs must arrive zeroed.
//
// Replaces: facialmmt_tpu/ops/pallas/block_mlp.py::_bwd_impl_pallas.
//
// What bounds it on the H100: five GEMM-shaped products of 2*T*C*HID FLOP each
// (fc1 recomputed, dgm, dxn, dW1, dW2; HID = 4C, so 40*T*C*C in all) against
// 6*T*C bytes of token traffic plus the weights, so the arithmetic is
// tensor-core work; but the two weight gradients are sums over ALL tokens,
// and a block sees only its own tile.
//
// What the design does about it: one block (8 warps) owns a tile of 32
// tokens and walks the hidden width in chunks of 64 units, as the forward
// does, so no (tile, 4C) buffer exists.  Per chunk: h = xn W1^T and
// dgm = dyk W2 on the tensor cores, GELU and its derivative elementwise,
// dxn += dh W1 into register fragments that live across the hidden loop, and
// the chunk's slices of dW1 = dh^T xn and dW2 = dyk^T g as K = 32 products.
// The TPU kernel keeps the weight gradients in one resident block that
// sequential grid cells add to; CUDA blocks run at once, so here every
// block adds its partial products to the fp32 outputs in device memory with
// vector atomics (T*C*C/4 element-adds per call at any stage).  The sums are
// therefore not bit-reproducible; they agree to fp32 rounding.  Per-block
// partial buffers plus a second reduction kernel would be reproducible but
// need T/32 copies of both weight matrices.
//
// Rounding follows the JAX kernel: xn, GELU output, dy*keep and dh are
// rounded to bf16 as matmul operands, every accumulation and the LN backward
// are fp32; db1, db2, dgamma, dbeta sum the unrounded fp32 values.
#include "common.cuh"

#include <math.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 32;       // tokens per block
constexpr int kChunk = 64;      // hidden units per chunk
constexpr int kMaxC = 768;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major>;
using FragACol = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                                wmma::col_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                                wmma::col_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                                wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// dxn output tiles per warp for width C, as the forward's fc2 accumulators
__host__ __device__ constexpr int acc_tiles(int C) {
  return ((kTile / 16) * (C / 16) + kWarps - 1) / kWarps;
}

struct Layout {
  int ldx;   // bf16 row stride of xn and dyk (C + 8)
  int ldf;   // fp32 row stride of the h and dgm/dh chunks (kChunk + 4)
  int ldh;   // bf16 row stride of the g and dh chunks (kChunk + 8)
  int ldy;   // fp32 row stride of the dxn staging (C + 4)
  size_t off_dyk, off_hf, off_df, off_gb, off_dhb, off_stage, off_stat, bytes;
};

__host__ __device__ inline Layout layout(int C) {
  Layout L;
  L.ldx = C + 8;
  L.ldf = kChunk + 4;
  L.ldh = kChunk + 8;
  L.ldy = C + 4;
  const size_t xb = (size_t)kTile * L.ldx * sizeof(__nv_bfloat16);
  const size_t fb = (size_t)kTile * L.ldf * sizeof(float);
  const size_t hb = (size_t)kTile * L.ldh * sizeof(__nv_bfloat16);
  L.off_dyk = xb;
  L.off_hf = 2 * xb;        // the fp32 dxn staging (kTile x ldy) reuses [0, 2xb)
  L.off_df = L.off_hf + fb;
  L.off_gb = L.off_df + fb;
  L.off_dhb = L.off_gb + hb;
  L.off_stage = L.off_dhb + hb;
  L.off_stat = L.off_stage + (size_t)kWarps * 256 * sizeof(float);
  L.bytes = L.off_stat + 2 * kTile * sizeof(float);
  return L;
}

template <int kAcc>
__global__ void __launch_bounds__(kThreads)
block_mlp_bwd_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ dy,
                     const __nv_bfloat16* __restrict__ gamma,
                     const __nv_bfloat16* __restrict__ beta,
                     const __nv_bfloat16* __restrict__ w1,
                     const __nv_bfloat16* __restrict__ b1,
                     const __nv_bfloat16* __restrict__ w2,
                     const float* __restrict__ keep,
                     __nv_bfloat16* __restrict__ dx, float* dgamma,
                     float* dbeta, float* dw1, float* db1, float* dw2,
                     float* db2, int T, int C, int HID, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(C);
  __nv_bfloat16* xn = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dyk = reinterpret_cast<__nv_bfloat16*>(smem + L.off_dyk);
  float* hf = reinterpret_cast<float*>(smem + L.off_hf);
  float* df = reinterpret_cast<float*>(smem + L.off_df);
  __nv_bfloat16* gb = reinterpret_cast<__nv_bfloat16*>(smem + L.off_gb);
  __nv_bfloat16* dhb = reinterpret_cast<__nv_bfloat16*>(smem + L.off_dhb);
  float* smean = reinterpret_cast<float*>(smem + L.off_stat);
  float* srstd = smean + kTile;
  float* ys = reinterpret_cast<float*>(smem);   // after the hidden loop

  const int t0 = blockIdx.x * kTile;
  const int rows = min(kTile, T - t0);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  float* stage = reinterpret_cast<float*>(smem + L.off_stage) + warp * 256;

  // 1. LN2 -> xn (bf16) with its row statistics, dyk = bf16(dy * keep); the
  //    missing rows of the last tile are zero in both, which makes them
  //    inert in every product below
  for (int r = warp; r < kTile; r += kWarps) {
    __nv_bfloat16* xr = xn + (size_t)r * L.ldx;
    __nv_bfloat16* dr = dyk + (size_t)r * L.ldx;
    if (r < rows) {
      const size_t t = (size_t)t0 + r;
      float mean, rstd;
      fmmt::warp_layernorm_row_stats(x + t * C, gamma, beta, xr, C, eps, lane,
                                     mean, rstd);
      if (lane == 0) {
        smean[r] = mean;
        srstd[r] = rstd;
      }
      const float kf = keep ? keep[t] : 1.f;
      for (int i = lane; i < C; i += 32)
        dr[i] = __float2bfloat16(fmmt::bf(dy[t * C + i]) * kf);
    } else {
      for (int i = lane; i < C; i += 32) {
        xr[i] = __float2bfloat16(0.f);
        dr[i] = __float2bfloat16(0.f);
      }
    }
  }
  // db2 = column sums of the unrounded dy * keep
  for (int c = tid; c < C; c += kThreads) {
    float s = 0.f;
    for (int r = 0; r < rows; ++r) {
      const size_t t = (size_t)t0 + r;
      s += fmmt::bf(dy[t * C + c]) * (keep ? keep[t] : 1.f);
    }
    atomicAdd(db2 + c, s);
  }
  __syncthreads();

  // this warp's dxn tiles: t = warp + kWarps * i over (kTile/16) x (C/16)
  const int ntiles = (kTile / 16) * (C / 16);
  const int ctiles = C / 16;
  FragC dxacc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) wmma::fill_fragment(dxacc[i], 0.f);

  // this warp's tile of the 32 x 64 chunk: 2 x 4 tiles of 16x16
  const int f_m = warp / 4;
  const int f_n = warp % 4;

  for (int j0 = 0; j0 < HID; j0 += kChunk) {
    // a. h = xn W1[chunk]^T and dgm = dyk W2[:, chunk], one tile per warp
    {
      FragC hacc, gacc;
      wmma::fill_fragment(hacc, 0.f);
      wmma::fill_fragment(gacc, 0.f);
      for (int k0 = 0; k0 < C; k0 += 16) {
        FragA a;
        FragBCol b;
        wmma::load_matrix_sync(a, xn + (size_t)(f_m * 16) * L.ldx + k0, L.ldx);
        wmma::load_matrix_sync(b, w1 + (size_t)(j0 + f_n * 16) * C + k0, C);
        wmma::mma_sync(hacc, a, b, hacc);
        FragA a2;
        FragBRow b2;
        wmma::load_matrix_sync(a2, dyk + (size_t)(f_m * 16) * L.ldx + k0,
                               L.ldx);
        wmma::load_matrix_sync(b2, w2 + (size_t)k0 * HID + j0 + f_n * 16, HID);
        wmma::mma_sync(gacc, a2, b2, gacc);
      }
      wmma::store_matrix_sync(hf + (f_m * 16) * L.ldf + f_n * 16, hacc, L.ldf,
                              wmma::mem_row_major);
      wmma::store_matrix_sync(df + (f_m * 16) * L.ldf + f_n * 16, gacc, L.ldf,
                              wmma::mem_row_major);
    }
    __syncthreads();
    // b. g = GELU(h), dh = dgm * (Phi(h) + h phi(h)); dh stays in df as fp32
    for (int i = tid; i < kTile * kChunk; i += kThreads) {
      const int r = i / kChunk;
      const int jj = i % kChunk;
      const float h = hf[r * L.ldf + jj] + fmmt::bf(b1[j0 + jj]);
      const float cdf = 0.5f * (1.f + erff(h * 0.70710678118654752f));
      const float pdf = expf(-0.5f * h * h) * 0.3989422804014327f;
      const float dh = df[r * L.ldf + jj] * (cdf + h * pdf);
      gb[r * L.ldh + jj] = __float2bfloat16(h * cdf);
      dhb[r * L.ldh + jj] = __float2bfloat16(dh);
      df[r * L.ldf + jj] = dh;
    }
    __syncthreads();
    // c. db1[chunk] = column sums of the fp32 dh
    if (tid < kChunk) {
      float s = 0.f;
      for (int r = 0; r < kTile; ++r) s += df[r * L.ldf + tid];
      atomicAdd(db1 + j0 + tid, s);
    }
    // d. dxn += dh W1[chunk]
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int t = warp + kWarps * i;
      if (t < ntiles) {
        const int m = t / ctiles;
        const int n = t % ctiles;
        for (int k0 = 0; k0 < kChunk; k0 += 16) {
          FragA a;
          FragBRow b;
          wmma::load_matrix_sync(a, dhb + (m * 16) * L.ldh + k0, L.ldh);
          wmma::load_matrix_sync(b, w1 + (size_t)(j0 + k0) * C + n * 16, C);
          wmma::mma_sync(dxacc[i], a, b, dxacc[i]);
        }
      }
    }
    // e. dW1[chunk] += dh^T xn  (64 x C, K = 32 tokens)
    for (int t = warp; t < (kChunk / 16) * ctiles; t += kWarps) {
      const int m = t / ctiles;
      const int n = t % ctiles;
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
      for (int k0 = 0; k0 < kTile; k0 += 16) {
        FragACol a;
        FragBRow b;
        wmma::load_matrix_sync(a, dhb + k0 * L.ldh + m * 16, L.ldh);
        wmma::load_matrix_sync(b, xn + (size_t)k0 * L.ldx + n * 16, L.ldx);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(stage, acc, 16, wmma::mem_row_major);
      __syncwarp();
      fmmt::warp_atomic_add_tile(dw1 + (size_t)(j0 + m * 16) * C + n * 16, C,
                                 stage, lane);
      __syncwarp();
    }
    // f. dW2[:, chunk] += dyk^T g  (C x 64, K = 32 tokens)
    for (int t = warp; t < ctiles * (kChunk / 16); t += kWarps) {
      const int m = t / (kChunk / 16);
      const int n = t % (kChunk / 16);
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
      for (int k0 = 0; k0 < kTile; k0 += 16) {
        FragACol a;
        FragBRow b;
        wmma::load_matrix_sync(a, dyk + (size_t)k0 * L.ldx + m * 16, L.ldx);
        wmma::load_matrix_sync(b, gb + k0 * L.ldh + n * 16, L.ldh);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(stage, acc, 16, wmma::mem_row_major);
      __syncwarp();
      fmmt::warp_atomic_add_tile(dw2 + (size_t)(m * 16) * HID + j0 + n * 16,
                                 HID, stage, lane);
      __syncwarp();
    }
    __syncthreads();  // hf / df / gb / dhb are rewritten by the next chunk
  }

  // 2. stage the fp32 dxn over the (now dead) xn / dyk buffers
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int t = warp + kWarps * i;
    if (t < ntiles) {
      const int m = t / ctiles;
      const int n = t % ctiles;
      wmma::store_matrix_sync(ys + (m * 16) * L.ldy + n * 16, dxacc[i], L.ldy,
                              wmma::mem_row_major);
    }
  }
  __syncthreads();

  // 3. LN backward, one warp per row:
  //    dx = dy + rstd * (dxhat - mean(dxhat) - xh * mean(dxhat * xh))
  for (int r = warp; r < rows; r += kWarps) {
    const size_t t = (size_t)t0 + r;
    const float mean = smean[r];
    const float rstd = srstd[r];
    float s1 = 0.f, s2 = 0.f;
    for (int i = lane; i < C; i += 32) {
      const float dxh = ys[r * L.ldy + i] * fmmt::bf(gamma[i]);
      const float xh = (fmmt::bf(x[t * C + i]) - mean) * rstd;
      s1 += dxh;
      s2 = fmaf(dxh, xh, s2);
    }
    const float m1 = fmmt::warp_sum(s1) / C;
    const float m2 = fmmt::warp_sum(s2) / C;
    for (int i = lane; i < C; i += 32) {
      const float dxh = ys[r * L.ldy + i] * fmmt::bf(gamma[i]);
      const float xh = (fmmt::bf(x[t * C + i]) - mean) * rstd;
      dx[t * C + i] = __float2bfloat16(fmmt::bf(dy[t * C + i]) +
                                       rstd * (dxh - m1 - xh * m2));
    }
  }
  // 4. dgamma = column sums of dxn * xh, dbeta = column sums of dxn
  for (int c = tid; c < C; c += kThreads) {
    float sg = 0.f, sb = 0.f;
    for (int r = 0; r < rows; ++r) {
      const float d = ys[r * L.ldy + c];
      const float xh =
          (fmmt::bf(x[((size_t)t0 + r) * C + c]) - smean[r]) * srstd[r];
      sg = fmaf(d, xh, sg);
      sb += d;
    }
    atomicAdd(dgamma + c, sg);
    atomicAdd(dbeta + c, sb);
  }
}

template <int kAcc>
int launch(const void* x, const void* dy, const void* gamma, const void* beta,
           const void* w1, const void* b1, const void* w2, const void* keep,
           void* dx, void* dgamma, void* dbeta, void* dw1, void* db1, void* dw2,
           void* db2, int T, int C, int HID, float eps, void* stream) {
  const size_t bytes = layout(C).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      block_mlp_bwd_kernel<kAcc>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (T + kTile - 1) / kTile;
  block_mlp_bwd_kernel<kAcc><<<blocks, kThreads, bytes,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(dy),
      static_cast<const __nv_bfloat16*>(gamma),
      static_cast<const __nv_bfloat16*>(beta),
      static_cast<const __nv_bfloat16*>(w1),
      static_cast<const __nv_bfloat16*>(b1),
      static_cast<const __nv_bfloat16*>(w2), static_cast<const float*>(keep),
      static_cast<__nv_bfloat16*>(dx), static_cast<float*>(dgamma),
      static_cast<float*>(dbeta), static_cast<float*>(dw1),
      static_cast<float*>(db1), static_cast<float*>(dw2),
      static_cast<float*>(db2), T, C, HID, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared-memory bytes one block needs; the wrapper checks this against the
// card's limit before launching.
FMMT_API long long fmmt_fused_ln_mlp_residual_bwd_smem(int C) {
  return static_cast<long long>(layout(C).bytes);
}

FMMT_API int fmmt_fused_ln_mlp_residual_bwd(
    const void* x, const void* dy, const void* gamma, const void* beta,
    const void* w1, const void* b1, const void* w2, const void* keep, void* dx,
    void* dgamma, void* dbeta, void* dw1, void* db1, void* dw2, void* db2,
    int T, int C, int HID, float eps, void* stream) {
  if (C % 16 != 0 || C > kMaxC || HID % kChunk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int need = acc_tiles(C);
  if (need <= 2)
    return launch<2>(x, dy, gamma, beta, w1, b1, w2, keep, dx, dgamma, dbeta,
                     dw1, db1, dw2, db2, T, C, HID, eps, stream);
  if (need <= 3)
    return launch<3>(x, dy, gamma, beta, w1, b1, w2, keep, dx, dgamma, dbeta,
                     dw1, db1, dw2, db2, T, C, HID, eps, stream);
  return launch<12>(x, dy, gamma, beta, w1, b1, w2, keep, dx, dgamma, dbeta,
                    dw1, db1, dw2, db2, T, C, HID, eps, stream);
}
