// Backward of the Swin block attention half, spill variant (any C up to
// 768; the dispatch sends C = 768 here):
//   out[w] = x[w] + keep[w] * (proj(MHA(LN1(x[w])) + bias[w % nW]))
// From x and the output gradient dy (both (W,N,C) bf16) the kernel recomputes
// LN1, qkv and the softmax per window and head and returns dx (W,N,C) bf16
// and, in fp32, dgamma, dbeta (C) and the bias cotangent summed over ALL
// windows, dbias (h,N,N).  Weights are in torch Linear layout, wqkv (3C,C)
// with q|k|v on the output axis, wproj (C,C).  keep (W,) fp32 is optional and
// gets no gradient: the residual gradient is dy, the branch gradient
// dy * keep.  The fp32 outputs must arrive zeroed.  The kernel emits xn
// (W,64,C), dqkv (W,64,3C) and attn (W,64,C) in bf16, rows N..63 of each
// window zero, and the caller forms the four weight gradients as K = T
// products outside.
//
// Replaces: facialmmt_tpu/ops/pallas/fused_block.py::_bwd_impl_spill.  (The
// resident variant, _bwd_impl_pallas, is csrc/attention_block_bwd.cu.)
//
// What bounds it on the H100: per window about 2.7x the forward's matmul
// work (22*N*C*C + 12*N*N*C FLOP) against 6*N*C bytes of token traffic, so
// it is tensor-core work, but what shapes the design is shared memory and
// the sums over windows.  A block gets 227 KB; x, dy, xn, dattn, attn, dqkv
// and an fp32 dxn for one padded window would need 6 to 9 (64, C) buffers
// (100 KB each at C = 768).
//
// What the design does about it: one block (8 warps) owns one window (N = 49
// rows padded to 64) and loops over heads, as the forward does.  Only
// dyk = bf16(dy * keep) is kept whole in shared memory; xn is read back from
// the emitted (L2-resident) copy.  Per head the block forms q, k, v,
// dattn_h = dyk Wproj[:, head], the scores, the fp32 softmax and its vjp,
// attn_h, dv, dq, dk (64 x hd each); dxn = dqkv Wqkv is formed after the head
// loop in 16-row tiles from the emitted dqkv.  The TPU kernel adds dgamma,
// dbeta and dbias into one resident output block across sequential grid
// cells; CUDA blocks run at once, so those cross-window sums here are fp32
// atomicAdds into zeroed device memory.  They are not bit-reproducible run
// to run; they agree to fp32 rounding.
//
// Padding: padded key columns carry probability 0 and ds = 0; padded query
// rows of xn, dyk, q, k, v are zero, so they add nothing to any gradient, and
// dbias, dgamma, dbeta and dx only visit rows and columns below N.
//
// Rounding follows the JAX kernel: xn, q (after scale), k, v, dyk, dattn, the
// probabilities and ds as matmul operands, dq, dk, dv and attn are rounded to
// bf16; the softmax, its vjp (on the fp32 probabilities), every accumulation
// and the LN backward are fp32.
#include "common.cuh"

#include <math.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 64;       // window rows, padded
constexpr int kMaxC = 768;
constexpr int kMaxCols = kMaxC / kThreads;   // columns per thread in LN bwd

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major>;
using FragACol = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                                wmma::col_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                                wmma::col_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                                wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

struct Layout {
  int ldx;    // bf16 row stride of dyk (C + 8)
  int ldh;    // bf16 row stride of the per-head buffers (hd + 8)
  int lds;    // fp32 row stride of the scores and dP (kRows + 4)
  int ldp;    // bf16 row stride of the probabilities and ds (kRows + 8)
  int ldy;    // fp32 row stride of the dxn staging (C + 4)
  size_t off_dyk, off_head, head_bytes, off_s, off_d, off_p, off_ds, off_stage,
      off_stat, bytes;
};

__host__ __device__ inline Layout layout(int C, int hd) {
  Layout L;
  L.ldx = C + 8;
  L.ldh = hd + 8;
  L.lds = kRows + 4;
  L.ldp = kRows + 8;
  L.ldy = C + 4;
  const size_t xb = (size_t)kRows * L.ldx * sizeof(__nv_bfloat16);
  // dyk, later one 16-row fp32 dxn tile over it
  L.off_dyk = 0;
  L.off_head = xb;
  L.head_bytes = (size_t)kRows * L.ldh * sizeof(__nv_bfloat16);
  L.off_s = L.off_head + 4 * L.head_bytes;   // q k v dattn
  L.off_d = L.off_s + (size_t)kRows * L.lds * sizeof(float);
  L.off_p = L.off_d + (size_t)kRows * L.lds * sizeof(float);
  L.off_ds = L.off_p + (size_t)kRows * L.ldp * sizeof(__nv_bfloat16);
  L.off_stage = L.off_ds + (size_t)kRows * L.ldp * sizeof(__nv_bfloat16);
  L.off_stat = L.off_stage + (size_t)kWarps * 256 * sizeof(float);
  L.bytes = L.off_stat + 2 * kRows * sizeof(float);
  return L;
}

struct Args {
  const __nv_bfloat16 *x, *dy, *gamma, *beta, *wqkv, *bqkv, *wproj;
  const float *bias, *keep;
  __nv_bfloat16* dx;
  float *dgamma, *dbeta, *dbias;
  __nv_bfloat16 *xn_out, *dqkv_out, *attn_out;
  int N, C, heads, nW;
  float eps;
};

// LN backward for rows [row0, row0 + nrows) of the window, whose fp32 dxn
// sits in ys (row-major, stride ldy, first row = row0):
//   dx = dy + rstd * (dxhat - mean(dxhat) - xh * mean(dxhat * xh)),
// one warp per row; each thread also adds its columns' dgamma / dbeta
// partial sums into sg / sb.
__device__ __forceinline__ void ln_backward_rows(
    const float* ys, int ldy, int row0, int nrows, const __nv_bfloat16* xw,
    const __nv_bfloat16* dyw, __nv_bfloat16* dxw, const __nv_bfloat16* gamma,
    const float* smean, const float* srstd, int C, int tid, float* sg,
    float* sb) {
  const int warp = tid / 32;
  const int lane = tid % 32;
  for (int rr = warp; rr < nrows; rr += kWarps) {
    const int n = row0 + rr;
    const float mean = smean[n];
    const float rstd = srstd[n];
    float s1 = 0.f, s2 = 0.f;
    for (int i = lane; i < C; i += 32) {
      const float dxh = ys[rr * ldy + i] * fmmt::bf(gamma[i]);
      const float xh = (fmmt::bf(xw[(size_t)n * C + i]) - mean) * rstd;
      s1 += dxh;
      s2 = fmaf(dxh, xh, s2);
    }
    const float m1 = fmmt::warp_sum(s1) / C;
    const float m2 = fmmt::warp_sum(s2) / C;
    for (int i = lane; i < C; i += 32) {
      const float dxh = ys[rr * ldy + i] * fmmt::bf(gamma[i]);
      const float xh = (fmmt::bf(xw[(size_t)n * C + i]) - mean) * rstd;
      dxw[(size_t)n * C + i] = __float2bfloat16(
          fmmt::bf(dyw[(size_t)n * C + i]) + rstd * (dxh - m1 - xh * m2));
    }
  }
#pragma unroll
  for (int j = 0; j < kMaxCols; ++j) {
    const int c = tid + j * kThreads;
    if (c < C) {
      float g = 0.f, b = 0.f;
      for (int rr = 0; rr < nrows; ++rr) {
        const int n = row0 + rr;
        const float d = ys[rr * ldy + c];
        const float xh =
            (fmmt::bf(xw[(size_t)n * C + c]) - smean[n]) * srstd[n];
        g = fmaf(d, xh, g);
        b += d;
      }
      sg[j] += g;
      sb[j] += b;
    }
  }
}

__global__ void __launch_bounds__(kThreads) fused_block_bwd_kernel(Args p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int N = p.N, C = p.C, heads = p.heads;
  const int hd = C / heads;
  const Layout L = layout(C, hd);
  const int w = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  __nv_bfloat16* dyk = reinterpret_cast<__nv_bfloat16*>(smem + L.off_dyk);
  // xn: this window's emitted rows
  __nv_bfloat16* xn = p.xn_out + (size_t)w * kRows * C;
  const int ldn = C;
  __nv_bfloat16* hbuf = reinterpret_cast<__nv_bfloat16*>(smem + L.off_head);
  const int hstride = kRows * L.ldh;
  __nv_bfloat16* qb = hbuf;
  __nv_bfloat16* kb = hbuf + hstride;
  __nv_bfloat16* vb = hbuf + 2 * hstride;
  __nv_bfloat16* dab = hbuf + 3 * hstride;   // dattn_h
  float* Sf = reinterpret_cast<float*>(smem + L.off_s);
  float* Df = reinterpret_cast<float*>(smem + L.off_d);
  __nv_bfloat16* Pb = reinterpret_cast<__nv_bfloat16*>(smem + L.off_p);
  __nv_bfloat16* dSb = reinterpret_cast<__nv_bfloat16*>(smem + L.off_ds);
  float* stage = reinterpret_cast<float*>(smem + L.off_stage) + warp * 256;
  float* smean = reinterpret_cast<float*>(smem + L.off_stat);
  float* srstd = smean + kRows;
  float* ys = reinterpret_cast<float*>(smem);   // over dyk, after the heads

  const __nv_bfloat16* xw = p.x + (size_t)w * N * C;
  const __nv_bfloat16* dyw = p.dy + (size_t)w * N * C;
  __nv_bfloat16* dxw = p.dx + (size_t)w * N * C;
  const float kw = p.keep ? p.keep[w] : 1.f;
  const float scale = rsqrtf((float)hd);
  const float* bias_w = p.bias + (size_t)(w % p.nW) * heads * N * N;

  // 1. LN1 -> xn (bf16) with row statistics, dyk = bf16(dy * keep); padded
  //    rows are zero in both
  for (int n = warp; n < kRows; n += kWarps) {
    __nv_bfloat16* xr = xn + (size_t)n * ldn;
    __nv_bfloat16* dr = dyk + (size_t)n * L.ldx;
    if (n < N) {
      float mean, rstd;
      fmmt::warp_layernorm_row_stats(xw + (size_t)n * C, p.gamma, p.beta, xr,
                                     C, p.eps, lane, mean, rstd);
      if (lane == 0) {
        smean[n] = mean;
        srstd[n] = rstd;
      }
      for (int i = lane; i < C; i += 32)
        dr[i] = __float2bfloat16(fmmt::bf(dyw[(size_t)n * C + i]) * kw);
    } else {
      for (int i = lane; i < C; i += 32) {
        xr[i] = __float2bfloat16(0.f);
        dr[i] = __float2bfloat16(0.f);
      }
    }
  }
  __syncthreads();

  const int ctiles = C / 16;
  const int htiles = hd / 16;

  for (int h = 0; h < heads; ++h) {
    // a. this head's q | k | v = xn Wqkv[rows]^T + bias (q scaled) and
    //    dattn_h = dyk Wproj[:, head columns], 64 x hd each
    for (int t = warp; t < 4 * 4 * htiles; t += kWarps) {
      const int m = t / (4 * htiles);
      const int which = (t % (4 * htiles)) / htiles;   // q, k, v, dattn
      const int d0 = (t % htiles) * 16;
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
      if (which < 3) {
        const int o0 = which * C + h * hd + d0;        // weight row of col 0
        for (int k0 = 0; k0 < C; k0 += 16) {
          FragA a;
          FragBCol b;
          wmma::load_matrix_sync(a, xn + (size_t)(m * 16) * ldn + k0, ldn);
          wmma::load_matrix_sync(b, p.wqkv + (size_t)o0 * C + k0, C);
          wmma::mma_sync(acc, a, b, acc);
        }
        wmma::store_matrix_sync(stage, acc, 16, wmma::mem_row_major);
        __syncwarp();
        __nv_bfloat16* dst = which == 0 ? qb : (which == 1 ? kb : vb);
        for (int e = lane; e < 256; e += 32) {
          const int r = m * 16 + e / 16;
          float v = stage[e] + fmmt::bf(p.bqkv[o0 + e % 16]);
          if (which == 0) v *= scale;
          dst[r * L.ldh + d0 + e % 16] = __float2bfloat16(r < N ? v : 0.f);
        }
      } else {
        for (int k0 = 0; k0 < C; k0 += 16) {
          FragA a;
          FragBRow b;
          wmma::load_matrix_sync(a, dyk + (size_t)(m * 16) * L.ldx + k0, L.ldx);
          wmma::load_matrix_sync(b, p.wproj + (size_t)k0 * C + h * hd + d0, C);
          wmma::mma_sync(acc, a, b, acc);
        }
        wmma::store_matrix_sync(stage, acc, 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32)
          dab[(m * 16 + e / 16) * L.ldh + d0 + e % 16] =
              __float2bfloat16(stage[e]);
      }
      __syncwarp();
    }
    __syncthreads();

    // b. scores S = q k^T and dP = dattn_h v^T (64 x 64 fp32 each)
    for (int t = warp; t < 32; t += kWarps) {
      const int m = (t % 16) / 4;
      const int n = t % 4;
      const __nv_bfloat16* left = t < 16 ? qb : dab;
      const __nv_bfloat16* right = t < 16 ? kb : vb;
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
      for (int k0 = 0; k0 < hd; k0 += 16) {
        FragA a;
        FragBCol b;
        wmma::load_matrix_sync(a, left + (m * 16) * L.ldh + k0, L.ldh);
        wmma::load_matrix_sync(b, right + (n * 16) * L.ldh + k0, L.ldh);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync((t < 16 ? Sf : Df) + (m * 16) * L.lds + n * 16,
                              acc, L.lds, wmma::mem_row_major);
    }
    __syncthreads();

    // c. softmax over the N real keys in fp32 and its vjp on the fp32
    //    probabilities: ds = P * (dP - rowsum(dP * P)); P and ds to bf16
    //    (0 for padded keys and rows); dbias += ds
    const float* bh = bias_w + (size_t)h * N * N;
    float* dbh = p.dbias + (size_t)h * N * N;
#pragma unroll
    for (int i = 0; i < kRows / kWarps; ++i) {
      const int r = warp + kWarps * i;
      const bool c0 = r < N && lane < N;
      const bool c1 = r < N && lane + 32 < N;
      const float s0 = c0 ? Sf[r * L.lds + lane] + bh[r * N + lane] : -INFINITY;
      const float s1 =
          c1 ? Sf[r * L.lds + lane + 32] + bh[r * N + lane + 32] : -INFINITY;
      const float mx = fmmt::warp_max(fmaxf(s0, s1));
      const float e0 = c0 ? expf(s0 - mx) : 0.f;
      const float e1 = c1 ? expf(s1 - mx) : 0.f;
      const float sum = fmmt::warp_sum(e0 + e1);
      const float inv = r < N ? 1.f / sum : 0.f;
      const float p0 = e0 * inv;
      const float p1 = e1 * inv;
      const float dp0 = c0 ? Df[r * L.lds + lane] : 0.f;
      const float dp1 = c1 ? Df[r * L.lds + lane + 32] : 0.f;
      const float dot = fmmt::warp_sum(p0 * dp0 + p1 * dp1);
      const float ds0 = p0 * (dp0 - dot);
      const float ds1 = p1 * (dp1 - dot);
      Pb[r * L.ldp + lane] = __float2bfloat16(p0);
      Pb[r * L.ldp + lane + 32] = __float2bfloat16(p1);
      dSb[r * L.ldp + lane] = __float2bfloat16(ds0);
      dSb[r * L.ldp + lane + 32] = __float2bfloat16(ds1);
      if (c0) atomicAdd(dbh + r * N + lane, ds0);
      if (c1) atomicAdd(dbh + r * N + lane + 32, ds1);
    }
    __syncthreads();

    // d. four 64 x hd products with K = 64:
    //    0: dq = (ds k) * scale   1: dk = ds^T q   2: dv = P^T dattn_h
    //    3: attn_h = P v
    for (int t = warp; t < 4 * 4 * htiles; t += kWarps) {
      const int which = t / (4 * htiles);
      const int m = (t % (4 * htiles)) / htiles;
      const int d0 = (t % htiles) * 16;
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
      for (int k0 = 0; k0 < kRows; k0 += 16) {
        FragBRow b;
        const __nv_bfloat16* right =
            which == 0 ? kb : (which == 1 ? qb : (which == 2 ? dab : vb));
        wmma::load_matrix_sync(b, right + k0 * L.ldh + d0, L.ldh);
        if (which == 1 || which == 2) {
          FragACol a;   // transposed left operand: A[m][k] = left[k][m]
          wmma::load_matrix_sync(
              a, (which == 1 ? dSb : Pb) + k0 * L.ldp + m * 16, L.ldp);
          wmma::mma_sync(acc, a, b, acc);
        } else {
          FragA a;
          wmma::load_matrix_sync(
              a, (which == 0 ? dSb : Pb) + (m * 16) * L.ldp + k0, L.ldp);
          wmma::mma_sync(acc, a, b, acc);
        }
      }
      wmma::store_matrix_sync(stage, acc, 16, wmma::mem_row_major);
      __syncwarp();
      if (which == 0)
        for (int e = lane; e < 256; e += 32) stage[e] *= scale;
      __syncwarp();
      const int col = h * hd + d0;          // channel of the tile's column 0
      if (which < 3) {
        for (int e = lane; e < 256; e += 32) {
          const int r = m * 16 + e / 16;
          p.dqkv_out[((size_t)w * kRows + r) * 3 * C + which * C + col +
                     e % 16] = __float2bfloat16(stage[e]);
        }
      } else {
        for (int e = lane; e < 256; e += 32) {
          const int r = m * 16 + e / 16;
          p.attn_out[((size_t)w * kRows + r) * C + col + e % 16] =
              __float2bfloat16(stage[e]);
        }
      }
      __syncwarp();
    }
    __syncthreads();

  }

  // 2. dxn and the LN backward
  float sg[kMaxCols], sb[kMaxCols];
#pragma unroll
  for (int j = 0; j < kMaxCols; ++j) sg[j] = sb[j] = 0.f;
  // dxn = dqkv Wqkv in 16-row tiles from the emitted dqkv (written by this
  // block, ordered by the head loop's last __syncthreads), staged over dyk
  const __nv_bfloat16* dq_w = p.dqkv_out + (size_t)w * kRows * 3 * C;
  for (int mt = 0; mt * 16 < N; ++mt) {
    for (int n = warp; n < ctiles; n += kWarps) {
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
      for (int k0 = 0; k0 < 3 * C; k0 += 16) {
        FragA a;
        FragBRow b;
        wmma::load_matrix_sync(a, dq_w + (size_t)(mt * 16) * 3 * C + k0,
                               3 * C);
        wmma::load_matrix_sync(b, p.wqkv + (size_t)k0 * C + n * 16, C);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(ys + n * 16, acc, L.ldy, wmma::mem_row_major);
    }
    __syncthreads();
    ln_backward_rows(ys, L.ldy, mt * 16, min(16, N - mt * 16), xw, dyw, dxw,
                     p.gamma, smean, srstd, C, tid, sg, sb);
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < kMaxCols; ++j) {
    const int c = tid + j * kThreads;
    if (c < C) {
      atomicAdd(p.dgamma + c, sg[j]);
      atomicAdd(p.dbeta + c, sb[j]);
    }
  }
}

int launch(const Args& a, int W, void* stream) {
  const size_t bytes = layout(a.C, a.C / a.heads).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      fused_block_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_block_bwd_kernel<<<W, kThreads, bytes,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int N, int C, int heads) {
  return N > kRows || N < 1 || C % 16 != 0 || C > kMaxC || C % heads != 0 ||
         (C / heads) % 16 != 0;
}

}  // namespace

// Shared-memory bytes one block needs; the wrapper checks this against the
// card's limit before launching.
FMMT_API long long fmmt_fused_attention_block_bwd_spill_smem(int C,
                                                             int heads) {
  return static_cast<long long>(layout(C, C / heads).bytes);
}

FMMT_API int fmmt_fused_attention_block_bwd_spill(
    const void* x, const void* dy, const void* gamma, const void* beta,
    const void* wqkv, const void* bqkv, const void* wproj, const void* bias,
    const void* keep, void* dx, void* dgamma, void* dbeta, void* dbias,
    void* xn_out, void* dqkv_out, void* attn_out, int W, int N, int C,
    int heads, int nW, float eps, void* stream) {
  if (bad_shape(N, C, heads)) return static_cast<int>(cudaErrorInvalidValue);
  Args a = {};
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.dy = static_cast<const __nv_bfloat16*>(dy);
  a.gamma = static_cast<const __nv_bfloat16*>(gamma);
  a.beta = static_cast<const __nv_bfloat16*>(beta);
  a.wqkv = static_cast<const __nv_bfloat16*>(wqkv);
  a.bqkv = static_cast<const __nv_bfloat16*>(bqkv);
  a.wproj = static_cast<const __nv_bfloat16*>(wproj);
  a.bias = static_cast<const float*>(bias);
  a.keep = static_cast<const float*>(keep);
  a.dx = static_cast<__nv_bfloat16*>(dx);
  a.dgamma = static_cast<float*>(dgamma);
  a.dbeta = static_cast<float*>(dbeta);
  a.dbias = static_cast<float*>(dbias);
  a.xn_out = static_cast<__nv_bfloat16*>(xn_out);
  a.dqkv_out = static_cast<__nv_bfloat16*>(dqkv_out);
  a.attn_out = static_cast<__nv_bfloat16*>(attn_out);
  a.N = N;
  a.C = C;
  a.heads = heads;
  a.nW = nW;
  a.eps = eps;
  return launch(a, W, stream);
}
