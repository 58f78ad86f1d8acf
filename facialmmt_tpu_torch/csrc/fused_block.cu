// Swin block attention half, window-resident:
//   out[w] = x[w] + keep[w] * (proj(MHA(LN1(x[w])) + bias[w % nW]))
// x (W,N,C) bf16 tokens in window layout; LN1 gamma/beta (C); packed qkv
// weight (3C,C) and bias (3C) in torch Linear layout, q|k|v on the output
// axis, q scaled by hd^-0.5 in-kernel; proj weight (C,C) and bias (C), all
// bf16.  bias (nW,h,N,N) fp32 is the relative-position bias plus the
// shifted-window mask; window w reads row w % nW, so windows must arrive
// faces-major (window_partition order).  keep (W,) fp32 is optional.
// N <= 64; C and the head dim are multiples of 16.
//
// Replaces: facialmmt_tpu/ops/pallas/fused_block.py::fused_attention_block.
//
// What bounds it on the H100: per window the work is the qkv and proj GEMMs
// (8*N*C*C FLOP) plus the attention (4*N*N*C FLOP), against 4*N*C bytes of
// token traffic; left to separate library calls, LN1, qkv, the head
// transposes, the attention, proj and the residual each make a full pass over
// the (T, C) activations in device memory.  Everything from the LN read to the
// residual write stays in shared memory here, so the only device-memory
// traffic is x in, out out and the (L2-resident) weights.
//
// What the design does about it: one block (8 warps) owns one window, and
// every matmul runs on the tensor cores (bf16 16x16x16 mma, fp32
// accumulation).  The window's N = 49 rows are padded to 64 (four 16-row
// tiles): padded rows of LN1 are zero, and padded keys get probability 0 in
// the softmax, which runs over exactly N keys.  At stage 3 (C=768, 24 heads) a
// whole (49, 3C) qkv tile in bf16 would be 225 KB, so the block loops over
// heads: per head it projects that head's q/k/v (64 x hd each), forms the
// 64 x 64 scores, the softmax and P v, and writes the head's output into a
// (64, C) bf16 buffer; proj runs once after the last head.  The score buffer
// doubles as the probability buffer and as per-warp staging for the mma
// epilogues, which keeps stage 3 inside 227 KB of shared memory.
//
// Rounding follows the JAX kernel: xn, q (after scale), k, v, the softmax
// probabilities and the concatenated head outputs are rounded to bf16; the
// residual add is in fp32 and rounded once.
#include "common.cuh"

#include <math.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 64;   // window rows, padded

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                                wmma::col_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                                wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

struct Layout {
  int ldx;    // bf16 row stride of xn / attn (C + 8)
  int ldh;    // bf16 row stride of q / k / v (hd + 8)
  int lds;    // fp32 row stride of the scores (kRows + 4)
  int ldp;    // bf16 row stride of the probabilities (kRows + 8)
  size_t off_attn, off_qkv, off_s, off_stage, bytes;
};

__host__ __device__ inline Layout layout(int C, int hd) {
  Layout L;
  L.ldx = C + 8;
  L.ldh = hd + 8;
  L.lds = kRows + 4;
  L.ldp = kRows + 8;
  const size_t x_bytes = (size_t)kRows * L.ldx * sizeof(__nv_bfloat16);
  L.off_attn = x_bytes;
  L.off_qkv = 2 * x_bytes;
  L.off_s = L.off_qkv + 3 * (size_t)kRows * L.ldh * sizeof(__nv_bfloat16);
  // the score region holds either the fp32 scores, or the bf16
  // probabilities followed by one 16x16 fp32 staging tile per warp
  const size_t s_bytes = (size_t)kRows * L.lds * sizeof(float);
  const size_t p_bytes = (size_t)kRows * L.ldp * sizeof(__nv_bfloat16);
  const size_t stage_bytes = (size_t)kWarps * 256 * sizeof(float);
  L.off_stage = L.off_s + p_bytes;
  L.bytes = L.off_s + (s_bytes > p_bytes + stage_bytes ? s_bytes
                                                       : p_bytes + stage_bytes);
  return L;
}

__global__ void __launch_bounds__(kThreads)
fused_block_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ gamma,
                   const __nv_bfloat16* __restrict__ beta,
                   const __nv_bfloat16* __restrict__ wqkv,
                   const __nv_bfloat16* __restrict__ bqkv,
                   const __nv_bfloat16* __restrict__ wproj,
                   const __nv_bfloat16* __restrict__ bproj,
                   const float* __restrict__ bias,
                   const float* __restrict__ keep,
                   __nv_bfloat16* __restrict__ out, int N, int C, int heads,
                   int nW, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int hd = C / heads;
  const Layout L = layout(C, hd);
  __nv_bfloat16* xn = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* attn = reinterpret_cast<__nv_bfloat16*>(smem + L.off_attn);
  __nv_bfloat16* qb = reinterpret_cast<__nv_bfloat16*>(smem + L.off_qkv);
  __nv_bfloat16* kb = qb + kRows * L.ldh;
  __nv_bfloat16* vb = kb + kRows * L.ldh;
  float* S = reinterpret_cast<float*>(smem + L.off_s);
  __nv_bfloat16* P = reinterpret_cast<__nv_bfloat16*>(smem + L.off_s);

  const int w = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  float* stage = reinterpret_cast<float*>(smem + L.off_stage) + warp * 256;
  const __nv_bfloat16* xw = x + (size_t)w * N * C;
  const float scale = rsqrtf((float)hd);
  const float* bias_w = bias + (size_t)(w % nW) * heads * N * N;

  // 1. LN1 -> xn (bf16), one warp per row; padded rows are zero
  for (int n = warp; n < kRows; n += kWarps) {
    if (n < N) {
      fmmt::warp_layernorm_row(xw + (size_t)n * C, gamma, beta,
                               xn + (size_t)n * L.ldx, C, eps, lane);
    } else {
      for (int i = lane; i < C; i += 32)
        xn[(size_t)n * L.ldx + i] = __float2bfloat16(0.f);
    }
  }
  __syncthreads();

  const int qkv_cols = 3 * hd / 16;
  for (int h = 0; h < heads; ++h) {
    // 2a. this head's q | k | v (64 x hd each) = xn @ Wqkv[rows]^T + bias
    for (int t = warp; t < 4 * qkv_cols; t += kWarps) {
      const int m = t / qkv_cols;
      const int n0 = (t % qkv_cols) * 16;      // column in [q | k | v]
      const int which = n0 / hd;
      const int d0 = n0 % hd;
      const int o0 = which * C + h * hd + d0;  // weight row of column 0
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
      for (int k0 = 0; k0 < C; k0 += 16) {
        FragA a;
        FragBCol b;
        wmma::load_matrix_sync(a, xn + (size_t)(m * 16) * L.ldx + k0, L.ldx);
        wmma::load_matrix_sync(b, wqkv + (size_t)o0 * C + k0, C);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(stage, acc, 16, wmma::mem_row_major);
      __syncwarp();
      __nv_bfloat16* dst = which == 0 ? qb : (which == 1 ? kb : vb);
      for (int e = lane; e < 256; e += 32) {
        const int r = m * 16 + e / 16;
        const int d = d0 + e % 16;
        float v = stage[e] + fmmt::bf(bqkv[o0 + e % 16]);
        if (which == 0) v *= scale;
        dst[r * L.ldh + d] = __float2bfloat16(r < N ? v : 0.f);
      }
      __syncwarp();
    }
    __syncthreads();

    // 2b. scores S = q k^T (64 x 64, fp32)
    for (int t = warp; t < 16; t += kWarps) {
      const int m = t / 4;
      const int n = t % 4;
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
      for (int k0 = 0; k0 < hd; k0 += 16) {
        FragA a;
        FragBCol b;
        wmma::load_matrix_sync(a, qb + (m * 16) * L.ldh + k0, L.ldh);
        wmma::load_matrix_sync(b, kb + (n * 16) * L.ldh + k0, L.ldh);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(S + (m * 16) * L.lds + n * 16, acc, L.lds,
                              wmma::mem_row_major);
    }
    __syncthreads();

    // 2c. + bias, softmax over the N real keys in fp32, probabilities in
    //     bf16 (0 for padded keys and rows).  P overlays S: read all, sync,
    //     write.
    const float* bh = bias_w + (size_t)h * N * N;
    float p[kRows / kWarps][2];
#pragma unroll
    for (int i = 0; i < kRows / kWarps; ++i) {
      const int r = warp + kWarps * i;
      float s0 = -INFINITY, s1 = -INFINITY;
      if (r < N) {
        if (lane < N) s0 = S[r * L.lds + lane] + bh[r * N + lane];
        if (lane + 32 < N) s1 = S[r * L.lds + lane + 32] + bh[r * N + lane + 32];
      }
      const float mx = fmmt::warp_max(fmaxf(s0, s1));
      const float e0 = (r < N && lane < N) ? expf(s0 - mx) : 0.f;
      const float e1 = (r < N && lane + 32 < N) ? expf(s1 - mx) : 0.f;
      const float sum = fmmt::warp_sum(e0 + e1);
      const float inv = r < N ? 1.f / sum : 0.f;
      p[i][0] = e0 * inv;
      p[i][1] = e1 * inv;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kRows / kWarps; ++i) {
      const int r = warp + kWarps * i;
      P[r * L.ldp + lane] = __float2bfloat16(p[i][0]);
      P[r * L.ldp + lane + 32] = __float2bfloat16(p[i][1]);
    }
    __syncthreads();

    // 2d. head output P v (64 x hd) -> attn[:, h*hd : (h+1)*hd] in bf16
    for (int t = warp; t < 4 * (hd / 16); t += kWarps) {
      const int m = t / (hd / 16);
      const int n = t % (hd / 16);
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
      for (int k0 = 0; k0 < kRows; k0 += 16) {
        FragA a;
        FragBRow b;
        wmma::load_matrix_sync(a, P + (m * 16) * L.ldp + k0, L.ldp);
        wmma::load_matrix_sync(b, vb + k0 * L.ldh + n * 16, L.ldh);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(stage, acc, 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32)
        attn[(size_t)(m * 16 + e / 16) * L.ldx + h * hd + n * 16 + e % 16] =
            __float2bfloat16(stage[e]);
      __syncwarp();
    }
    __syncthreads();  // q/k/v, S and P are rewritten by the next head
  }

  // 3. proj + bias, keep scale, fp32 residual, straight to the output
  const float kw = keep ? keep[w] : 1.f;
  __nv_bfloat16* ow = out + (size_t)w * N * C;
  for (int t = warp; t < 4 * (C / 16); t += kWarps) {
    const int m = t / (C / 16);
    const int n = t % (C / 16);
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
    for (int k0 = 0; k0 < C; k0 += 16) {
      FragA a;
      FragBCol b;
      wmma::load_matrix_sync(a, attn + (size_t)(m * 16) * L.ldx + k0, L.ldx);
      wmma::load_matrix_sync(b, wproj + (size_t)(n * 16) * C + k0, C);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(stage, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = m * 16 + e / 16;
      const int c = n * 16 + e % 16;
      if (r < N) {
        const float y = (stage[e] + fmmt::bf(bproj[c])) * kw;
        ow[(size_t)r * C + c] =
            __float2bfloat16(y + fmmt::bf(xw[(size_t)r * C + c]));
      }
    }
    __syncwarp();
  }
}

}  // namespace

// Shared-memory bytes one block needs; the wrapper checks this against the
// card's limit before launching.
FMMT_API long long fmmt_fused_attention_block_smem(int N, int C, int heads) {
  return static_cast<long long>(layout(C, C / heads).bytes);
}

FMMT_API int fmmt_fused_attention_block(
    const void* x, const void* gamma, const void* beta, const void* wqkv,
    const void* bqkv, const void* wproj, const void* bproj, const void* bias,
    const void* keep, void* out, int W, int N, int C, int heads, int nW,
    float eps, void* stream) {
  if (N > kRows || C % 16 != 0 || C % heads != 0 || (C / heads) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = layout(C, C / heads).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      fused_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_block_kernel<<<W, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(gamma),
      static_cast<const __nv_bfloat16*>(beta),
      static_cast<const __nv_bfloat16*>(wqkv),
      static_cast<const __nv_bfloat16*>(bqkv),
      static_cast<const __nv_bfloat16*>(wproj),
      static_cast<const __nv_bfloat16*>(bproj),
      static_cast<const float*>(bias), static_cast<const float*>(keep),
      static_cast<__nv_bfloat16*>(out), N, C, heads, nW, eps);
  return static_cast<int>(cudaGetLastError());
}
