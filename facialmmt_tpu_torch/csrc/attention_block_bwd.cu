// Backward of the Swin block attention half, resident variant (C <= 384):
//   out[w] = x[w] + keep[w] * (proj(MHA(LN1(x[w])) + bias[w % nW]))
// From x and the output gradient dy (both (W,N,C) bf16) the kernels recompute
// LN1, qkv and the softmax and return dx (W,N,C) bf16 and, in fp32, dgamma |
// dbeta | dbproj (3C), dWqkv (3C,C), dbqkv (3C), dWproj (C,C) and the bias
// cotangent summed over ALL windows, dbias (h,N,N).  Weights are in torch
// Linear layout, wqkv (3C,C) with q|k|v on the output axis, wproj (C,C).
// keep (W,) fp32 is optional and gets no gradient: the residual gradient is
// dy, the branch gradient dy * keep.
//
// Replaces: facialmmt_tpu/ops/pallas/fused_block.py::_bwd_impl_pallas (the
// spill variant, _bwd_impl_spill, is csrc/fused_block_bwd.cu).
//
// What bounds it on the H100: per token 22 C^2 + 12 N C FLOP of products
// (qkv recomputed, dattn, dxn, dWqkv, dWproj, and the attention's scores,
// P v, dP, dv, dq, dk): 96-170 GFLOP per call at stages 0-2 of a 150-image
// batch (0.10-0.17 ms at 989 TFLOP/s), against the scratch the steps hand
// each other through device memory: xn, dyk, dattn and attn (T,C) bf16, qkv
// and dqkv (T,3C) bf16, the fp32 dxn (T,C), about 30 T C bytes (1.35 GB,
// 0.40 ms at 3.35 TB/s, at stage 0 where T = 470,400 and C = 96; 0.34 GB at
// stage 2).  So it is bound by the bytes at every stage it serves.  The
// first version of this kernel (one block a window walking the heads with
// wmma, every window reloading all four weight matrices from L2, each head's
// dWqkv and dWproj slices K = 64 products added by fp32 atomics) ran at
// 2-4 % of that bound and gave other bits every launch.
//
// What the design does about it: device kernels on tile_gemm.cuh's tiled
// wgmma product and one window pass, one wrapper call (one launch in
// PERF.md's counts).  The 49-row windows are packed 128 rows to a product
// tile, with no padding; padding exists only inside the window pass.
//   1. the rows' LN1 statistics, then xn = bf16(LN1(x)) and dyk = bf16(dy
//      keep[w]) (swin_bwd.cuh::prep_rows);
//   2. qkv = LN1(x) Wqkv^T + bqkv, q scaled: the forward's kScaleQ product
//      with its LayerNorm prologue, so it rounds exactly as the forward;
//   3. dattn = bf16(dyk Wproj) (B = Wproj^T, a transposed copy the wrapper
//      makes);
//   4. the window pass: one block a head and a fixed run of windows, 4 warps
//      of 16 query rows each, in mma.sync registers as the forward's
//      attention pass: s = q k^T + bias[w % nW] and the fp32 softmax p,
//      attn_h = bf16(p) v (to attn, for dWproj), dP = dattn_h v^T,
//      ds = p (dP - rowsum(dP p)), dq = bf16(ds) k scale; then, from
//      bf16(p) and bf16(ds) staged in shared memory, dk = bf16(ds)^T q and
//      dv = bf16(p)^T dattn_h for the warp's 16 key rows; dq | dk | dv to
//      dqkv (T,3C) bf16.  Across its windows the block keeps an fp32 (N,N)
//      sum of ds (each element owned by one lane) and per-warp column sums
//      of the fp32 dq | dk | dv, and writes them as its partials of dbias and
//      dbqkv;
//   5. dxn = dqkv Wqkv (B = Wqkv^T, the wrapper's copy), fp32 out, and the
//      LayerNorm backward (swin_bwd.cuh::ln_bwd_rows, the MLP backward's),
//      with the column partials of dgamma, dbeta and dbproj = sum dy keep;
//   6. dWqkv = dqkv^T xn and dWproj = dyk^T attn as split-T products, and
//      sum_rows adds every set of partials in a fixed order.
// No step adds with atomics: two launches give the same bits.
//
// Rounding follows the JAX kernel: xn, q (after the scale), k, v, dyk,
// dattn, the probabilities, ds, dq, dk, dv and attn are rounded to bf16 as
// matmul operands; the softmax, its vjp on the fp32 probabilities, every
// accumulation and the LN backward are fp32; dbqkv sums the unrounded fp32
// dq | dk | dv (the spill variant sums the rounded ones) and dbias the fp32
// ds.
#include "swin_bwd.cuh"

#include <math.h>
#include <stdint.h>

namespace {

using fmmt::bwd::Arena;
namespace gemm = fmmt::gemm;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 64;           // window rows, padded
constexpr int kLdp = kRows + 8;     // bf16 row stride of the p and ds tiles
constexpr int kBlocksWanted = 8 * 132;

// q, k, v, dattn tiles (64 x hd + 8 bf16) | p, ds tiles (64 x 72 bf16) |
// the fp32 ds sum (64 x 64) | per-warp column sums (4 x 3 hd fp32)
struct WinLayout {
  size_t off_p, off_ds, off_db, off_col, bytes;
};

__host__ __device__ inline WinLayout win_layout(int hd) {
  WinLayout L;
  L.off_p = 4 * (size_t)kRows * (hd + 8) * sizeof(__nv_bfloat16);
  L.off_ds = L.off_p + (size_t)kRows * kLdp * sizeof(__nv_bfloat16);
  L.off_db = L.off_ds + (size_t)kRows * kLdp * sizeof(__nv_bfloat16);
  L.off_col = L.off_db + (size_t)kRows * kRows * sizeof(float);
  L.bytes = L.off_col + (size_t)kWarps * 3 * hd * sizeof(float);
  return L;
}

// The window pass's plan: blocks (head, g), block g taking windows
// g * per .. g * per + per - 1; about kBlocksWanted blocks.
struct WinPlan {
  int groups, per;
};

inline WinPlan win_plan(int W, int heads) {
  int groups = (kBlocksWanted + heads - 1) / heads;
  groups = groups < W ? groups : W;
  WinPlan p;
  p.per = (W + groups - 1) / groups;
  p.groups = (W + p.per - 1) / p.per;
  return p;
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void store32(__nv_bfloat16* p, uint32_t v) {
  *reinterpret_cast<uint32_t*>(p) = v;
}

// Sum over the 8 lanes of a fragment column (lanes of equal l % 4): the
// 16 rows' total lands in every one of them.
__device__ __forceinline__ float col_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

struct WinArgs {
  const __nv_bfloat16* qkv;    // (T, 3C), q scaled
  const __nv_bfloat16* dattn;  // (T, C)
  const float* bias;           // (nW, h, N, N)
  __nv_bfloat16* attn;         // (T, C)
  __nv_bfloat16* dqkv;         // (T, 3C)
  float* dbqkv_part;           // (groups, 3C)
  float* dbias_part;           // (groups, h, N, N)
  int W, N, C, heads, nW, per;
  float scale;
};

__global__ void __launch_bounds__(kThreads) window_bwd_kernel(const WinArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int N = p.N, C = p.C, heads = p.heads;
  const int hd = C / heads;
  const int ldh = hd + 8;
  const int cpr = hd / 8;
  const WinLayout L = win_layout(hd);
  const int head = blockIdx.x;
  const int g = blockIdx.y;
  const int w0 = g * p.per;
  const int w1 = min(p.W, w0 + p.per);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gid = lane / 4;
  const int tig = lane % 4;
  __nv_bfloat16* qb = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* kb = qb + kRows * ldh;
  __nv_bfloat16* vb = kb + kRows * ldh;
  __nv_bfloat16* ab = vb + kRows * ldh;     // dattn_h
  __nv_bfloat16* pb = reinterpret_cast<__nv_bfloat16*>(smem + L.off_p);
  __nv_bfloat16* sb = reinterpret_cast<__nv_bfloat16*>(smem + L.off_ds);
  float* dbacc = reinterpret_cast<float*>(smem + L.off_db);
  float* colacc = reinterpret_cast<float*>(smem + L.off_col) + warp * 3 * hd;
  const int r0 = warp * 16;
  const int row0 = r0 + gid;
  const int row1 = row0 + 8;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int i = tid; i < kRows * kRows; i += kThreads) dbacc[i] = 0.f;
  for (int i = lane; i < 3 * hd; i += 32) colacc[i] = 0.f;

  for (int w = w0; w < w1; ++w) {
    const size_t tok0 = (size_t)w * N;
    // 1. q, k, v and dattn of the head, rows N..63 zero
    for (int i = tid; i < kRows * cpr; i += kThreads) {
      const int r = i / cpr;
      const int c = (i % cpr) * 8;
      const bool real = r < N;
      const size_t t = tok0 + (real ? r : 0);
      const __nv_bfloat16* src = p.qkv + t * 3 * C + head * hd + c;
      *reinterpret_cast<uint4*>(qb + r * ldh + c) =
          real ? *reinterpret_cast<const uint4*>(src) : zero;
      *reinterpret_cast<uint4*>(kb + r * ldh + c) =
          real ? *reinterpret_cast<const uint4*>(src + C) : zero;
      *reinterpret_cast<uint4*>(vb + r * ldh + c) =
          real ? *reinterpret_cast<const uint4*>(src + 2 * C) : zero;
      *reinterpret_cast<uint4*>(ab + r * ldh + c) =
          real ? *reinterpret_cast<const uint4*>(p.dattn + t * C + head * hd + c)
               : zero;
    }
    __syncthreads();

    // 2. scores s = q k^T and dP = dattn_h v^T of this warp's 16 rows
    float sc[kRows / 8][4], dp[kRows / 8][4];
#pragma unroll
    for (int j = 0; j < kRows / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
    for (int ks = 0; ks < hd / 16; ++ks) {
      const int c = ks * 16 + 2 * tig;
      const uint32_t aq[4] = {ld32(qb + row0 * ldh + c), ld32(qb + row1 * ldh + c),
                              ld32(qb + row0 * ldh + c + 8),
                              ld32(qb + row1 * ldh + c + 8)};
      const uint32_t aa[4] = {ld32(ab + row0 * ldh + c), ld32(ab + row1 * ldh + c),
                              ld32(ab + row0 * ldh + c + 8),
                              ld32(ab + row1 * ldh + c + 8)};
#pragma unroll
      for (int j = 0; j < kRows / 8; ++j) {
        if (8 * j < N) {
          const __nv_bfloat16* kr = kb + (8 * j + gid) * ldh + c;
          const __nv_bfloat16* vr = vb + (8 * j + gid) * ldh + c;
          fmmt::mma_16816(sc[j], aq, ld32(kr), ld32(kr + 8));
          fmmt::mma_16816(dp[j], aa, ld32(vr), ld32(vr + 8));
        }
      }
    }

    // 3. + bias, the fp32 softmax over the N real keys (as the forward);
    //    lane (gid, tig) holds columns 8j + 2 tig, + 1 of rows row0, row1
    const float* bias_u = p.bias + ((size_t)(w % p.nW) * heads + head) * N * N;
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < kRows / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * tig + e;
        const bool key = col < N;
        sc[j][e] = (key && row0 < N) ? sc[j][e] + bias_u[row0 * N + col]
                                     : -INFINITY;
        sc[j][2 + e] = (key && row1 < N) ? sc[j][2 + e] + bias_u[row1 * N + col]
                                         : -INFINITY;
        m0 = fmaxf(m0, sc[j][e]);
        m1 = fmaxf(m1, sc[j][2 + e]);
      }
    }
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
    if (row0 >= N) m0 = 0.f;
    if (row1 >= N) m1 = 0.f;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < kRows / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[j][e] = expf(sc[j][e] - m0);
        sc[j][2 + e] = expf(sc[j][2 + e] - m1);
        sum0 += sc[j][e];
        sum1 += sc[j][2 + e];
      }
    }
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
    const float inv0 = row0 < N ? 1.f / sum0 : 0.f;
    const float inv1 = row1 < N ? 1.f / sum1 : 0.f;

    // 4. p (fp32) and its vjp ds = p (dP - rowsum(dP p)); the fp32 ds into
    //    the block's dbias sum; bf16(p) and bf16(ds) as A fragments and into
    //    the shared tiles for the transposed products
    float dot0 = 0.f, dot1 = 0.f;
#pragma unroll
    for (int j = 0; j < kRows / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[j][e] *= inv0;
        sc[j][2 + e] *= inv1;
        dot0 = fmaf(sc[j][e], dp[j][e], dot0);
        dot1 = fmaf(sc[j][2 + e], dp[j][2 + e], dot1);
      }
    }
    dot0 += __shfl_xor_sync(0xffffffffu, dot0, 1);
    dot0 += __shfl_xor_sync(0xffffffffu, dot0, 2);
    dot1 += __shfl_xor_sync(0xffffffffu, dot1, 1);
    dot1 += __shfl_xor_sync(0xffffffffu, dot1, 2);
    uint32_t pr[kRows / 8][2], dsr[kRows / 8][2];
#pragma unroll
    for (int j = 0; j < kRows / 8; ++j) {
      const int col = 8 * j + 2 * tig;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        dp[j][e] = sc[j][e] * (dp[j][e] - dot0);
        dp[j][2 + e] = sc[j][2 + e] * (dp[j][2 + e] - dot1);
        if (col + e < N) {
          if (row0 < N) dbacc[row0 * kRows + col + e] += dp[j][e];
          if (row1 < N) dbacc[row1 * kRows + col + e] += dp[j][2 + e];
        }
      }
      pr[j][0] = fmmt::pack_bf16(sc[j][0], sc[j][1]);
      pr[j][1] = fmmt::pack_bf16(sc[j][2], sc[j][3]);
      dsr[j][0] = fmmt::pack_bf16(dp[j][0], dp[j][1]);
      dsr[j][1] = fmmt::pack_bf16(dp[j][2], dp[j][3]);
      store32(pb + row0 * kLdp + col, pr[j][0]);
      store32(pb + row1 * kLdp + col, pr[j][1]);
      store32(sb + row0 * kLdp + col, dsr[j][0]);
      store32(sb + row1 * kLdp + col, dsr[j][1]);
    }

    // 5. attn_h = bf16(p) v and dq = bf16(ds) k scale for the warp's rows;
    //    attn and dq (bf16) out, the fp32 dq's column sums kept
    for (int c0 = 0; c0 < hd; c0 += 16) {
      float oa[2][4], oq[2][4];
#pragma unroll
      for (int jn = 0; jn < 2; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) oa[jn][e] = oq[jn][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kRows / 16; ++ks) {
        if (16 * ks < N) {
          const uint32_t a[4] = {pr[2 * ks][0], pr[2 * ks][1],
                                 pr[2 * ks + 1][0], pr[2 * ks + 1][1]};
          const uint32_t d[4] = {dsr[2 * ks][0], dsr[2 * ks][1],
                                 dsr[2 * ks + 1][0], dsr[2 * ks + 1][1]};
#pragma unroll
          for (int jn = 0; jn < 2; ++jn) {
            uint32_t b0, b1;
            const int off = (16 * ks + (lane & 15)) * ldh + c0 + 8 * jn;
            fmmt::ldmatrix_x2_trans(b0, b1, vb + off);
            fmmt::mma_16816(oa[jn], a, b0, b1);
            fmmt::ldmatrix_x2_trans(b0, b1, kb + off);
            fmmt::mma_16816(oq[jn], d, b0, b1);
          }
        }
      }
#pragma unroll
      for (int jn = 0; jn < 2; ++jn) {
        const int c = c0 + 8 * jn + 2 * tig;
#pragma unroll
        for (int e = 0; e < 4; ++e) oq[jn][e] *= p.scale;
        const float s0 = col_sum(oq[jn][0] + oq[jn][2]);
        const float s1 = col_sum(oq[jn][1] + oq[jn][3]);
        if (gid == 0) {
          colacc[c] += s0;
          colacc[c + 1] += s1;
        }
        const size_t ca = (size_t)head * hd + c;
        if (row0 < N) {
          store32(p.attn + (tok0 + row0) * C + ca,
                  fmmt::pack_bf16(oa[jn][0], oa[jn][1]));
          store32(p.dqkv + (tok0 + row0) * 3 * C + ca,
                  fmmt::pack_bf16(oq[jn][0], oq[jn][1]));
        }
        if (row1 < N) {
          store32(p.attn + (tok0 + row1) * C + ca,
                  fmmt::pack_bf16(oa[jn][2], oa[jn][3]));
          store32(p.dqkv + (tok0 + row1) * 3 * C + ca,
                  fmmt::pack_bf16(oq[jn][2], oq[jn][3]));
        }
      }
    }
    __syncthreads();   // every warp's bf16(p) and bf16(ds) rows are in

    // 6. dk = bf16(ds)^T q and dv = bf16(p)^T dattn_h for the warp's 16 key
    //    rows, contracting over the queries: the A fragments are the
    //    transposing loads of the ds and p tiles
    for (int c0 = 0; c0 < hd; c0 += 16) {
      float ok[2][4], ov[2][4];
#pragma unroll
      for (int jn = 0; jn < 2; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) ok[jn][e] = ov[jn][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kRows / 16; ++ks) {
        if (16 * ks < N) {
          const int aoff =
              (16 * ks + (lane % 8) + (lane / 16) * 8) * kLdp + r0 +
              ((lane / 8) % 2) * 8;
          uint32_t as[4], ap[4];
          fmmt::ldmatrix_x4_trans(as, sb + aoff);
          fmmt::ldmatrix_x4_trans(ap, pb + aoff);
#pragma unroll
          for (int jn = 0; jn < 2; ++jn) {
            uint32_t b0, b1;
            const int off = (16 * ks + (lane & 15)) * ldh + c0 + 8 * jn;
            fmmt::ldmatrix_x2_trans(b0, b1, qb + off);
            fmmt::mma_16816(ok[jn], as, b0, b1);
            fmmt::ldmatrix_x2_trans(b0, b1, ab + off);
            fmmt::mma_16816(ov[jn], ap, b0, b1);
          }
        }
      }
#pragma unroll
      for (int jn = 0; jn < 2; ++jn) {
        const int c = c0 + 8 * jn + 2 * tig;
        const float k0 = col_sum(ok[jn][0] + ok[jn][2]);
        const float k1 = col_sum(ok[jn][1] + ok[jn][3]);
        const float v0 = col_sum(ov[jn][0] + ov[jn][2]);
        const float v1 = col_sum(ov[jn][1] + ov[jn][3]);
        if (gid == 0) {
          colacc[hd + c] += k0;
          colacc[hd + c + 1] += k1;
          colacc[2 * hd + c] += v0;
          colacc[2 * hd + c + 1] += v1;
        }
        const size_t ck = (size_t)C + head * hd + c;
        const size_t cv = (size_t)2 * C + head * hd + c;
        if (row0 < N) {
          __nv_bfloat16* dst = p.dqkv + (tok0 + row0) * 3 * C;
          store32(dst + ck, fmmt::pack_bf16(ok[jn][0], ok[jn][1]));
          store32(dst + cv, fmmt::pack_bf16(ov[jn][0], ov[jn][1]));
        }
        if (row1 < N) {
          __nv_bfloat16* dst = p.dqkv + (tok0 + row1) * 3 * C;
          store32(dst + ck, fmmt::pack_bf16(ok[jn][2], ok[jn][3]));
          store32(dst + cv, fmmt::pack_bf16(ov[jn][2], ov[jn][3]));
        }
      }
    }
    __syncthreads();   // the tiles are rewritten by the next window
  }

  // the block's partials: dbias (N, N) of this head; dbqkv's columns of this
  // head, the 4 warps' sums added in warp order
  float* dbp = p.dbias_part + ((size_t)g * heads + head) * N * N;
  for (int i = tid; i < N * N; i += kThreads)
    dbp[i] = dbacc[(i / N) * kRows + i % N];
  const float* cols = reinterpret_cast<const float*>(smem + L.off_col);
  for (int i = tid; i < 3 * hd; i += kThreads) {
    float s = 0.f;
    for (int k = 0; k < kWarps; ++k) s += cols[k * 3 * hd + i];
    p.dbqkv_part[(size_t)g * 3 * C + (i / hd) * C + head * hd + i % hd] = s;
  }
}

struct Scratch {
  float2* st;
  __nv_bfloat16 *xn, *dyk, *qkv, *dattn, *attn, *dqkv;
  float *dxn, *ln_part, *dbqkv_part, *dbias_part, *dwqkv_part, *dwproj_part,
      *tmp;
};

Scratch plan(Arena& ar, int W, int N, int C, int heads) {
  const int T = W * N;
  const gemm::SplitPlan pq = gemm::split_plan(3 * C, C, T);
  const gemm::SplitPlan pp = gemm::split_plan(C, C, T);
  const WinPlan wp = win_plan(W, heads);
  const int ln_blocks = fmmt::bwd::ln_bwd_blocks(T);
  Scratch s;
  s.st = ar.take<float2>(T);
  s.xn = ar.take<__nv_bfloat16>((size_t)T * C);
  s.dyk = ar.take<__nv_bfloat16>((size_t)T * C);
  s.qkv = ar.take<__nv_bfloat16>((size_t)T * 3 * C);
  s.dattn = ar.take<__nv_bfloat16>((size_t)T * C);
  s.attn = ar.take<__nv_bfloat16>((size_t)T * C);
  s.dqkv = ar.take<__nv_bfloat16>((size_t)T * 3 * C);
  s.dxn = ar.take<float>((size_t)T * C);
  s.ln_part = ar.take<float>((size_t)ln_blocks * 3 * C);
  s.dbqkv_part = ar.take<float>((size_t)wp.groups * 3 * C);
  s.dbias_part = ar.take<float>((size_t)wp.groups * heads * N * N);
  s.dwqkv_part = ar.take<float>((size_t)pq.slices * 3 * C * C);
  s.dwproj_part = ar.take<float>((size_t)pp.slices * C * C);
  size_t tmp = gemm::sum_rows_scratch(pq.slices, 3LL * C * C);
  const size_t more[] = {gemm::sum_rows_scratch(pp.slices, (long long)C * C),
                         gemm::sum_rows_scratch(ln_blocks, 3 * C),
                         gemm::sum_rows_scratch(wp.groups, 3 * C),
                         gemm::sum_rows_scratch(wp.groups,
                                                (long long)heads * N * N)};
  for (size_t m : more) tmp = m > tmp ? m : tmp;
  s.tmp = ar.take<float>(tmp);
  return s;
}

bool bad_shape(int W, int N, int C, int heads, int nW) {
  return W < 1 || N < 1 || N > kRows || C % 16 != 0 || C < 16 || C > 384 ||
         heads < 1 || C % heads != 0 || (C / heads) % 16 != 0 || nW < 1 ||
         W % nW != 0;
}

}  // namespace

// Bytes of scratch one call needs (-1: a shape the kernels do not take); the
// wrapper allocates them.
FMMT_API long long fmmt_fused_attention_block_bwd_scratch(int W, int N, int C,
                                                          int heads, int nW) {
  if (bad_shape(W, N, C, heads, nW)) return -1;
  Arena ar{nullptr, 0};
  plan(ar, W, N, C, heads);
  return static_cast<long long>(ar.used);
}

// Shared-memory bytes the largest of the device kernels needs per block.
FMMT_API long long fmmt_fused_attention_block_bwd_smem(int C, int heads) {
  size_t most = win_layout(C / heads).bytes;
  const size_t more[] = {gemm::smem_bytes(3 * C, C, true),
                         gemm::smem_bytes(C, C, false),
                         gemm::smem_bytes(C, 3 * C, false),
                         gemm::wgrad_smem(C), fmmt::bwd::ln_bwd_smem(C)};
  for (size_t m : more) most = m > most ? m : most;
  return static_cast<long long>(most);
}

// wqkv (3C,C), bqkv (3C), wqkvt = Wqkv^T (C,3C), wprojt = Wproj^T (C,C), all
// bf16; bias (nW,h,N,N) and keep (W) fp32 (keep may be null); scratch of
// fmmt_fused_attention_block_bwd_scratch bytes.  Outputs: dx (W,N,C) bf16;
// dvec (3C) fp32 = dgamma | dbeta | dbproj; dwqkv (3C,C), dbqkv (3C), dwproj
// (C,C) and dbias (h,N,N) fp32.
FMMT_API int fmmt_fused_attention_block_bwd(
    const void* x, const void* dy, const void* gamma, const void* beta,
    const void* wqkv, const void* bqkv, const void* wqkvt, const void* wprojt,
    const void* bias, const void* keep, void* scratch, void* dx, void* dvec,
    void* dwqkv, void* dbqkv, void* dwproj, void* dbias, int W, int N, int C,
    int heads, int nW, float eps, void* stream) {
  if (bad_shape(W, N, C, heads, nW))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const int T = W * N;
  const int hd = C / heads;
  Arena ar{static_cast<unsigned char*>(scratch), 0};
  const Scratch s = plan(ar, W, N, C, heads);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* dyb = static_cast<const __nv_bfloat16*>(dy);
  const auto* gb = static_cast<const __nv_bfloat16*>(gamma);
  const auto* bb = static_cast<const __nv_bfloat16*>(beta);
  const auto* kp = static_cast<const float*>(keep);

  int err = gemm::launch_row_stats(xb, s.st, T, C, eps, cs);
  if (err) return err;
  err = fmmt::bwd::launch_prep_rows(xb, dyb, s.st, gb, bb, kp, N, s.xn, s.dyk,
                                    T, C, cs);
  if (err) return err;

  gemm::Args a{};
  a.a = xb;
  a.stats = s.st;
  a.gamma = gb;
  a.beta = bb;
  a.b = static_cast<const __nv_bfloat16*>(wqkv);
  a.bias = static_cast<const __nv_bfloat16*>(bqkv);
  a.out = s.qkv;
  a.M = T;
  a.N = 3 * C;
  a.K = C;
  a.keep_div = 1;
  a.q_cols = C;
  a.q_scale = 1.f / sqrtf(static_cast<float>(hd));
  err = gemm::launch<true, gemm::kScaleQ>(a, cs);
  if (err) return err;

  gemm::Args d{};
  d.a = s.dyk;
  d.b = static_cast<const __nv_bfloat16*>(wprojt);
  d.out = s.dattn;
  d.M = T;
  d.N = C;
  d.K = C;
  err = gemm::launch<false, gemm::kPlain>(d, cs);
  if (err) return err;

  const WinPlan wp = win_plan(W, heads);
  WinArgs w{};
  w.qkv = s.qkv;
  w.dattn = s.dattn;
  w.bias = static_cast<const float*>(bias);
  w.attn = s.attn;
  w.dqkv = s.dqkv;
  w.dbqkv_part = s.dbqkv_part;
  w.dbias_part = s.dbias_part;
  w.W = W;
  w.N = N;
  w.C = C;
  w.heads = heads;
  w.nW = nW;
  w.per = wp.per;
  w.scale = a.q_scale;
  const size_t bytes = win_layout(hd).bytes;
  cudaError_t cerr = cudaFuncSetAttribute(
      window_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  window_bwd_kernel<<<dim3(heads, wp.groups), kThreads, bytes, cs>>>(w);
  cerr = cudaGetLastError();
  if (cerr != cudaSuccess) return static_cast<int>(cerr);

  gemm::Args q{};
  q.a = s.dqkv;
  q.b = static_cast<const __nv_bfloat16*>(wqkvt);
  q.out_f32 = s.dxn;
  q.M = T;
  q.N = C;
  q.K = 3 * C;
  err = gemm::launch<false, gemm::kF32>(q, cs);
  if (err) return err;
  err = fmmt::bwd::launch_ln_bwd(s.dxn, xb, dyb, s.st, gb, kp, N,
                                 static_cast<__nv_bfloat16*>(dx), s.ln_part,
                                 T, C, cs);
  if (err) return err;

  err = gemm::launch_wgrad(s.dqkv, s.xn, s.dwqkv_part, 3 * C, C, T, cs);
  if (err) return err;
  err = gemm::launch_wgrad(s.dyk, s.attn, s.dwproj_part, C, C, T, cs);
  if (err) return err;
  err = gemm::sum_rows(s.dwqkv_part, static_cast<float*>(dwqkv),
                       gemm::split_plan(3 * C, C, T).slices, 3 * C * C, s.tmp,
                       cs);
  if (err) return err;
  err = gemm::sum_rows(s.dwproj_part, static_cast<float*>(dwproj),
                       gemm::split_plan(C, C, T).slices, C * C, s.tmp, cs);
  if (err) return err;
  err = gemm::sum_rows(s.ln_part, static_cast<float*>(dvec),
                       fmmt::bwd::ln_bwd_blocks(T), 3 * C, s.tmp, cs);
  if (err) return err;
  err = gemm::sum_rows(s.dbqkv_part, static_cast<float*>(dbqkv), wp.groups,
                       3 * C, s.tmp, cs);
  if (err) return err;
  return gemm::sum_rows(s.dbias_part, static_cast<float*>(dbias), wp.groups,
                        heads * N * N, s.tmp, cs);
}
