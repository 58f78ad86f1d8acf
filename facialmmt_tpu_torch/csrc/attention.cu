// Fused multi-head attention for the text tower:
//   out[b,h] = softmax(q[b,h] k[b,h]^T + bias[b]) v[b,h]
// q (B,H,Sq,D) pre-scaled, k/v (B,H,Sk,D), all bf16; bias (B,Sk) fp32 additive
// padding bias broadcast over queries; out (B,H,Sq,D) bf16.  D is 16, 32 or
// 64; Sq != Sk works and Sk need not be a multiple of the key tile.
//
// Replaces: facialmmt_tpu/ops/pallas/attention.py::fused_attention.
//
// What bounds it on the H100: at the text tower's shape (B=8 dialogues,
// H=16, S=512, D=64) q, k, v and out are 8.4 MB each, 33.5 MB in all (0.0100
// ms at 3.35 TB/s), against 4*B*H*S*S*D = 8.6 GFLOP (0.0087 ms at 989
// TFLOP/s): bytes by a little, so the kernel has to keep the 512x512 scores
// of each (b,h) out of device memory and still run the two products near the
// tensor cores' rate.  The TPU kernel held the whole fp32 score block in VMEM
// (1 MB), which does not fit the 227 KB of shared memory a Hopper block can
// use.
//
// What the design does about it: flash attention with everything per query
// row in registers.  A block of 4 warps owns 64 or 128 query rows (16 or 32 a
// warp, kMT m16 tiles); the launch takes 32 a warp, which halves the K/V
// fragment loads per score, whenever the grid of 128-row blocks still holds
// two blocks per SM (the text tower: 512 blocks at 255 registers a thread),
// else 16 (more blocks for the short fusion shapes).  q goes through shared
// memory into A fragments once (ldmatrix).  K, V and the bias stream through
// a ring of two shared-memory stages of 64 keys filled by cp.async, so the
// next tile loads while this one multiplies, with one barrier per tile (three
// stages measured no faster).  S = q k^T accumulates on mma.sync m16n8k16
// (bf16 operands, fp32 accumulation) with k's B fragments from ldmatrix; the
// online softmax runs on those registers (a row's max and sum are shuffles
// among the 4 lanes that hold it; x = (q.k + bias) log2(e) is one fma from
// the scaled bias, then ex2 on the special-function unit); P is packed to
// bf16 in registers, where the accumulator layout of q k^T is already the
// A-operand layout of P v; v's B fragments come from ldmatrix.trans; O is
// rescaled and accumulated in registers.  The output is divided by the row sum
// in registers and leaves through the warp's own q rows in shared memory, so
// that its stores are 16 bytes wide and contiguous.  Trailing key tiles whose
// bias is padding only (<= -1e29) are skipped for a batch row that has a real
// key: there every skipped p is exactly 0 in fp32 and every alpha exactly 1,
// so the result is bit-identical; padding inside the keys is computed.
//
// mma.sync, not wgmma: the register layout is the one kernels 8-10 already
// use and check, and it lets a warp own its rows with no warpgroup-wide 64-row
// tile, matrix descriptor or swizzled layout.  On the text tower's shape it
// runs level with F.scaled_dot_product_attention with no padding (PERF.md):
// the phases of a tile (products, softmax, products) run in step across the
// block's warps, two warps an SM sub-partition at this register count, so the
// tensor cores idle through each softmax.  wgmma (q and k from shared memory,
// P from registers) with producer / consumer warpgroups that overlap one
// tile's softmax with another's products, as FlashAttention-3 does, is the
// next step.
//
// Fully padded rows (every key biased by -1e30, as the serving warm-up pack
// sends): the running max starts at -inf and is only ever set from real
// scores; keys are masked by the caller's finite bias, never by -inf, so such
// a row gets a uniform softmax as the JAX reference does, never NaN (its
// tiles are not skipped).  Keys past Sk in the last tile (zero-filled in
// shared memory) get -inf, so they are left out of the max and the sum.
//
// Rounding as the JAX reference: fp32 scores and softmax statistics,
// probabilities rounded to bf16 for P v, fp32 accumulation, output rounded
// once.
//
// fp32 q, k, v and out (the model under --compute_dtype float32; the JAX
// kernel then computes in q's dtype: fp32 products, fp32 probabilities, fp32
// out): attention_f32_kernel, the same flash scheme on TF32 mma.sync
// (m16n8k8: operands rounded to TF32's 10-bit mantissa, cvt.rna, fp32
// accumulation), 16 query rows a warp, q held in registers as A fragments
// from the start, K / V / bias through the same two-stage cp.async ring in
// fp32 (row stride D + 4 floats: the fragment loads of a warp hit 32
// distinct banks), the same log2-domain online softmax, bias handling and
// trailing-tile skip.  P v needs no shuffle: the k index of the product is
// relabelled so that the scores' accumulator layout (columns 2t, 2t + 1 of
// rows g, g + 8) is the A operand's (columns t, t + 4), with V's rows read
// in the same order.  The output leaves as fp32, never rounded to bf16.  At
// the text tower's shape it moves twice the bf16 kernel's bytes at half the
// tensor cores' rate (PERF.md has its time beside F.scaled_dot_product_attention
// in fp32).
#include "common.cuh"

#include <math.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kKeys = 64;     // keys per tile
constexpr int kStages = 2;    // K / V / bias tiles in flight
constexpr int kSMs = 132;     // H100 SXM
constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit (ex2.approx, subnormal results flushed to
// 0; -inf gives 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int D, int kMT>
struct Layout {
  static constexpr int kRows = 16 * kMT * kWarps;  // query rows per block
  static constexpr int ld = D + 8;  // bf16 row stride: 16-byte pad, no bank
                                    // conflicts for ldmatrix
  static constexpr size_t q_bytes = (size_t)kRows * ld * 2;
  static constexpr size_t kv_bytes = (size_t)kKeys * ld * 2;
  static constexpr size_t stage_bytes = 2 * kv_bytes + kKeys * 4;
  static constexpr size_t bytes = q_bytes + kStages * stage_bytes;
};

template <int D, int kMT>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const float* __restrict__ bias,
                 __nv_bfloat16* __restrict__ out, int H, int Sq, int Sk) {
  using L = Layout<D, kMT>;
  constexpr int ld = L::ld;
  constexpr int kVec = D / 8;     // 16-byte chunks per row
  constexpr int kNT = kKeys / 8;  // 8-key column blocks of a score tile
  constexpr int kDT = D / 8;      // 8-wide column blocks of the output
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;   // fragment row
  const int t = lane % 4;   // fragment column pair
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = blockIdx.x * L::kRows;
  const __nv_bfloat16* qp = q + (size_t)bh * Sq * D;
  const __nv_bfloat16* kp = k + (size_t)bh * Sk * D;
  const __nv_bfloat16* vp = v + (size_t)bh * Sk * D;
  const float* bp = bias + (size_t)b * Sk;
  int ntiles = (Sk + kKeys - 1) / kKeys;

  auto stage = [&](int s) { return smem + L::q_bytes + s * L::stage_bytes; };
  // K, V and bias of key tile `tile` -> stage s; keys past Sk are zero
  auto load_tile = [&](int tile, int s) {
    const int k0 = tile * kKeys;
    __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(stage(s));
    __nv_bfloat16* vs = ks + kKeys * ld;
    float* bs = reinterpret_cast<float*>(vs + kKeys * ld);
    for (int i = tid; i < kKeys * kVec; i += kThreads) {
      const int j = i / kVec;
      const int c = (i % kVec) * 8;
      const bool real = k0 + j < Sk;
      const size_t off = real ? (size_t)(k0 + j) * D + c : 0;
      fmmt::cp_async16(ks + j * ld + c, kp + off, real);
      fmmt::cp_async16(vs + j * ld + c, vp + off, real);
    }
    if (tid < kKeys) {
      const bool real = k0 + tid < Sk;
      fmmt::cp_async4(bs + tid, bp + (real ? k0 + tid : 0), real);
    }
  };

  // q tile (rows past Sq are zero) travels with key tile 0 in group 0
  for (int i = tid; i < L::kRows * kVec; i += kThreads) {
    const int r = i / kVec;
    const int c = (i % kVec) * 8;
    const bool real = q0 + r < Sq;
    fmmt::cp_async16(qs + r * ld + c,
                     qp + (real ? (size_t)(q0 + r) * D + c : 0), real);
  }
  {
    // trailing key tiles of padding only (bias <= -1e29) add exactly 0 to a
    // row with a real key: such rows stop at the tile of their last real key
    __shared__ int last_real;
    if (tid == 0) last_real = -1;
    __syncthreads();
    int mine = -1;
    for (int j = tid; j < Sk; j += kThreads)
      if (bp[j] > -1e29f) mine = j;
    for (int o = 16; o > 0; o >>= 1)
      mine = max(mine, __shfl_xor_sync(0xffffffffu, mine, o));
    if (lane == 0) atomicMax(&last_real, mine);
    __syncthreads();
    if (last_real >= 0) ntiles = last_real / kKeys + 1;
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntiles) load_tile(s, s);
    fmmt::cp_async_commit();
  }

  const int r0 = warp * 16 * kMT;   // this warp's first row in the block
  const bool live = q0 + r0 < Sq;   // a warp of padding rows only does loads
  uint32_t qf[kMT][D / 16][4];
  float o[kMT][kDT][4];
  float m[kMT][2], l[kMT][2];       // rows g and g + 8 of each m16 tile
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int jn = 0; jn < kDT; ++jn)
      o[mt][jn][0] = o[mt][jn][1] = o[mt][jn][2] = o[mt][jn][3] = 0.f;
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
  }

  for (int tile = 0; tile < ntiles; ++tile) {
    fmmt::cp_async_wait<kStages - 2>();
    // tile `tile` has landed for every thread, and every warp is done with
    // the stage that the next load overwrites (the one of tile - 1)
    __syncthreads();
    {
      const int next = tile + kStages - 1;
      if (next < ntiles) load_tile(next, next % kStages);
      fmmt::cp_async_commit();
    }
    if (!live) continue;
    if (tile == 0) {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          fmmt::ldmatrix_x4(qf[mt][kk], qs + (r0 + mt * 16 + (lane & 15)) * ld
                                            + kk * 16 + (lane >> 4) * 8);
    }
    const __nv_bfloat16* ks =
        reinterpret_cast<const __nv_bfloat16*>(stage(tile % kStages));
    const __nv_bfloat16* vs = ks + kKeys * ld;
    const float* bs = reinterpret_cast<const float*>(vs + kKeys * ld);
    const int nk = min(kKeys, Sk - tile * kKeys);

    // S = q k^T: s[mt][j] is the 16 x 8 block of keys 8j..8j+7
    float s[kMT][kNT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
        s[mt][j][0] = s[mt][j][1] = s[mt][j][2] = s[mt][j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int jp = 0; jp < kNT / 2; ++jp) {
        uint32_t kb[4];
        fmmt::ldmatrix_x4(kb, ks + (16 * jp + (lane & 7) + (lane >> 4) * 8) * ld
                                  + kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          fmmt::mma_16816(s[mt][2 * jp], qf[mt][kk], kb[0], kb[1]);
          fmmt::mma_16816(s[mt][2 * jp + 1], qf[mt][kk], kb[2], kb[3]);
        }
      }
    }

    // online softmax in the log2 domain.  Lane (g, t) holds columns
    // 8j + 2t, + 1 of rows g (s[..][0..1]) and g + 8 (s[..][2..3]).
    // x = (q.k + bias) log2(e) as one fma from the scaled bias, so that the
    // keys of a fully padded row keep equal scores (the -1e30 bias absorbs
    // q.k exactly).  Keys past Sk (the last tile only) get -inf.
    float bl[kNT][2];
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      bl[j][0] = bs[8 * j + 2 * t] * kLog2e;
      bl[j][1] = bs[8 * j + 2 * t + 1] * kLog2e;
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[mt][j][e] = fmaf(s[mt][j][e], kLog2e, bl[j][e]);
          s[mt][j][2 + e] = fmaf(s[mt][j][2 + e], kLog2e, bl[j][e]);
        }
      }
      if (nk < kKeys) {
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (8 * j + 2 * t + e >= nk)
              s[mt][j][e] = s[mt][j][2 + e] = -INFINITY;
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          mx0 = fmaxf(mx0, s[mt][j][e]);
          mx1 = fmaxf(mx1, s[mt][j][2 + e]);
        }
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      // finite: the tile has a real key and the bias is finite
      const float mn0 = fmaxf(m[mt][0], mx0);
      const float mn1 = fmaxf(m[mt][1], mx1);
      const float alpha0 = ex2(m[mt][0] - mn0);   // 0 on the first tile
      const float alpha1 = ex2(m[mt][1] - mn1);
      m[mt][0] = mn0;
      m[mt][1] = mn1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[mt][j][e] = ex2(s[mt][j][e] - mn0);
          s[mt][j][2 + e] = ex2(s[mt][j][2 + e] - mn1);
          sum0 += s[mt][j][e];
          sum1 += s[mt][j][2 + e];
        }
      }
      // per-lane partial sums; the 4 lanes of a row are added at the end
      l[mt][0] = l[mt][0] * alpha0 + sum0;
      l[mt][1] = l[mt][1] * alpha1 + sum1;
#pragma unroll
      for (int jn = 0; jn < kDT; ++jn) {
        o[mt][jn][0] *= alpha0;
        o[mt][jn][1] *= alpha0;
        o[mt][jn][2] *= alpha1;
        o[mt][jn][3] *= alpha1;
      }
    }

    // O += P v, keys 16 kk..16 kk + 15 at a time
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      uint32_t pa[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        pa[mt][0] = fmmt::pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
        pa[mt][1] = fmmt::pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
        pa[mt][2] = fmmt::pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
        pa[mt][3] = fmmt::pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
      }
#pragma unroll
      for (int jd = 0; jd < D / 16; ++jd) {
        uint32_t vb[4];
        fmmt::ldmatrix_x4_trans(vb, vs + (16 * kk + (lane & 15)) * ld + 16 * jd
                                        + (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          fmmt::mma_16816(o[mt][2 * jd], pa[mt], vb[0], vb[1]);
          fmmt::mma_16816(o[mt][2 * jd + 1], pa[mt], vb[2], vb[3]);
        }
      }
    }
  }
  if (!live) return;

  // out = O / l, in bf16 over this warp's own q rows (read by no other warp
  // and no longer by this one), then its real rows out 16 bytes a thread
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    float l0 = l[mt][0], l1 = l[mt][1];
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.f / l0;
    const float inv1 = 1.f / l1;
    const int row = r0 + mt * 16 + g;
#pragma unroll
    for (int jn = 0; jn < kDT; ++jn) {
      const int c = 8 * jn + 2 * t;
      *reinterpret_cast<uint32_t*>(qs + row * ld + c) =
          fmmt::pack_bf16(o[mt][jn][0] * inv0, o[mt][jn][1] * inv0);
      *reinterpret_cast<uint32_t*>(qs + (row + 8) * ld + c) =
          fmmt::pack_bf16(o[mt][jn][2] * inv1, o[mt][jn][3] * inv1);
    }
  }
  __syncwarp();
  for (int i = lane; i < 16 * kMT * kVec; i += 32) {
    const int r = r0 + i / kVec;
    const int c = (i % kVec) * 8;
    if (q0 + r < Sq)
      *reinterpret_cast<uint4*>(out + ((size_t)bh * Sq + q0 + r) * D + c) =
          *reinterpret_cast<const uint4*>(qs + r * ld + c);
  }
}

template <int D, int kMT>
int launch(const void* q, const void* k, const void* v, const void* bias,
           void* out, int B, int H, int Sq, int Sk, cudaStream_t stream) {
  using L = Layout<D, kMT>;
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<D, kMT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + L::kRows - 1) / L::kRows, B * H);
  attention_kernel<D, kMT><<<grid, kThreads, L::bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), H, Sq, Sk);
  return static_cast<int>(cudaGetLastError());
}

// 32 rows a warp when the grid of 128-row blocks still holds two blocks per
// SM (the text tower's 8 x 16 x 512: 512 blocks), else 16 (more, smaller
// blocks for the short fusion shapes).
template <int D>
int launch_rows(const void* q, const void* k, const void* v, const void* bias,
                void* out, int B, int H, int Sq, int Sk, cudaStream_t stream) {
  const long long wide = (long long)B * H * ((Sq + 127) / 128);
  if (wide >= 2 * kSMs)
    return launch<D, 2>(q, k, v, bias, out, B, H, Sq, Sk, stream);
  return launch<D, 1>(q, k, v, bias, out, B, H, Sq, Sk, stream);
}

// ---------------------------------------------------------------------------
// fp32 operands on TF32 mma.sync (the design is at the top of this file).

using fmmt::mma_1688_tf32;
using fmmt::tf32;

template <int D>
struct LayoutF32 {
  static constexpr int kRows = 16 * kWarps;  // query rows per block
  static constexpr int ld = D + 4;  // fp32 row stride: 16-byte pad
  static constexpr size_t kv_bytes = (size_t)kKeys * ld * 4;
  static constexpr size_t stage_bytes = 2 * kv_bytes + kKeys * 4;
  static constexpr size_t bytes = kStages * stage_bytes;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ bias, float* __restrict__ out,
                     int H, int Sq, int Sk) {
  using L = LayoutF32<D>;
  constexpr int ld = L::ld;
  constexpr int kVec = D / 4;     // 16-byte chunks per row
  constexpr int kNT = kKeys / 8;  // 8-key column blocks of a score tile
  constexpr int kDT = D / 8;      // 8-wide column blocks (k steps of q k^T)
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = blockIdx.x * L::kRows;
  const float* qp = q + (size_t)bh * Sq * D;
  const float* kp = k + (size_t)bh * Sk * D;
  const float* vp = v + (size_t)bh * Sk * D;
  const float* bp = bias + (size_t)b * Sk;
  int ntiles = (Sk + kKeys - 1) / kKeys;

  auto stage = [&](int s) {
    return reinterpret_cast<float*>(smem + s * L::stage_bytes);
  };
  // K, V and bias of key tile `tile` -> stage s; keys past Sk are zero
  auto load_tile = [&](int tile, int s) {
    const int k0 = tile * kKeys;
    float* ks = stage(s);
    float* vs = ks + kKeys * ld;
    float* bs = vs + kKeys * ld;
    for (int i = tid; i < kKeys * kVec; i += kThreads) {
      const int j = i / kVec;
      const int c = (i % kVec) * 4;
      const bool real = k0 + j < Sk;
      const size_t off = real ? (size_t)(k0 + j) * D + c : 0;
      fmmt::cp_async16(ks + j * ld + c, kp + off, real);
      fmmt::cp_async16(vs + j * ld + c, vp + off, real);
    }
    if (tid < kKeys) {
      const bool real = k0 + tid < Sk;
      fmmt::cp_async4(bs + tid, bp + (real ? k0 + tid : 0), real);
    }
  };

  {
    // trailing key tiles of padding only, as the bf16 kernel skips them
    __shared__ int last_real;
    if (tid == 0) last_real = -1;
    __syncthreads();
    int mine = -1;
    for (int j = tid; j < Sk; j += kThreads)
      if (bp[j] > -1e29f) mine = j;
    for (int o = 16; o > 0; o >>= 1)
      mine = max(mine, __shfl_xor_sync(0xffffffffu, mine, o));
    if (lane == 0) atomicMax(&last_real, mine);
    __syncthreads();
    if (last_real >= 0) ntiles = last_real / kKeys + 1;
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntiles) load_tile(s, s);
    fmmt::cp_async_commit();
  }

  const int row0 = q0 + warp * 16 + g;   // this lane's rows row0, row0 + 8
  const int row1 = row0 + 8;
  const bool live = q0 + warp * 16 < Sq;
  // q's A fragments, rows past Sq zero
  uint32_t qf[kDT][4];
#pragma unroll
  for (int kk = 0; kk < kDT; ++kk) {
    const int c = 8 * kk + t;
    qf[kk][0] = tf32(row0 < Sq ? qp[(size_t)row0 * D + c] : 0.f);
    qf[kk][1] = tf32(row1 < Sq ? qp[(size_t)row1 * D + c] : 0.f);
    qf[kk][2] = tf32(row0 < Sq ? qp[(size_t)row0 * D + c + 4] : 0.f);
    qf[kk][3] = tf32(row1 < Sq ? qp[(size_t)row1 * D + c + 4] : 0.f);
  }
  float o[kDT][4];
#pragma unroll
  for (int jn = 0; jn < kDT; ++jn)
    o[jn][0] = o[jn][1] = o[jn][2] = o[jn][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int tile = 0; tile < ntiles; ++tile) {
    fmmt::cp_async_wait<kStages - 2>();
    __syncthreads();
    {
      const int next = tile + kStages - 1;
      if (next < ntiles) load_tile(next, next % kStages);
      fmmt::cp_async_commit();
    }
    if (!live) continue;
    const float* ks = stage(tile % kStages);
    const float* vs = ks + kKeys * ld;
    const float* bs = vs + kKeys * ld;
    const int nk = min(kKeys, Sk - tile * kKeys);

    // S = q k^T: s[j] is the 16 x 8 block of keys 8j..8j+7
    float s[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDT; ++kk) {
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const float* kr = ks + (8 * j + g) * ld + 8 * kk + t;
        mma_1688_tf32(s[j], qf[kk], tf32(kr[0]), tf32(kr[4]));
      }
    }

    // online softmax in the log2 domain, as the bf16 kernel: lane (g, t)
    // holds columns 8j + 2t, + 1 of rows g (s[j][0..1]) and g + 8
    // (s[j][2..3])
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float bl = bs[8 * j + 2 * t + e] * kLog2e;
        s[j][e] = fmaf(s[j][e], kLog2e, bl);
        s[j][2 + e] = fmaf(s[j][2 + e], kLog2e, bl);
        if (8 * j + 2 * t + e >= nk) s[j][e] = s[j][2 + e] = -INFINITY;
        mx0 = fmaxf(mx0, s[j][e]);
        mx1 = fmaxf(mx1, s[j][2 + e]);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    const float alpha0 = ex2(m0 - mn0);
    const float alpha1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] = ex2(s[j][e] - mn0);
        s[j][2 + e] = ex2(s[j][2 + e] - mn1);
        sum0 += s[j][e];
        sum1 += s[j][2 + e];
      }
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
#pragma unroll
    for (int jn = 0; jn < kDT; ++jn) {
      o[jn][0] *= alpha0;
      o[jn][1] *= alpha0;
      o[jn][2] *= alpha1;
      o[jn][3] *= alpha1;
    }

    // O += P v over each 8-key block: the product's k index i stands for key
    // 8j + 2i (i < 4) and 8j + 2(i - 4) + 1, so P's A fragment is the score
    // registers as they lie, and V's B fragment rows 8j + 2t, 8j + 2t + 1
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const uint32_t pa[4] = {tf32(s[j][0]), tf32(s[j][2]), tf32(s[j][1]),
                              tf32(s[j][3])};
      const float* vr = vs + (8 * j + 2 * t) * ld + g;
#pragma unroll
      for (int jn = 0; jn < kDT; ++jn)
        mma_1688_tf32(o[jn], pa, tf32(vr[8 * jn]), tf32(vr[ld + 8 * jn]));
    }
  }
  if (!live) return;

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0;
  const float inv1 = 1.f / l1;
#pragma unroll
  for (int jn = 0; jn < kDT; ++jn) {
    const int c = 8 * jn + 2 * t;
    if (row0 < Sq)
      *reinterpret_cast<float2*>(out + ((size_t)bh * Sq + row0) * D + c) =
          make_float2(o[jn][0] * inv0, o[jn][1] * inv0);
    if (row1 < Sq)
      *reinterpret_cast<float2*>(out + ((size_t)bh * Sq + row1) * D + c) =
          make_float2(o[jn][2] * inv1, o[jn][3] * inv1);
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const void* bias,
               void* out, int B, int H, int Sq, int Sk, cudaStream_t stream) {
  using L = LayoutF32<D>;
  cudaError_t err = cudaFuncSetAttribute(
      attention_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + L::kRows - 1) / L::kRows, B * H);
  attention_f32_kernel<D><<<grid, kThreads, L::bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(bias),
      static_cast<float*>(out), H, Sq, Sk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Head dims 16, 32 and 64 are compiled (the text tower uses 64); the Python
// wrapper rejects any other before calling.  f32: q, k, v and out are fp32
// (the TF32 kernel), else bf16.
FMMT_API int fmmt_fused_attention(const void* q, const void* k, const void* v,
                                  const void* bias, void* out, int B, int H,
                                  int Sq, int Sk, int D, int f32,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32) {
    switch (D) {
      case 16: return launch_f32<16>(q, k, v, bias, out, B, H, Sq, Sk, s);
      case 32: return launch_f32<32>(q, k, v, bias, out, B, H, Sq, Sk, s);
      case 64: return launch_f32<64>(q, k, v, bias, out, B, H, Sq, Sk, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (D) {
    case 16: return launch_rows<16>(q, k, v, bias, out, B, H, Sq, Sk, s);
    case 32: return launch_rows<32>(q, k, v, bias, out, B, H, Sq, Sk, s);
    case 64: return launch_rows<64>(q, k, v, bias, out, B, H, Sq, Sk, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
