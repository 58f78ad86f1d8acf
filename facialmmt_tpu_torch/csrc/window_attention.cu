// Swin window attention core:
//   out[w, h] = softmax(q[w, h] k[w, h]^T + bias[w % nW, h]) v[w, h]
// q, k, v, out (W, heads, N, hd) bf16 with q pre-scaled; bias (nW, heads, N, N)
// bf16, the relative-position bias plus the shifted-window mask, already
// rounded to bf16 by the caller; window w reads bias row w % nW, so windows
// must arrive faces-major (window_partition order).  N <= 64, hd 16, 32 or 64.
//
// Replaces: facialmmt_tpu/ops/pallas/window_attention.py::
// fused_window_attention, paired_window_attention and
// fused_window_attention_v2.  The three TPU kernels compute this one function
// and differ in how windows are tiled onto the matrix unit (serially in a
// cell; two windows in one 98 x 98 product under a block-diagonal bias; G
// windows merged outside the kernel).  Here they are one device kernel,
// compiled for 1 to 4 windows side by side in a block:
//   fused_window_attention      1 window per block at a time, `serial`
//                               windows one after another;
//   paired_window_attention     the 2 windows of a pair side by side;
//   fused_window_attention_v2   the G <= 4 windows of a group side by side.
// No block-diagonal product is formed: each window of a pair or group has its
// own 4 warps, its own scores and its own bias row, which gives the same
// result as the -1e9 off-diagonal blocks (their probabilities are exactly 0)
// without their FLOPs.
//
// What bounds it on the H100: bytes.  Per (window, head) it reads q, k, v and
// writes out, 4 * N * hd * 2 = 12.5 KB at N = 49, hd = 32, against
// 4 * N * N * hd = 0.3 MFLOP; at 64 faces stage 0 moves 154 MB (0.046 ms at
// 3.35 TB/s) for 0.004 ms of tensor-core work.
//
// What the design does about it: the grid is over (window group, head), so
// the card sees W * heads / windows-per-block independent blocks (1536 even
// at stage 3, where W = 64).  q, k and v are read once with 16-byte loads
// into padded shared-memory tiles (15 KB a window, so many blocks fit an SM),
// and that is the only barrier among a window's 4 warps: each warp owns 16
// query rows and keeps their scores, softmax and probabilities in registers
// (mma.sync m16n8k16, bf16 operands, fp32 accumulation; the accumulator
// layout of q k^T is the A-operand layout of P v, so the probabilities never
// touch shared memory).  A row's max and sum are two shuffles inside the 4
// lanes that hold it.  v reaches the tensor core transposed through ldmatrix.
// The output goes back through the warp's own q rows in shared memory so that
// its stores are 16 bytes wide and contiguous.  N = 49 is padded to 64 rows:
// padded keys get probability 0, padded v rows are 0, and a warp whose 16
// rows are all padding skips the arithmetic.
//
// Rounding follows the JAX kernels: fp32 scores, bias added in fp32 from its
// bf16 value, fp32 softmax, probabilities rounded to bf16, fp32 accumulation
// of P v, output rounded once.
#include "common.cuh"

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kGroupWarps = 4;                 // warps that own one window
constexpr int kGroupThreads = 32 * kGroupWarps;
constexpr int kRows = 64;                      // window rows, padded
constexpr int kMaxConc = 4;                    // windows side by side

// Shared memory of one window: q, k and v tiles of 64 rows, hd + 8 wide (the
// 16-byte pad keeps fragment loads free of bank conflicts).
__host__ __device__ constexpr size_t window_bytes(int hd) {
  return 3 * (size_t)kRows * (hd + 8) * sizeof(__nv_bfloat16);
}

// Barrier of the 4 warps that own window slot g (barrier 0 is __syncthreads).
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, %1;" ::"r"(g + 1), "r"(kGroupThreads) : "memory");
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int kConc, int kHd>
__global__ void __launch_bounds__(kConc * kGroupThreads, 6 / kConc)
window_attention_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ bias,
                        __nv_bfloat16* __restrict__ out, int heads, int N,
                        int nW, int serial) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int ldh = kHd + 8;         // bf16 row stride of the tiles
  constexpr int cpr = kHd / 8;         // 16-byte chunks per row
  const int g = threadIdx.x / kGroupThreads;   // window slot in the block
  const int tid = threadIdx.x % kGroupThreads;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gid = lane / 4;            // fragment row
  const int tig = lane % 4;            // fragment column pair
  __nv_bfloat16* qb =
      reinterpret_cast<__nv_bfloat16*>(smem + (size_t)g * window_bytes(kHd));
  __nv_bfloat16* kb = qb + kRows * ldh;
  __nv_bfloat16* vb = kb + kRows * ldh;

  const int head = blockIdx.x % heads;
  const int cell = blockIdx.x / heads;
  const int r0 = warp * 16;            // this warp's query rows
  const int row0 = r0 + gid;
  const int row1 = row0 + 8;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int s = 0; s < serial; ++s) {
    const int w = (cell * serial + s) * kConc + g;
    const size_t unit = ((size_t)w * heads + head) * N * kHd;
    const __nv_bfloat16* bias_u =
        bias + ((size_t)(w % nW) * heads + head) * N * N;

    // 1. q, k, v -> shared memory, 16 bytes a thread; rows N..63 are zero
    const uint4* q4 = reinterpret_cast<const uint4*>(q + unit);
    const uint4* k4 = reinterpret_cast<const uint4*>(k + unit);
    const uint4* v4 = reinterpret_cast<const uint4*>(v + unit);
    for (int i = tid; i < kRows * cpr; i += kGroupThreads) {
      const int r = i / cpr;
      const int c = (i % cpr) * 8;
      const bool real = r < N;
      *reinterpret_cast<uint4*>(qb + r * ldh + c) = real ? q4[i] : zero;
      *reinterpret_cast<uint4*>(kb + r * ldh + c) = real ? k4[i] : zero;
      *reinterpret_cast<uint4*>(vb + r * ldh + c) = real ? v4[i] : zero;
    }
    group_sync(g);

    if (r0 < N) {
      // 2. scores of this warp's 16 rows against all keys, in registers:
      //    sc[j] is the 16 x 8 block of keys 8j..8j+7
      float sc[kRows / 8][4];
#pragma unroll
      for (int j = 0; j < kRows / 8; ++j)
        sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kHd / 16; ++ks) {
        const int c = ks * 16 + 2 * tig;
        const uint32_t a[4] = {ld32(qb + row0 * ldh + c),
                               ld32(qb + row1 * ldh + c),
                               ld32(qb + row0 * ldh + c + 8),
                               ld32(qb + row1 * ldh + c + 8)};
#pragma unroll
        for (int j = 0; j < kRows / 8; ++j) {
          if (8 * j < N) {
            const __nv_bfloat16* kr = kb + (8 * j + gid) * ldh + c;
            fmmt::mma_16816(sc[j], a, ld32(kr), ld32(kr + 8));
          }
        }
      }

      // 3. + bias, softmax over the N real keys in fp32.  Lane (gid, tig)
      //    holds columns 8j + 2 tig, + 1 of rows row0 (sc[j][0..1]) and row1
      //    (sc[j][2..3]); the 4 lanes of a gid hold a whole row.
      float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < kRows / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * tig + e;
          const bool key = col < N;
          sc[j][e] = (key && row0 < N)
                         ? sc[j][e] + fmmt::bf(bias_u[row0 * N + col])
                         : -INFINITY;
          sc[j][2 + e] = (key && row1 < N)
                             ? sc[j][2 + e] + fmmt::bf(bias_u[row1 * N + col])
                             : -INFINITY;
          m0 = fmaxf(m0, sc[j][e]);
          m1 = fmaxf(m1, sc[j][2 + e]);
        }
      }
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
      if (row0 >= N) m0 = 0.f;         // a padded row: every score is -inf
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
      // probabilities in bf16, already in the A-operand layout of P v
      uint32_t pr[kRows / 8][2];
#pragma unroll
      for (int j = 0; j < kRows / 8; ++j) {
        pr[j][0] = fmmt::pack_bf16(sc[j][0] * inv0, sc[j][1] * inv0);
        pr[j][1] = fmmt::pack_bf16(sc[j][2] * inv1, sc[j][3] * inv1);
      }

      // 4. P v (fp32 accumulation): keys 16 ks..16 ks + 15 at a time
      float oc[kHd / 8][4];
#pragma unroll
      for (int jn = 0; jn < kHd / 8; ++jn)
        oc[jn][0] = oc[jn][1] = oc[jn][2] = oc[jn][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kRows / 16; ++ks) {
        if (16 * ks < N) {
          const uint32_t a[4] = {pr[2 * ks][0], pr[2 * ks][1],
                                 pr[2 * ks + 1][0], pr[2 * ks + 1][1]};
#pragma unroll
          for (int jn = 0; jn < kHd / 8; ++jn) {
            uint32_t b0, b1;
            fmmt::ldmatrix_x2_trans(b0, b1,
                              vb + (16 * ks + (lane & 15)) * ldh + 8 * jn);
            fmmt::mma_16816(oc[jn], a, b0, b1);
          }
        }
      }

      // 5. bf16 into this warp's own q rows (no other warp reads them), then
      //    its real rows back to device memory, 16 bytes a thread
      __syncwarp();
#pragma unroll
      for (int jn = 0; jn < kHd / 8; ++jn) {
        const int c = 8 * jn + 2 * tig;
        *reinterpret_cast<uint32_t*>(qb + row0 * ldh + c) =
            fmmt::pack_bf16(oc[jn][0], oc[jn][1]);
        *reinterpret_cast<uint32_t*>(qb + row1 * ldh + c) =
            fmmt::pack_bf16(oc[jn][2], oc[jn][3]);
      }
      __syncwarp();
      uint4* o4 = reinterpret_cast<uint4*>(out + unit);
      const int rows_here = min(16, N - r0);
      for (int i = lane; i < rows_here * cpr; i += 32) {
        const int r = r0 + i / cpr;
        o4[r * cpr + i % cpr] = *reinterpret_cast<const uint4*>(
            qb + r * ldh + (i % cpr) * 8);
      }
    }
    group_sync(g);   // the tiles are rewritten by the next window
  }
}

template <int kConc, int kHd>
int launch(const void* q, const void* k, const void* v, const void* bias,
           void* out, int W, int heads, int N, int nW, int serial,
           void* stream) {
  const size_t bytes = kConc * window_bytes(kHd);
  cudaError_t err = cudaFuncSetAttribute(
      window_attention_kernel<kConc, kHd>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = W / (kConc * serial) * heads;
  window_attention_kernel<kConc, kHd><<<blocks, kConc * kGroupThreads, bytes,
                                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(out), heads, N, nW, serial);
  return static_cast<int>(cudaGetLastError());
}

template <int kConc>
int launch_hd(const void* q, const void* k, const void* v, const void* bias,
              void* out, int W, int heads, int N, int hd, int nW, int serial,
              void* stream) {
  switch (hd) {
    case 16:
      return launch<kConc, 16>(q, k, v, bias, out, W, heads, N, nW, serial,
                               stream);
    case 32:
      return launch<kConc, 32>(q, k, v, bias, out, W, heads, N, nW, serial,
                               stream);
    default:
      return launch<kConc, 64>(q, k, v, bias, out, W, heads, N, nW, serial,
                               stream);
  }
}

}  // namespace

// Shared-memory bytes one block of `conc` windows needs; the wrapper checks
// this against the card's limit before launching.
FMMT_API long long fmmt_window_attention_smem(int hd, int conc) {
  return static_cast<long long>(conc * window_bytes(hd));
}

// conc: windows side by side in a block (1..4); serial: windows each slot
// takes one after another.  W must be a multiple of conc * serial.
FMMT_API int fmmt_window_attention(const void* q, const void* k, const void* v,
                                   const void* bias, void* out, int W,
                                   int heads, int N, int hd, int nW, int conc,
                                   int serial, void* stream) {
  if (N < 1 || N > kRows || (hd != 16 && hd != 32 && hd != 64) || conc < 1 ||
      conc > kMaxConc || serial < 1 || W % (conc * serial) != 0 || nW < 1 ||
      W % nW != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (conc) {
    case 1:
      return launch_hd<1>(q, k, v, bias, out, W, heads, N, hd, nW, serial,
                          stream);
    case 2:
      return launch_hd<2>(q, k, v, bias, out, W, heads, N, hd, nW, serial,
                          stream);
    case 3:
      return launch_hd<3>(q, k, v, bias, out, W, heads, N, hd, nW, serial,
                          stream);
    default:
      return launch_hd<4>(q, k, v, bias, out, W, heads, N, hd, nW, serial,
                          stream);
  }
}
