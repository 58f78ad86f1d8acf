// Swin patch-merging tail: out[t] = LN(x[t]) @ w, no bias.
// x (T, K) bf16 rows of gathered 2x2 neighbourhoods (K = 4C); LN gamma/beta
// (K) bf16; w (K, M) bf16 row-major (M = 2C, the input axis first, as the JAX
// kernel takes it); out (T, M) bf16.  Any T works: the last row tile masks
// its missing rows.  K and M are multiples of 16.
//
// Replaces: facialmmt_tpu/ops/pallas/merge_kernel.py::fused_merge.
//
// What bounds it on the H100: 2 * T * K * M FLOP against 2 * T * (K + M) bytes
// is K M / (K + M) = 128, 256 and 512 FLOP per byte at K = 384, 768 and 1536,
// against the card's 295: bytes at the first two Swin-tiny transitions,
// operations at the last.  Every transition is 7.4 GFLOP at 64 faces (0.0075
// ms) while the rows shrink from 58 MB (0.017 ms) to 14 MB; left to LayerNorm
// and Linear calls the normalised rows make one more round trip through
// device memory.
//
// What the design does about it: a tiled GEMM with a LayerNorm prologue on a
// 2-D grid of 64-row x 192-column output tiles, so that every Swin-tiny
// transition at 64 faces launches at least 196 blocks for the 132 SMs (784 /
// 392 / 196), and at the first transition (M = 192) one column tile takes
// every column.  A block (8 warps) first takes its rows' LayerNorm statistics
// in fp32, two-pass (mean, then biased variance; each warp keeps 8 rows'
// loads in flight), while cp.async already brings gamma, beta and the first
// chunks.  Then it loops over K in chunks of 64: cp.async fills a ring of
// three shared-memory stages with the x chunk (64 x 64) and the w chunk
// (64 x 192); each step, behind one barrier, issues the load of chunk c + 2,
// normalises chunk c + 1 in place (bf16((x rstd - mean rstd) gamma + beta))
// and multiplies chunk c, whose normalised rows the previous step wrote: the
// 2 x 4 warps each take a 32 x 48 sub-tile from ldmatrix (w through the
// transposing load) on mma.sync m16n8k16 into fp32 registers.  The
// normalised rows never reach device memory.  The epilogue rounds once to
// bf16 and stores 16 bytes a thread through shared memory.  108.5 KB of
// shared memory at K = 1536, two blocks an SM.
//
// What holds it back (PERF.md has the measurements): it beats F.layer_norm +
// F.linear at the first transition and loses at the other two.  Variants
// that dropped one part at a time put the cost in the block's fixed work
// (launch, statistics, barriers), in the cp.async traffic through shared
// memory (every row tile copies its whole 192-column slab of w, and every
// column tile re-reads its rows for their statistics) and in the
// normalisation pass, more than in the products.  Sharing w across row tiles
// (TMA multicast in a thread-block cluster), wgmma, and persistent blocks are
// the next steps.
//
// mma.sync, not wgmma: the same fragment helpers as kernels 1 and 8-10, no
// matrix descriptors or swizzled layouts.
//
// Rounding follows the JAX kernel: LN output rounded to bf16 before the
// matmul, fp32 accumulation, output rounded once.
//
// x and out come in bf16 or fp32 (x_f32; the model's compute dtype).  As the
// JAX kernel reads x in its own dtype, fp32 rows keep their LayerNorm
// statistics in fp32 and out is fp32, never rounded; the product's operands
// stay bf16, as the JAX kernel's do.  On fp32 rows the LayerNorm is applied
// by a row pass (swin_bwd.cuh::prep_rows, the prologue's arithmetic, after
// tile_gemm.cuh's row statistics) into a bf16 (T, K) scratch, xn_buf, that
// the same tiled product reads without its prologue (kLn false), and the
// epilogue stores the fp32 sums from registers, 8 bytes a thread (32
// contiguous bytes a row of 4 lanes).  Kernels 2 and 3 take fp32 tokens the
// same way (csrc/block_mlp.cu).
#include "swin_bwd.cuh"

#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kWM = 2;              // warp grid over the block's tile: 2 x 4
constexpr int kWR = 32;             // rows a warp
constexpr int kWN = 48;             // columns a warp
constexpr int kBM = kWM * kWR;      // 64 rows per block
constexpr int kBN = (kWarps / kWM) * kWN;   // 192 output columns per block
constexpr int kBK = 64;             // input columns per stage
constexpr int kStages = 3;
constexpr int kMT = kWR / 16;
constexpr int kNT = kWN / 8;
constexpr int kRowsPerWarp = kBM / kWarps;  // LayerNorm statistics
constexpr int ldx = kBK + 8;        // bf16 row strides: 16-byte pad, no bank
constexpr int ldw = kBN + 8;        // conflicts for ldmatrix
constexpr size_t kXBytes = (size_t)kBM * ldx * 2;
constexpr size_t kStageBytes = kXBytes + (size_t)kBK * ldw * 2;
static_assert((size_t)kBM * ldw * 2 <= kStageBytes,
              "the output tile is staged over stage 0");

__host__ __device__ constexpr size_t align128(size_t n) {
  return (n + 127) / 128 * 128;
}

struct Layout {
  size_t off_stats, off_stage, bytes;
};

// gamma, beta (bf16, K each) | rstd, -mean rstd (fp32, kBM each) | stages
__host__ __device__ inline Layout layout(int K) {
  Layout L;
  L.off_stats = align128((size_t)2 * K * sizeof(__nv_bfloat16));
  L.off_stage = L.off_stats + align128(2 * kBM * sizeof(float));
  L.bytes = L.off_stage + kStages * kStageBytes;
  return L;
}

__device__ __forceinline__ float sum8(const uint4& v) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(p[e]);
    s += f.x + f.y;
  }
  return s;
}

__device__ __forceinline__ float sqdev8(const uint4& v, float mean) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(p[e]);
    s = fmaf(f.x - mean, f.x - mean, s);
    s = fmaf(f.y - mean, f.y - mean, s);
  }
  return s;
}

// kLn: x is the raw rows, LayerNorm applied in the prologue (bf16 tokens);
// else x is the rows' bf16 LayerNorm already (fp32 tokens' xn_buf).  TO: the
// type of out, bf16 or fp32.
template <bool kLn, typename TO>
__global__ void __launch_bounds__(kThreads)
merge_kernel(const __nv_bfloat16* __restrict__ x,
             const __nv_bfloat16* __restrict__ gamma,
             const __nv_bfloat16* __restrict__ beta,
             const __nv_bfloat16* __restrict__ w,
             TO* __restrict__ out, int T, int K, int M, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(K);
  __nv_bfloat16* gs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* bs = gs + K;
  float* scale_s = reinterpret_cast<float*>(smem + L.off_stats);  // rstd
  float* shift_s = scale_s + kBM;  // -mean rstd
  auto xs = [&](int s) {
    return reinterpret_cast<__nv_bfloat16*>(smem + L.off_stage +
                                            s * kStageBytes);
  };
  auto ws = [&](int s) {
    return reinterpret_cast<__nv_bfloat16*>(smem + L.off_stage +
                                            s * kStageBytes + kXBytes);
  };
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int t0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int nchunks = (K + kBK - 1) / kBK;

  // x columns k0..k0+63 of the block's rows and w rows k0..k0+63 of its
  // columns -> stage s; anything past T, K or M is zero
  auto load_chunk = [&](int c, int s) {
    const int k0 = c * kBK;
    __nv_bfloat16* xd = xs(s);
    __nv_bfloat16* wd = ws(s);
    for (int i = tid; i < kBM * (kBK / 8); i += kThreads) {
      const int r = i / (kBK / 8);
      const int col = (i % (kBK / 8)) * 8;
      const bool real = t0 + r < T && k0 + col < K;
      fmmt::cp_async16(xd + r * ldx + col,
                       x + (real ? (size_t)(t0 + r) * K + k0 + col : 0), real);
    }
    for (int i = tid; i < kBK * (kBN / 8); i += kThreads) {
      const int r = i / (kBN / 8);
      const int col = (i % (kBN / 8)) * 8;
      const bool real = k0 + r < K && n0 + col < M;
      fmmt::cp_async16(wd + r * ldw + col,
                       w + (real ? (size_t)(k0 + r) * M + n0 + col : 0), real);
    }
  };
  // normalise the x chunk of stage s in place: bf16((x rstd - mean rstd) *
  // gamma + beta); columns past K stay 0
  auto normalise = [&](int c, int s) {
    const int k0 = c * kBK;
    __nv_bfloat16* xd = xs(s);
    for (int i = tid; i < kBM * (kBK / 8); i += kThreads) {
      const int r = i / (kBK / 8);
      const int col = (i % (kBK / 8)) * 8;
      if (k0 + col >= K) continue;
      uint4* p = reinterpret_cast<uint4*>(xd + r * ldx + col);
      uint4 val = *p;
      __nv_bfloat162* v2 = reinterpret_cast<__nv_bfloat162*>(&val);
      const __nv_bfloat162* g2 =
          reinterpret_cast<const __nv_bfloat162*>(gs + k0 + col);
      const __nv_bfloat162* b2 =
          reinterpret_cast<const __nv_bfloat162*>(bs + k0 + col);
      const float scale = scale_s[r];
      const float shift = shift_s[r];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 xv = __bfloat1622float2(v2[e]);
        const float2 gv = __bfloat1622float2(g2[e]);
        const float2 bv = __bfloat1622float2(b2[e]);
        v2[e] = __floats2bfloat162_rn(
            fmaf(fmaf(xv.x, scale, shift), gv.x, bv.x),
            fmaf(fmaf(xv.y, scale, shift), gv.y, bv.y));
      }
      *p = val;
    }
  };

  // gamma and beta travel with chunk 0 in group 0
  if constexpr (kLn) {
    for (int i = tid; i < K / 8; i += kThreads) {
      fmmt::cp_async16(gs + i * 8, gamma + i * 8, true);
      fmmt::cp_async16(bs + i * 8, beta + i * 8, true);
    }
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nchunks) load_chunk(s, s);
    fmmt::cp_async_commit();
  }

  // LayerNorm statistics of rows warp * 8 .. + 7 while the ring fills (fp32,
  // two-pass, biased variance).  Rows past T read row T - 1, so that the
  // loads stay unconditional and the 8 of a step are in flight together;
  // their statistics are set to 0 and they are never stored.
  if constexpr (kLn) {
    const int rw = warp * kRowsPerWarp;
    const __nv_bfloat16* rows[kRowsPerWarp];
    float acc[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      rows[i] = x + (size_t)min(t0 + rw + i, T - 1) * K;
      acc[i] = 0.f;
    }
    for (int c = lane * 8; c < K; c += 256) {
      uint4 v[kRowsPerWarp];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
        v[i] = *reinterpret_cast<const uint4*>(rows[i] + c);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) acc[i] += sum8(v[i]);
    }
    float mean[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      mean[i] = fmmt::warp_sum(acc[i]) / K;
      acc[i] = 0.f;
    }
    for (int c = lane * 8; c < K; c += 256) {
      uint4 v[kRowsPerWarp];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
        v[i] = *reinterpret_cast<const uint4*>(rows[i] + c);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) acc[i] += sqdev8(v[i], mean[i]);
    }
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const float rstd = rsqrtf(fmmt::warp_sum(acc[i]) / K + eps);
      if (lane == 0) {
        const bool real = t0 + rw + i < T;
        scale_s[rw + i] = real ? rstd : 0.f;
        shift_s[rw + i] = real ? -mean[i] * rstd : 0.f;
      }
    }
  }
  fmmt::cp_async_wait<kStages - 2>();
  __syncthreads();   // statistics, gamma, beta and chunk 0 visible
  if constexpr (kLn) normalise(0, 0);

  const int wm = warp % kWM;
  const int wn = warp / kWM;
  float acc[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
      acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;

  // One barrier a chunk: chunk c was normalised in the previous step; this
  // step normalises chunk c + 1 while it multiplies chunk c.
  for (int c = 0; c < nchunks; ++c) {
    fmmt::cp_async_wait<kStages - 3>();
    // chunk c + 1 has landed for every thread, chunk c's normalised rows are
    // visible, and every warp is done with chunk c - 1, whose stage the next
    // load overwrites
    __syncthreads();
    {
      const int next = c + kStages - 1;
      if (next < nchunks) load_chunk(next, next % kStages);
      fmmt::cp_async_commit();
    }
    if constexpr (kLn)
      if (c + 1 < nchunks) normalise(c + 1, (c + 1) % kStages);

    const __nv_bfloat16* xd = xs(c % kStages);
    const __nv_bfloat16* wd = ws(c % kStages);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
        fmmt::ldmatrix_x4(a[mt], xd + (wm * kWR + mt * 16 + (lane & 15)) * ldx
                                     + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int jp = 0; jp < kNT / 2; ++jp) {
        uint32_t b[4];
        fmmt::ldmatrix_x4_trans(b, wd + (kk * 16 + (lane & 15)) * ldw
                                       + wn * kWN + jp * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          fmmt::mma_16816(acc[mt][2 * jp], a[mt], b[0], b[1]);
          fmmt::mma_16816(acc[mt][2 * jp + 1], a[mt], b[2], b[3]);
        }
      }
    }
  }

  if constexpr (std::is_same<TO, float>::value) {
    // fp32 sums straight from the registers: each row's 4 lanes store 32
    // contiguous bytes (M is a multiple of 16, so a pair never straddles it)
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const int row = t0 + wm * kWR + mt * 16 + g;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int col = n0 + wn * kWN + 8 * j + 2 * t;
        if (col >= M) continue;
        if (row < T)
          *reinterpret_cast<float2*>(out + (size_t)row * M + col) =
              make_float2(acc[mt][j][0], acc[mt][j][1]);
        if (row + 8 < T)
          *reinterpret_cast<float2*>(out + (size_t)(row + 8) * M + col) =
              make_float2(acc[mt][j][2], acc[mt][j][3]);
      }
    }
    return;
  }
  // bf16 tile over the ring, then 16-byte stores of its real rows / columns
  fmmt::cp_async_wait<0>();
  __syncthreads();
  __nv_bfloat16* os = xs(0);
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    const int row = wm * kWR + mt * 16 + g;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int col = wn * kWN + 8 * j + 2 * t;
      *reinterpret_cast<uint32_t*>(os + row * ldw + col) =
          fmmt::pack_bf16(acc[mt][j][0], acc[mt][j][1]);
      *reinterpret_cast<uint32_t*>(os + (row + 8) * ldw + col) =
          fmmt::pack_bf16(acc[mt][j][2], acc[mt][j][3]);
    }
  }
  __syncthreads();
  for (int i = tid; i < kBM * (kBN / 8); i += kThreads) {
    const int r = i / (kBN / 8);
    const int col = (i % (kBN / 8)) * 8;
    if (t0 + r < T && n0 + col < M)
      *reinterpret_cast<uint4*>(out + (size_t)(t0 + r) * M + n0 + col) =
          *reinterpret_cast<const uint4*>(os + r * ldw + col);
  }
}

}  // namespace

// Shared-memory bytes one block needs; the wrapper checks this against the
// card's limit before launching.
FMMT_API long long fmmt_fused_merge_smem(int K) {
  return static_cast<long long>(layout(K).bytes);
}

// stats (T) float2 and xn_buf (T, K) bf16 are scratch the caller allocates
// when x_f32 is nonzero (null otherwise); x (T, K) and out (T, M) are fp32
// then, else bf16.
FMMT_API int fmmt_fused_merge(const void* x, const void* gamma,
                              const void* beta, const void* w, void* stats,
                              void* xn_buf, void* out, int T, int K, int M,
                              int x_f32, float eps, void* stream) {
  if (T < 1 || K % 16 != 0 || M % 16 != 0 || (x_f32 && (!stats || !xn_buf)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* gb = static_cast<const __nv_bfloat16*>(gamma);
  const auto* bb = static_cast<const __nv_bfloat16*>(beta);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  const size_t bytes = layout(K).bytes;
  const dim3 grid((T + kBM - 1) / kBM, (M + kBN - 1) / kBN);
  cudaError_t err;
  if (x_f32) {
    const float* xf = static_cast<const float*>(x);
    auto* st = static_cast<float2*>(stats);
    auto* xn = static_cast<__nv_bfloat16*>(xn_buf);
    int e = fmmt::gemm::launch_row_stats(xf, st, T, K, eps, s);
    if (e != 0) return e;
    e = fmmt::bwd::launch_prep_rows<float>(xf, nullptr, st, gb, bb, nullptr,
                                           1, xn, nullptr, T, K, s);
    if (e != 0) return e;
    err = cudaFuncSetAttribute(merge_kernel<false, float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    merge_kernel<false, float><<<grid, kThreads, bytes, s>>>(
        xn, gb, bb, wb, static_cast<float*>(out), T, K, M, eps);
    return static_cast<int>(cudaGetLastError());
  }
  err = cudaFuncSetAttribute(merge_kernel<true, __nv_bfloat16>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_kernel<true, __nv_bfloat16><<<grid, kThreads, bytes, s>>>(
      static_cast<const __nv_bfloat16*>(x), gb, bb, wb,
      static_cast<__nv_bfloat16*>(out), T, K, M, eps);
  return static_cast<int>(cudaGetLastError());
}
