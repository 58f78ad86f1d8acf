// Tiled GEMM with a fused prologue and epilogue, the device code of the
// Swin block halves' products, forward (kernels 2 and 3,
// csrc/attention_block.cu and csrc/block_mlp.cu) and backward (kernels 4 and
// 5, csrc/block_mlp_bwd.cu and csrc/attention_block_bwd.cu; their operand
// layouts are at the end of this note):
//   out[m, n] = epilogue(sum_k A'[m, k] * B[n, k] + bias[n])
// A (M, K) bf16 row-major; B (N, K) bf16 row-major, the torch Linear weight
// layout; bias (N) bf16; out (M, N) bf16.  A' is A itself, or with
// kLayerNorm bf16((A[m] - mean) rstd * gamma + beta), the row's LayerNorm
// rounded to bf16 as the JAX kernels round it before their products; the
// rows' (rstd, -mean rstd) come from row_stats_kernel, one pass over A
// before the product.  Epilogues, all in fp32 and rounded once:
//   kGelu      exact-erf GELU(y), y = acc + bias           (fc1 of the MLP)
//   kScaleQ    y, times q_scale in the columns n < q_cols  (the qkv product)
//   kResidual  res[m, n] + keep[m / keep_div] * y          (fc2, proj)
//   kPlain     acc, no bias                   (the backward's dattn, bf16)
//   kF32       acc, no bias, fp32 out_f32     (the backward's dxn)
// Any M; N and K multiples of 16.
//
// What bounds such a product on the H100: at the Swin-tiny shapes of a
// 64-face pack (M = 3136 to 200704 rows, K and N = 96 to 3072) 2 M N K FLOP
// against 2 (M K + N K + M N) bytes is 50-1000 FLOP per byte, so the larger
// ones are bound by the tensor cores, the narrow stage-0 ones (K or N = 96)
// by the bytes.  What the pre-redesign kernels lost was neither: every 16-row
// tile reloaded its weight fragments straight from L2.
//
// What the design does about it: a block of two warpgroups owns a 128-row x
// BN output tile (BN = 128, 96 or 64, the widest that divides N, chosen by
// the host), so every weight byte that reaches the SM serves 128 rows.  K is
// walked in 64-wide chunks through a ring of kStages shared-memory stages that
// cp.async fills (A chunk 128 x 64, B chunk BN x 64), each 128-byte row
// stored under the 128-byte swizzle (16-byte piece j of row r at piece
// j ^ (r % 8)), the layout wgmma reads without bank conflicts.  Each
// warpgroup multiplies its 64 rows by the BN columns with four
// wgmma.mma_async m64nBNk16 a chunk, both operands straight from shared
// memory through matrix descriptors, the sum in fp32 registers; two blocks
// an SM, so one block's loads and barriers overlap the other's products.
// With kLayerNorm each chunk is normalised in shared memory after it lands
// and before its products: the normalised rows never reach device memory.
// The epilogue stages the fp32 tile over the ring and writes 16 bytes a
// thread.  The grid is 1-D with the column tiles of one row tile adjacent,
// so A is read from device memory about once and from L2 after that.
//
// What holds it back (PERF.md has the measurements): at K >= 384 it runs at
// 150-300 TFLOP/s where cuBLAS reaches about 600 on the same shapes, and at
// stage 0 its LayerNorm products (K = 96, 4704 short blocks) move their
// outputs at well under the HBM rate.  Each warpgroup waits for its products
// before the next barrier, and a block's loads, barriers and epilogue are
// hidden only by the SM's other block.  A four-stage ring at one block an SM
// with each chunk's products left running across the barrier was slower at
// every Swin-tiny shape in an A/B on the card; a producer warp with TMA,
// clusters sharing the weight tile, and persistent blocks are the next steps.
//
// The backward's products, after the forward's below:
//   * A (M, K) B (N, K)^T where B is the transpose of a stored torch-layout
//     weight (dgm = dyk W2, dxn = dh W1, dattn = dyk Wproj, dxn = dqkv
//     Wqkv): B is a bf16 transposed copy of the weight that the wrapper makes
//     once a call (4.7 MB at most, plain data movement), so every B stays
//     K-major and this product reads it unchanged;
//   * dual_gelu_bwd_kernel: two K-major products of one tile over one pass
//     of K, h = xn W1^T and dgm = dyk W2, with the GELU backward as their
//     epilogue and db1's column partials (kernel 4's hidden layer);
//   * wgrad_kernel: the weight gradients out = A^T B summed over T token
//     rows (dW1 = dh^T xn, dW2 = dyk^T g, dWqkv = dqkv^T xn, dWproj = dyk^T
//     attn), both operands token-major, read MN-major through wgmma's
//     transpose bits; T split into fixed slices with fp32 partials that
//     sum_rows adds in a fixed order.
// Both use the same tiles, ring and swizzle as the forward's product.
#pragma once

#include "common.cuh"

#include <math.h>

namespace fmmt {
namespace gemm {

enum Epilogue { kGelu = 0, kScaleQ = 1, kResidual = 2, kPlain = 3, kF32 = 4 };

constexpr int kWarps = 8;         // two warpgroups
constexpr int kThreads = 32 * kWarps;
constexpr int kBM = 128;          // rows of a block's tile, 64 a warpgroup
constexpr int kBK = 64;           // K per ring stage: one 128-byte row
constexpr int kStages = 3;
constexpr size_t kABytes = (size_t)kBM * kBK * 2;

struct Args {
  const __nv_bfloat16* a;
  const float2* stats;            // kLayerNorm: (rstd, -mean rstd) per row
  const __nv_bfloat16* gamma;
  const __nv_bfloat16* beta;
  const __nv_bfloat16* b;
  const __nv_bfloat16* bias;
  const __nv_bfloat16* res;       // kResidual
  const float* keep;              // kResidual, optional
  __nv_bfloat16* out;
  float* out_f32;                 // kF32
  int M, N, K;
  int keep_div;                   // keep index of row m: m / keep_div
  int q_cols;                     // kScaleQ
  float q_scale;
};

template <int BN>
struct Tile {
  static constexpr size_t kStageBytes = kABytes + (size_t)BN * kBK * 2;
  static constexpr int ldo = BN + 4;        // fp32 stride of the output tile
  static_assert((size_t)kBM * ldo * 4 <= kStages * kStageBytes,
                "the output tile is staged over the ring");
};

__host__ __device__ constexpr size_t align_up(size_t n, size_t a) {
  return (n + a - 1) / a * a;
}

// gamma, beta (bf16, K each) | stats (float2, kBM) | ring, 1024-aligned for
// the swizzle (the dynamic shared memory base is aligned at run time, hence
// the 1024 bytes of slack)
struct Layout {
  size_t off_stats, off_ring, bytes;
};

template <int BN>
__host__ __device__ inline Layout layout(int K, bool ln) {
  Layout L;
  L.off_stats = ln ? align_up((size_t)2 * K * sizeof(__nv_bfloat16), 128) : 0;
  L.off_ring = align_up(L.off_stats + (ln ? kBM * sizeof(float2) : 0), 1024);
  L.bytes = L.off_ring + kStages * Tile<BN>::kStageBytes + 1024;
  return L;
}

// Byte offset of 16-byte piece j of row r in a 128-byte-swizzled tile.
__device__ __forceinline__ int swz(int r, int j) {
  return r * 128 + ((j ^ (r & 7)) << 4);
}

// wgmma matrix descriptor of a K-major tile under the 128-byte swizzle: start
// address, leading offset 1 (unused by this layout), stride 1024 bytes from
// one 8-row group to the next.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// D (64 x N, fp32, this warpgroup's registers) += A (64 x 16) B^T (16 x N),
// both operands in shared memory behind descriptors.  Thread t of the
// warpgroup holds d[4j + e] at row 16 (t / 32) + (t % 32) / 4 + 8 (e / 2),
// column 8j + 2 (t % 4) + e % 2.
template <int kTrans = 0>
__device__ __forceinline__ void wgmma_64(float (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(kTrans));
}

template <int kTrans = 0>
__device__ __forceinline__ void wgmma_96(float (&d)[48], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, %51, %51;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(1), "n"(kTrans));
}

template <int kTrans = 0>
__device__ __forceinline__ void wgmma_128(float (&d)[64], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(kTrans));
}

template <int BN, int kTrans = 0>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t da,
                                           uint64_t db) {
  if constexpr (BN == 128)
    wgmma_128<kTrans>(d, da, db);
  else if constexpr (BN == 96)
    wgmma_96<kTrans>(d, da, db);
  else
    wgmma_64<kTrans>(d, da, db);
}

__device__ __forceinline__ float gelu_erf(float h) {
  return 0.5f * h * (1.f + erff(h * 0.70710678118654752f));
}

// (rstd, -mean rstd) of each row's LayerNorm in fp32, two passes (mean, then
// the biased variance), the row re-read from L1.  A row takes `lanes` lanes
// (4 to 32, at least K / 8 where that is below 32), so that a warp keeps
// several narrow rows' loads in flight.  Static: every source that includes
// this header has its own copy.
static __global__ void __launch_bounds__(256)
row_stats_kernel(const __nv_bfloat16* __restrict__ a, float2* __restrict__ st,
                 int M, int K, int lanes, float eps) {
  const int lane = threadIdx.x % 32;
  const int per_warp = 32 / lanes;
  const int row = (blockIdx.x * 8 + threadIdx.x / 32) * per_warp + lane / lanes;
  const int sub = lane % lanes;
  const __nv_bfloat16* x = a + (size_t)min(row, M - 1) * K;
  auto group_sum = [&](float v) {
    for (int o = lanes / 2; o > 0; o >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
  };
  float s = 0.f;
  for (int c = sub * 8; c < K; c += lanes * 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(x + c);
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(p[e]);
      s += f.x + f.y;
    }
  }
  const float mean = group_sum(s) / K;
  float q = 0.f;
  for (int c = sub * 8; c < K; c += lanes * 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(x + c);
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(p[e]);
      q = fmaf(f.x - mean, f.x - mean, q);
      q = fmaf(f.y - mean, f.y - mean, q);
    }
  }
  const float rstd = rsqrtf(group_sum(q) / K + eps);
  if (sub == 0 && row < M) st[row] = make_float2(rstd, -mean * rstd);
}

template <int BN, bool kLayerNorm, int kEpi>
__global__ void __launch_bounds__(kThreads, 2)
tile_gemm_kernel(const Args p) {
  using TL = Tile<BN>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Layout L = layout<BN>(p.K, kLayerNorm);
  __nv_bfloat16* gs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* bs = gs + p.K;
  float2* st_s = reinterpret_cast<float2*>(smem_raw + L.off_stats);
  unsigned char* ring = smem_raw + L.off_ring;
  ring += (1024 - (smem_addr(ring) & 1023)) & 1023;
  auto as = [&](int s) { return ring + s * TL::kStageBytes; };
  auto bsm = [&](int s) { return ring + s * TL::kStageBytes + kABytes; };
  const int M = p.M, N = p.N, K = p.K;
  const int tid = threadIdx.x;
  const int wg = tid / 128;                 // warpgroup: rows 64 wg..
  const int ntiles_n = (N + BN - 1) / BN;
  const int m0 = (blockIdx.x / ntiles_n) * kBM;
  const int n0 = (blockIdx.x % ntiles_n) * BN;
  const int nchunks = (K + kBK - 1) / kBK;

  // A columns k0..k0+63 of the block's rows and B rows n0..n0+BN-1, columns
  // k0..k0+63 -> stage s, swizzled; anything past M, N or K is zero
  auto load_chunk = [&](int c, int s) {
    const int k0 = c * kBK;
    unsigned char* ad = as(s);
    unsigned char* bd = bsm(s);
    for (int i = tid; i < kBM * 8; i += kThreads) {
      const int r = i / 8;
      const int j = i % 8;
      const bool real = m0 + r < M && k0 + j * 8 < K;
      cp_async16(ad + swz(r, j),
                 p.a + (real ? (size_t)(m0 + r) * K + k0 + j * 8 : 0), real);
    }
    for (int i = tid; i < BN * 8; i += kThreads) {
      const int r = i / 8;
      const int j = i % 8;
      const bool real = n0 + r < N && k0 + j * 8 < K;
      cp_async16(bd + swz(r, j),
                 p.b + (real ? (size_t)(n0 + r) * K + k0 + j * 8 : 0), real);
    }
  };
  // normalise the A chunk of stage s in place: bf16((x rstd - mean rstd) *
  // gamma + beta); columns past K stay 0
  auto normalise = [&](int c, int s) {
    const int k0 = c * kBK;
    unsigned char* ad = as(s);
    for (int i = tid; i < kBM * 8; i += kThreads) {
      const int r = i / 8;
      const int j = i % 8;
      if (k0 + j * 8 >= K) continue;
      uint4* q = reinterpret_cast<uint4*>(ad + swz(r, j));
      uint4 val = *q;
      __nv_bfloat162* v2 = reinterpret_cast<__nv_bfloat162*>(&val);
      const __nv_bfloat162* g2 =
          reinterpret_cast<const __nv_bfloat162*>(gs + k0 + j * 8);
      const __nv_bfloat162* b2 =
          reinterpret_cast<const __nv_bfloat162*>(bs + k0 + j * 8);
      const float2 sc = st_s[r];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 xv = __bfloat1622float2(v2[e]);
        const float2 gv = __bfloat1622float2(g2[e]);
        const float2 bv = __bfloat1622float2(b2[e]);
        v2[e] = __floats2bfloat162_rn(
            fmaf(fmaf(xv.x, sc.x, sc.y), gv.x, bv.x),
            fmaf(fmaf(xv.y, sc.x, sc.y), gv.y, bv.y));
      }
      *q = val;
    }
  };

  if constexpr (kLayerNorm) {
    // gamma, beta and the rows' statistics travel with chunk 0 in group 0;
    // rows past M get (0, 0)
    for (int i = tid; i < K / 8; i += kThreads) {
      cp_async16(gs + i * 8, p.gamma + i * 8, true);
      cp_async16(bs + i * 8, p.beta + i * 8, true);
    }
    for (int i = tid; i < kBM / 2; i += kThreads) {
      const bool real = m0 + 2 * i < M;
      if (m0 + 2 * i + 1 < M || !real) {
        cp_async16(st_s + 2 * i, p.stats + (real ? m0 + 2 * i : 0), real);
      } else {   // the last real row alone (16 bytes would run past M)
        st_s[2 * i] = p.stats[m0 + 2 * i];
        st_s[2 * i + 1] = make_float2(0.f, 0.f);
      }
    }
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nchunks) load_chunk(s, s);
    cp_async_commit();
  }

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  // Per chunk c: chunk c has landed (with kLayerNorm it is normalised behind
  // a first barrier); the writes are fenced for the async proxy that wgmma
  // reads through; one barrier, after which every warpgroup is done with
  // chunk c - 1, whose stage the load of chunk c + kStages - 1 takes; the
  // four products of the chunk, waited for before the next barrier.
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<kStages - 2>();
    if constexpr (kLayerNorm) {
      __syncthreads();
      normalise(c, c % kStages);
    }
    fence_proxy_async();
    __syncthreads();
    {
      const int next = c + kStages - 1;
      if (next < nchunks) load_chunk(next, next % kStages);
      cp_async_commit();
    }
    const uint64_t da = sw128_desc(as(c % kStages) + wg * 64 * 128);
    const uint64_t db = sw128_desc(bsm(c % kStages));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)   // 32 bytes along K: +2 units
      wgmma_tile<BN>(acc, da + 2 * kk, db + 2 * kk);
    wgmma_commit();
    wgmma_wait0();
  }

  // the fp32 tile over the ring, then 8 columns a thread: bias, epilogue,
  // one rounding, 16-byte stores of the real rows and columns
  cp_async_wait<0>();
  __syncthreads();
  float* os = reinterpret_cast<float*>(ring);
  {
    const int t = tid % 128;
    const int row = wg * 64 + (t / 32) * 16 + (t % 32) / 4;
    const int col = 2 * (t % 4);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      *reinterpret_cast<float2*>(os + row * TL::ldo + 8 * j + col) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(os + (row + 8) * TL::ldo + 8 * j + col) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
  __syncthreads();
  for (int i = tid; i < kBM * (BN / 8); i += kThreads) {
    const int r = i / (BN / 8);
    const int col = (i % (BN / 8)) * 8;
    const int m = m0 + r;
    const int n = n0 + col;
    if (m >= M || n >= N) continue;
    const float4 lo = *reinterpret_cast<const float4*>(os + r * TL::ldo + col);
    const float4 hi =
        *reinterpret_cast<const float4*>(os + r * TL::ldo + col + 4);
    if constexpr (kEpi == kF32) {
      float4* o = reinterpret_cast<float4*>(p.out_f32 + (size_t)m * N + n);
      o[0] = lo;
      o[1] = hi;
      continue;
    }
    float y[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    if constexpr (kEpi != kPlain) {
      const uint4 bias8 = *reinterpret_cast<const uint4*>(p.bias + n);
      const __nv_bfloat162* bias2 =
          reinterpret_cast<const __nv_bfloat162*>(&bias8);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 bv = __bfloat1622float2(bias2[e]);
        y[2 * e] += bv.x;
        y[2 * e + 1] += bv.y;
      }
    }
    if constexpr (kEpi == kGelu) {
#pragma unroll
      for (int e = 0; e < 8; ++e) y[e] = gelu_erf(y[e]);
    } else if constexpr (kEpi == kScaleQ) {
      if (n < p.q_cols) {
#pragma unroll
        for (int e = 0; e < 8; ++e) y[e] *= p.q_scale;
      }
    } else if constexpr (kEpi == kResidual) {
      const float kw = p.keep ? p.keep[m / p.keep_div] : 1.f;
      const uint4 res8 =
          *reinterpret_cast<const uint4*>(p.res + (size_t)m * N + n);
      const __nv_bfloat162* res2 =
          reinterpret_cast<const __nv_bfloat162*>(&res8);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 rv = __bfloat1622float2(res2[e]);
        y[2 * e] = rv.x + y[2 * e] * kw;
        y[2 * e + 1] = rv.y + y[2 * e + 1] * kw;
      }
    }
    uint4 o;
    uint32_t* o32 = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
    for (int e = 0; e < 4; ++e) o32[e] = pack_bf16(y[2 * e], y[2 * e + 1]);
    *reinterpret_cast<uint4*>(p.out + (size_t)m * N + n) = o;
  }
}

// The tile width the host picks for N columns: 128 where it divides N, else
// 96, else 64.
inline int tile_n(int N) {
  return N % 128 == 0 ? 128 : (N % 96 == 0 ? 96 : 64);
}

inline size_t smem_bytes(int N, int K, bool ln) {
  switch (tile_n(N)) {
    case 128: return layout<128>(K, ln).bytes;
    case 96: return layout<96>(K, ln).bytes;
    default: return layout<64>(K, ln).bytes;
  }
}

// The rows' LayerNorm statistics for a kLayerNorm product: st (M) float2.
static inline int launch_row_stats(const __nv_bfloat16* a, float2* st,
                                   int M, int K, float eps,
                                   cudaStream_t stream) {
  if (M < 1 || K % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  int lanes = 4;
  while (lanes < 32 && lanes * 8 < K) lanes *= 2;
  const int rows_per_block = 8 * (32 / lanes);
  row_stats_kernel<<<(M + rows_per_block - 1) / rows_per_block, 256, 0,
                     stream>>>(a, st, M, K, lanes, eps);
  return static_cast<int>(cudaGetLastError());
}

template <int BN, bool kLayerNorm, int kEpi>
int launch_tile(const Args& p, cudaStream_t stream) {
  const size_t bytes = layout<BN>(p.K, kLayerNorm).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      tile_gemm_kernel<BN, kLayerNorm, kEpi>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      (long long)((p.M + kBM - 1) / kBM) * ((p.N + BN - 1) / BN);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  tile_gemm_kernel<BN, kLayerNorm, kEpi>
      <<<static_cast<unsigned>(blocks), kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// One product; the tile width by N.  N and K multiples of 16, M >= 1; with
// kLayerNorm, p.stats from launch_row_stats on the same stream.
template <bool kLayerNorm, int kEpi>
int launch(const Args& p, cudaStream_t stream) {
  if (p.M < 1 || p.N % 16 != 0 || p.K % 16 != 0 || p.N < 16 || p.K < 16)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (tile_n(p.N)) {
    case 128: return launch_tile<128, kLayerNorm, kEpi>(p, stream);
    case 96: return launch_tile<96, kLayerNorm, kEpi>(p, stream);
    default: return launch_tile<64, kLayerNorm, kEpi>(p, stream);
  }
}

// ---------------------------------------------------------------------------
// The backward's products (kernels 4 and 5: csrc/block_mlp_bwd.cu and
// csrc/attention_block_bwd.cu).

// Two products of the same tile sharing one pass over K, for the MLP
// backward's hidden layer:
//   h = A1 B1^T + bias1,  dgm = A2 B2^T       (A1 = xn, B1 = W1; A2 = dyk,
//                                              B2 = W2^T, all K-major)
// and the GELU backward as the epilogue: g = bf16(GELU(h)),
// dh = bf16(dgm GELU'(h)), and the column sums of the fp32 dh over the tile's
// rows to dh_part[row tile][N].  dgm and the fp32 h never reach device
// memory.  Two accumulators of BN = 64 columns (64 registers) keep it at two
// blocks an SM; two ring stages of (A1, A2, B1, B2) chunks, 48 KB each.
constexpr int kDualBN = 64;
constexpr int kDualStages = 2;
constexpr size_t kDualBBytes = (size_t)kDualBN * kBK * 2;
constexpr size_t kDualStageBytes = 2 * kABytes + 2 * kDualBBytes;
constexpr int kDualLdo = kDualBN + 4;
static_assert((size_t)2 * kBM * kDualLdo * 4 <= kDualStages * kDualStageBytes,
              "both fp32 output tiles are staged over the ring");

struct DualArgs {
  const __nv_bfloat16 *a1, *b1, *a2, *b2, *bias1;
  __nv_bfloat16 *g, *dh;
  float* dh_part;
  int M, N, K;
};

__host__ __device__ constexpr size_t dual_smem_bytes() {
  return kDualStages * kDualStageBytes + 1024;
}

static __global__ void __launch_bounds__(kThreads, 2)
dual_gelu_bwd_kernel(const DualArgs p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* ring = smem_raw;
  ring += (1024 - (smem_addr(ring) & 1023)) & 1023;
  auto a1s = [&](int s) { return ring + s * kDualStageBytes; };
  auto a2s = [&](int s) { return a1s(s) + kABytes; };
  auto b1s = [&](int s) { return a1s(s) + 2 * kABytes; };
  auto b2s = [&](int s) { return a1s(s) + 2 * kABytes + kDualBBytes; };
  const int M = p.M, N = p.N, K = p.K;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int ntiles_n = N / kDualBN;
  const int tm = blockIdx.x / ntiles_n;
  const int m0 = tm * kBM;
  const int n0 = (blockIdx.x % ntiles_n) * kDualBN;
  const int nchunks = (K + kBK - 1) / kBK;

  auto load_chunk = [&](int c, int s) {
    const int k0 = c * kBK;
    for (int i = tid; i < kBM * 8; i += kThreads) {
      const int r = i / 8;
      const int j = i % 8;
      const bool real = m0 + r < M && k0 + j * 8 < K;
      const size_t off = real ? (size_t)(m0 + r) * K + k0 + j * 8 : 0;
      cp_async16(a1s(s) + swz(r, j), p.a1 + off, real);
      cp_async16(a2s(s) + swz(r, j), p.a2 + off, real);
    }
    for (int i = tid; i < kDualBN * 8; i += kThreads) {
      const int r = i / 8;
      const int j = i % 8;
      const bool real = k0 + j * 8 < K;
      const size_t off = real ? (size_t)(n0 + r) * K + k0 + j * 8 : 0;
      cp_async16(b1s(s) + swz(r, j), p.b1 + off, real);
      cp_async16(b2s(s) + swz(r, j), p.b2 + off, real);
    }
  };

  load_chunk(0, 0);
  cp_async_commit();
  float acc1[kDualBN / 2], acc2[kDualBN / 2];
#pragma unroll
  for (int i = 0; i < kDualBN / 2; ++i) acc1[i] = acc2[i] = 0.f;
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    if (c + 1 < nchunks) load_chunk(c + 1, (c + 1) % kDualStages);
    cp_async_commit();
    const int s = c % kDualStages;
    const uint64_t da1 = sw128_desc(a1s(s) + wg * 64 * 128);
    const uint64_t da2 = sw128_desc(a2s(s) + wg * 64 * 128);
    const uint64_t db1 = sw128_desc(b1s(s));
    const uint64_t db2 = sw128_desc(b2s(s));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      wgmma_64(acc1, da1 + 2 * kk, db1 + 2 * kk);
      wgmma_64(acc2, da2 + 2 * kk, db2 + 2 * kk);
    }
    wgmma_commit();
    wgmma_wait0();
  }

  cp_async_wait<0>();
  __syncthreads();
  float* hs = reinterpret_cast<float*>(ring);
  float* ds = hs + kBM * kDualLdo;
  {
    const int t = tid % 128;
    const int row = wg * 64 + (t / 32) * 16 + (t % 32) / 4;
    const int col = 2 * (t % 4);
#pragma unroll
    for (int j = 0; j < kDualBN / 8; ++j) {
      const int o0 = row * kDualLdo + 8 * j + col;
      const int o1 = o0 + 8 * kDualLdo;
      *reinterpret_cast<float2*>(hs + o0) = make_float2(acc1[4 * j], acc1[4 * j + 1]);
      *reinterpret_cast<float2*>(hs + o1) = make_float2(acc1[4 * j + 2], acc1[4 * j + 3]);
      *reinterpret_cast<float2*>(ds + o0) = make_float2(acc2[4 * j], acc2[4 * j + 1]);
      *reinterpret_cast<float2*>(ds + o1) = make_float2(acc2[4 * j + 2], acc2[4 * j + 3]);
    }
  }
  __syncthreads();
  // 8 columns a thread: h = acc + b1, g = h Phi(h), dh = dgm (Phi(h) +
  // h phi(h)); the fp32 dh back over dgm (0 in rows past M) for the sums
  for (int i = tid; i < kBM * (kDualBN / 8); i += kThreads) {
    const int r = i / (kDualBN / 8);
    const int col = (i % (kDualBN / 8)) * 8;
    const int m = m0 + r;
    const int n = n0 + col;
    float* dr = ds + r * kDualLdo + col;
    if (m >= M) {
#pragma unroll
      for (int e = 0; e < 8; ++e) dr[e] = 0.f;
      continue;
    }
    const float* hr = hs + r * kDualLdo + col;
    const uint4 bias8 = *reinterpret_cast<const uint4*>(p.bias1 + n);
    const __nv_bfloat16* bias = reinterpret_cast<const __nv_bfloat16*>(&bias8);
    uint4 go, dho;
    uint32_t* g32 = reinterpret_cast<uint32_t*>(&go);
    uint32_t* d32 = reinterpret_cast<uint32_t*>(&dho);
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      float gv[2], dv[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float h = hr[e + u] + __bfloat162float(bias[e + u]);
        const float cdf = 0.5f * (1.f + erff(h * 0.70710678118654752f));
        const float pdf = expf(-0.5f * h * h) * 0.3989422804014327f;
        gv[u] = h * cdf;
        dv[u] = dr[e + u] * (cdf + h * pdf);
        dr[e + u] = dv[u];
      }
      g32[e / 2] = pack_bf16(gv[0], gv[1]);
      d32[e / 2] = pack_bf16(dv[0], dv[1]);
    }
    *reinterpret_cast<uint4*>(p.g + (size_t)m * N + n) = go;
    *reinterpret_cast<uint4*>(p.dh + (size_t)m * N + n) = dho;
  }
  __syncthreads();
  if (tid < kDualBN) {
    float sum = 0.f;
    for (int r = 0; r < kBM; ++r) sum += ds[r * kDualLdo + tid];
    p.dh_part[(size_t)tm * N + n0 + tid] = sum;
  }
}

// Rows of dh_part the dual product writes: one per 128-row tile.
inline int dual_row_tiles(int M) { return (M + kBM - 1) / kBM; }

// N a multiple of 64, K a multiple of 16.
static inline int launch_dual(const DualArgs& p, cudaStream_t stream) {
  if (p.M < 1 || p.N % kDualBN != 0 || p.K % 16 != 0 || p.K < 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = dual_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      dual_gelu_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (long long)dual_row_tiles(p.M) * (p.N / kDualBN);
  dual_gelu_bwd_kernel<<<static_cast<unsigned>(blocks), kThreads, bytes,
                         stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Weight gradients, out = A^T B summed over T token rows, both operands
// stored token-major: A (T, M) and B (T, N) row-major, out (M, N) fp32, e.g.
// dW1 = dh^T xn.  Against the forward's product both operands reach shared
// memory MN-major: a chunk is 64 token rows, each stored as 128-byte rows of
// 64 consecutive M (or N) values, one block of 64 x 128 bytes per 64
// columns, under the same 128-byte swizzle, and wgmma reads them with its
// transpose bits set (leading offset 8192 bytes from one 64-column block to
// the next, stride 1024 bytes from one 8-row group of tokens to the next;
// 16 tokens a k-step, 2048 bytes).  T is split into `slices` fixed ranges of
// `rows` tokens, so that the (M / 128) x (N / BN) output tiles times the
// slices fill the card; block (slice, tile) writes its fp32 partial tile to
// part[slice][M][N], and sum_rows adds the slices in a fixed order: no
// atomics, the same bits every launch.
struct WgradArgs {
  const __nv_bfloat16* a;
  const __nv_bfloat16* b;
  float* part;
  int M, N, T, rows;
};

template <int BN>
struct WgradTile {
  static constexpr int kNB = (BN + 63) / 64;                 // 64-col blocks
  static constexpr size_t kBBytes = (size_t)kNB * 64 * 128;
  static constexpr size_t kStageBytes = kABytes + kBBytes;
  static constexpr int ldo = BN + 4;
  static_assert((size_t)kBM * ldo * 4 <= kStages * kStageBytes,
                "the output tile is staged over the ring");
};

template <int BN>
__host__ __device__ constexpr size_t wgrad_smem_bytes() {
  return kStages * WgradTile<BN>::kStageBytes + 1024;
}

// wgmma descriptor of an MN-major tile under the 128-byte swizzle.
__device__ __forceinline__ uint64_t sw128_mn_desc(const void* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(8192 >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 2) wgrad_kernel(const WgradArgs p) {
  using TL = WgradTile<BN>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* ring = smem_raw;
  ring += (1024 - (smem_addr(ring) & 1023)) & 1023;
  auto as = [&](int s) { return ring + s * TL::kStageBytes; };
  auto bsm = [&](int s) { return ring + s * TL::kStageBytes + kABytes; };
  const int M = p.M, N = p.N;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int ntiles_n = (N + BN - 1) / BN;
  const int ntiles = ((M + kBM - 1) / kBM) * ntiles_n;
  const int slice = blockIdx.x / ntiles;
  const int tile = blockIdx.x % ntiles;
  const int m0 = (tile / ntiles_n) * kBM;
  const int n0 = (tile % ntiles_n) * BN;
  const int t0 = slice * p.rows;
  const int t1 = min(p.T, t0 + p.rows);
  const int nchunks = (t1 - t0 + kBK - 1) / kBK;

  // token rows t0 + 64 c .. + 63 -> stage s; row kr of column block cb at
  // swizzled row cb * 64 + kr; anything past t1, M or N is zero
  auto load_chunk = [&](int c, int s) {
    const int k0 = t0 + c * kBK;
    for (int i = tid; i < kBK * 16; i += kThreads) {
      const int kr = i / 16;
      const int cb = (i / 8) % 2;
      const int j = i % 8;
      const int m = m0 + cb * 64 + j * 8;
      const bool real = k0 + kr < t1 && m < M;
      cp_async16(as(s) + swz(cb * 64 + kr, j),
                 p.a + (real ? (size_t)(k0 + kr) * M + m : 0), real);
    }
    for (int i = tid; i < kBK * TL::kNB * 8; i += kThreads) {
      const int kr = i / (TL::kNB * 8);
      const int cb = (i / 8) % TL::kNB;
      const int j = i % 8;
      const int nl = cb * 64 + j * 8;
      const bool real = k0 + kr < t1 && nl < BN && n0 + nl < N;
      cp_async16(bsm(s) + swz(cb * 64 + kr, j),
                 p.b + (real ? (size_t)(k0 + kr) * N + n0 + nl : 0), real);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nchunks) load_chunk(s, s);
    cp_async_commit();
  }
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<kStages - 2>();
    fence_proxy_async();
    __syncthreads();
    {
      const int next = c + kStages - 1;
      if (next < nchunks) load_chunk(next, next % kStages);
      cp_async_commit();
    }
    const uint64_t da = sw128_mn_desc(as(c % kStages) + wg * 64 * 128);
    const uint64_t db = sw128_mn_desc(bsm(c % kStages));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)   // 16 token rows: +2048 bytes
      wgmma_tile<BN, 1>(acc, da + 128 * kk, db + 128 * kk);
    wgmma_commit();
    wgmma_wait0();
  }

  cp_async_wait<0>();
  __syncthreads();
  float* os = reinterpret_cast<float*>(ring);
  {
    const int t = tid % 128;
    const int row = wg * 64 + (t / 32) * 16 + (t % 32) / 4;
    const int col = 2 * (t % 4);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      *reinterpret_cast<float2*>(os + row * TL::ldo + 8 * j + col) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(os + (row + 8) * TL::ldo + 8 * j + col) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
  __syncthreads();
  float* part = p.part + (size_t)slice * M * N;
  for (int i = tid; i < kBM * (BN / 4); i += kThreads) {
    const int r = i / (BN / 4);
    const int col = (i % (BN / 4)) * 4;
    const int m = m0 + r;
    const int n = n0 + col;
    if (m >= M || n >= N) continue;
    *reinterpret_cast<float4*>(part + (size_t)m * N + n) =
        *reinterpret_cast<const float4*>(os + r * TL::ldo + col);
  }
}

// The split of T: enough slices that the output tiles times the slices give
// two blocks an SM of the H100's 132, each slice a whole number of 64-row
// chunks.
struct SplitPlan {
  int slices, rows;
};

inline SplitPlan split_plan(int M, int N, int T) {
  const int bn = tile_n(N);
  const int tiles = ((M + kBM - 1) / kBM) * ((N + bn - 1) / bn);
  const int chunks = (T + kBK - 1) / kBK;
  int want = (2 * 132 + tiles - 1) / tiles;
  want = want < chunks ? want : chunks;
  want = want > 1 ? want : 1;
  SplitPlan sp;
  sp.rows = (chunks + want - 1) / want * kBK;
  sp.slices = (T + sp.rows - 1) / sp.rows;
  return sp;
}

inline size_t wgrad_smem(int N) {
  switch (tile_n(N)) {
    case 128: return wgrad_smem_bytes<128>();
    case 96: return wgrad_smem_bytes<96>();
    default: return wgrad_smem_bytes<64>();
  }
}

template <int BN>
int launch_wgrad_tile(const WgradArgs& p, int slices, cudaStream_t stream) {
  const size_t bytes = wgrad_smem_bytes<BN>();
  cudaError_t err = cudaFuncSetAttribute(
      wgrad_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (long long)slices * ((p.M + kBM - 1) / kBM) *
                           ((p.N + BN - 1) / BN);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  wgrad_kernel<BN><<<static_cast<unsigned>(blocks), kThreads, bytes, stream>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}

// part (split_plan(M, N, T).slices, M, N) fp32 <- the slices' partial
// products; M and N multiples of 16.
static inline int launch_wgrad(const __nv_bfloat16* a, const __nv_bfloat16* b,
                               float* part, int M, int N, int T,
                               cudaStream_t stream) {
  if (T < 1 || M % 16 != 0 || N % 16 != 0 || M < 16 || N < 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const SplitPlan sp = split_plan(M, N, T);
  WgradArgs p{a, b, part, M, N, T, sp.rows};
  switch (tile_n(N)) {
    case 128: return launch_wgrad_tile<128>(p, sp.slices, stream);
    case 96: return launch_wgrad_tile<96>(p, sp.slices, stream);
    default: return launch_wgrad_tile<64>(p, sp.slices, stream);
  }
}

// Fixed-order sums of partial rows: out[n] = sum over r < R of in[r][n],
// taken as sums of kSumRows consecutive rows, then sums of those, and so on
// until one row is left; inside each group the rows are added in order.  The
// order depends on R alone, so every launch gives the same bits.
constexpr int kSumRows = 32;

static __global__ void __launch_bounds__(128)
sum_rows_kernel(const float* __restrict__ in, float* __restrict__ out, int R,
                int N) {
  const int r0 = blockIdx.y * kSumRows;
  const int r1 = min(R, r0 + kSumRows);
  float* dst = out + (size_t)blockIdx.y * N;
  if (N % 4 == 0) {
    const int n = 4 * (blockIdx.x * 128 + threadIdx.x);
    if (n >= N) return;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = r0; r < r1; ++r) {
      const float4 v = *reinterpret_cast<const float4*>(in + (size_t)r * N + n);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    *reinterpret_cast<float4*>(dst + n) = s;
  } else {
    const int n = blockIdx.x * 128 + threadIdx.x;
    if (n >= N) return;
    float s = 0.f;
    for (int r = r0; r < r1; ++r) s += in[(size_t)r * N + n];
    dst[n] = s;
  }
}

// Floats of scratch sum_rows needs for R rows of N.
inline size_t sum_rows_scratch(long long R, long long N) {
  if (R <= kSumRows) return 0;
  const long long g1 = (R + kSumRows - 1) / kSumRows;
  const long long g2 = (g1 + kSumRows - 1) / kSumRows;
  return (size_t)(g1 + (g2 > 1 ? g2 : 0)) * N;
}

// out (N) <- the fixed-order sum of in (R, N); tmp holds
// sum_rows_scratch(R, N) floats.
static inline int sum_rows(const float* in, float* out, int R, int N,
                           float* tmp, cudaStream_t stream) {
  if (R < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int per_block = N % 4 == 0 ? 512 : 128;
  const unsigned gx = (N + per_block - 1) / per_block;
  const float* src = in;
  float* bufs[2] = {tmp, nullptr};
  int k = 0;
  while (R > kSumRows) {
    const int G = (R + kSumRows - 1) / kSumRows;
    float* dst = bufs[k];
    sum_rows_kernel<<<dim3(gx, G), 128, 0, stream>>>(src, dst, R, N);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (k == 0) bufs[1] = tmp + (size_t)G * N;
    src = dst;
    R = G;
    k ^= 1;
  }
  sum_rows_kernel<<<dim3(gx, 1), 128, 0, stream>>>(src, out, R, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gemm
}  // namespace fmmt
