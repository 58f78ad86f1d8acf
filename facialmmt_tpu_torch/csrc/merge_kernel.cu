// Swin patch-merging tail: out[t] = LN(x[t]) @ w, no bias.
// x (T, K) bf16 rows of gathered 2x2 neighbourhoods (K = 4C); LN gamma/beta
// (K) bf16; w (K, M) bf16 row-major (M = 2C, the input axis first, as the JAX
// kernel takes it); out (T, M) bf16.  Any T works: the last tile masks its
// missing rows.  K and M are multiples of 16.
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
// What the design does about it: one block (8 warps) owns a tile of 32 rows.
// A row's LayerNorm needs the whole row, so the tile is normalised into shared
// memory first (fp32 statistics, one warp per row; 32 x (K + 8) bf16, 99 KB at
// K = 1536), and the normalised rows never reach device memory.  Then each warp
// takes output column tiles of 16: it streams the K x 16 strip of w from L2
// once and multiplies it into both 16-row halves of the tile on the tensor
// cores (bf16 16x16x16 mma, fp32 accumulation), so w is read once per 32
// rows.  A ring of four blocks of the strip loaded ahead of their mma was
// tried and was no faster on an H100; staging w through shared memory with
// TMA and wgmma is later work.
//
// Rounding follows the JAX kernel: LN output rounded to bf16 before the
// matmul, fp32 accumulation, output rounded once.
#include "common.cuh"

#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 32;       // rows per block

struct Layout {
  int ldx;   // bf16 row stride of the normalised tile (K + 8)
  size_t off_stage, bytes;
};

__host__ __device__ inline Layout layout(int K) {
  Layout L;
  L.ldx = K + 8;
  L.off_stage = (size_t)kTile * L.ldx * sizeof(__nv_bfloat16);
  // two 16x16 fp32 staging tiles per warp
  L.bytes = L.off_stage + (size_t)kWarps * 512 * sizeof(float);
  return L;
}

__global__ void __launch_bounds__(kThreads)
merge_kernel(const __nv_bfloat16* __restrict__ x,
             const __nv_bfloat16* __restrict__ gamma,
             const __nv_bfloat16* __restrict__ beta,
             const __nv_bfloat16* __restrict__ w,
             __nv_bfloat16* __restrict__ out, int T, int K, int M, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(K);
  __nv_bfloat16* xn = reinterpret_cast<__nv_bfloat16*>(smem);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  float* stage = reinterpret_cast<float*>(smem + L.off_stage) + warp * 512;
  const int t0 = blockIdx.x * kTile;
  const int rows = min(kTile, T - t0);

  // LN -> xn (bf16), one warp per row; missing rows of the last tile are 0
  for (int r = warp; r < kTile; r += kWarps) {
    if (r < rows) {
      fmmt::warp_layernorm_row(x + (size_t)(t0 + r) * K, gamma, beta,
                               xn + (size_t)r * L.ldx, K, eps, lane);
    } else {
      for (int i = lane; i < K; i += 32)
        xn[(size_t)r * L.ldx + i] = __float2bfloat16(0.f);
    }
  }
  __syncthreads();

  for (int n = warp; n < M / 16; n += kWarps) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc0, acc1;
    wmma::fill_fragment(acc0, 0.f);
    wmma::fill_fragment(acc1, 0.f);
    for (int k0 = 0; k0 < K; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a0, a1;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b;
      wmma::load_matrix_sync(b, w + (size_t)k0 * M + n * 16, M);
      wmma::load_matrix_sync(a0, xn + k0, L.ldx);
      wmma::load_matrix_sync(a1, xn + (size_t)16 * L.ldx + k0, L.ldx);
      wmma::mma_sync(acc0, a0, b, acc0);
      wmma::mma_sync(acc1, a1, b, acc1);
    }
    wmma::store_matrix_sync(stage, acc0, 16, wmma::mem_row_major);
    wmma::store_matrix_sync(stage + 256, acc1, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 512; e += 32) {
      const int r = e / 16;
      if (r < rows)
        out[(size_t)(t0 + r) * M + n * 16 + e % 16] =
            __float2bfloat16(stage[e]);
    }
    __syncwarp();
  }
}

}  // namespace

// Shared-memory bytes one block needs; the wrapper checks this against the
// card's limit before launching.
FMMT_API long long fmmt_fused_merge_smem(int K) {
  return static_cast<long long>(layout(K).bytes);
}

FMMT_API int fmmt_fused_merge(const void* x, const void* gamma,
                              const void* beta, const void* w, void* out,
                              int T, int K, int M, float eps, void* stream) {
  if (T < 1 || K % 16 != 0 || M % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = layout(K).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (T + kTile - 1) / kTile;
  merge_kernel<<<blocks, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(gamma),
      static_cast<const __nv_bfloat16*>(beta),
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(out),
      T, K, M, eps);
  return static_cast<int>(cudaGetLastError());
}
