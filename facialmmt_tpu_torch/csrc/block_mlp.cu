// Swin block MLP half:
//   out[t] = x[t] + keep[t] * fc2(GELU_erf(fc1(LN2(x[t]))))
// x (T,C) bf16 tokens; LN2 gamma/beta (C); fc1 weight (HID,C) and bias (HID);
// fc2 weight (C,HID) and bias (C), torch Linear layout, all bf16; keep (T,)
// fp32 optional.  Any T works: the last tile masks its missing rows.  C is a
// multiple of 16 up to 768 and HID a multiple of 64.
//
// Replaces: facialmmt_tpu/ops/pallas/block_mlp.py::fused_ln_mlp_residual.
//
// What bounds it on the H100: two GEMMs of 2*T*C*HID FLOP each (HID = 4C)
// against 4*T*C bytes of token traffic, so it is compute-bound on the tensor
// cores; left unfused, the (T, 4C) GELU intermediate makes a round trip
// through device memory between fc1 and fc2 (at stage 0 of a 64-face pack,
// 200704 x 384 values).
//
// What the design does about it: one block (8 warps) owns a tile of 32
// tokens.  It normalises them into shared memory once, then walks the hidden
// dimension in chunks of 64 units: fc1 for the chunk runs on the tensor cores
// (bf16 16x16x16 mma, fp32 accumulation; one 16x16 tile per warp), GELU with
// CUDA's erff goes to a small bf16 buffer, and fc2's partial products for the
// chunk accumulate into fragments that stay in registers for the whole
// hidden loop (at most 12 per warp, C <= 768).  The hidden activations never
// leave the SM, and at stage 3 (HID = 3072) the per-tile hidden state is
// 32 x 64 values instead of 32 x 3072.  Weight tiles are read straight from
// L2 (every block reads all of W1 and W2); staging them through shared memory
// with TMA and wgmma is later work.
//
// Rounding follows the JAX kernel: LN output and GELU output are rounded to
// bf16 before their matmuls; fc2 + bias, keep and the residual add are fp32,
// rounded once.
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

// fc2 output tiles per warp for width C: (kTile/16) * (C/16) tiles over
// kWarps warps.  The kernel is compiled for 2, 3 and 12 accumulator
// fragments: measured at the Swin-tiny stage shapes with 64 faces (NVIDIA
// H100 80GB HBM3, 700.00 W), the 2- and 3-fragment builds (C = 96, 192) ran
// 1.7x and 1.4x faster than the 12-fragment one, whose 172 registers allow
// one block per SM, while at C = 384 the 12-fragment build beat a 6-fragment
// one (0.75 vs 0.86 ms).
__host__ __device__ constexpr int acc_tiles(int C) {
  return ((kTile / 16) * (C / 16) + kWarps - 1) / kWarps;
}

struct Layout {
  int ldx;   // bf16 row stride of xn (C + 8)
  int ldf;   // fp32 row stride of the fc1 chunk (kChunk + 4)
  int ldh;   // bf16 row stride of the GELU chunk (kChunk + 8)
  int ldy;   // fp32 row stride of the output staging (C + 4)
  size_t off_f, off_h, bytes;
};

__host__ __device__ inline Layout layout(int C) {
  Layout L;
  L.ldx = C + 8;
  L.ldf = kChunk + 4;
  L.ldh = kChunk + 8;
  L.ldy = C + 4;
  L.off_f = (size_t)kTile * L.ldx * sizeof(__nv_bfloat16);
  L.off_h = L.off_f + (size_t)kTile * L.ldf * sizeof(float);
  const size_t main = L.off_h + (size_t)kTile * L.ldh * sizeof(__nv_bfloat16);
  const size_t stage = (size_t)kTile * L.ldy * sizeof(float);  // reuses all
  L.bytes = main > stage ? main : stage;
  return L;
}

template <int kAcc>
__global__ void __launch_bounds__(kThreads)
block_mlp_kernel(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ gamma,
                 const __nv_bfloat16* __restrict__ beta,
                 const __nv_bfloat16* __restrict__ w1,
                 const __nv_bfloat16* __restrict__ b1,
                 const __nv_bfloat16* __restrict__ w2,
                 const __nv_bfloat16* __restrict__ b2,
                 const float* __restrict__ keep,
                 __nv_bfloat16* __restrict__ out, int T, int C, int HID,
                 float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(C);
  __nv_bfloat16* xn = reinterpret_cast<__nv_bfloat16*>(smem);
  float* hf = reinterpret_cast<float*>(smem + L.off_f);
  __nv_bfloat16* hb = reinterpret_cast<__nv_bfloat16*>(smem + L.off_h);
  float* ys = reinterpret_cast<float*>(smem);   // after the hidden loop

  const int t0 = blockIdx.x * kTile;
  const int rows = min(kTile, T - t0);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  // LN2 -> xn (bf16), one warp per row; missing rows of the last tile are 0
  for (int r = warp; r < kTile; r += kWarps) {
    if (r < rows) {
      fmmt::warp_layernorm_row(x + (size_t)(t0 + r) * C, gamma, beta,
                               xn + (size_t)r * L.ldx, C, eps, lane);
    } else {
      for (int i = lane; i < C; i += 32)
        xn[(size_t)r * L.ldx + i] = __float2bfloat16(0.f);
    }
  }
  __syncthreads();

  // this warp's fc2 output tiles: t = warp + kWarps * i over (kTile/16) x
  // (C/16) tiles, row-tile major
  const int ntiles = (kTile / 16) * (C / 16);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> yacc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) wmma::fill_fragment(yacc[i], 0.f);

  // fc1 tile of this warp inside a chunk: 2 x 4 tiles of 16x16
  const int f_m = warp / 4;
  const int f_n = warp % 4;

  for (int j0 = 0; j0 < HID; j0 += kChunk) {
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int k0 = 0; k0 < C; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> b;
        wmma::load_matrix_sync(a, xn + (size_t)(f_m * 16) * L.ldx + k0, L.ldx);
        wmma::load_matrix_sync(b, w1 + (size_t)(j0 + f_n * 16) * C + k0, C);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(hf + (f_m * 16) * L.ldf + f_n * 16, acc, L.ldf,
                              wmma::mem_row_major);
    }
    __syncthreads();
    for (int i = tid; i < kTile * kChunk; i += kThreads) {
      const int r = i / kChunk;
      const int jj = i % kChunk;
      const float h = hf[r * L.ldf + jj] + fmmt::bf(b1[j0 + jj]);
      hb[r * L.ldh + jj] =
          __float2bfloat16(0.5f * h * (1.f + erff(h * 0.70710678118654752f)));
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int t = warp + kWarps * i;
      if (t < ntiles) {
        const int m = t / (C / 16);
        const int n = t % (C / 16);
        for (int k0 = 0; k0 < kChunk; k0 += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::col_major> b;
          wmma::load_matrix_sync(a, hb + (m * 16) * L.ldh + k0, L.ldh);
          wmma::load_matrix_sync(b, w2 + (size_t)(n * 16) * HID + j0 + k0, HID);
          wmma::mma_sync(yacc[i], a, b, yacc[i]);
        }
      }
    }
    __syncthreads();  // hf / hb are rewritten by the next chunk
  }

  // stage the fp32 result over the (now dead) xn / hidden buffers
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int t = warp + kWarps * i;
    if (t < ntiles) {
      const int m = t / (C / 16);
      const int n = t % (C / 16);
      wmma::store_matrix_sync(ys + (m * 16) * L.ldy + n * 16, yacc[i], L.ldy,
                              wmma::mem_row_major);
    }
  }
  __syncthreads();

  // bias, keep scale, fp32 residual; c fastest so the store is coalesced
  for (int i = tid; i < rows * C; i += kThreads) {
    const int r = i / C;
    const int c = i % C;
    const size_t t = (size_t)t0 + r;
    float y = ys[r * L.ldy + c] + fmmt::bf(b2[c]);
    if (keep) y *= keep[t];
    out[t * C + c] = __float2bfloat16(fmmt::bf(x[t * C + c]) + y);
  }
}

template <int kAcc>
int launch(const void* x, const void* gamma, const void* beta, const void* w1,
           const void* b1, const void* w2, const void* b2, const void* keep,
           void* out, int T, int C, int HID, float eps, void* stream) {
  const size_t bytes = layout(C).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      block_mlp_kernel<kAcc>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (T + kTile - 1) / kTile;
  block_mlp_kernel<kAcc><<<blocks, kThreads, bytes,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(gamma),
      static_cast<const __nv_bfloat16*>(beta),
      static_cast<const __nv_bfloat16*>(w1),
      static_cast<const __nv_bfloat16*>(b1),
      static_cast<const __nv_bfloat16*>(w2),
      static_cast<const __nv_bfloat16*>(b2), static_cast<const float*>(keep),
      static_cast<__nv_bfloat16*>(out), T, C, HID, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared-memory bytes one block needs; the wrapper checks this against the
// card's limit before launching.
FMMT_API long long fmmt_fused_ln_mlp_residual_smem(int C) {
  return static_cast<long long>(layout(C).bytes);
}

FMMT_API int fmmt_fused_ln_mlp_residual(const void* x, const void* gamma,
                                        const void* beta, const void* w1,
                                        const void* b1, const void* w2,
                                        const void* b2, const void* keep,
                                        void* out, int T, int C, int HID,
                                        float eps, void* stream) {
  if (C % 16 != 0 || C > kMaxC || HID % kChunk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int need = acc_tiles(C);
  if (need <= 2) return launch<2>(x, gamma, beta, w1, b1, w2, b2, keep, out,
                                  T, C, HID, eps, stream);
  if (need <= 3) return launch<3>(x, gamma, beta, w1, b1, w2, b2, keep, out,
                                  T, C, HID, eps, stream);
  return launch<12>(x, gamma, beta, w1, b1, w2, b2, keep, out, T, C, HID, eps,
                    stream);
}
