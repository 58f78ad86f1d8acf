// Fused multi-head attention for the text tower:
//   out[b,h] = softmax(q[b,h] k[b,h]^T + bias[b]) v[b,h]
// q (B,H,Sq,D) pre-scaled, k/v (B,H,Sk,D), all bf16; bias (B,Sk) fp32 additive
// padding bias broadcast over queries; out (B,H,Sq,D) bf16.  Sq != Sk works.
//
// Replaces: facialmmt_tpu/ops/pallas/attention.py::fused_attention.
//
// What bounds it on the H100: at the text tower's shape (B=8 dialogues,
// H=16, S=512, D=64) the math is 4*B*H*S*S*D = 8.6 GFLOP per layer against
// 8 MB of q/k/v/out traffic, so it is compute-bound; the TPU kernel held a
// whole 512x512 fp32 score block per (b,h) in VMEM (1 MB), which does not fit
// the 227 KB of shared memory a Hopper block can use.
//
// What the design does about it: flash-style streaming over K/V tiles of 64
// keys with an online softmax (fp32 running max, sum and accumulator), so the
// score block never exists in memory.  A block of 4 warps owns 64 query rows,
// 16 per warp.  Both matmuls run on the tensor cores (bf16 16x16x16 mma, fp32
// accumulation): S = q k^T per 16x64 strip, then the strip's probabilities
// (bf16) times the V tile, accumulated into the warp's fp32 output strip in
// shared memory after it is rescaled by exp(m_old - m_new).  wgmma/TMA
// pipelining is later work.
//
// Fully padded rows (every key biased by -1e30, as the serving warm-up pack
// sends): the running max starts at -inf and is only ever set from real
// scores; keys are masked by the caller's finite bias, never by -inf, so such
// a row gets a uniform softmax as the JAX reference does, never NaN.  Keys
// past Sk in the last tile are left out of the max and the sum.
#include "common.cuh"

#include <math.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // query rows per block
constexpr int kKeys = 64;           // keys per tile

__host__ __device__ constexpr size_t align128(size_t n) {
  return (n + 127) / 128 * 128;
}

template <int D>
struct Layout {
  static constexpr int ldt = D + 8;       // bf16 q / k / v tiles
  static constexpr int lds = kKeys + 4;   // fp32 score strip
  static constexpr int ldp = kKeys + 8;   // bf16 probability strip
  static constexpr int ldo = D + 4;       // fp32 output strip
  static constexpr size_t tile = align128((size_t)kRows * ldt * 2);
  static constexpr size_t s_bytes = align128(16 * lds * 4);
  static constexpr size_t p_bytes = align128(16 * ldp * 2);
  static constexpr size_t o_bytes = align128(16 * ldo * 4);
  static constexpr size_t stat_bytes = align128(3 * 16 * 4);
  static constexpr size_t warp_bytes = s_bytes + p_bytes + o_bytes + stat_bytes;
  static constexpr size_t off_bias = 3 * tile;
  static constexpr size_t off_warps = off_bias + align128(kKeys * 4);
  static constexpr size_t bytes = off_warps + kWarps * warp_bytes;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const float* __restrict__ bias,
                 __nv_bfloat16* __restrict__ out, int H, int Sq, int Sk) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem + L::tile);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem + 2 * L::tile);
  float* bs = reinterpret_cast<float*>(smem + L::off_bias);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  unsigned char* wbase = smem + L::off_warps + warp * L::warp_bytes;
  float* S = reinterpret_cast<float*>(wbase);
  __nv_bfloat16* P = reinterpret_cast<__nv_bfloat16*>(wbase + L::s_bytes);
  float* O = reinterpret_cast<float*>(wbase + L::s_bytes + L::p_bytes);
  float* mrow = reinterpret_cast<float*>(wbase + L::s_bytes + L::p_bytes +
                                         L::o_bytes);
  float* lrow = mrow + 16;
  float* arow = lrow + 16;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = blockIdx.x * kRows;
  const __nv_bfloat16* qp = q + (size_t)bh * Sq * D;
  const __nv_bfloat16* kp = k + (size_t)bh * Sk * D;
  const __nv_bfloat16* vp = v + (size_t)bh * Sk * D;
  const float* bp = bias + (size_t)b * Sk;
  constexpr int kVec = D / 8;  // 16-byte vectors per row

  // q tile (rows past Sq are zero), per-warp state
  for (int i = tid; i < kRows * kVec; i += kThreads) {
    const int r = i / kVec;
    const int c = (i % kVec) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (q0 + r < Sq)
      val = *reinterpret_cast<const uint4*>(qp + (size_t)(q0 + r) * D + c);
    *reinterpret_cast<uint4*>(qs + r * L::ldt + c) = val;
  }
  for (int i = lane; i < 16 * L::ldo; i += 32) O[i] = 0.f;
  if (lane < 16) {
    mrow[lane] = -INFINITY;
    lrow[lane] = 0.f;
  }
  const __nv_bfloat16* qw = qs + warp * 16 * L::ldt;
  const int r = lane / 2;        // this lane's row of the warp's strip
  const int half = lane % 2;     // and its half of the 64 keys

  for (int k0 = 0; k0 < Sk; k0 += kKeys) {
    const int nk = min(kKeys, Sk - k0);
    __syncthreads();  // every warp is done with the previous K/V tile
    for (int i = tid; i < kKeys * kVec; i += kThreads) {
      const int j = i / kVec;
      const int c = (i % kVec) * 8;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (j < nk) {
        kv = *reinterpret_cast<const uint4*>(kp + (size_t)(k0 + j) * D + c);
        vv = *reinterpret_cast<const uint4*>(vp + (size_t)(k0 + j) * D + c);
      }
      *reinterpret_cast<uint4*>(ks + j * L::ldt + c) = kv;
      *reinterpret_cast<uint4*>(vs + j * L::ldt + c) = vv;
    }
    for (int j = tid; j < kKeys; j += kThreads) bs[j] = j < nk ? bp[k0 + j] : 0.f;
    __syncthreads();

    // S (16 x 64) = q strip @ k tile^T
#pragma unroll
    for (int n = 0; n < kKeys / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int d0 = 0; d0 < D; d0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> bf;
        wmma::load_matrix_sync(a, qw + d0, L::ldt);
        wmma::load_matrix_sync(bf, ks + (n * 16) * L::ldt + d0, L::ldt);
        wmma::mma_sync(acc, a, bf, acc);
      }
      wmma::store_matrix_sync(S + n * 16, acc, L::lds, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax: two lanes per row, 32 keys each
    const float m_old = mrow[r];
    float tmax = -INFINITY;
    for (int j = half * 32; j < half * 32 + 32; ++j)
      if (j < nk) tmax = fmaxf(tmax, S[r * L::lds + j] + bs[j]);
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m_old, tmax);   // finite: nk >= 1, finite bias
    float sum = 0.f;
    for (int j = half * 32; j < half * 32 + 32; ++j) {
      const float p = j < nk ? expf(S[r * L::lds + j] + bs[j] - m_new) : 0.f;
      sum += p;
      P[r * L::ldp + j] = __float2bfloat16(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const float alpha = expf(m_old - m_new);  // 0 on the first tile
    const float l_new = lrow[r] * alpha + sum;
    __syncwarp();
    if (half == 0) {
      mrow[r] = m_new;
      lrow[r] = l_new;
      arow[r] = alpha;
    }
    __syncwarp();

    // O = alpha * O + P @ v tile
    for (int i = lane; i < 16 * D; i += 32) {
      const int rr = i / D;
      O[rr * L::ldo + i % D] *= arow[rr];
    }
    __syncwarp();
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, O + n * 16, L::ldo, wmma::mem_row_major);
#pragma unroll
      for (int j0 = 0; j0 < kKeys; j0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> bf;
        wmma::load_matrix_sync(a, P + j0, L::ldp);
        wmma::load_matrix_sync(bf, vs + j0 * L::ldt + n * 16, L::ldt);
        wmma::mma_sync(acc, a, bf, acc);
      }
      wmma::store_matrix_sync(O + n * 16, acc, L::ldo, wmma::mem_row_major);
    }
    __syncwarp();
  }

  // out = O / l for the warp's live rows
  for (int i = lane; i < 16 * D; i += 32) {
    const int rr = i / D;
    const int row = q0 + warp * 16 + rr;
    if (row < Sq)
      out[((size_t)bh * Sq + row) * D + i % D] =
          __float2bfloat16(O[rr * L::ldo + i % D] / lrow[rr]);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* bias,
           void* out, int B, int H, int Sq, int Sk, cudaStream_t stream) {
  constexpr size_t bytes = Layout<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kRows - 1) / kRows, B * H);
  attention_kernel<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), H, Sq, Sk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Head dims 16, 32 and 64 are compiled (the text tower uses 64); the Python
// wrapper rejects any other before calling.
FMMT_API int fmmt_fused_attention(const void* q, const void* k, const void* v,
                                  const void* bias, void* out, int B, int H,
                                  int Sq, int Sk, int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(q, k, v, bias, out, B, H, Sq, Sk, s);
    case 32: return launch<32>(q, k, v, bias, out, B, H, Sq, Sk, s);
    case 64: return launch<64>(q, k, v, bias, out, B, H, Sq, Sk, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
