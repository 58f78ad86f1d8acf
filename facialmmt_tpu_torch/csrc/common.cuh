// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel library entry point has a plain C signature (pointers and the
// stream as void*, sizes as int) so Python binds it with ctypes, and returns
// cudaGetLastError() right after the launch: a refused launch (too many
// threads, too much shared memory) never runs, and a later synchronize would
// not report it.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#define FMMT_API extern "C" __attribute__((visibility("default")))

namespace fmmt {

// --- register-fragment and asynchronous-copy helpers (mma.sync, ldmatrix,
// cp.async), shared by the kernels that keep their tiles in registers.

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D (16x8, fp32) += A (16x16, bf16, row) * B (16x8, bf16, col).  Lane l holds,
// with g = l / 4 and t = l % 4: a0 = A[g][2t..2t+1], a1 = A[g+8][2t..],
// a2 = A[g][2t+8..], a3 = A[g+8][2t+8..]; b0 = B[2t..2t+1][g],
// b1 = B[2t+8..2t+9][g]; c0, c1 = D[g][2t..2t+1], c2, c3 = D[g+8][2t..2t+1].
// The accumulator of one 16x16 product (two of these, columns 0-7 and 8-15)
// is therefore, packed to bf16, the A fragment of the next product.
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An fp32 value rounded to TF32 (10-bit mantissa, to nearest, ties away),
// as an mma.sync operand register.
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// D (16x8, fp32) += A (16x8, tf32, row) * B (8x8, tf32, col).  Lane l holds,
// with g = l / 4 and t = l % 4: a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4],
// a3 = A[g+8][t+4]; b0 = B[t][g], b1 = B[t+4][g]; c0, c1 = D[g][2t..2t+1],
// c2, c3 = D[g+8][2t..2t+1] (the accumulator layout of mma_16816).
__device__ __forceinline__ void mma_1688_tf32(float (&c)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The B fragment of a 16 (k) x 8 (n) block of a row-major [k][n] tile: lanes
// 0..15 pass the addresses of its 16 rows, and the transposing load hands
// lane l the pairs [2t..2t+1][g] and [2t+8..2t+9][g].
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& b0, uint32_t& b1,
                                                  const __nv_bfloat16* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];"
      : "=r"(b0), "=r"(b1)
      : "r"(smem_addr(row)));
}

// Four 8x8 bf16 matrices; lanes 8i..8i+7 pass the row addresses of matrix i
// and lane l receives row l / 4, columns 2 (l % 4) and 2 (l % 4) + 1 of each.
// * A fragment of rows r0..r0+15, columns c0..c0+15 of a row-major tile:
//   lane l passes &tile[r0 + l % 16][c0 + (l / 16) * 8] -> {a0, a1, a2, a3}.
// * B fragments of two 8-column blocks of a tile stored [n][k] (k^T rows):
//   lane l passes &tile[n0 + l % 8 + (l / 16) * 8][k0 + (l / 8 % 2) * 8]
//   -> {b0, b1} of columns n0..n0+7, then {b0, b1} of n0+8..n0+15.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const __nv_bfloat16* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}

// The transposing load of four 8x8 matrices: lane l receives rows 2 (l % 4)
// and 2 (l % 4) + 1 of column l / 4.  B fragments of two 8-column blocks of a
// row-major [k][n] tile: lane l passes &tile[k0 + l % 16][n0 + (l / 16) * 8]
// -> {b0, b1} of columns n0..n0+7, then {b0, b1} of n0+8..n0+15.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const __nv_bfloat16* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}

// 16 bytes from device to shared memory without passing through registers.
// With full == false nothing is read and the 16 bytes are zero-filled (src
// must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

// The same for 4 bytes (through L1: small, reused, unaligned to 16).
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most n of this thread's committed groups are in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(n) : "memory");
}

// --- Hopper's asynchronous copies: mbarriers, bulk copies through the
// Tensor Memory Accelerator (TMA) and the proxy fence between them and
// ordinary shared-memory accesses.
//
// An mbarrier counts arrivals and bytes: a stage of a ring is "full" when
// its one producer has arrived (arrive.expect_tx, announcing the bytes) and
// the bulk copies have delivered those bytes (complete_tx).  Its phase flips
// each time; a consumer's k-th wait on a barrier passes parity k & 1.

// Make shared-memory writes of this thread visible to later bulk copies (the
// async proxy) into the same memory, and the other way round.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(arrivals)
               : "memory");
}

// After the initialising thread's mbar_init calls, before a barrier that
// hands the mbarriers to other threads.
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Spin until the phase of parity `parity` has completed; the bytes the bulk
// copies delivered in it are then visible to this thread.  A phase that never
// completes (bytes announced but not copied) traps after about 2^34 cycles,
// so the launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  const long long start = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1LL << 34)) __trap();
  }
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from device to
// shared memory by the TMA; completion is counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The box of a 3-D tensor map at coordinates (c0, c1, c2), innermost first,
// into shared memory (128-byte aligned; under a swizzle, aligned to the
// swizzle's repeat so that its pattern follows the tile's own rows).
__device__ __forceinline__ void tensor_load_3d(void* dst, const CUtensorMap* map,
                                               int c0, int c1, int c2,
                                               uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_addr(bar))
      : "memory");
}

// cuTensorMapEncodeTiled, looked up in the driver at run time so that the
// library does not link libcuda.  Null when the driver lacks it.
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A tensor map over `count` tiles of rows x cols elements stored one after
// another, bf16 (elem 2) or fp32 (elem 4) (cols * elem a multiple of 16,
// base 16-byte aligned), whose box is one whole tile: coordinates (0, 0, t)
// copy tile t.  `swizzle` permutes the 16-byte pieces of each row in shared
// memory by the row (its span must be at least a row's bytes).
inline cudaError_t encode_tile_stack(CUtensorMap* map, const void* base,
                                     int cols, int rows, long long count,
                                     CUtensorMapSwizzle swizzle,
                                     int elem = 2) {
  const EncodeTiledFn encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)count};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * elem,
                                 (cuuint64_t)cols * rows * elem};
  const cuuint32_t box[3] = {(cuuint32_t)cols, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map,
                elem == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                3,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

__device__ __forceinline__ float bf(const __nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Round an fp32 value through bf16, as the JAX kernels' .astype(bf16) does.
__device__ __forceinline__ float round_bf16(const float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Eight consecutive elements of a row in fp32: one 16-byte load of bf16, or
// two of fp32 (p 32-byte aligned: rows of K % 8 == 0 elements).
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    v[2 * e] = f.x;
    v[2 * e + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 lo = reinterpret_cast<const float4*>(p)[0];
  const float4 hi = reinterpret_cast<const float4*>(p)[1];
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

// One token element as fp32, and back into the tokens' type (bf16: rounded
// once, as the JAX kernels' .astype(x.dtype); fp32: as is).
__device__ __forceinline__ float to_f32(const __nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(const float v) { return v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, const float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void store_f32(float* p, const float v) { *p = v; }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// A bump allocator over one scratch buffer.  Run once with base = nullptr it
// counts the bytes a call needs (the wrapper's query), then hands out the
// same offsets over the buffer the wrapper allocated.
struct Arena {
  unsigned char* base;
  size_t used;
  template <typename T>
  T* take(size_t n) {
    used = (used + 255) / 256 * 256;
    T* p = base ? reinterpret_cast<T*>(base + used) : nullptr;
    used += n * sizeof(T);
    return p;
  }
};

}  // namespace fmmt
