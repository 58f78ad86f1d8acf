// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel library entry point has a plain C signature (pointers and the
// stream as void*, sizes as int) so Python binds it with ctypes, and returns
// cudaGetLastError() right after the launch: a refused launch (too many
// threads, too much shared memory) never runs, and a later synchronize would
// not report it.
#pragma once

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

__device__ __forceinline__ float bf(const __nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Round an fp32 value through bf16, as the JAX kernels' .astype(bf16) does.
__device__ __forceinline__ float round_bf16(const float v) {
  return __bfloat162float(__float2bfloat16(v));
}

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
