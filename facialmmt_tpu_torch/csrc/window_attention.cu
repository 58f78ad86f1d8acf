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
//   fused_window_attention      1 window slot per block;
//   paired_window_attention     the 2 windows of a pair side by side;
//   fused_window_attention_v2   the G <= 4 windows of a group side by side.
// No block-diagonal product is formed: each window slot has its own 4 warps,
// its own scores and its own bias row, which gives the same result as the
// -1e9 off-diagonal blocks (their probabilities are exactly 0) without their
// FLOPs.
//
// What bounds it on the H100: bytes.  Per (window, head) unit it reads q, k,
// v and writes out, 4 * N * hd * 2 = 12.5 KB at N = 49, hd = 32, against
// 4 * N * N * hd = 0.3 MFLOP; at 64 faces stage 0 moves 154 MB (0.046 ms at
// 3.35 TB/s) for 0.004 ms of tensor-core work.
//
// What the design does about it:
// * A block owns one head and `conc` consecutive bias rows, and walks over a
//   chunk of faces: window f * E + row for face f, E = lcm(nW, conc) windows
//   a face (nW = 1: a face is `conc` consecutive windows).  Each warp loads
//   its 16 rows of the bias once, straight into the score accumulator's
//   layout as packed bf16 (16 registers a lane), with -inf at keys and rows
//   past N, so the walk makes no bias load and no bounds check.  The chunk is
//   chosen at launch (ops/kernels/window_attention.py::launch_plan): every
//   Swin stage of a 64-face pack gets at least 2 blocks and, where it has the
//   units, 8 window slots per SM, each walking at most 5 faces.
// * Each unit's q, k and v are one contiguous run of N * hd * 2 bytes.  They
//   reach shared memory through the TMA into a ring of `stages` slots, one
//   mbarrier a slot: while a slot computes unit i, units i + 1 and i + 2 are
//   in flight.  Rows N..63 of every slot are zeroed once; no copy writes them.
// * A tile row is dense, hd * 2 bytes, under the TMA's 32/64/128-byte
//   swizzle (a row's 16-byte pieces permuted by the row), one 3-D tensor-map
//   copy per operand: every fragment load is free of bank conflicts, and a
//   lane's addresses are a few offsets computed once, the swizzle folded in.
//   Rows padded to hd + 8 with one bulk copy a row (147 a unit at N = 49,
//   issued by one warp) ran 2.6 times slower (the variant 'padded' of
//   experiments/torch_window_variants.py).
// * Measured on the H100 (experiments/torch_window_variants.py), the copies
//   alone run at close to the HBM rate and the arithmetic is what bounds the
//   kernel, so the pass is lean: ldmatrix for every fragment, N = 49 fixed at
//   compile time for Swin's 7 x 7 windows, exponentials on the
//   special-function unit, key blocks past N and all-padding row halves
//   skipped.  Each warp owns 16 query rows and keeps their scores, softmax
//   and probabilities in registers (mma.sync m16n8k16, bf16 operands, fp32
//   accumulation; the accumulator layout of q k^T is the A-operand layout of
//   P v).  A row's max and sum are two shuffles inside the 4 lanes that hold
//   it.  The output goes back through the warp's own q rows so that its
//   stores are 16 bytes wide; a slot is refilled only after all 4 warps have
//   passed a barrier behind those stores, each after a proxy fence.
//
// Rounding follows the JAX kernels: fp32 scores, bias added in fp32 from its
// bf16 value, fp32 softmax (exp(s - m) as 2^(s log2(e) - m log2(e)) by
// ex2.approx), probabilities rounded to bf16, fp32 accumulation of P v,
// output rounded once.
//
// fp32 q, k, v and out (the model under --compute_dtype float32; the JAX
// kernels then keep q, k, v, the probabilities and out in q's dtype, the
// scores and softmax in fp32, and round only the bias to bf16): the same
// device kernel instantiated on fp32 tiles (f32).  A tile row is hd * 4
// bytes under the swizzle of its width (128 bytes at hd 32; hd 64's 256-byte
// rows, wider than any swizzle, are unswizzled), with the ring cut to the
// stages that fit a block (ring_stages: 2 at hd 32 with 4 slots, down to 1 at
// hd 64).  Both products run on TF32 mma.sync (m16n8k8, operands rounded by
// cvt.rna, fp32 accumulation), as kernel 1's fp32 instantiation does: the q
// A and k B fragments come from the same ldmatrix lane addresses, each
// 32-bit element read as a pair of b16 halves; the probabilities stay fp32
// and their accumulator layout is P v's A fragment once the product's k index
// is relabelled (k i stands for key 2i, k i + 4 for key 2i + 1 of an 8-key
// block), with v's B fragment read in that order by 32-bit shared loads (no
// transposing ldmatrix moves 32-bit elements), the swizzle folded into a
// lane's two row offsets; out leaves as fp32 through the warp's q rows.
#include "common.cuh"

#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kGroupWarps = 4;                 // warps that own one window slot
constexpr int kGroupThreads = 32 * kGroupWarps;
constexpr int kRows = 64;                      // window rows, padded
constexpr int kMaxConc = 4;                    // windows side by side
constexpr int kMaxStages = 3;                  // ring slots a window slot cycles
constexpr int kAlign = 1024;                   // the 128-byte swizzle's repeat
constexpr int kSmemLimit = 232448;             // opt-in bytes of a Hopper block
constexpr int kMaxDevices = 64;
constexpr uint32_t kNegInf = 0xff80u;          // bf16 -inf

// A tile row: hd elements of 2 (bf16) or 4 (fp32) bytes.
__host__ __device__ constexpr int row_bytes(int hd, int elem) {
  return elem * hd;
}

__host__ __device__ constexpr int tile_bytes(int rb) { return kRows * rb; }

// Tiles (3 a ring slot) of rb-byte rows, then one mbarrier a ring slot,
// after up to kAlign bytes that align the tiles.
__host__ __device__ constexpr long long smem_bytes(int rb, int conc,
                                                   int stages) {
  return kAlign + (long long)conc * stages * (3LL * tile_bytes(rb) + 8);
}

// The most ring slots, kMaxStages at most, that fit a block's shared memory
// (bf16: 3, or 2 at hd 64 with 4 window slots; fp32 down to 1).
__host__ __device__ constexpr int ring_stages(int rb, int conc) {
  return smem_bytes(rb, conc, kMaxStages) <= kSmemLimit
             ? kMaxStages
             : (smem_bytes(rb, conc, 2) <= kSmemLimit ? 2 : 1);
}

__host__ __device__ constexpr int gcd(int a, int b) {
  return b == 0 ? a : gcd(b, a % b);
}

// Barrier of the 4 warps that own window slot g (barrier 0 is __syncthreads).
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, %1;" ::"r"(g + 1), "r"(kGroupThreads) : "memory");
}

// Tile addressing.  A tile row is rb bytes of 16-byte pieces.  The TMA's
// swizzle stores piece p of row r at piece p ^ sw(r), sw(r) = (r / (128 /
// rb)) % (rb / 16): bits 4.. of the address XORed with bits 7.. (every tile
// starts on a 1024-byte boundary).  row_off(r) is the offset of row r with
// sw(r) folded in, and piece(off, p) moves an offset to piece p of the same
// row with one XOR (the bits it flips are 0 in r * rb).  sw(r + 8 m) = sw(r)
// for the rows a lane steps over, so one lane offset serves every 8th row.
// Rows of 256 bytes (fp32 at hd 64) are wider than the 128-byte swizzle can
// span and are stored unswizzled, sw(r) = 0.
template <int kRb>
struct Tile {
  static constexpr int rb = kRb;
  __device__ static __forceinline__ int row_off(int r) {
    if constexpr (rb > 128)
      return r * rb;
    else
      return r * rb + (((r / (128 / rb)) & (rb / 16 - 1)) << 4);
  }
  __device__ static __forceinline__ int piece(int off, int p) {
    return off ^ (p << 4);
  }
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t bias_bits(const __nv_bfloat16* row, int r,
                                              int c, int N) {
  return (r < N && c < N)
             ? (uint32_t)(*reinterpret_cast<const uint16_t*>(row + r * N + c))
             : kNegInf;
}

// 2^x on the special-function unit (ex2.approx, subnormal results flushed to
// zero; 2^-inf = 0), as kernel 1 (attention.cu) takes its exponentials.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float lo_bf16(uint32_t v) {
  return __uint_as_float(v << 16);
}

__device__ __forceinline__ float hi_bf16(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

struct Maps {
  CUtensorMap q, k, v;
};

// The four registers of an ldmatrix fragment, each an fp32 element, rounded
// to TF32 in place.
__device__ __forceinline__ void to_tf32(uint32_t (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) r[i] = fmmt::tf32(__uint_as_float(r[i]));
}

__device__ __forceinline__ uint32_t ld_tf32(const unsigned char* p) {
  return fmmt::tf32(*reinterpret_cast<const float*>(p));
}

// TT: the tokens' type (q, k, v, out), bf16 or fp32.  kN: N fixed at compile
// time (Swin's 7 x 7 windows), or 0 to take n.
template <typename TT, int kConc, int kHd, int kN>
__global__ void __launch_bounds__(kConc * kGroupThreads,
                                  kConc == 1 ? 4 : (kConc == 2 ? 2 : 1))
window_attention_kernel(__grid_constant__ const Maps maps,
                        const __nv_bfloat16* __restrict__ bias,
                        TT* __restrict__ out, int heads, int n, int nW, int E,
                        int faces, int chunk, int stages) {
  constexpr bool kF32 = std::is_same<TT, float>::value;
  using T = Tile<row_bytes(kHd, sizeof(TT))>;
  extern __shared__ unsigned char smem_raw[];
  const int N = kN > 0 ? kN : n;
  constexpr int rb = T::rb;
  constexpr int tile = tile_bytes(rb);
  constexpr int cpr = rb / 16;         // 16-byte pieces per row
  unsigned char* smem =
      smem_raw + (kAlign - fmmt::smem_addr(smem_raw) % kAlign) % kAlign;
  const int g = threadIdx.x / kGroupThreads;   // window slot in the block
  const int tid = threadIdx.x % kGroupThreads;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gid = lane / 4;            // fragment row
  const int tig = lane % 4;            // fragment column pair
  const int r0 = warp * 16;            // this warp's query rows
  const int row0 = r0 + gid;
  const int row1 = row0 + 8;

  // block -> (head, row group, chunk of faces); slot g walks window
  // f * E + row of faces f0 .. f0 + units - 1, bias row row % nW
  const int groups = E / kConc;
  const int head = blockIdx.x % heads;
  const int rest = blockIdx.x / heads;
  const int row = (rest % groups) * kConc + g;
  const int f0 = (rest / groups) * chunk;
  const int units = min(chunk, faces - f0);
  unsigned char* ring = smem + (size_t)g * stages * 3 * tile;
  uint64_t* full = reinterpret_cast<uint64_t*>(
                       smem + (size_t)kConc * stages * 3 * tile) +
                   g * stages;
  const uint32_t unit_bytes = 3u * N * rb;

  // 1. zero rows N..63 of every tile of the ring, set up the mbarriers
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const int pad16 = (kRows - N) * rb / 16;
  for (int i = tid; i < stages * 3 * pad16; i += kGroupThreads)
    *reinterpret_cast<uint4*>(ring + (i / pad16) * tile + N * rb +
                              (i % pad16) * 16) = zero;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) fmmt::mbar_init(&full[s], 1);
    fmmt::fence_mbar_init();
  }
  fmmt::fence_proxy_async();
  group_sync(g);

  // unit i of the walk into ring slot s
  auto issue = [&](int i, int s) {
    const int unit = ((f0 + i) * E + row) * heads + head;
    unsigned char* dst = ring + (size_t)s * 3 * tile;
    if (tid == 0) {
      fmmt::mbar_arrive_expect_tx(&full[s], unit_bytes);
      fmmt::tensor_load_3d(dst, &maps.q, 0, 0, unit, &full[s]);
      fmmt::tensor_load_3d(dst + tile, &maps.k, 0, 0, unit, &full[s]);
      fmmt::tensor_load_3d(dst + 2 * tile, &maps.v, 0, 0, unit, &full[s]);
    }
  };
  for (int i = 0; i < min(stages, units); ++i) issue(i, i);

  // 2. this warp's 16 rows of the slot's bias row, once: bb[j][0] holds
  //    columns 8j + 2 tig, + 1 of row0, bb[j][1] those of row1, as bf16 bits
  uint32_t bb[kRows / 8][2];
  if (r0 < N) {
    const __nv_bfloat16* bias_u =
        bias + ((size_t)(row % nW) * heads + head) * N * N;
#pragma unroll
    for (int j = 0; j < kRows / 8; ++j) {
      const int c = 8 * j + 2 * tig;
      bb[j][0] = bias_bits(bias_u, row0, c, N) |
                 bias_bits(bias_u, row0, c + 1, N) << 16;
      bb[j][1] = bias_bits(bias_u, row1, c, N) |
                 bias_bits(bias_u, row1, c + 1, N) << 16;
    }
  }

  // lane offsets of the ldmatrix rows (see fmmt::ldmatrix_x4 and _x4_trans):
  // the q A fragment (rows r0 + lane % 16, piece lane / 16 of a 16-column
  // step), two k B fragments (key rows lane % 8 + 8 (lane / 16), piece
  // lane / 8 % 2), two v B fragments (key rows lane % 16, piece lane / 16),
  // and this lane's output pair (row0, column 2 tig of a piece)
  const int qa = T::piece(T::row_off(r0 + lane % 16), lane / 16);
  const int kbo = T::piece(T::row_off(lane % 8 + 8 * (lane / 16)),
                           lane / 8 % 2);
  const int vbo = T::piece(T::row_off(lane % 16), lane / 16);
  const int oo = T::row_off(row0) + 4 * tig;
  // fp32: this lane's v elements (key 2 tig, + 1 of an 8-key block, column
  // gid of an 8-column block; the XOR with an even piece p moves them to
  // columns 4 p + gid) and its output pair (row0, columns 2 tig, + 1)
  const int vo0 = T::piece(T::row_off(2 * tig), gid / 4) + 4 * (gid % 4);
  const int vo1 = T::piece(T::row_off(2 * tig + 1), gid / 4) + 4 * (gid % 4);
  const int oo32 = T::piece(T::row_off(row0), tig / 2) + 8 * (tig % 2);

  int s = 0;
  uint32_t phase = 0;
  for (int i = 0; i < units; ++i) {
    unsigned char* qb = ring + (size_t)s * 3 * tile;
    const uint32_t qs = fmmt::smem_addr(qb);
    fmmt::mbar_wait(&full[s], phase);

    if (r0 < N) {
      // 3. scores of this warp's 16 rows against all keys, in registers:
      //    sc[j] is the 16 x 8 block of keys 8j..8j+7
      float sc[kRows / 8][4];
#pragma unroll
      for (int j = 0; j < kRows / 8; ++j)
        sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
      // a k step is two 16-byte pieces of a row: 16 bf16 or 8 fp32 columns
#pragma unroll
      for (int ks = 0; ks < cpr / 2; ++ks) {
        uint32_t a[4];
        ldsm_x4(a, qs + T::piece(qa, 2 * ks));
        if constexpr (kF32) to_tf32(a);
#pragma unroll
        for (int jj = 0; jj < kRows / 16; ++jj) {
          if (16 * jj < N) {
            uint32_t b[4];
            ldsm_x4(b, qs + tile + T::piece(kbo, 2 * ks) + 16 * jj * rb);
            if constexpr (kF32) {
              to_tf32(b);
              fmmt::mma_1688_tf32(sc[2 * jj], a, b[0], b[1]);
              if (16 * jj + 8 < N)
                fmmt::mma_1688_tf32(sc[2 * jj + 1], a, b[2], b[3]);
            } else {
              fmmt::mma_16816(sc[2 * jj], a, b[0], b[1]);
              if (16 * jj + 8 < N)
                fmmt::mma_16816(sc[2 * jj + 1], a, b[2], b[3]);
            }
          }
        }
      }

      // 4. + bias (-inf past N), softmax over the N real keys in fp32.  Lane
      //    (gid, tig) holds columns 8j + 2 tig, + 1 of rows row0 (sc[j][0..1])
      //    and row1 (sc[j][2..3]); the 4 lanes of a gid hold a whole row.
      //    Key blocks wholly past N, and row1 where all of this warp's row1
      //    are padding, have probability 0 and are not computed (adding
      //    their exp(-inf) = 0 to the sums would change no bit).
      const bool half1 = r0 + 8 < N;
      float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < kRows / 8; ++j) {
        if (8 * j < N) {
          sc[j][0] += lo_bf16(bb[j][0]);
          sc[j][1] += hi_bf16(bb[j][0]);
          sc[j][2] += lo_bf16(bb[j][1]);
          sc[j][3] += hi_bf16(bb[j][1]);
          m0 = fmaxf(m0, fmaxf(sc[j][0], sc[j][1]));
          m1 = fmaxf(m1, fmaxf(sc[j][2], sc[j][3]));
        }
      }
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
      // exp(s - m) = 2^(s log2(e) - m log2(e)): one fma and one ex2; a
      // padded row's max is taken as 0 (every score is -inf)
      const float ml0 = row0 < N ? m0 * kLog2e : 0.f;
      const float ml1 = row1 < N ? m1 * kLog2e : 0.f;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < kRows / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (8 * j < N) {
            sc[j][e] = ex2(fmaf(sc[j][e], kLog2e, -ml0));
            sum0 += sc[j][e];
          } else {
            sc[j][e] = 0.f;
          }
          if (8 * j < N && half1) {
            sc[j][2 + e] = ex2(fmaf(sc[j][2 + e], kLog2e, -ml1));
            sum1 += sc[j][2 + e];
          } else {
            sc[j][2 + e] = 0.f;
          }
        }
      }
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
      const float inv0 = row0 < N ? 1.f / sum0 : 0.f;
      const float inv1 = row1 < N ? 1.f / sum1 : 0.f;
      uint4* o4 = reinterpret_cast<uint4*>(
          out + (size_t)(((f0 + i) * E + row) * heads + head) * N * kHd);
      if constexpr (kF32) {
        // 5f. P v on TF32, one 8-key block at a time: the probabilities in
        //     fp32, P's A fragment the score registers as they lie (k index
        //     t for key 2 tig, t + 4 for key 2 tig + 1), v's B fragment
        //     keys 8j + 2 tig, + 1 of column 8 jn + gid
        float oc[kHd / 8][4];
#pragma unroll
        for (int jn = 0; jn < kHd / 8; ++jn)
          oc[jn][0] = oc[jn][1] = oc[jn][2] = oc[jn][3] = 0.f;
#pragma unroll
        for (int j = 0; j < kRows / 8; ++j) {
          if (8 * j < N) {
            const uint32_t pa[4] = {fmmt::tf32(sc[j][0] * inv0),
                                    fmmt::tf32(sc[j][2] * inv1),
                                    fmmt::tf32(sc[j][1] * inv0),
                                    fmmt::tf32(sc[j][3] * inv1)};
            const unsigned char* vr = qb + 2 * tile + 8 * j * rb;
#pragma unroll
            for (int jn = 0; jn < kHd / 8; ++jn)
              fmmt::mma_1688_tf32(oc[jn], pa,
                                  ld_tf32(vr + (vo0 ^ (2 * jn << 4))),
                                  ld_tf32(vr + (vo1 ^ (2 * jn << 4))));
          }
        }
        // 6f. fp32 into this warp's own q rows, then its real rows out
        __syncwarp();
#pragma unroll
        for (int jn = 0; jn < kHd / 8; ++jn) {
          *reinterpret_cast<float2*>(qb + (oo32 ^ (2 * jn << 4))) =
              make_float2(oc[jn][0], oc[jn][1]);
          *reinterpret_cast<float2*>(qb + (oo32 ^ (2 * jn << 4)) + 8 * rb) =
              make_float2(oc[jn][2], oc[jn][3]);
        }
      } else {
        // probabilities in bf16, already in the A-operand layout of P v
        uint32_t pr[kRows / 8][2];
#pragma unroll
        for (int j = 0; j < kRows / 8; ++j) {
          pr[j][0] = fmmt::pack_bf16(sc[j][0] * inv0, sc[j][1] * inv0);
          pr[j][1] = fmmt::pack_bf16(sc[j][2] * inv1, sc[j][3] * inv1);
        }

        // 5. P v (fp32 accumulation): keys 16 ks..16 ks + 15 at a time, two
        //    8-column blocks of v a transposing ldmatrix
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
            for (int jn = 0; jn < kHd / 8; jn += 2) {
              uint32_t b[4];
              ldsm_x4_trans(b, qs + 2 * tile + T::piece(vbo, jn) +
                                   16 * ks * rb);
              fmmt::mma_16816(oc[jn], a, b[0], b[1]);
              fmmt::mma_16816(oc[jn + 1], a, b[2], b[3]);
            }
          }
        }

        // 6. bf16 into this warp's own q rows (no other warp reads them), then
        //    its real rows back to device memory, 16 bytes a thread
        __syncwarp();
#pragma unroll
        for (int jn = 0; jn < kHd / 8; ++jn) {
          *reinterpret_cast<uint32_t*>(qb + T::piece(oo, jn)) =
              fmmt::pack_bf16(oc[jn][0], oc[jn][1]);
          *reinterpret_cast<uint32_t*>(qb + T::piece(oo, jn) + 8 * rb) =
              fmmt::pack_bf16(oc[jn][2], oc[jn][3]);
        }
      }
      __syncwarp();
      const int rows_here = min(16, N - r0);
      for (int p = lane; p < rows_here * cpr; p += 32) {
        const int r = r0 + p / cpr;
        o4[r * cpr + p % cpr] = *reinterpret_cast<const uint4*>(
            qb + T::piece(T::row_off(r), p % cpr));
      }
    }
    // the slot is refilled only after every warp is done with it
    fmmt::fence_proxy_async();
    group_sync(g);
    if (i + stages < units) issue(i + stages, s);
    if (++s == stages) {
      s = 0;
      phase ^= 1;
    }
  }
}

template <typename TT, int kConc, int kHd, int kN>
int launch(const void* q, const void* k, const void* v, const void* bias,
           void* out, int W, int heads, int N, int nW, int chunk,
           void* stream) {
  const auto kernel = window_attention_kernel<TT, kConc, kHd, kN>;
  constexpr int rb = row_bytes(kHd, sizeof(TT));
  constexpr int stages = ring_stages(rb, kConc);
  constexpr long long bytes = smem_bytes(rb, kConc, stages);
  // the shared-memory attribute once per instantiation and device
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[dev] = true;
  }
  Maps maps;
  // the swizzle spans a row (Tile's sw): 32, 64 or 128 bytes, none above
  constexpr CUtensorMapSwizzle swizzle =
      rb == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
               : (rb == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : (rb == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                        : CU_TENSOR_MAP_SWIZZLE_NONE));
  CUtensorMap* const dst[3] = {&maps.q, &maps.k, &maps.v};
  const void* const src[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    err = fmmt::encode_tile_stack(dst[i], src[i], kHd, N,
                                  (long long)W * heads, swizzle,
                                  (int)sizeof(TT));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int E = nW / gcd(nW, kConc) * kConc;
  const int faces = W / E;
  const int blocks = heads * (E / kConc) * ((faces + chunk - 1) / chunk);
  kernel<<<blocks, kConc * kGroupThreads, bytes,
           static_cast<cudaStream_t>(stream)>>>(
      maps, static_cast<const __nv_bfloat16*>(bias), static_cast<TT*>(out),
      heads, N, nW, E, faces, chunk, stages);
  return static_cast<int>(cudaGetLastError());
}

template <typename TT, int kConc>
int launch_hd(const void* q, const void* k, const void* v, const void* bias,
              void* out, int W, int heads, int N, int hd, int nW, int chunk,
              void* stream) {
  switch (hd) {
    case 16:
      return launch<TT, kConc, 16, 0>(q, k, v, bias, out, W, heads, N, nW,
                                      chunk, stream);
    case 32:   // Swin's head dim; its 7 x 7 windows with N fixed
      return N == 49 ? launch<TT, kConc, 32, 49>(q, k, v, bias, out, W, heads,
                                                 N, nW, chunk, stream)
                     : launch<TT, kConc, 32, 0>(q, k, v, bias, out, W, heads,
                                                N, nW, chunk, stream);
    default:
      return launch<TT, kConc, 64, 0>(q, k, v, bias, out, W, heads, N, nW,
                                      chunk, stream);
  }
}

template <typename TT>
int launch_conc(const void* q, const void* k, const void* v, const void* bias,
                void* out, int W, int heads, int N, int hd, int nW, int conc,
                int chunk, void* stream) {
  switch (conc) {
    case 1:
      return launch_hd<TT, 1>(q, k, v, bias, out, W, heads, N, hd, nW, chunk,
                              stream);
    case 2:
      return launch_hd<TT, 2>(q, k, v, bias, out, W, heads, N, hd, nW, chunk,
                              stream);
    case 3:
      return launch_hd<TT, 3>(q, k, v, bias, out, W, heads, N, hd, nW, chunk,
                              stream);
    default:
      return launch_hd<TT, 4>(q, k, v, bias, out, W, heads, N, hd, nW, chunk,
                              stream);
  }
}

}  // namespace

// Shared-memory bytes one block of `conc` window slots needs, ring
// included, for bf16 tiles or (f32) fp32 ones; the wrapper's launch plan
// computes the same and a card test holds the two equal.
FMMT_API long long fmmt_window_attention_smem(int hd, int conc, int f32) {
  const int rb = row_bytes(hd, f32 ? 4 : 2);
  return smem_bytes(rb, conc, ring_stages(rb, conc));
}

// conc: window slots side by side in a block (1..4; when nW > 1 it divides
// nW); chunk: faces a block walks (E = lcm(nW, conc) windows a face; the last
// chunk may be shorter).  q, k, v and out are 16-byte aligned, fp32 when f32
// is nonzero, else bf16.
FMMT_API int fmmt_window_attention(const void* q, const void* k, const void* v,
                                   const void* bias, void* out, int W,
                                   int heads, int N, int hd, int nW, int conc,
                                   int chunk, int f32, void* stream) {
  if (N < 1 || N > kRows || (hd != 16 && hd != 32 && hd != 64) || conc < 1 ||
      conc > kMaxConc || chunk < 1 || nW < 1 || W % nW != 0 ||
      (nW > 1 && nW % conc != 0) || W % (nW / gcd(nW, conc) * conc) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* const operands[4] = {q, k, v, out};
  for (const void* p : operands)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return static_cast<int>(cudaErrorMisalignedAddress);
  if (f32)
    return launch_conc<float>(q, k, v, bias, out, W, heads, N, hd, nW, conc,
                              chunk, stream);
  return launch_conc<__nv_bfloat16>(q, k, v, bias, out, W, heads, N, hd, nW,
                                    conc, chunk, stream);
}
