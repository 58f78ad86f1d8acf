// Swin block attention half:
//   out[w] = x[w] + keep[w] * (proj(MHA(LN1(x[w])) + bias[w % nW]))
// x (W,N,C) bf16 tokens in window layout; LN1 gamma/beta (C); packed qkv
// weight (3C,C) and bias (3C) in torch Linear layout, q|k|v on the output
// axis, q scaled by hd^-0.5 in-kernel; proj weight (C,C) and bias (C), all
// bf16.  bias (nW,h,N,N) fp32 is the relative-position bias plus the
// shifted-window mask; window w reads row w % nW, so windows must arrive
// faces-major (window_partition order).  keep (W,) fp32 is optional.
// N <= 64; C and the head dim multiples of 16.
//
// Replaces: facialmmt_tpu/ops/pallas/fused_block.py::fused_attention_block.
//
// What bounds it on the H100: per window the qkv and proj products (8 N C^2
// FLOP) and the attention (4 N^2 C FLOP) against 4 N C bytes of tokens in
// and out: 18.6 GFLOP (0.019 ms) at every Swin-tiny stage of a 64-face pack,
// and 77 MB (0.023 ms).  The first version of this kernel (one window a block,
// 49 rows padded to 64, weight fragments straight from L2 for every 16-row
// tile) moved W x 4 x 8 C^2 = 1.21 GB of weights into the SMs per launch and
// sat at 2-4 % of that bound.
//
// What the design does about it: four device kernels on the card's terms,
// one wrapper call (PERF.md counts it as one launch):
//   0. the LN1 statistics of every token row, one warp a row, to a (W N)
//      float2 scratch;
//   1. qkv: the tiled GEMM of tile_gemm.cuh over the W N packed token rows
//      (no padding: windows share 128-row tiles), LN1 applied in its
//      prologue, bias and the q scale as its epilogue, bf16 out to a (W N, 3C)
//      scratch that the wrapper allocates (115 MB at stage 0 of a 64-face
//      pack, 14 MB at stage 3; mostly L2-resident at stages 2-3);
//   2. attention: one (window, head) unit on 4 warps, two units a block, so
//      the grid has W x heads / 2 blocks (768 at stage 3, where W = 64): q,
//      k, v of the head are read from the scratch with 16-byte loads into
//      shared tiles of 64 rows, each warp keeps its 16 query rows' scores,
//      softmax and probabilities in mma.sync registers (as kernels 8-10 do),
//      and the head's output goes to a (W N, C) bf16 scratch in the
//      concatenated-heads layout that proj reads;
//   3. proj: the tiled GEMM again, bias, keep and the fp32 residual as its
//      epilogue.
// Every weight byte that reaches an SM serves 128 token rows (W N / 128 x 8
// C^2 bytes a launch, 0.12 GB at every stage: 10x less), every product is
// hand-written (wgmma in the products, mma.sync in the attention), and no
// step adds with atomics, so two launches give the same bits.
//
// Rounding follows the JAX kernel: xn, q (after the scale), k, v, the
// softmax probabilities and the concatenated head outputs are rounded to
// bf16; the scores, the softmax and the residual add are fp32; out is
// rounded once.
//
// x and out come in bf16 or fp32 (x_f32; the model's compute dtype).  On
// fp32 tokens the LN1 statistics, the residual and out are fp32, as the JAX
// kernel keeps them for x in its own dtype; the products keep bf16 operands
// (the JAX kernel's fp32 instantiation keeps xn, q, k, v and the
// probabilities in fp32: the bf16 operands stay within the port's kernel
// bound of the fp32 plain version, PERF.md).  LN1 is then applied by a row
// pass (swin_bwd.cuh::prep_rows, the prologue's arithmetic) into the head
// outputs' scratch, which the qkv product reads without a prologue before
// the window pass overwrites it, and proj's epilogue is kResidualF32.
//
// The WHOLE Swin block, the attention half then the MLP half
//   y = the attention half above (no keep), rounded to bf16,
//   out = y + fc2(GELU(fc1(LN2(y))))
// (fmmt_fused_whole_block; replaces facialmmt_tpu/ops/pallas/fused_block.py::
// fused_whole_block, which JAX refuses at C = 768 for want of VMEM: here
// every Swin-tiny width, C <= 768) is one wrapper call over the same device
// kernels: the
// four above, then kernel 3's two products (csrc/block_mlp.cu), fc1 with LN2
// in its prologue and bias + GELU as its epilogue, fc2 with bias and the
// residual.  What the JAX kernel saves by keeping y in VMEM (one HBM round
// trip of y, T C bytes each way) is the smaller part of the split's cost on
// the H100 (the products; PERF.md): the split's y round trip stays, and the
// work the fusion removes is the split's LN2 statistics pass, one more read
// of y.  proj's epilogue (kResidualStats) leaves, per row and 128- / 96- /
// 64-column tile of y, the (mean, M2) of the bf16-rounded outputs it wrote,
// and fc1's prologue (kLnParts) merges a row's partials in column order into
// (rstd, -mean rstd): a fixed order, so two launches give the same bits.  At
// C = 768 a row spans six partials, at C = 96 one.
//
// On fp32 tokens (x_f32; the JAX kernel and its _whole_reference keep y,
// LN2's statistics and the residual in x's dtype) the whole block is the
// fp32 instantiations of the two halves in sequence, on the same scratch:
// the attention half above with proj's kResidualF32 into an fp32 y, then
// kernel 3's fp32 path on y (its LN2 statistics, the row pass into the head
// outputs' bf16 scratch, which nothing reads any more, fc1 + GELU, fc2 with
// the fp32 residual, kResidualF32).  kResidualStats / kLnParts take bf16
// rows only; the fp32 block therefore equals kernel 2 then kernel 3 on fp32
// tokens bit for bit.
#include "swin_bwd.cuh"

#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kGroupWarps = 4;                 // warps that own one unit
constexpr int kGroupThreads = 32 * kGroupWarps;
constexpr int kUnits = 2;                      // (window, head) units a block
constexpr int kRows = 64;                      // window rows, padded

// Shared memory of one unit: q, k and v tiles of 64 rows, hd + 8 wide (the
// 16-byte pad keeps fragment loads free of bank conflicts).
__host__ __device__ constexpr size_t unit_bytes(int hd) {
  return 3 * (size_t)kRows * (hd + 8) * sizeof(__nv_bfloat16);
}

// Barrier of the 4 warps that own unit slot g (barrier 0 is __syncthreads).
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, %1;" ::"r"(g + 1), "r"(kGroupThreads) : "memory");
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// softmax(q k^T + bias[w % nW, head]) v for unit u = w * heads + head, q, k
// and v read from the (W N, 3C) rows of step 1, the result written to the
// head's columns of the (W N, C) rows.
__global__ void __launch_bounds__(kUnits * kGroupThreads)
window_pass_kernel(const __nv_bfloat16* __restrict__ qkv,
                   const float* __restrict__ bias,
                   __nv_bfloat16* __restrict__ attn, int units, int heads,
                   int N, int nW, int C, int hd) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldh = hd + 8;              // bf16 row stride of the tiles
  const int cpr = hd / 8;              // 16-byte chunks per row
  const int g = threadIdx.x / kGroupThreads;   // unit slot in the block
  const int u = blockIdx.x * kUnits + g;
  if (u >= units) return;              // the slot's own barrier only
  const int tid = threadIdx.x % kGroupThreads;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gid = lane / 4;            // fragment row
  const int tig = lane % 4;            // fragment column pair
  __nv_bfloat16* qb =
      reinterpret_cast<__nv_bfloat16*>(smem + (size_t)g * unit_bytes(hd));
  __nv_bfloat16* kb = qb + kRows * ldh;
  __nv_bfloat16* vb = kb + kRows * ldh;

  const int w = u / heads;
  const int head = u % heads;
  const size_t tok0 = (size_t)w * N;   // the window's first token row
  const float* bias_u = bias + ((size_t)(w % nW) * heads + head) * N * N;
  const int r0 = warp * 16;            // this warp's query rows
  const int row0 = r0 + gid;
  const int row1 = row0 + 8;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  // 1. the head's q, k, v -> shared memory, 16 bytes a thread; rows N..63
  //    are zero
  for (int i = tid; i < kRows * cpr; i += kGroupThreads) {
    const int r = i / cpr;
    const int c = (i % cpr) * 8;
    const bool real = r < N;
    const __nv_bfloat16* src =
        qkv + (tok0 + (real ? r : 0)) * 3 * C + head * hd + c;
    *reinterpret_cast<uint4*>(qb + r * ldh + c) =
        real ? *reinterpret_cast<const uint4*>(src) : zero;
    *reinterpret_cast<uint4*>(kb + r * ldh + c) =
        real ? *reinterpret_cast<const uint4*>(src + C) : zero;
    *reinterpret_cast<uint4*>(vb + r * ldh + c) =
        real ? *reinterpret_cast<const uint4*>(src + 2 * C) : zero;
  }
  group_sync(g);
  if (r0 >= N) return;                 // all 16 rows are padding

  // 2. scores of this warp's 16 rows against all keys, in registers: sc[j]
  //    is the 16 x 8 block of keys 8j..8j+7
  float sc[kRows / 8][4];
#pragma unroll
  for (int j = 0; j < kRows / 8; ++j)
    sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
  for (int ks = 0; ks < hd / 16; ++ks) {
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

  // 3. + bias (fp32), softmax over the N real keys in fp32.  Lane (gid, tig)
  //    holds columns 8j + 2 tig, + 1 of rows row0 (sc[j][0..1]) and row1
  //    (sc[j][2..3]); the 4 lanes of a gid hold a whole row.
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < kRows / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * j + 2 * tig + e;
      const bool key = col < N;
      sc[j][e] = (key && row0 < N) ? sc[j][e] + bias_u[row0 * N + col]
                                   : -INFINITY;
      sc[j][2 + e] = (key && row1 < N) ? sc[j][2 + e] + bias_u[row1 * N + col]
                                       : -INFINITY;
      m0 = fmaxf(m0, sc[j][e]);
      m1 = fmaxf(m1, sc[j][2 + e]);
    }
  }
  m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
  m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
  m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
  m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
  if (row0 >= N) m0 = 0.f;             // a padded row: every score is -inf
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

  // 4. P v (fp32 accumulation), 16 output columns at a time, each rounded to
  //    bf16 into this warp's own q rows (no other warp reads them, and this
  //    warp is done with its q fragments)
  __syncwarp();
  for (int c0 = 0; c0 < hd; c0 += 16) {
    float oc[2][4];
#pragma unroll
    for (int jn = 0; jn < 2; ++jn)
      oc[jn][0] = oc[jn][1] = oc[jn][2] = oc[jn][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kRows / 16; ++ks) {
      if (16 * ks < N) {
        const uint32_t a[4] = {pr[2 * ks][0], pr[2 * ks][1],
                               pr[2 * ks + 1][0], pr[2 * ks + 1][1]};
#pragma unroll
        for (int jn = 0; jn < 2; ++jn) {
          uint32_t b0, b1;
          fmmt::ldmatrix_x2_trans(
              b0, b1, vb + (16 * ks + (lane & 15)) * ldh + c0 + 8 * jn);
          fmmt::mma_16816(oc[jn], a, b0, b1);
        }
      }
    }
#pragma unroll
    for (int jn = 0; jn < 2; ++jn) {
      const int c = c0 + 8 * jn + 2 * tig;
      *reinterpret_cast<uint32_t*>(qb + row0 * ldh + c) =
          fmmt::pack_bf16(oc[jn][0], oc[jn][1]);
      *reinterpret_cast<uint32_t*>(qb + row1 * ldh + c) =
          fmmt::pack_bf16(oc[jn][2], oc[jn][3]);
    }
  }

  // 5. the warp's real rows to the head's columns, 16 bytes a thread
  __syncwarp();
  const int rows_here = min(16, N - r0);
  for (int i = lane; i < rows_here * cpr; i += 32) {
    const int r = r0 + i / cpr;
    const int c = (i % cpr) * 8;
    *reinterpret_cast<uint4*>(attn + (tok0 + r) * C + head * hd + c) =
        *reinterpret_cast<const uint4*>(qb + r * ldh + c);
  }
}

size_t window_pass_bytes(int hd) { return kUnits * unit_bytes(hd); }

// The four device kernels of the attention half into out (W N, C).  TX:
// the tokens' type (x, out), bf16 or fp32.  kEpi: proj's epilogue,
// kResidual, or kResidualStats with the rows' LN2 partials to row_part (bf16
// tokens only; fp32 tokens take kResidualF32).  stats (W N) float2, qkv
// (W N, 3C) and heads_out (W N, C) bf16 are scratch.
template <typename TX, int kEpi>
int attention_half(const TX* x, const void* gamma, const void* beta,
                   const void* wqkv, const void* bqkv, const void* wproj,
                   const void* bproj, const void* bias, const void* keep,
                   float2* stats, __nv_bfloat16* qkv,
                   __nv_bfloat16* heads_out, TX* out, float2* row_part, int W,
                   int N, int C, int heads, int nW, float eps,
                   cudaStream_t s) {
  constexpr bool kF32 = std::is_same<TX, float>::value;
  static_assert(!kF32 || kEpi == fmmt::gemm::kResidual,
                "fp32 tokens: the attention half alone");
  const int hd = C / heads;
  const auto* gb = static_cast<const __nv_bfloat16*>(gamma);
  const auto* bb = static_cast<const __nv_bfloat16*>(beta);
  int err = fmmt::gemm::launch_row_stats(x, stats, W * N, C, eps, s);
  if (err != 0) return err;
  fmmt::gemm::Args a{};
  a.b = static_cast<const __nv_bfloat16*>(wqkv);
  a.bias = static_cast<const __nv_bfloat16*>(bqkv);
  a.out = qkv;
  a.M = W * N;
  a.N = 3 * C;
  a.K = C;
  a.keep_div = 1;
  a.q_cols = C;
  a.q_scale = 1.f / sqrtf(static_cast<float>(hd));
  if constexpr (kF32) {
    // xn = bf16(LN1(x)) over the head outputs' scratch, which the window
    // pass overwrites only after qkv has read it (one stream)
    err = fmmt::bwd::launch_prep_rows<float>(x, nullptr, stats, gb, bb,
                                             nullptr, 1, heads_out, nullptr,
                                             W * N, C, s);
    if (err != 0) return err;
    a.a = heads_out;
    err = fmmt::gemm::launch<fmmt::gemm::kLnNone, fmmt::gemm::kScaleQ>(a, s);
  } else {
    a.a = x;
    a.stats = stats;
    a.gamma = gb;
    a.beta = bb;
    err = fmmt::gemm::launch<fmmt::gemm::kLnStats, fmmt::gemm::kScaleQ>(a, s);
  }
  if (err != 0) return err;

  const int units = W * heads;
  const size_t bytes = window_pass_bytes(hd);
  cudaError_t cerr = cudaFuncSetAttribute(
      window_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  window_pass_kernel<<<(units + kUnits - 1) / kUnits, kUnits * kGroupThreads,
                       bytes, s>>>(qkv, static_cast<const float*>(bias),
                                   heads_out, units, heads, N, nW, C, hd);
  cerr = cudaGetLastError();
  if (cerr != cudaSuccess) return static_cast<int>(cerr);

  fmmt::gemm::Args p{};
  p.a = heads_out;
  p.b = static_cast<const __nv_bfloat16*>(wproj);
  p.bias = static_cast<const __nv_bfloat16*>(bproj);
  p.keep = static_cast<const float*>(keep);
  p.keep_div = N;
  p.row_part = row_part;
  p.M = W * N;
  p.N = C;
  p.K = C;
  if constexpr (kF32) {
    p.res_f32 = x;
    p.out_f32 = out;
    return fmmt::gemm::launch<fmmt::gemm::kLnNone,
                              fmmt::gemm::kResidualF32>(p, s);
  } else {
    p.res = x;
    p.out = out;
    return fmmt::gemm::launch<fmmt::gemm::kLnNone, kEpi>(p, s);
  }
}

bool bad_shape(int W, int N, int C, int heads, int nW) {
  return W < 1 || N < 1 || N > kRows || C % 16 != 0 || C < 16 || heads < 1 ||
         C % heads != 0 || (C / heads) % 16 != 0 || nW < 1 || W % nW != 0;
}

// The whole block's scratch, in the order it is handed out; y holds the
// tokens' type (bf16, or fp32 when x_f32).
struct WholeScratch {
  float2 *stats, *parts;
  __nv_bfloat16 *qkv, *heads_out;
  void* y;
  __nv_bfloat16* h;
};

WholeScratch whole_plan(fmmt::Arena& ar, int W, int N, int C, int HID,
                        int x_f32) {
  const size_t T = (size_t)W * N;
  WholeScratch s;
  s.stats = ar.take<float2>(T);
  s.parts = ar.take<float2>(T * fmmt::gemm::col_tiles(C));
  s.qkv = ar.take<__nv_bfloat16>(T * 3 * C);
  s.heads_out = ar.take<__nv_bfloat16>(T * C);
  s.y = ar.take<unsigned char>(T * C * (x_f32 ? 4 : 2));
  s.h = ar.take<__nv_bfloat16>(T * HID);
  return s;
}

bool bad_whole_shape(int W, int N, int C, int heads, int nW, int HID) {
  return bad_shape(W, N, C, heads, nW) || C > 768 || HID % 64 != 0 ||
         HID < 64;
}

}  // namespace

// Shared-memory bytes the largest of the steps needs per block; the
// wrapper checks this against the card's limit before launching.
FMMT_API long long fmmt_fused_attention_block_smem(int N, int C, int heads) {
  const size_t qkv = fmmt::gemm::smem_bytes(3 * C, C, true);
  const size_t proj = fmmt::gemm::smem_bytes(C, C, false);
  const size_t core = window_pass_bytes(C / heads);
  size_t most = qkv > proj ? qkv : proj;
  return static_cast<long long>(most > core ? most : core);
}

// stats (W N) float2, qkv_buf (W N, 3C) and attn_buf (W N, C) bf16 are
// scratch the caller allocates; x and out (W, N, C) fp32 when x_f32 is
// nonzero, else bf16.
FMMT_API int fmmt_fused_attention_block(
    const void* x, const void* gamma, const void* beta, const void* wqkv,
    const void* bqkv, const void* wproj, const void* bproj, const void* bias,
    const void* keep, void* stats, void* qkv_buf, void* attn_buf, void* out,
    int W, int N, int C, int heads, int nW, int x_f32, float eps,
    void* stream) {
  if (bad_shape(W, N, C, heads, nW))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* st = static_cast<float2*>(stats);
  auto* qkv = static_cast<__nv_bfloat16*>(qkv_buf);
  auto* heads_out = static_cast<__nv_bfloat16*>(attn_buf);
  if (x_f32)
    return attention_half<float, fmmt::gemm::kResidual>(
        static_cast<const float*>(x), gamma, beta, wqkv, bqkv, wproj, bproj,
        bias, keep, st, qkv, heads_out, static_cast<float*>(out), nullptr, W,
        N, C, heads, nW, eps, s);
  return attention_half<__nv_bfloat16, fmmt::gemm::kResidual>(
      static_cast<const __nv_bfloat16*>(x), gamma, beta, wqkv, bqkv, wproj,
      bproj, bias, keep, st, qkv, heads_out, static_cast<__nv_bfloat16*>(out),
      nullptr, W, N, C, heads, nW, eps, s);
}

// Bytes of scratch one whole-block call needs (-1: a shape it does not
// take); the wrapper allocates them.
FMMT_API long long fmmt_fused_whole_block_scratch(int W, int N, int C,
                                                  int heads, int nW, int HID,
                                                  int x_f32) {
  if (bad_whole_shape(W, N, C, heads, nW, HID)) return -1;
  fmmt::Arena ar{nullptr, 0};
  whole_plan(ar, W, N, C, HID, x_f32);
  return static_cast<long long>(ar.used);
}

// Shared-memory bytes the largest of the whole block's steps needs per block
// (fp32 tokens: fc1 without its LayerNorm prologue).
FMMT_API long long fmmt_fused_whole_block_smem(int N, int C, int heads,
                                               int HID, int x_f32) {
  size_t most = static_cast<size_t>(fmmt_fused_attention_block_smem(N, C,
                                                                    heads));
  const size_t more[] = {
      x_f32 ? fmmt::gemm::smem_bytes(HID, C, false)
            : fmmt::gemm::smem_bytes(HID, C, true, fmmt::gemm::col_tiles(C)),
      fmmt::gemm::smem_bytes(C, HID, false)};
  for (size_t m : more) most = m > most ? m : most;
  return static_cast<long long>(most);
}

// The whole block: the attention half's operands (no keep), then LN2
// gamma2 / beta2 (C), w1 (HID, C), b1 (HID), w2 (C, HID), b2 (C), all bf16;
// scratch of fmmt_fused_whole_block_scratch bytes; x and out (W, N, C) fp32
// when x_f32 is nonzero, else bf16.
FMMT_API int fmmt_fused_whole_block(
    const void* x, const void* gamma, const void* beta, const void* wqkv,
    const void* bqkv, const void* wproj, const void* bproj, const void* bias,
    const void* gamma2, const void* beta2, const void* w1, const void* b1,
    const void* w2, const void* b2, void* scratch, void* out, int W, int N,
    int C, int heads, int nW, int HID, int x_f32, float eps, void* stream) {
  if (bad_whole_shape(W, N, C, heads, nW, HID))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  fmmt::Arena ar{static_cast<unsigned char*>(scratch), 0};
  const WholeScratch sc = whole_plan(ar, W, N, C, HID, x_f32);
  if (x_f32) {
    // kernel 2's fp32 path into y, then kernel 3's on y (csrc/block_mlp.cu)
    const float* xf = static_cast<const float*>(x);
    float* y = static_cast<float*>(sc.y);
    const int T = W * N;
    int err = attention_half<float, fmmt::gemm::kResidual>(
        xf, gamma, beta, wqkv, bqkv, wproj, bproj, bias, nullptr, sc.stats,
        sc.qkv, sc.heads_out, y, nullptr, W, N, C, heads, nW, eps, s);
    if (err != 0) return err;
    err = fmmt::gemm::launch_row_stats(y, sc.stats, T, C, eps, s);
    if (err != 0) return err;
    err = fmmt::bwd::launch_prep_rows<float>(
        y, nullptr, sc.stats, static_cast<const __nv_bfloat16*>(gamma2),
        static_cast<const __nv_bfloat16*>(beta2), nullptr, 1, sc.heads_out,
        nullptr, T, C, s);
    if (err != 0) return err;
    fmmt::gemm::Args a{};
    a.a = sc.heads_out;
    a.b = static_cast<const __nv_bfloat16*>(w1);
    a.bias = static_cast<const __nv_bfloat16*>(b1);
    a.out = sc.h;
    a.M = T;
    a.N = HID;
    a.K = C;
    a.keep_div = 1;
    err = fmmt::gemm::launch<fmmt::gemm::kLnNone, fmmt::gemm::kGelu>(a, s);
    if (err != 0) return err;
    fmmt::gemm::Args p{};
    p.a = sc.h;
    p.b = static_cast<const __nv_bfloat16*>(w2);
    p.bias = static_cast<const __nv_bfloat16*>(b2);
    p.keep_div = 1;
    p.res_f32 = y;
    p.out_f32 = static_cast<float*>(out);
    p.M = T;
    p.N = C;
    p.K = HID;
    return fmmt::gemm::launch<fmmt::gemm::kLnNone,
                              fmmt::gemm::kResidualF32>(p, s);
  }
  auto* y = static_cast<__nv_bfloat16*>(sc.y);
  int err = attention_half<__nv_bfloat16, fmmt::gemm::kResidualStats>(
      static_cast<const __nv_bfloat16*>(x), gamma, beta, wqkv, bqkv, wproj,
      bproj, bias, nullptr, sc.stats, sc.qkv, sc.heads_out, y, sc.parts, W,
      N, C, heads, nW, eps, s);
  if (err != 0) return err;

  fmmt::gemm::Args a{};
  a.a = y;
  a.stats = sc.parts;
  a.parts = fmmt::gemm::col_tiles(C);
  a.part_cols = fmmt::gemm::tile_n(C);
  a.eps = eps;
  a.gamma = static_cast<const __nv_bfloat16*>(gamma2);
  a.beta = static_cast<const __nv_bfloat16*>(beta2);
  a.b = static_cast<const __nv_bfloat16*>(w1);
  a.bias = static_cast<const __nv_bfloat16*>(b1);
  a.out = sc.h;
  a.M = W * N;
  a.N = HID;
  a.K = C;
  a.keep_div = 1;
  err = fmmt::gemm::launch<fmmt::gemm::kLnParts, fmmt::gemm::kGelu>(a, s);
  if (err != 0) return err;

  fmmt::gemm::Args p{};
  p.a = sc.h;
  p.b = static_cast<const __nv_bfloat16*>(w2);
  p.bias = static_cast<const __nv_bfloat16*>(b2);
  p.res = y;
  p.keep_div = 1;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.M = W * N;
  p.N = C;
  p.K = HID;
  return fmmt::gemm::launch<fmmt::gemm::kLnNone, fmmt::gemm::kResidual>(p, s);
}
