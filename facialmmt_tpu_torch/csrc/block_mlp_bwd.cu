// Backward of the Swin block MLP half
//   out[t] = x[t] + keep[t] * fc2(GELU_erf(fc1(LN2(x[t]))))
// From x and the output gradient dy (both (T,C) bf16) the kernels recompute
// LN2, fc1 and GELU and return dx (T,C) bf16 and, in fp32, dgamma | dbeta |
// db2 (3C), dW1 (HID,C), db1 (HID), dW2 (C,HID), in torch Linear layout.
// keep (T,) fp32 is optional and gets no gradient: the residual gradient is
// dy, the branch gradient dy * keep.
//
// Replaces: facialmmt_tpu/ops/pallas/block_mlp.py::_bwd_impl_pallas.
//
// What bounds it on the H100: five products of 2 T C HID FLOP each (fc1
// recomputed, dgm = dyk W2, dxn = dh W1, dW1 = dh^T xn, dW2 = dyk^T g; HID =
// 4C, 40 T C^2 FLOP in all: 173 GFLOP, 0.18 ms at 989 TFLOP/s, at every
// stage of a 150-image batch) against the scratch the products hand each
// other through device memory: xn and dyk (T,C) bf16, g and dh (T,HID) bf16,
// the fp32 dxn (T,C), each written once and read once or twice, about
// 26 T C bytes (1.2 GB, 0.35 ms at 3.35 TB/s, at stage 0 where T = 470,400
// and C = 96; 0.06 GB at stage 3).  So stage 0 is bound by the bytes and
// stages 1-3 by the products.  The first version of this kernel (32-token
// blocks of wmma, every weight fragment straight from L2, the dW1 / dW2
// slices added to device memory with fp32 atomics, 2 HID C T / 32 adds a
// call) ran at 2-4 % of that bound and gave other bits every launch.
//
// What the design does about it: device kernels on tile_gemm.cuh's tiled
// wgmma product, one wrapper call (one launch in PERF.md's counts):
//   1. the rows' LN2 statistics (launch_row_stats, as the forward), then
//      xn = bf16(LN2(x)) and dyk = bf16(dy keep) to (T,C) scratch (prep_rows);
//   2. the hidden layer, one block a (128-row, 64-column) tile of (T,HID),
//      two accumulators over one pass of K = C: h = xn W1^T and dgm = dyk W2
//      (B = W2^T, a transposed copy the wrapper makes: 4.7 MB at most, read
//      K-major as every B of the product).  Its epilogue writes g =
//      bf16(GELU(h + b1)) and dh = bf16(dgm GELU'(h + b1)) to two (T,HID)
//      scratches and the column sums of the fp32 dh of its 128 rows for db1;
//      dgm and the fp32 h never reach device memory.  xn is read from step
//      1's copy rather than normalised again in the product's prologue: the
//      same bits, and dW1 needs the copy anyway;
//   3. dxn = dh W1 (B = W1^T, the wrapper's copy), fp32 out (T,C);
//   4. the LayerNorm backward, one warp a row (ln_bwd_rows), with per-block
//      column partials of dgamma, dbeta and db2 = sum dy keep;
//   5. dW1 = dh^T xn and dW2 = dyk^T g as tile_gemm.cuh's split-T products
//      (both operands token-major, read MN-major by wgmma; T cut into fixed
//      slices so that every launch has at least 264 blocks), each slice an
//      fp32 partial;
//   6. sum_rows adds every set of partials in a fixed order.
// No step adds with atomics: two launches give the same bits.
//
// Rounding follows the JAX kernel: xn, the GELU output, dy*keep and dh are
// rounded to bf16 as matmul operands; every accumulation and the LN backward
// are fp32; db1, db2, dgamma, dbeta sum the unrounded fp32 values.
//
// x, dy and dx come in bf16 or fp32 (x_f32; the model's compute dtype), as
// the JAX kernel reads x and the gradient in x's dtype: only steps 1 and 4
// read or write them (swin_bwd.cuh's row kernels), so on fp32 tokens the LN
// statistics, the LN backward and dx are fp32 and the products the same.
#include "swin_bwd.cuh"

namespace {

using fmmt::Arena;
namespace gemm = fmmt::gemm;

struct Scratch {
  float2* st;
  __nv_bfloat16 *xn, *dyk, *g, *dh;
  float *dxn, *db1_part, *ln_part, *dw1_part, *dw2_part, *tmp;
};

// The call's scratch, in the order it is handed out (Arena).
Scratch plan(Arena& ar, int T, int C, int HID) {
  Scratch s;
  const gemm::SplitPlan p1 = gemm::split_plan(HID, C, T);
  const gemm::SplitPlan p2 = gemm::split_plan(C, HID, T);
  const int tiles = gemm::dual_row_tiles(T);
  const int ln_blocks = fmmt::bwd::ln_bwd_blocks(T);
  s.st = ar.take<float2>(T);
  s.xn = ar.take<__nv_bfloat16>((size_t)T * C);
  s.dyk = ar.take<__nv_bfloat16>((size_t)T * C);
  s.g = ar.take<__nv_bfloat16>((size_t)T * HID);
  s.dh = ar.take<__nv_bfloat16>((size_t)T * HID);
  s.dxn = ar.take<float>((size_t)T * C);
  s.db1_part = ar.take<float>((size_t)tiles * HID);
  s.ln_part = ar.take<float>((size_t)ln_blocks * 3 * C);
  s.dw1_part = ar.take<float>((size_t)p1.slices * HID * C);
  s.dw2_part = ar.take<float>((size_t)p2.slices * C * HID);
  size_t tmp = gemm::sum_rows_scratch(p1.slices, (long long)HID * C);
  const size_t more[] = {
      gemm::sum_rows_scratch(p2.slices, (long long)C * HID),
      gemm::sum_rows_scratch(tiles, HID),
      gemm::sum_rows_scratch(ln_blocks, 3 * C)};
  for (size_t m : more) tmp = m > tmp ? m : tmp;
  s.tmp = ar.take<float>(tmp);
  return s;
}

bool bad_shape(int T, int C, int HID) {
  return T < 1 || C % 16 != 0 || C < 16 || C > 768 || HID % 64 != 0 ||
         HID < 64;
}

}  // namespace

// Bytes of scratch one call needs; the wrapper allocates them.
FMMT_API long long fmmt_fused_ln_mlp_residual_bwd_scratch(int T, int C,
                                                          int HID) {
  if (bad_shape(T, C, HID)) return -1;
  Arena ar{nullptr, 0};
  plan(ar, T, C, HID);
  return static_cast<long long>(ar.used);
}

// Shared-memory bytes the largest of the device kernels needs per block; the
// wrapper checks this against the card's limit before launching.
FMMT_API long long fmmt_fused_ln_mlp_residual_bwd_smem(int C, int HID) {
  size_t most = gemm::dual_smem_bytes();
  const size_t more[] = {gemm::smem_bytes(C, HID, false),
                         gemm::wgrad_smem(C), gemm::wgrad_smem(HID),
                         fmmt::bwd::ln_bwd_smem(C)};
  for (size_t m : more) most = m > most ? m : most;
  return static_cast<long long>(most);
}

namespace {

// The whole sequence; TX: the type of x, dy and dx, bf16 or fp32.
template <typename TX>
int mlp_bwd(const void* x, const void* dy, const void* gamma,
            const void* beta, const void* w1, const void* b1, const void* w1t,
            const void* w2t, const void* keep, void* scratch, void* dx,
            void* dvec, void* dw1, void* db1, void* dw2, int T, int C, int HID,
            float eps, cudaStream_t cs) {
  Arena ar{static_cast<unsigned char*>(scratch), 0};
  const Scratch s = plan(ar, T, C, HID);
  const auto* xb = static_cast<const TX*>(x);
  const auto* dyb = static_cast<const TX*>(dy);
  const auto* gb = static_cast<const __nv_bfloat16*>(gamma);
  const auto* kp = static_cast<const float*>(keep);

  int err = gemm::launch_row_stats(xb, s.st, T, C, eps, cs);
  if (err) return err;
  err = fmmt::bwd::launch_prep_rows(
      xb, dyb, s.st, gb, static_cast<const __nv_bfloat16*>(beta), kp, 1, s.xn,
      s.dyk, T, C, cs);
  if (err) return err;

  gemm::DualArgs d{};
  d.a1 = s.xn;
  d.b1 = static_cast<const __nv_bfloat16*>(w1);
  d.a2 = s.dyk;
  d.b2 = static_cast<const __nv_bfloat16*>(w2t);
  d.bias1 = static_cast<const __nv_bfloat16*>(b1);
  d.g = s.g;
  d.dh = s.dh;
  d.dh_part = s.db1_part;
  d.M = T;
  d.N = HID;
  d.K = C;
  err = gemm::launch_dual(d, cs);
  if (err) return err;

  gemm::Args a{};
  a.a = s.dh;
  a.b = static_cast<const __nv_bfloat16*>(w1t);
  a.out_f32 = s.dxn;
  a.M = T;
  a.N = C;
  a.K = HID;
  err = gemm::launch<gemm::kLnNone, gemm::kF32>(a, cs);
  if (err) return err;

  err = fmmt::bwd::launch_ln_bwd(s.dxn, xb, dyb, s.st, gb, kp, 1,
                                 static_cast<TX*>(dx), s.ln_part, T, C, cs);
  if (err) return err;
  err = gemm::launch_wgrad(s.dh, s.xn, s.dw1_part, HID, C, T, cs);
  if (err) return err;
  err = gemm::launch_wgrad(s.dyk, s.g, s.dw2_part, C, HID, T, cs);
  if (err) return err;

  err = gemm::sum_rows(s.dw1_part, static_cast<float*>(dw1),
                       gemm::split_plan(HID, C, T).slices, HID * C, s.tmp, cs);
  if (err) return err;
  err = gemm::sum_rows(s.dw2_part, static_cast<float*>(dw2),
                       gemm::split_plan(C, HID, T).slices, C * HID, s.tmp, cs);
  if (err) return err;
  err = gemm::sum_rows(s.db1_part, static_cast<float*>(db1),
                       gemm::dual_row_tiles(T), HID, s.tmp, cs);
  if (err) return err;
  return gemm::sum_rows(s.ln_part, static_cast<float*>(dvec),
                        fmmt::bwd::ln_bwd_blocks(T), 3 * C, s.tmp, cs);
}

}  // namespace

// x, dy and dx (T,C) fp32 when x_f32 is nonzero, else bf16; w1 (HID,C), b1
// (HID), w1t = W1^T (C,HID), w2t = W2^T (HID,C), all bf16; keep (T) fp32 or
// null; scratch of fmmt_fused_ln_mlp_residual_bwd_scratch bytes.  Outputs:
// dx; dvec (3C) fp32 = dgamma | dbeta | db2; dw1 (HID,C), db1 (HID), dw2
// (C,HID) fp32.
FMMT_API int fmmt_fused_ln_mlp_residual_bwd(
    const void* x, const void* dy, const void* gamma, const void* beta,
    const void* w1, const void* b1, const void* w1t, const void* w2t,
    const void* keep, void* scratch, void* dx, void* dvec, void* dw1,
    void* db1, void* dw2, int T, int C, int HID, int x_f32, float eps,
    void* stream) {
  if (bad_shape(T, C, HID)) return static_cast<int>(cudaErrorInvalidValue);
  return (x_f32 ? mlp_bwd<float> : mlp_bwd<__nv_bfloat16>)(
      x, dy, gamma, beta, w1, b1, w1t, w2t, keep, scratch, dx, dvec, dw1, db1,
      dw2, T, C, HID, eps, static_cast<cudaStream_t>(stream));
}
