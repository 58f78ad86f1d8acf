// Swin block MLP half:
//   out[t] = x[t] + keep[t] * fc2(GELU_erf(fc1(LN2(x[t]))))
// x (T,C) bf16 tokens; LN2 gamma/beta (C); fc1 weight (HID,C) and bias (HID);
// fc2 weight (C,HID) and bias (C), torch Linear layout, all bf16; keep (T,)
// fp32 optional.  Any T works: the last tile masks its missing rows.  C is a
// multiple of 16 up to 768 and HID a multiple of 64.
//
// Replaces: facialmmt_tpu/ops/pallas/block_mlp.py::fused_ln_mlp_residual.
//
// What bounds it on the H100: two GEMMs of 2*T*C*HID FLOP each (HID = 4C),
// 29.6 GFLOP (0.030 ms) at every Swin-tiny stage of a 64-face pack, against
// 4*T*C bytes of tokens in and out (77 MB at stage 0): the tensor cores.  The
// first version of this kernel (32 tokens a block, every 16-row tile loading
// its W1 / W2 fragments straight from L2, one block an SM at C = 768) moved
// T x C^2 = 1.85 GB of weights into the SMs per launch and sat at 3-4 % of
// that bound.
//
// What the design does about it: three device kernels, one wrapper call
// (PERF.md counts it as one launch): the LN2 statistics of every token, one
// warp a row, then twice the tiled GEMM of tile_gemm.cuh (128-row tiles,
// weight chunks through a cp.async ring in shared memory, wgmma):
//   1. fc1 with LN2 applied in its prologue and bias + GELU as its
//      epilogue, the GELU output in bf16 to a (T, HID) scratch that the
//      wrapper allocates (the JAX kernel rounds it to bf16 too, so the round
//      trip changes no bit; 38.5 MB at stage 2, 19 MB at stage 3, L2-sized;
//      154 MB at stage 0);
//   2. fc2 with bias, keep and the fp32 residual as its epilogue.
// Every weight byte that reaches an SM serves 128 tokens (T / 128 x 16 C^2
// bytes a launch, 0.23 GB at every stage: 8x less), and the grids hold 600
// to 4704 blocks for fc1 and 150 to 1568 for fc2 at 64 faces, so stage 3
// (T = 3136) fills the 132 SMs too.  No atomics: two launches give the same
// bits.
//
// Rounding follows the JAX kernel: LN output and GELU output are rounded to
// bf16 before their matmuls; fc2 + bias, keep and the residual add are fp32,
// rounded once.
//
// x and out come in bf16 or fp32 (x_f32; the model's compute dtype): as the
// JAX kernel reads x in its own dtype, fp32 tokens keep their LN statistics
// and the residual in fp32 and out is fp32, never rounded; the products'
// operands stay bf16, as the JAX kernel's do.  On fp32 tokens LN2 is applied
// by a row pass (swin_bwd.cuh::prep_rows, the prologue's arithmetic) into a
// bf16 (T, C) scratch, xn_buf, that fc1 reads without a prologue, and fc2's
// epilogue is kResidualF32; bf16 tokens take the sequence above unchanged.
#include "swin_bwd.cuh"

// Shared-memory bytes the larger of the two products needs per block; the
// wrapper checks this against the card's limit before launching.
FMMT_API long long fmmt_fused_ln_mlp_residual_smem(int C, int HID) {
  const size_t fc1 = fmmt::gemm::smem_bytes(HID, C, true);
  const size_t fc2 = fmmt::gemm::smem_bytes(C, HID, false);
  return static_cast<long long>(fc1 > fc2 ? fc1 : fc2);
}

// stats (T) float2 and h_buf (T, HID) bf16 are scratch the caller
// allocates, and with x_f32 xn_buf (T, C) bf16 (null otherwise); x and out
// (T, C) are fp32 when x_f32 is nonzero, else bf16.
FMMT_API int fmmt_fused_ln_mlp_residual(const void* x, const void* gamma,
                                        const void* beta, const void* w1,
                                        const void* b1, const void* w2,
                                        const void* b2, const void* keep,
                                        void* stats, void* h_buf, void* xn_buf,
                                        void* out, int T, int C, int HID,
                                        int x_f32, float eps, void* stream) {
  if (T < 1 || C % 16 != 0 || C < 16 || C > 768 || HID % 64 != 0 || HID < 64
      || (x_f32 && !xn_buf))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* gb = static_cast<const __nv_bfloat16*>(gamma);
  const auto* bb = static_cast<const __nv_bfloat16*>(beta);
  __nv_bfloat16* hb = static_cast<__nv_bfloat16*>(h_buf);
  float2* st = static_cast<float2*>(stats);

  fmmt::gemm::Args a{};
  a.b = static_cast<const __nv_bfloat16*>(w1);
  a.bias = static_cast<const __nv_bfloat16*>(b1);
  a.out = hb;
  a.M = T;
  a.N = HID;
  a.K = C;
  a.keep_div = 1;
  fmmt::gemm::Args p{};
  p.a = hb;
  p.b = static_cast<const __nv_bfloat16*>(w2);
  p.bias = static_cast<const __nv_bfloat16*>(b2);
  p.keep = static_cast<const float*>(keep);
  p.keep_div = 1;
  p.M = T;
  p.N = C;
  p.K = HID;
  if (x_f32) {
    const float* xf = static_cast<const float*>(x);
    auto* xn = static_cast<__nv_bfloat16*>(xn_buf);
    int err = fmmt::gemm::launch_row_stats(xf, st, T, C, eps, s);
    if (err != 0) return err;
    err = fmmt::bwd::launch_prep_rows<float>(xf, nullptr, st, gb, bb, nullptr,
                                             1, xn, nullptr, T, C, s);
    if (err != 0) return err;
    a.a = xn;
    err = fmmt::gemm::launch<fmmt::gemm::kLnNone, fmmt::gemm::kGelu>(a, s);
    if (err != 0) return err;
    p.res_f32 = xf;
    p.out_f32 = static_cast<float*>(out);
    return fmmt::gemm::launch<fmmt::gemm::kLnNone,
                              fmmt::gemm::kResidualF32>(p, s);
  }
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  int err = fmmt::gemm::launch_row_stats(xb, st, T, C, eps, s);
  if (err != 0) return err;
  a.a = xb;
  a.stats = st;
  a.gamma = gb;
  a.beta = bb;
  err = fmmt::gemm::launch<fmmt::gemm::kLnStats, fmmt::gemm::kGelu>(a, s);
  if (err != 0) return err;
  p.res = xb;
  p.out = static_cast<__nv_bfloat16*>(out);
  return fmmt::gemm::launch<fmmt::gemm::kLnNone, fmmt::gemm::kResidual>(p, s);
}
