"""Swin block MLP half: x + keep_t * fc2(GELU_erf(fc1(LN2(x)))).

Counterpart of facialmmt_tpu/ops/pallas/block_mlp.py: fused_ln_mlp_residual
(CUDA kernel csrc/block_mlp.cu) and its backward _bwd_impl_pallas (CUDA
kernel csrc/block_mlp_bwd.cu; both on the tiled products of
csrc/tile_gemm.cuh).  x (T, C) tokens; weights in torch Linear
layout, w1 (HID, C) and w2 (C, HID); keep (T,) is an optional per-token
stochastic-depth multiplier, which gets no gradient.

`fused_ln_mlp_residual` is what the model calls: a torch.autograd.Function
that saves only its inputs and recomputes LN / fc1 / GELU in the backward.
Forward and backward each take the plain version for CPU tensors and the
kernel for CUDA tensors; on a CUDA tensor x and dy go to the kernel in their
own dtype, bf16 or fp32 (an instantiation each: the LN statistics, the
residual, out and dx stay fp32 for fp32 tokens, as the JAX kernel keeps
them), the weights in bf16 (`kernel_operands`, `bwd_kernel_operands`), and
every gradient comes back in its parameter's dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from facialmmt_tpu_torch.ops import kernels


def fused_ln_mlp_residual_plain(x, gamma, beta, w1, b1, w2, b2, keep=None,
                                eps: float = 1e-5):
    """Plain PyTorch version: fp32 LN statistics, matmuls in x's dtype,
    exact-erf GELU, fp32 residual."""
    c = x.shape[-1]
    xf = x.float()
    xn = F.layer_norm(xf, (c,), gamma.float(), beta.float(), eps).to(x.dtype)
    hid = F.gelu(F.linear(xn, w1.to(x.dtype), b1.to(x.dtype)).float())
    y = F.linear(hid.to(x.dtype), w2.to(x.dtype), b2.to(x.dtype)).float()
    if keep is not None:
        y = y * keep.float().reshape(-1, 1)
    return (xf + y).to(x.dtype)


def fused_ln_mlp_residual_cuda(x, gamma, beta, w1, b1, w2, b2, keep=None,
                               eps: float = 1e-5):
    """Launch csrc/block_mlp.cu (three device kernels: LN2 statistics, fc1 +
    GELU, fc2 + residual; with fp32 tokens a LayerNorm row pass before fc1):
    bf16 or fp32 tokens (out of the same dtype), bf16 weights, fp32 keep,
    any T, C a multiple of 16 up to 768, HID a multiple of 64; raises on
    anything else."""
    kernels.require(x.is_cuda,
                    f"{x.device} tensor: the kernel takes CUDA tensors")
    kernels.require(x.dim() == 2, f"x: expected (T, C), got {tuple(x.shape)}")
    t, c = x.shape
    hid = w1.shape[0]
    dev = x.device
    kernels.require(t > 0 and c % 16 == 0 and c <= 768 and hid % 64 == 0,
                    f"unsupported shape T={t}, C={c}, HID={hid}")
    bf16 = torch.bfloat16
    kernels.check_token_dtype("x", x)
    kernels.check_cuda_tensor("x", x, x.dtype, (t, c), dev)
    for name, a, shape in (("gamma", gamma, (c,)),
                           ("beta", beta, (c,)), ("w1", w1, (hid, c)),
                           ("b1", b1, (hid,)), ("w2", w2, (c, hid)),
                           ("b2", b2, (c,))):
        kernels.check_cuda_tensor(name, a, bf16, shape, dev)
    if keep is not None:
        kernels.check_cuda_tensor("keep", keep, torch.float32, (t,), dev)
    lib = kernels.library()
    smem = lib.fmmt_fused_ln_mlp_residual_smem(c, hid)
    kernels.require(smem <= kernels.max_shared_memory(dev),
                    f"needs {smem} B of shared memory per block")
    out = torch.empty_like(x)
    # the kernel's scratch: LN2 statistics per token, the GELU output, and
    # for fp32 tokens their bf16 LayerNorm, which fc1 reads
    stats = torch.empty((t, 2), dtype=torch.float32, device=dev)
    hidden = torch.empty((t, hid), dtype=bf16, device=dev)
    f32 = kernels.is_f32(x)
    xn = torch.empty((t, c), dtype=bf16, device=dev) if f32 else None
    err = lib.fmmt_fused_ln_mlp_residual(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        None if keep is None else keep.data_ptr(), stats.data_ptr(),
        hidden.data_ptr(), None if xn is None else xn.data_ptr(),
        out.data_ptr(), t, c, hid, f32, eps, kernels.stream_ptr(dev))
    kernels.check_launch("fused_ln_mlp_residual", err)
    fused_ln_mlp_residual_cuda.launches += 1
    return out


fused_ln_mlp_residual_cuda.launches = 0


def _layer_norm_parts(x, gamma, beta, eps):
    """fp32 LN pieces the backward needs: xh (normalised), rstd, xn."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    rstd = torch.rsqrt((xf - mean).square().mean(-1, keepdim=True) + eps)
    xh = (xf - mean) * rstd
    return xh, rstd, xh * gamma.float() + beta.float()


def layer_norm_backward(dxn, xh, rstd, gamma):
    """(dx through the LN, dgamma, dbeta) from dxn = dL/d(LN output), fp32."""
    dxh = dxn * gamma.float()
    m1 = dxh.mean(-1, keepdim=True)
    m2 = (dxh * xh).mean(-1, keepdim=True)
    red = tuple(range(dxn.dim() - 1))
    return (rstd * (dxh - m1 - xh * m2), (dxn * xh).sum(red), dxn.sum(red))


def fused_ln_mlp_residual_bwd_plain(x, dy, gamma, beta, w1, b1, w2, keep=None,
                                    eps: float = 1e-5):
    """Plain PyTorch backward, written out step by step with the kernel's
    roundings (matmul operands in x's dtype, fp32 accumulation and sums).
    Returns (dx in x's dtype, dgamma, dbeta, dw1, db1, dw2, db2 in fp32)."""
    dt = x.dtype
    xh, rstd, xn = _layer_norm_parts(x, gamma, beta, eps)
    xn_b = xn.to(dt)
    h = F.linear(xn_b, w1.to(dt)).float() + b1.float()
    cdf = 0.5 * (1.0 + torch.erf(h * 2.0 ** -0.5))
    g_b = (h * cdf).to(dt)
    dyf = dy.float()
    dyk = dyf if keep is None else dyf * keep.float().reshape(-1, 1)
    dyk_b = dyk.to(dt)
    dgm = (dyk_b @ w2.to(dt)).float()                      # (T, HID)
    pdf = torch.exp(-0.5 * h * h) * 0.3989422804014327
    dh = dgm * (cdf + h * pdf)
    dh_b = dh.to(dt)
    dxn = (dh_b @ w1.to(dt)).float()                       # (T, C)
    dx_ln, dgamma, dbeta = layer_norm_backward(dxn, xh, rstd, gamma)
    dw1 = dh_b.float().t() @ xn_b.float()                  # (HID, C)
    dw2 = dyk_b.float().t() @ g_b.float()                  # (C, HID)
    return ((dyf + dx_ln).to(dt), dgamma, dbeta, dw1, dh.sum(0), dw2,
            dyk.sum(0))


def fused_ln_mlp_residual_bwd_cuda(x, dy, gamma, beta, w1, b1, w2, keep=None,
                                   eps: float = 1e-5):
    """Launch csrc/block_mlp_bwd.cu (the LN2 statistics, xn and dy * keep,
    the hidden layer's two products with the GELU backward, dxn, the LN
    backward, the split-T weight-gradient products and their fixed-order
    sums): bf16 or fp32 tokens with a gradient of the same dtype (dx of it
    too), bf16 weights, fp32 keep, any T, C a multiple of 16 up to 768, HID
    a multiple of 64; raises on anything else.  Same returns as the plain
    version; two launches give the same bits."""
    kernels.require(x.is_cuda,
                    f"{x.device} tensor: the kernel takes CUDA tensors")
    kernels.require(x.dim() == 2, f"x: expected (T, C), got {tuple(x.shape)}")
    t, c = x.shape
    hid = w1.shape[0]
    dev = x.device
    kernels.require(t > 0 and c % 16 == 0 and c <= 768 and hid % 64 == 0,
                    f"unsupported shape T={t}, C={c}, HID={hid}")
    bf16 = torch.bfloat16
    kernels.check_token_dtype("x", x)
    for name, a, shape in (("x", x, (t, c)), ("dy", dy, (t, c))):
        kernels.check_cuda_tensor(name, a, x.dtype, shape, dev)
    for name, a, shape in (("gamma", gamma, (c,)), ("beta", beta, (c,)),
                           ("w1", w1, (hid, c)), ("b1", b1, (hid,)),
                           ("w2", w2, (c, hid))):
        kernels.check_cuda_tensor(name, a, bf16, shape, dev)
    if keep is not None:
        kernels.check_cuda_tensor("keep", keep, torch.float32, (t,), dev)
    lib = kernels.library()
    smem = lib.fmmt_fused_ln_mlp_residual_bwd_smem(c, hid)
    kernels.require(smem <= kernels.max_shared_memory(dev),
                    f"needs {smem} B of shared memory per block")
    # the products read both weights transposed too (B operands K-major)
    w1t, w2t = w1.t().contiguous(), w2.t().contiguous()
    scratch = torch.empty(
        lib.fmmt_fused_ln_mlp_residual_bwd_scratch(t, c, hid),
        dtype=torch.uint8, device=dev)
    dx = torch.empty_like(x)
    f32 = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    dvec, dw1, db1, dw2 = f32(3, c), f32(hid, c), f32(hid), f32(c, hid)
    err = lib.fmmt_fused_ln_mlp_residual_bwd(
        x.data_ptr(), dy.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        w1.data_ptr(), b1.data_ptr(), w1t.data_ptr(), w2t.data_ptr(),
        None if keep is None else keep.data_ptr(), scratch.data_ptr(),
        dx.data_ptr(), dvec.data_ptr(), dw1.data_ptr(), db1.data_ptr(),
        dw2.data_ptr(), t, c, hid, kernels.is_f32(x), eps,
        kernels.stream_ptr(dev))
    kernels.check_launch("fused_ln_mlp_residual_bwd", err)
    fused_ln_mlp_residual_bwd_cuda.launches += 1
    dgamma, dbeta, db2 = dvec
    return dx, dgamma, dbeta, dw1, db1, dw2, db2


fused_ln_mlp_residual_bwd_cuda.launches = 0


def kernel_operand(t, dtype=torch.bfloat16):
    """A kernel operand: `t` detached, cast and made contiguous."""
    return t.detach().to(dtype).contiguous()


def kernel_operands(x, gamma, beta, w1, b1, w2, b2, keep):
    """What FusedLnMlpResidual hands the forward kernel for CUDA tensors: x
    in its own dtype (kernels.token_operand), the weights in bf16, keep in
    fp32."""
    return (kernels.token_operand(x),
            *[kernel_operand(p) for p in (gamma, beta, w1, b1, w2, b2)],
            None if keep is None else kernel_operand(keep, torch.float32))


def bwd_kernel_operands(x, dy, gamma, beta, w1, b1, w2, keep):
    """What FusedLnMlpResidual's backward hands the kernel: x and dy in
    their own dtype, the weights in bf16, keep in fp32."""
    return (kernels.token_operand(x), kernels.token_operand(dy),
            *[kernel_operand(p) for p in (gamma, beta, w1, b1, w2)],
            None if keep is None else kernel_operand(keep, torch.float32))


class FusedLnMlpResidual(torch.autograd.Function):
    """x + keep * fc2(GELU(fc1(LN2(x)))) with a recomputing backward: only the
    inputs are saved."""

    @staticmethod
    def forward(ctx, x, gamma, beta, w1, b1, w2, b2, keep, eps):
        params = (gamma, beta, w1, b1, w2, b2)
        if x.is_cuda:
            xk, *pk, keep = kernel_operands(x, *params, keep)
            out = fused_ln_mlp_residual_cuda(xk, *pk, keep, eps)
        else:
            xk = x.detach()
            out = fused_ln_mlp_residual_plain(xk, *params, keep, eps)
        ctx.save_for_backward(xk, *params, keep)
        ctx.eps = eps
        ctx.x_dtype = x.dtype
        return out.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        xk, gamma, beta, w1, b1, w2, b2, keep = ctx.saved_tensors
        if xk.is_cuda:
            grads = fused_ln_mlp_residual_bwd_cuda(
                *bwd_kernel_operands(xk, dy, gamma, beta, w1, b1, w2, keep),
                ctx.eps)
        else:
            grads = fused_ln_mlp_residual_bwd_plain(
                xk, dy.to(xk.dtype), gamma, beta, w1, b1, w2, keep, ctx.eps)
        dx, *dparams = grads
        dparams = [g.to(p.dtype)
                   for g, p in zip(dparams, (gamma, beta, w1, b1, w2, b2))]
        return (dx.to(ctx.x_dtype), *dparams, None, None)


def fused_ln_mlp_residual(x, gamma, beta, w1, b1, w2, b2, keep=None,
                          eps: float = 1e-5):
    """CPU tensors -> plain versions; CUDA tensors -> the kernels, or raise."""
    return FusedLnMlpResidual.apply(x, gamma, beta, w1, b1, w2, b2, keep, eps)
