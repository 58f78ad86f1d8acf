"""Swin block MLP half: x + keep_t * fc2(GELU_erf(fc1(LN2(x)))).

Counterpart of facialmmt_tpu/ops/pallas/block_mlp.py: fused_ln_mlp_residual
(CUDA kernel csrc/block_mlp.cu) and its backward _bwd_impl_pallas (CUDA
kernel csrc/block_mlp_bwd.cu).  x (T, C) tokens; weights in torch Linear
layout, w1 (HID, C) and w2 (C, HID); keep (T,) is an optional per-token
stochastic-depth multiplier, which gets no gradient.

`fused_ln_mlp_residual` is what the model calls: a torch.autograd.Function
that saves only its inputs and recomputes LN / fc1 / GELU in the backward.
Forward and backward each take the plain version for CPU tensors and the
kernel for CUDA tensors; on a CUDA tensor the operands are cast to bf16 at the
kernel boundary and every gradient comes back in its parameter's dtype.
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
    GELU, fc2 + residual): bf16 tokens and weights, fp32 keep, any T, C a
    multiple of 16 up to 768, HID a multiple of 64; raises on anything
    else."""
    kernels.require(x.is_cuda,
                    f"{x.device} tensor: the kernel takes CUDA tensors")
    kernels.require(x.dim() == 2, f"x: expected (T, C), got {tuple(x.shape)}")
    t, c = x.shape
    hid = w1.shape[0]
    dev = x.device
    kernels.require(t > 0 and c % 16 == 0 and c <= 768 and hid % 64 == 0,
                    f"unsupported shape T={t}, C={c}, HID={hid}")
    bf16 = torch.bfloat16
    for name, a, shape in (("x", x, (t, c)), ("gamma", gamma, (c,)),
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
    # the kernel's scratch: LN2 statistics per token, the GELU output
    stats = torch.empty((t, 2), dtype=torch.float32, device=dev)
    hidden = torch.empty((t, hid), dtype=bf16, device=dev)
    err = lib.fmmt_fused_ln_mlp_residual(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        None if keep is None else keep.data_ptr(), stats.data_ptr(),
        hidden.data_ptr(), out.data_ptr(), t, c, hid, eps,
        kernels.stream_ptr(dev))
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
    """Launch csrc/block_mlp_bwd.cu: bf16 tokens, gradient and weights, fp32
    keep, any T, C a multiple of 16 up to 768, HID a multiple of 64; raises
    on anything else.  Same returns as the plain version."""
    kernels.require(x.is_cuda,
                    f"{x.device} tensor: the kernel takes CUDA tensors")
    kernels.require(x.dim() == 2, f"x: expected (T, C), got {tuple(x.shape)}")
    t, c = x.shape
    hid = w1.shape[0]
    dev = x.device
    kernels.require(t > 0 and c % 16 == 0 and c <= 768 and hid % 64 == 0,
                    f"unsupported shape T={t}, C={c}, HID={hid}")
    bf16 = torch.bfloat16
    for name, a, shape in (("x", x, (t, c)), ("dy", dy, (t, c)),
                           ("gamma", gamma, (c,)), ("beta", beta, (c,)),
                           ("w1", w1, (hid, c)), ("b1", b1, (hid,)),
                           ("w2", w2, (c, hid))):
        kernels.check_cuda_tensor(name, a, bf16, shape, dev)
    if keep is not None:
        kernels.check_cuda_tensor("keep", keep, torch.float32, (t,), dev)
    lib = kernels.library()
    smem = lib.fmmt_fused_ln_mlp_residual_bwd_smem(c)
    kernels.require(smem <= kernels.max_shared_memory(dev),
                    f"needs {smem} B of shared memory per block")
    dx = torch.empty_like(x)
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=dev)
    dgamma, dbeta, db2 = zeros(c), zeros(c), zeros(c)
    dw1, db1, dw2 = zeros(hid, c), zeros(hid), zeros(c, hid)
    err = lib.fmmt_fused_ln_mlp_residual_bwd(
        x.data_ptr(), dy.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        None if keep is None else keep.data_ptr(), dx.data_ptr(),
        dgamma.data_ptr(), dbeta.data_ptr(), dw1.data_ptr(), db1.data_ptr(),
        dw2.data_ptr(), db2.data_ptr(), t, c, hid, eps,
        kernels.stream_ptr(dev))
    kernels.check_launch("fused_ln_mlp_residual_bwd", err)
    fused_ln_mlp_residual_bwd_cuda.launches += 1
    return dx, dgamma, dbeta, dw1, db1, dw2, db2


fused_ln_mlp_residual_bwd_cuda.launches = 0


def kernel_operand(t, dtype=torch.bfloat16):
    """A kernel operand: `t` detached, cast and made contiguous."""
    return t.detach().to(dtype).contiguous()


class FusedLnMlpResidual(torch.autograd.Function):
    """x + keep * fc2(GELU(fc1(LN2(x)))) with a recomputing backward: only the
    inputs are saved."""

    @staticmethod
    def forward(ctx, x, gamma, beta, w1, b1, w2, b2, keep, eps):
        params = (gamma, beta, w1, b1, w2, b2)
        if x.is_cuda:
            xk = kernel_operand(x)
            keep = None if keep is None else kernel_operand(keep, torch.float32)
            out = fused_ln_mlp_residual_cuda(
                xk, *[kernel_operand(p) for p in params], keep, eps)
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
                xk, kernel_operand(dy),
                *[kernel_operand(p) for p in (gamma, beta, w1, b1, w2)],
                keep, ctx.eps)
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
