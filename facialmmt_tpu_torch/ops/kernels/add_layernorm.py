"""Residual add and TF-style LayerNorm in one pass, at inference.

No counterpart in the JAX package, whose LayerNorms XLA fuses into their
producers; the CUDA kernel is csrc/add_layernorm.cu.  x (..., H) and an
optional residual of the same shape and dtype (bf16 or fp32) give
LayerNormTF(x + residual): the sum rounded to x's dtype, fp32 statistics
with the biased variance centred on the mean, eps inside the root, gamma and
beta applied in fp32, one rounding to x's dtype.

`fused_add_layernorm` is what ops/layers.py::LayerNormTF calls.  It takes the
kernel on a CUDA tensor when autograd records nothing
(`torch.is_grad_enabled()` False: a server's pack, an eval step), and the
plain version otherwise: on the CPU, and under grad on the card, where a
training step (its remat recompute included) keeps the chain it had, with
autograd's backward.
"""

from __future__ import annotations

import torch

from facialmmt_tpu_torch.ops import kernels

MAX_WIDTH = 4096
PARAM_DTYPES = (torch.bfloat16, torch.float32)


def fused_add_layernorm_plain(x, residual, weight, bias, eps: float):
    """Plain PyTorch version: the add in x's dtype, then LayerNormTF's fp32
    chain (ops/layers.py)."""
    if residual is not None:
        x = x + residual
    xf = x.float()
    u = xf.mean(-1, keepdim=True)
    s = (xf - u).square().mean(-1, keepdim=True)
    y = (xf - u) * torch.rsqrt(s + eps)
    y = weight.float() * y + bias.float()
    return y.to(x.dtype)


def _check(name, t, dtype, shape, dev):
    """One operand as the kernel takes it (plain tests first: the wrapper
    runs 99 times a serving pack, so no message is formatted unless one is
    raised)."""
    if t.device != dev:
        raise ValueError(f"{name}: on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.shape != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: must be 16-byte aligned")


def fused_add_layernorm_cuda(x, residual, weight, bias, eps: float):
    """Launch csrc/add_layernorm.cu: x and residual (or None) contiguous of
    one dtype, bf16 or fp32, last dimension H a multiple of 8 up to
    MAX_WIDTH; weight and bias (H,) of one dtype, bf16 or fp32; every
    operand 16-byte aligned.  Returns a new tensor of x's dtype and shape;
    raises on anything else."""
    if not x.is_cuda:
        raise ValueError(f"{x.device} tensor: the kernel takes CUDA tensors")
    if x.dtype not in kernels.TOKEN_DTYPES:
        raise ValueError(f"x: dtype {x.dtype}; the kernel takes "
                         f"{kernels.TOKEN_DTYPES}")
    h = x.shape[-1] if x.dim() else 0
    if h % 8 or not 8 <= h <= MAX_WIDTH:
        raise ValueError(f"width {h}: the kernel takes a multiple of 8 in "
                         f"[8, {MAX_WIDTH}]")
    if weight.dtype not in PARAM_DTYPES:
        raise ValueError(f"weight: dtype {weight.dtype}; the kernel takes "
                         f"{PARAM_DTYPES}")
    dev = x.device
    _check("x", x, x.dtype, x.shape, dev)
    if residual is not None:
        _check("residual", residual, x.dtype, x.shape, dev)
    _check("weight", weight, weight.dtype, (h,), dev)
    _check("bias", bias, weight.dtype, (h,), dev)
    out = torch.empty_like(x)
    rows = x.numel() // h
    if rows == 0:
        return out
    err = kernels.library().fmmt_add_layernorm(
        x.data_ptr(), 0 if residual is None else residual.data_ptr(),
        weight.data_ptr(), bias.data_ptr(), out.data_ptr(), rows, h,
        kernels.is_f32(x), kernels.is_f32(weight), eps,
        kernels.stream_ptr(dev))
    kernels.check_launch("fused_add_layernorm", err)
    fused_add_layernorm_cuda.launches += 1
    return out


fused_add_layernorm_cuda.launches = 0


def fused_add_layernorm(x, residual, weight, bias, eps: float):
    """LayerNormTF(x + residual), or of x alone when residual is None.  A
    CUDA tensor with grad disabled -> the kernel, or raise; otherwise the
    plain version.  A residual of another dtype than x (an fp32 stream
    under autocast) is added first, as the plain version's add promotes
    it."""
    if not x.is_cuda or torch.is_grad_enabled():
        return fused_add_layernorm_plain(x, residual, weight, bias, eps)
    if residual is not None and residual.dtype != x.dtype:
        x, residual = x + residual, None
    return fused_add_layernorm_cuda(
        x.contiguous(), None if residual is None else residual.contiguous(),
        weight, bias, eps)
