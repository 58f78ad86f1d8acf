"""Swin block MLP half: x + keep_t * fc2(GELU_erf(fc1(LN2(x)))).

Counterpart of facialmmt_tpu/ops/pallas/block_mlp.py::fused_ln_mlp_residual;
the CUDA kernel is csrc/block_mlp.cu.  x (T, C) tokens; weights in torch
Linear layout, w1 (HID, C) and w2 (C, HID); keep (T,) is an optional
per-token stochastic-depth multiplier.
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
    """Launch csrc/block_mlp.cu: bf16 tokens and weights, fp32 keep, any T,
    C a multiple of 16 up to 768, HID a multiple of 64; raises on anything
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
    smem = lib.fmmt_fused_ln_mlp_residual_smem(c)
    kernels.require(smem <= kernels.max_shared_memory(dev),
                    f"needs {smem} B of shared memory per block")
    out = torch.empty_like(x)
    err = lib.fmmt_fused_ln_mlp_residual(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        None if keep is None else keep.data_ptr(), out.data_ptr(),
        t, c, hid, eps, kernels.stream_ptr(dev))
    kernels.check_launch("fused_ln_mlp_residual", err)
    fused_ln_mlp_residual_cuda.launches += 1
    return out


fused_ln_mlp_residual_cuda.launches = 0


def fused_ln_mlp_residual(x, gamma, beta, w1, b1, w2, b2, keep=None,
                          eps: float = 1e-5):
    """CPU tensors -> plain version; CUDA tensors -> the kernel, or raise."""
    fn = fused_ln_mlp_residual_cuda if x.is_cuda else fused_ln_mlp_residual_plain
    return fn(x, gamma, beta, w1, b1, w2, b2, keep, eps)
