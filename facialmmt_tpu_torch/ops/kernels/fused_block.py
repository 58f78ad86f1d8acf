"""Swin block attention half: x + keep_w * proj(MHA(LN1(x)) + bias[w % nW]).

Counterpart of facialmmt_tpu/ops/pallas/fused_block.py::fused_attention_block;
the CUDA kernel is csrc/fused_block.cu.  x (W, N, C) is window-resident
(faces-major windows, so window w reads bias row w % nW).  Weights are in
torch Linear layout: wqkv (3C, C) with q|k|v on the output axis, wproj (C, C).
q is scaled by hd^-0.5 inside.  bias (nW, h, N, N) is the relative-position
bias plus the shifted-window mask; keep (W,) is an optional per-window
stochastic-depth multiplier.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from facialmmt_tpu_torch.ops import kernels


def fused_attention_block_plain(x, gamma, beta, wqkv, bqkv, wproj, bproj,
                                bias, keep=None, eps: float = 1e-5):
    """Plain PyTorch version (the JAX _reference): fp32 LN statistics and
    softmax, matmuls in x's dtype, fp32 residual."""
    w, n, c = x.shape
    nw, h = bias.shape[0], bias.shape[1]
    hd = c // h
    xf = x.float()
    xn = F.layer_norm(xf, (c,), gamma.float(), beta.float(), eps).to(x.dtype)
    qkv = F.linear(xn, wqkv.to(x.dtype), bqkv.to(x.dtype))     # (W, N, 3C)
    qkv = qkv.reshape(w, n, 3, h, hd).permute(2, 0, 3, 1, 4)    # 3, W, h, N, hd
    q, k, v = qkv[0] * hd ** -0.5, qkv[1], qkv[2]
    s = torch.einsum("whnd,whmd->whnm", q.float(), k.float())
    s = s.reshape(w // nw, nw, h, n, n) + bias.float()[None]
    p = torch.softmax(s.reshape(w, h, n, n), dim=-1).to(x.dtype)
    attn = torch.einsum("whnm,whmd->wnhd", p, v).reshape(w, n, c)
    y = F.linear(attn, wproj.to(x.dtype), bproj.to(x.dtype)).float()
    if keep is not None:
        y = y * keep.float().reshape(w, 1, 1)
    return (xf + y).to(x.dtype)


def fused_attention_block_cuda(x, gamma, beta, wqkv, bqkv, wproj, bproj,
                               bias, keep=None, eps: float = 1e-5):
    """Launch csrc/fused_block.cu: bf16 tokens and weights, fp32 bias/keep,
    N <= 64, C and the head dim multiples of 16; raises on anything else."""
    kernels.require(x.is_cuda,
                    f"{x.device} tensor: the kernel takes CUDA tensors")
    kernels.require(x.dim() == 3 and bias.dim() == 4,
                    f"x (W, N, C) / bias (nW, h, N, N) expected, got "
                    f"{tuple(x.shape)} / {tuple(bias.shape)}")
    w, n, c = x.shape
    nw, h = bias.shape[0], bias.shape[1]
    dev = x.device
    kernels.require(0 < n <= 64 and c % h == 0 and (c // h) % 16 == 0,
                    f"unsupported window shape N={n}, C={c}, heads={h}")
    kernels.require(w % nw == 0, f"W={w} is not a multiple of nW={nw}")
    bf16 = torch.bfloat16
    for name, t, shape in (("x", x, (w, n, c)), ("gamma", gamma, (c,)),
                           ("beta", beta, (c,)), ("wqkv", wqkv, (3 * c, c)),
                           ("bqkv", bqkv, (3 * c,)), ("wproj", wproj, (c, c)),
                           ("bproj", bproj, (c,))):
        kernels.check_cuda_tensor(name, t, bf16, shape, dev)
    kernels.check_cuda_tensor("bias", bias, torch.float32, (nw, h, n, n), dev)
    if keep is not None:
        kernels.check_cuda_tensor("keep", keep, torch.float32, (w,), dev)
    lib = kernels.library()
    smem = lib.fmmt_fused_attention_block_smem(n, c, h)
    kernels.require(smem <= kernels.max_shared_memory(dev),
                    f"needs {smem} B of shared memory per block")
    out = torch.empty_like(x)
    err = lib.fmmt_fused_attention_block(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), wqkv.data_ptr(),
        bqkv.data_ptr(), wproj.data_ptr(), bproj.data_ptr(), bias.data_ptr(),
        None if keep is None else keep.data_ptr(), out.data_ptr(),
        w, n, c, h, nw, eps, kernels.stream_ptr(dev))
    kernels.check_launch("fused_attention_block", err)
    fused_attention_block_cuda.launches += 1
    return out


fused_attention_block_cuda.launches = 0


def fused_attention_block(x, gamma, beta, wqkv, bqkv, wproj, bproj, bias,
                          keep=None, eps: float = 1e-5):
    """CPU tensors -> plain version; CUDA tensors -> the kernel, or raise."""
    fn = fused_attention_block_cuda if x.is_cuda else fused_attention_block_plain
    return fn(x, gamma, beta, wqkv, bqkv, wproj, bproj, bias, keep, eps)
