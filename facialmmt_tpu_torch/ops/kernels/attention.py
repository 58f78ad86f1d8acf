"""Fused multi-head attention: softmax(q k^T + bias) v per (batch, head).

Counterpart of facialmmt_tpu/ops/pallas/attention.py::fused_attention; the
CUDA kernel is csrc/attention.cu.  q (B, H, Sq, D) is pre-scaled, k/v are
(B, H, Sk, D), bias (B, Sk) is an additive padding bias broadcast over the
queries; Sq != Sk is allowed.
"""

from __future__ import annotations

import torch

from facialmmt_tpu_torch.ops import kernels

HEAD_DIMS = (16, 32, 64)


def fused_attention_plain(q, k, v, bias):
    """Plain PyTorch version: fp32 scores and softmax, probabilities in v's
    dtype (the JAX _reference_attention)."""
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    scores = scores + bias.float()[:, None, None, :]
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def fused_attention_cuda(q, k, v, bias):
    """Launch csrc/attention.cu.  bf16 q/k/v, fp32 bias, head dim in
    HEAD_DIMS; raises on anything else."""
    kernels.require(q.is_cuda,
                    f"{q.device} tensor: the kernel takes CUDA tensors")
    kernels.require(q.dim() == 4, f"q: expected (B, H, Sq, D), got {q.shape}")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    dev = q.device
    kernels.require(d in HEAD_DIMS, f"head dim {d} not in {HEAD_DIMS}")
    kernels.require(sq > 0 and sk > 0 and b * h <= 65535,
                    f"unsupported shape q {tuple(q.shape)}, Sk {sk}")
    kernels.check_cuda_tensor("q", q, torch.bfloat16, (b, h, sq, d), dev)
    kernels.check_cuda_tensor("k", k, torch.bfloat16, (b, h, sk, d), dev)
    kernels.check_cuda_tensor("v", v, torch.bfloat16, (b, h, sk, d), dev)
    kernels.check_cuda_tensor("bias", bias, torch.float32, (b, sk), dev)
    out = torch.empty_like(q)
    lib = kernels.library()
    err = lib.fmmt_fused_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        out.data_ptr(), b, h, sq, sk, d, kernels.stream_ptr(dev))
    kernels.check_launch("fused_attention", err)
    fused_attention_cuda.launches += 1
    return out


fused_attention_cuda.launches = 0


def fused_attention(q, k, v, bias):
    """CPU tensors -> plain version; CUDA tensors -> the kernel, or raise."""
    if q.is_cuda:
        return fused_attention_cuda(q, k, v, bias)
    return fused_attention_plain(q, k, v, bias)
