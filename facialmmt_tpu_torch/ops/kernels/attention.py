"""Fused multi-head attention: softmax(q k^T + bias) v per (batch, head).

Counterpart of facialmmt_tpu/ops/pallas/attention.py::fused_attention; the
CUDA kernel is csrc/attention.cu.  q (B, H, Sq, D) is pre-scaled, k/v are
(B, H, Sk, D), bias (B, Sk) is an additive padding bias broadcast over the
queries; Sq != Sk is allowed.

`fused_attention` is what the models call: a torch.autograd.Function whose
forward is the kernel on CUDA tensors (operands cast to bf16, the bias to
fp32, at the kernel boundary) and the plain version on CPU tensors, and
whose backward differentiates the plain version recomputed from the saved
inputs, as JAX's custom_vjp differentiates _reference_attention: neither
package has a backward kernel for it.
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


class FusedAttention(torch.autograd.Function):
    """softmax(q k^T + bias) v.  Forward: the kernel on CUDA tensors, the
    plain version on CPU tensors.  Backward: torch autograd of the plain
    version recomputed from the saved inputs (kernels.grads_of_recomputed)."""

    @staticmethod
    def forward(ctx, q, k, v, bias):
        from facialmmt_tpu_torch.ops.kernels.block_mlp import kernel_operand

        ctx.save_for_backward(q, k, v, bias)
        if q.is_cuda:
            out = fused_attention_cuda(
                *[kernel_operand(t) for t in (q, k, v)],
                kernel_operand(bias, torch.float32))
        else:
            out = fused_attention_plain(q.detach(), k.detach(), v.detach(),
                                        bias.detach())
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        return tuple(kernels.grads_of_recomputed(
            fused_attention_plain, ctx.saved_tensors, ctx.needs_input_grad,
            dout))


def fused_attention(q, k, v, bias):
    """CPU tensors -> plain version; CUDA tensors -> the kernel, or raise."""
    return FusedAttention.apply(q, k, v, bias)
