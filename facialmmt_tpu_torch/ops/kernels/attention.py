"""Fused multi-head attention: softmax(q k^T + bias) v per (batch, head).

Counterpart of facialmmt_tpu/ops/pallas/attention.py::fused_attention; the
CUDA kernel is csrc/attention.cu.  q (B, H, Sq, D) is pre-scaled, k/v are
(B, H, Sk, D), bias (B, Sk) is an additive padding bias broadcast over the
queries; Sq != Sk is allowed.

`fused_attention` is what the models call: a torch.autograd.Function whose
forward is the kernel on CUDA tensors (q, k, v in their own dtype, bf16 or
fp32, each with its instantiation of the kernel; the bias cast to fp32:
`kernel_operands`) and the plain version on CPU tensors, and
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
    """Launch csrc/attention.cu: q/k/v all bf16 (the bf16 kernel) or all fp32
    (the TF32 kernel, fp32 out), fp32 bias, head dim in HEAD_DIMS; raises on
    anything else."""
    kernels.require(q.is_cuda,
                    f"{q.device} tensor: the kernel takes CUDA tensors")
    kernels.require(q.dim() == 4, f"q: expected (B, H, Sq, D), got {q.shape}")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    dev = q.device
    kernels.require(d in HEAD_DIMS, f"head dim {d} not in {HEAD_DIMS}")
    kernels.require(sq > 0 and sk > 0 and b * h <= 65535,
                    f"unsupported shape q {tuple(q.shape)}, Sk {sk}")
    dt = q.dtype
    kernels.check_token_dtype("q", q)
    kernels.check_cuda_tensor("q", q, dt, (b, h, sq, d), dev)
    kernels.check_cuda_tensor("k", k, dt, (b, h, sk, d), dev)
    kernels.check_cuda_tensor("v", v, dt, (b, h, sk, d), dev)
    kernels.check_cuda_tensor("bias", bias, torch.float32, (b, sk), dev)
    out = torch.empty_like(q)
    lib = kernels.library()
    err = lib.fmmt_fused_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        out.data_ptr(), b, h, sq, sk, d, kernels.is_f32(q),
        kernels.stream_ptr(dev))
    kernels.check_launch("fused_attention", err)
    fused_attention_cuda.launches += 1
    return out


fused_attention_cuda.launches = 0


def kernel_operands(q, k, v, bias):
    """What FusedAttention hands the kernel for CUDA tensors: q, k, v in their
    own dtype (kernels.token_operand), the bias in fp32."""
    from facialmmt_tpu_torch.ops.kernels.block_mlp import kernel_operand

    return (*[kernels.token_operand(t) for t in (q, k, v)],
            kernel_operand(bias, torch.float32))


class FusedAttention(torch.autograd.Function):
    """softmax(q k^T + bias) v.  Forward: the kernel on CUDA tensors, the
    plain version on CPU tensors.  Backward: torch autograd of the plain
    version recomputed from the saved inputs (kernels.grads_of_recomputed)."""

    @staticmethod
    def forward(ctx, q, k, v, bias):
        ctx.save_for_backward(q, k, v, bias)
        if q.is_cuda:
            out = fused_attention_cuda(*kernel_operands(q, k, v, bias))
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
