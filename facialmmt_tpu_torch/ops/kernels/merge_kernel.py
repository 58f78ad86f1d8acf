"""Swin patch-merging tail: LN(x) @ w, no bias.

Counterpart of facialmmt_tpu/ops/pallas/merge_kernel.py::fused_merge; the CUDA
kernel is csrc/merge_kernel.cu.  x (B, L, 4C) holds the gathered rows of the
2x2 neighbourhoods, gamma/beta (4C,) the LayerNorm affine, and w (4C, 2C) the
reduction with the input axis first, as the JAX function takes it (a torch
Linear's weight is its transpose).  Returns (B, L, 2C).  The 2x2 gather itself
stays a PyTorch index_select outside (ops/swin.py::PatchMerging.gather).

`fused_merge` is a torch.autograd.Function: the forward is the kernel on a
CUDA tensor and the plain version on a CPU tensor; the backward differentiates
the plain version recomputed from the saved inputs, as the JAX package does
(it has no backward kernel either).  x comes in bf16 or fp32 (the model's
compute dtype): as the JAX kernel reads x in its own dtype (fp32 LayerNorm
statistics, out in x's dtype), the kernel has an instantiation for each and
the Function hands x over in its own dtype, the affine and the weight in
bf16 (`kernel_operands`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from facialmmt_tpu_torch.ops import kernels
from facialmmt_tpu_torch.ops.kernels.block_mlp import kernel_operand


def fused_merge_plain(x, gamma, beta, w, eps: float = 1e-5):
    """Plain PyTorch version with the kernel's precision: fp32 LN statistics,
    matmul operands rounded to bf16, fp32 accumulation, result in x's dtype."""
    xn = F.layer_norm(x.float(), x.shape[-1:], gamma.float(), beta.float(),
                      eps)
    bf16 = torch.bfloat16
    return (xn.to(bf16).float() @ w.to(bf16).float()).to(x.dtype)


def fused_merge_cuda(x, gamma, beta, w, eps: float = 1e-5):
    """Launch csrc/merge_kernel.cu: bf16 or fp32 rows (out of the same
    dtype; fp32 rows take a LayerNorm row pass into a bf16 scratch before
    the product), bf16 affine and weight, any number of rows, 4C and 2C
    multiples of 16; raises on anything else."""
    kernels.require(x.is_cuda,
                    f"{x.device} tensor: the kernel takes CUDA tensors")
    kernels.require(x.dim() == 3 and w.dim() == 2,
                    f"x (B, L, 4C) / w (4C, 2C) expected, got "
                    f"{tuple(x.shape)} / {tuple(w.shape)}")
    b, l, c4 = x.shape
    c2 = w.shape[1]
    dev = x.device
    kernels.require(b * l > 0 and c4 % 16 == 0 and c2 % 16 == 0,
                    f"unsupported shape T={b * l}, 4C={c4}, 2C={c2}")
    bf16 = torch.bfloat16
    kernels.check_token_dtype("x", x)
    kernels.check_cuda_tensor("x", x, x.dtype, (b, l, c4), dev)
    for name, t, shape in (("gamma", gamma, (c4,)), ("beta", beta, (c4,)),
                           ("w", w, (c4, c2))):
        kernels.check_cuda_tensor(name, t, bf16, shape, dev)
    lib = kernels.library()
    smem = lib.fmmt_fused_merge_smem(c4)
    kernels.require(smem <= kernels.max_shared_memory(dev),
                    f"needs {smem} B of shared memory per block")
    out = torch.empty((b, l, c2), dtype=x.dtype, device=dev)
    # fp32 rows: their LayerNorm statistics and bf16 normalised rows
    f32 = kernels.is_f32(x)
    stats, xn = ((torch.empty((b * l, 2), dtype=torch.float32, device=dev),
                  torch.empty((b * l, c4), dtype=bf16, device=dev)) if f32
                 else (None, None))
    err = lib.fmmt_fused_merge(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w.data_ptr(),
        None if stats is None else stats.data_ptr(),
        None if xn is None else xn.data_ptr(), out.data_ptr(), b * l, c4, c2,
        f32, eps, kernels.stream_ptr(dev))
    kernels.check_launch("fused_merge", err)
    fused_merge_cuda.launches += 1
    return out


fused_merge_cuda.launches = 0


def kernel_operands(x, gamma, beta, w):
    """What the Function hands the kernel for CUDA tensors: x in its own
    dtype (kernels.token_operand), the affine and the weight in bf16."""
    return (kernels.token_operand(x),
            *[kernel_operand(t) for t in (gamma, beta, w)])


class _FusedMerge(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, w, eps):
        ctx.save_for_backward(x, gamma, beta, w)
        ctx.eps = eps
        if x.is_cuda:
            out = fused_merge_cuda(*kernel_operands(x, gamma, beta, w), eps)
        else:
            out = fused_merge_plain(x, gamma, beta, w, eps)
        return out.to(x.dtype)

    @staticmethod
    def backward(ctx, dout):
        eps = ctx.eps
        return (*kernels.grads_of_recomputed(
            lambda *t: fused_merge_plain(*t, eps), ctx.saved_tensors,
            ctx.needs_input_grad, dout), None)


def fused_merge(x, gamma, beta, w, eps: float = 1e-5):
    """CPU tensors -> plain version; CUDA tensors -> the kernel, or raise."""
    return _FusedMerge.apply(x, gamma, beta, w, eps)
