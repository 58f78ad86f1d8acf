"""Swin window attention core: softmax(q k^T + bias[w % nW]) v per window and
head.

Counterpart of facialmmt_tpu/ops/pallas/window_attention.py and its three
entry points, `fused_window_attention`, `paired_window_attention` and
`fused_window_attention_v2`; the CUDA kernel is csrc/window_attention.cu.
q, k, v are (W, h, N, hd) with q PRE-SCALED; bias (nW, h, N, N) is additive
(relative-position bias plus shifted-window mask), W % nW == 0, and window w
reads bias row w % nW (windows arrive faces-major).  Returns (W, h, N, hd).

The three TPU kernels compute one function and differ in how windows are
tiled onto the matrix unit.  On Hopper they share one device kernel and
differ in the windows a block holds side by side (1, the 2 of a pair, the G of
a group), each window on 4 warps of its own; no block-diagonal product is
formed, since its off-diagonal -1e9 blocks have probability exactly 0.

All three store the bias in bf16 (the shift mask's -100 survives that, the
relative-position values are rounded), so the plain version rounds it through
bf16 too.  Each public function is a torch.autograd.Function whose forward is
the kernel on a CUDA tensor and the plain version on a CPU tensor, and whose
backward differentiates the exact formulation (`_reference`, unrounded bias)
recomputed from the saved q, k, v, bias, as the JAX package does: neither
package has a backward kernel for these.
"""

from __future__ import annotations

import torch

from facialmmt_tpu_torch.ops import kernels
from facialmmt_tpu_torch.ops.kernels.block_mlp import kernel_operand

MAX_SIDE_BY_SIDE = 4    # windows one block of csrc/window_attention.cu holds
HEAD_DIMS = (16, 32, 64)


def _reference(q, k, v, bias):
    """fp32 scores and softmax, probabilities in v's dtype."""
    w, nw = q.shape[0], bias.shape[0]
    s = torch.einsum("whnd,whmd->whnm", q.float(), k.float())
    s = (s.reshape(w // nw, nw, *s.shape[1:]) + bias.float()[None]).reshape(
        s.shape)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("whnm,whmd->whnd", p, v)


def window_attention_plain(q, k, v, bias):
    """Plain PyTorch version of all three kernels: `_reference` on the bias
    rounded through bf16, as the kernels store it."""
    return _reference(q, k, v, bias.to(torch.bfloat16).float())


def _launch(wrapper, q, k, v, bias, conc: int, serial: int):
    """Check the operands and launch csrc/window_attention.cu with `conc`
    windows side by side in a block and `serial` one after another: bf16
    q/k/v, N <= 64, head dim in HEAD_DIMS; raises on anything else.  The bias
    is cast to bf16 here, outside the kernel."""
    kernels.require(q.is_cuda,
                    f"{q.device} tensor: the kernel takes CUDA tensors")
    kernels.require(q.dim() == 4 and bias.dim() == 4,
                    f"q (W, h, N, hd) / bias (nW, h, N, N) expected, got "
                    f"{tuple(q.shape)} / {tuple(bias.shape)}")
    w, h, n, hd = q.shape
    nw = bias.shape[0]
    dev = q.device
    kernels.require(0 < n <= 64 and hd in HEAD_DIMS,
                    f"unsupported window shape N={n}, hd={hd}")
    kernels.require(w % nw == 0, f"W={w} is not a multiple of nW={nw}")
    kernels.require(w % (conc * serial) == 0,
                    f"W={w} is not a multiple of {conc} x {serial} windows "
                    f"per block")
    for name, t in (("q", q), ("k", k), ("v", v)):
        kernels.check_cuda_tensor(name, t, torch.bfloat16, (w, h, n, hd), dev)
    kernels.require(tuple(bias.shape) == (nw, h, n, n) and bias.device == dev,
                    f"bias: shape {tuple(bias.shape)} on {bias.device}, "
                    f"expected {(nw, h, n, n)} on {dev}")
    bias = bias.detach().to(torch.bfloat16).contiguous()
    lib = kernels.library()
    smem = lib.fmmt_window_attention_smem(hd, conc)
    kernels.require(smem <= kernels.max_shared_memory(dev),
                    f"needs {smem} B of shared memory per block")
    out = torch.empty_like(q)
    err = lib.fmmt_window_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        out.data_ptr(), w, h, n, hd, nw, conc, serial,
        kernels.stream_ptr(dev))
    kernels.check_launch(wrapper.__name__, err)
    wrapper.launches += 1
    return out


def fused_window_attention_cuda(q, k, v, bias, group: int = 0):
    """One window per block at a time.  `group` is how many windows a block
    takes one after another, lowered until it divides W; 0 takes 1: blocks run
    in parallel on the card and a block's windows share nothing, so a larger
    group only leaves fewer blocks in flight."""
    serial = max(1, min(group, q.shape[0]))
    while q.shape[0] % serial:
        serial -= 1
    return _launch(fused_window_attention_cuda, q, k, v, bias, 1, serial)


def _check_pairs(w: int, nw: int) -> None:
    kernels.require(w % 2 == 0 and (nw == 1 or nw % 2 == 0),
                    f"paired windows need an even W and an even (or single) "
                    f"bias group count, got W={w}, nW={nw}")


def paired_window_attention_cuda(q, k, v, bias, pairs: int = 8):
    """The two windows of a pair (2c, 2c+1) side by side in one block, each
    with its own bias row.  W must be even and, when nW > 1, nW even, so a
    pair never straddles a face.  `pairs`, the TPU kernel's pairs per grid
    cell, is accepted and unused: every block takes one pair."""
    _check_pairs(q.shape[0], bias.shape[0])
    return _launch(paired_window_attention_cuda, q, k, v, bias, 2, 1)


def _group_size(w: int, nw: int, group: int) -> int:
    """The JAX rule: lower `group` until it divides W and, when nW > 1, nW."""
    g = max(1, min(group, MAX_SIDE_BY_SIDE))
    while w % g or (nw > 1 and nw % g):
        g -= 1
    return g


def fused_window_attention_v2_cuda(q, k, v, bias, group: int = 4):
    """`group` windows (at most 4) side by side in one block, lowered until it
    divides W and, when nW > 1, nW."""
    g = _group_size(q.shape[0], bias.shape[0], group)
    return _launch(fused_window_attention_v2_cuda, q, k, v, bias, g, 1)


fused_window_attention_cuda.launches = 0
paired_window_attention_cuda.launches = 0
fused_window_attention_v2_cuda.launches = 0


class _WindowAttention(torch.autograd.Function):
    """Forward: `cuda_fn` on CUDA tensors (operands cast to bf16 at the kernel
    boundary), the plain version on CPU tensors.  Backward: torch autograd of
    `_reference` recomputed from the saved inputs, in fp32 outside autocast."""

    @staticmethod
    def forward(ctx, q, k, v, bias, cuda_fn, tiling):
        ctx.save_for_backward(q, k, v, bias)
        if q.is_cuda:
            out = cuda_fn(kernel_operand(q), kernel_operand(k),
                          kernel_operand(v), bias, tiling)
        else:
            out = window_attention_plain(q, k, v, bias)
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        return (*kernels.grads_of_recomputed(
            _reference, ctx.saved_tensors, ctx.needs_input_grad, dout),
            None, None)


def fused_window_attention(q, k, v, bias, group: int = 0):
    """CPU tensors -> plain version; CUDA tensors -> the kernel, or raise."""
    return _WindowAttention.apply(q, k, v, bias, fused_window_attention_cuda,
                                  group)


def paired_window_attention(q, k, v, bias, pairs: int = 8):
    """CPU tensors -> plain version; CUDA tensors -> the kernel, or raise.
    Raises on an odd W, or an odd nW > 1 (ops/swin.py sends those shapes to
    fused_window_attention)."""
    _check_pairs(q.shape[0], bias.shape[0])
    return _WindowAttention.apply(q, k, v, bias, paired_window_attention_cuda,
                                  pairs)


def fused_window_attention_v2(q, k, v, bias, group: int = 4):
    """CPU tensors -> plain version; CUDA tensors -> the kernel, or raise."""
    return _WindowAttention.apply(q, k, v, bias,
                                  fused_window_attention_v2_cuda, group)
