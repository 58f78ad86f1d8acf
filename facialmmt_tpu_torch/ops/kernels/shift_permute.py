"""The cyclic shift of shifted-window attention as one row permutation.

Counterpart of facialmmt_tpu/ops/pallas/shift_permute.py: shift_permute (CUDA
kernel csrc/shift_permute.cu).  x (B, H*W, C) is in window layout; the result
is x[:, perm], or x[:, inv] with inverse=True, where perm / inv are
ops/swin.py::shifted_window_perms(h, w, ws, shift): SwinBlock's roll before
attention and its undo.  Pure data movement, so the kernel is bit-equal to the
index gather in every dtype.

`shift_permute` is a torch.autograd.Function: a permutation's vector-Jacobian
product is its inverse permutation, so the backward runs the same kernel in
the opposite direction (JAX's custom_vjp).  CPU tensors take the plain
version, CUDA tensors the kernel, which raises on shapes outside
`shift_permute_ok`.  As in the JAX package, SwinBlock keeps its index gather;
nothing in the model calls this function.
"""

from __future__ import annotations

import functools

import torch

from facialmmt_tpu_torch.ops import kernels
from facialmmt_tpu_torch.ops.swin import shifted_window_perms


def shift_permute_ok(h: int, w: int, ws: int, shift: int) -> bool:
    """Shape gate: an exact window grid, a genuine 2x2-neighbourhood shift
    (0 < shift < ws) and at least two windows each way."""
    return (0 < shift < ws and h % ws == 0 and w % ws == 0
            and h // ws >= 2 and w // ws >= 2)


@functools.lru_cache(maxsize=64)
def _perm(h: int, w: int, ws: int, shift: int, inverse: bool,
          device: torch.device) -> torch.Tensor:
    perm, inv = shifted_window_perms(h, w, ws, shift)
    return torch.from_numpy(inv if inverse else perm).to(device)


def shift_permute_plain(x, h: int, w: int, ws: int, shift: int,
                        inverse: bool = False):
    """Plain PyTorch version: x.index_select(1, perm or inv)."""
    return x.index_select(1, _perm(h, w, ws, shift, inverse, x.device))


def shift_permute_cuda(x, h: int, w: int, ws: int, shift: int,
                       inverse: bool = False):
    """Launch csrc/shift_permute.cu on a contiguous CUDA tensor (B, h*w, C) of
    any dtype; raises outside shift_permute_ok."""
    kernels.require(shift_permute_ok(h, w, ws, shift),
                    f"shift_permute takes 0 < shift < ws and a window grid of "
                    f"at least 2 x 2, got h={h}, w={w}, ws={ws}, "
                    f"shift={shift}")
    kernels.require(x.is_cuda,
                    f"{x.device} tensor: the kernel takes CUDA tensors")
    kernels.require(x.dim() == 3 and x.shape[1] == h * w,
                    f"x: expected (B, {h * w}, C), got {tuple(x.shape)}")
    kernels.require(x.is_contiguous(), "x: must be contiguous")
    b, _, c = x.shape
    out = torch.empty_like(x)
    err = kernels.library().fmmt_shift_permute(
        x.data_ptr(), out.data_ptr(), b, h, w, ws, shift, int(inverse),
        c * x.element_size(), kernels.stream_ptr(x.device))
    kernels.check_launch("shift_permute", err)
    shift_permute_cuda.launches += 1
    return out


shift_permute_cuda.launches = 0


def _apply(x, h, w, ws, shift, inverse):
    if x.is_cuda:
        return shift_permute_cuda(x.contiguous(), h, w, ws, shift, inverse)
    return shift_permute_plain(x, h, w, ws, shift, inverse)


class ShiftPermute(torch.autograd.Function):
    """The permutation forward, its inverse backward; nothing is saved."""

    @staticmethod
    def forward(ctx, x, h, w, ws, shift, inverse):
        ctx.geometry = (h, w, ws, shift, inverse)
        return _apply(x.detach(), h, w, ws, shift, inverse)

    @staticmethod
    def backward(ctx, g):
        h, w, ws, shift, inverse = ctx.geometry
        return _apply(g, h, w, ws, shift, not inverse), None, None, None, \
            None, None


def shift_permute(x, h: int, w: int, ws: int, shift: int,
                  inverse: bool = False):
    """CPU tensors -> plain version; CUDA tensors -> the kernel, or raise."""
    return ShiftPermute.apply(x, h, w, ws, shift, inverse)
