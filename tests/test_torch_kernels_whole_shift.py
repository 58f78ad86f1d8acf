"""The whole-block and shift-permutation modules against the JAX package.

On the CPU each port module runs its plain PyTorch version:
  * fused_whole_block_plain against JAX's fused_whole_block in interpret mode
    at the JAX suite's own bound (max|d| <= 2e-3 * max|out|: the Pallas
    kernel casts the weights and the bias to bf16 inside, test_pallas.py), and
    against JAX's fp32 _whole_reference at atol 1e-5, rtol 1e-4; the
    gradient of every input against jax.grad of _whole_reference at
    max|d| <= 1e-4 * max|grad| (fp32 on both sides, summation order only);
  * shift_permute_plain against JAX's shift_permute in interpret mode, bit
    for bit, both directions, the round trip and the gradient.
tests/test_torch_gpu.py holds the CUDA kernels against these plain versions
on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facialmmt_tpu.ops.pallas import fused_block as jblock
from facialmmt_tpu.ops.pallas import shift_permute as jshift
from facialmmt_tpu_torch.ops import kernels
from facialmmt_tpu_torch.ops.kernels import fused_block, shift_permute
from facialmmt_tpu_torch.ops.swin import (shifted_window_mask,
                                          shifted_window_perms)

T = torch.from_numpy


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _whole_inputs(rng, w, n, c, h, nw, res):
    """JAX-layout inputs of the whole block (wqkv (C, 3C), w1 (C, 4C), w2
    (4C, C)); nw > 1 adds the shifted-window mask of a res x res stage."""
    f = lambda *shape, scale=1.0, offset=0.0: (
        rng.normal(size=shape) * scale + offset).astype(np.float32)
    bias = f(nw, h, n, n, scale=0.5)
    if nw > 1:
        bias += shifted_window_mask(res, res, 7, 3)[:, None].astype(np.float32)
    hid = 4 * c
    return (f(w, n, c), f(c, scale=0.02, offset=1), f(c, scale=0.02),
            f(c, 3 * c, scale=0.02), f(3 * c, scale=0.02), f(c, c, scale=0.02),
            f(c, scale=0.02), bias, f(c, scale=0.02, offset=1),
            f(c, scale=0.02), f(c, hid, scale=0.02), f(hid, scale=0.02),
            f(hid, c, scale=0.02), f(c, scale=0.02))


TRANSPOSED = (3, 5, 10, 12)   # wqkv, wproj, w1, w2: JAX (in, out) -> Linear


def _port_args(args):
    return [T(a.T.copy()) if i in TRANSPOSED else T(a)
            for i, a in enumerate(args)]


WHOLE_SHAPES = pytest.mark.parametrize(
    "w,c,h,nw,res", [(8, 96, 3, 4, 14), (8, 192, 6, 4, 14)],
    ids=["stage0-shape", "stage1-shifted"])


@WHOLE_SHAPES
def test_fused_whole_block_matches_jax(rng, w, c, h, nw, res):
    """test_pallas.py's shape (C = 96, bias (4, 3, 49, 49)) and a stage-1
    width with the shifted-window mask in the bias."""
    args = _whole_inputs(rng, w, 49, c, h, nw, res)
    got = fused_block.fused_whole_block(*_port_args(args)).numpy()
    interp = np.asarray(jblock.fused_whole_block(*args, interpret=True))
    assert _rel(got, interp) <= 2e-3
    want = np.asarray(jblock._whole_reference(*args, 1e-5))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)


@WHOLE_SHAPES
def test_fused_whole_block_grads_match_jax(rng, w, c, h, nw, res):
    """Every input's gradient through FusedWholeBlock's backward (autograd
    of the plain version) against jax.grad of _whole_reference."""
    args = _whole_inputs(rng, w, 49, c, h, nw, res)
    cot = rng.normal(size=(w, 49, c)).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(jblock._whole_reference(*a, 1e-5)
                                       * cot), argnums=tuple(range(14)))(*args)
    leaves = [t.requires_grad_() for t in _port_args(args)]
    out = fused_block.fused_whole_block(*leaves)
    got = torch.autograd.grad(out, leaves, T(cot))
    for i, (g, wnt) in enumerate(zip(got, want)):
        g = g.numpy().T if i in TRANSPOSED else g.numpy()
        wnt = np.asarray(wnt)
        assert np.abs(g - wnt).max() <= 1e-4 * np.abs(wnt).max(), i


def test_fused_whole_block_is_the_two_halves(rng):
    """The plain version is the attention half, rounded to x's dtype, then
    the MLP half: in bf16 it equals the two plain halves composed."""
    args = [t.to(torch.bfloat16) for t in
            _port_args(_whole_inputs(rng, 4, 49, 32, 2, 1, 7))]
    got = fused_block.fused_whole_block(*args)
    y = fused_block.fused_attention_block(*args[:8])
    from facialmmt_tpu_torch.ops.kernels import block_mlp

    want = block_mlp.fused_ln_mlp_residual(y.reshape(-1, 32), *args[8:])
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.reshape(got.shape))


SHIFT_SHAPES = pytest.mark.parametrize(
    "h,w,ws,s,c", [(56, 56, 7, 3, 96), (14, 14, 7, 3, 384), (21, 14, 7, 2, 8)])


@SHIFT_SHAPES
def test_shift_permute_matches_jax(rng, h, w, ws, s, c):
    """test_pallas.py's three shapes: bit-equal to the JAX kernel and to the
    index gather, both ways, round trip, and the gradient."""
    x = rng.normal(size=(2, h * w, c)).astype(np.float32)
    perm, inv = shifted_window_perms(h, w, ws, s)
    for inverse, idx in ((False, perm), (True, inv)):
        got = shift_permute.shift_permute(T(x), h, w, ws, s, inverse).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jshift.shift_permute(x, h, w, ws, s, inverse,
                                                 True)))
        np.testing.assert_array_equal(got, x[:, idx])
    fwd = shift_permute.shift_permute(T(x), h, w, ws, s)
    assert torch.equal(shift_permute.shift_permute(fwd, h, w, ws, s, True),
                       T(x))
    cot = x[:, inv]
    g_want = jax.grad(lambda a: jnp.sum(
        jshift.shift_permute(a, h, w, ws, s, False, True) * cot))(x)
    xt = T(x).requires_grad_()
    (g,) = torch.autograd.grad(shift_permute.shift_permute(xt, h, w, ws, s),
                               xt, T(cot))
    np.testing.assert_array_equal(g.numpy(), np.asarray(g_want))


@pytest.mark.parametrize("h,w,s", [(56, 56, 3), (28, 28, 3), (14, 14, 3),
                                   (21, 14, 2), (14, 21, 4), (14, 14, 6)])
@pytest.mark.parametrize("inverse", [False, True])
def test_shift_permute_kernel_template(h, w, s, inverse):
    """The index arithmetic of csrc/shift_permute.cu, written out: target
    (window wi, wj; row r, c) reads source window (wi + da + (r + s') // ws,
    wj + da + (c + s') // ws) mod the grid at ((r + s') % ws, (c + s') % ws),
    s' = s and da = 0 forward, s' = ws - s and da = -1 inverse.  It must give
    shifted_window_perms' permutation."""
    ws = 7
    nh, nw = h // ws, w // ws
    sp = ws - s if inverse else s
    da_r, da_c = (nh - 1, nw - 1) if inverse else (0, 0)
    wi, wj, r, c = np.meshgrid(np.arange(nh), np.arange(nw), np.arange(ws),
                               np.arange(ws), indexing="ij")
    src_wi = (wi + da_r + (r + sp) // ws) % nh
    src_wj = (wj + da_c + (c + sp) // ws) % nw
    src = ((src_wi * nw + src_wj) * ws * ws + (r + sp) % ws * ws
           + (c + sp) % ws).reshape(-1)
    np.testing.assert_array_equal(src, shifted_window_perms(h, w, ws, s)
                                  [int(inverse)])


@pytest.mark.parametrize("h,w,ws,s", [(14, 14, 7, 0), (14, 14, 7, 7),
                                      (15, 14, 7, 3), (7, 14, 7, 3),
                                      (14, 7, 7, 3)])
def test_shift_permute_refusals(h, w, ws, s):
    """shift_permute_ok refuses what JAX's refuses (no shift, shift = ws, a
    partial window, a one-window grid); the kernel wrapper raises on it."""
    assert not shift_permute.shift_permute_ok(h, w, ws, s)
    assert not jshift.shift_permute_ok(h, w, ws, s)
    with pytest.raises(ValueError, match="shift"):
        shift_permute.shift_permute_cuda(torch.zeros(1, h * w, 8), h, w, ws, s)
    assert shift_permute.shift_permute_ok(14, 14, 7, 3)


def test_the_two_kernels_have_counted_wrappers_and_run_plain_on_the_cpu(rng):
    """kernel_wrappers() lists all thirteen kernels (the twelve TPU kernels'
    ports and the residual add + LayerNorm); on CPU tensors neither new
    function launches anything."""
    wrappers = kernels.kernel_wrappers()
    assert len(wrappers) == 13
    assert wrappers["fused_whole_block"] is fused_block.fused_whole_block_cuda
    assert wrappers["shift_permute"] is shift_permute.shift_permute_cuda
    kernels.reset_launch_counts()
    fused_block.fused_whole_block(*_port_args(_whole_inputs(rng, 2, 16, 32, 2,
                                                            1, 7)))
    shift_permute.shift_permute(torch.zeros(1, 196, 4), 14, 14, 7, 3)
    assert set(kernels.launch_counts().values()) == {0}
    with pytest.raises(ValueError, match="CUDA"):
        fused_block.fused_whole_block_cuda(*_port_args(
            _whole_inputs(rng, 2, 16, 32, 2, 1, 7)))
