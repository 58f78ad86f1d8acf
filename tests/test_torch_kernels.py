"""The port's three kernel modules against the JAX Pallas kernels.

On the CPU each port module runs its plain PyTorch version; it is held
  * against the JAX kernel run in interpret mode, at the JAX suite's own bound
    max|d| <= 2e-2 * max|out| (the Pallas kernels round matmul operands to
    bf16 inside, test_pallas.py), and
  * against the JAX fp32 reference / XLA path at atol 1e-5, rtol 1e-4.
tests/test_torch_gpu.py compares each CUDA kernel with its plain version on
the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facialmmt_tpu.ops.pallas import attention as jattn
from facialmmt_tpu.ops.pallas import block_mlp as jmlp
from facialmmt_tpu.ops.pallas import fused_block as jblock
from facialmmt_tpu_torch.ops.kernels import attention, block_mlp, fused_block

T = torch.from_numpy


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _attention_inputs(rng, b, h, sq, sk, d):
    q = (rng.normal(size=(b, h, sq, d)) * 0.2).astype(np.float32)
    k = rng.normal(size=(b, h, sk, d)).astype(np.float32)
    v = rng.normal(size=(b, h, sk, d)).astype(np.float32)
    bias = np.where(rng.random((b, sk)) > 0.3, 0.0, -1e30).astype(np.float32)
    bias[-1] = -1e30   # a fully padded row: every key masked
    return q, k, v, bias


@pytest.mark.parametrize("sq,sk", [(32, 32), (24, 40)],
                         ids=["self", "cross"])
def test_fused_attention_matches_jax(rng, sq, sk):
    q, k, v, bias = _attention_inputs(rng, 3, 2, sq, sk, 16)
    got = attention.fused_attention(T(q), T(k), T(v), T(bias)).numpy()
    interp = np.asarray(jattn.fused_attention(q, k, v, bias, True))
    assert _rel(got, interp) <= 2e-2
    want = np.asarray(jattn._reference_attention(q, k, v, jnp.asarray(bias)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
    # the fully padded row gets the uniform softmax, as in JAX: mean of v
    np.testing.assert_allclose(got[-1], np.broadcast_to(
        v[-1].mean(axis=1, keepdims=True), got[-1].shape), atol=1e-5,
        rtol=1e-4)


def _block_inputs(rng, w, n, c, h, nw):
    x = rng.normal(size=(w, n, c)).astype(np.float32)
    gamma = (rng.normal(size=(c,)) * 0.1 + 1).astype(np.float32)
    beta = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    wqkv = (rng.normal(size=(c, 3 * c)) * 0.2).astype(np.float32)
    bqkv = (rng.normal(size=(3 * c,)) * 0.1).astype(np.float32)
    wproj = (rng.normal(size=(c, c)) * 0.2).astype(np.float32)
    bproj = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    bias = (rng.normal(size=(nw, h, n, n)) * 0.5).astype(np.float32)
    if nw > 1:   # shifted-window style mask rows
        bias += np.where(rng.random((nw, 1, n, n)) > 0.7, -100.0, 0.0
                         ).astype(np.float32)
    return x, gamma, beta, wqkv, bqkv, wproj, bproj, bias


@pytest.mark.parametrize("nw,use_keep", [(4, False), (4, True), (1, False),
                                         (1, True)],
                         ids=["shifted", "shifted-keep", "plain", "plain-keep"])
def test_fused_attention_block_matches_jax(rng, nw, use_keep):
    w, n, c, h = 8, 16, 16, 2
    x, g, be, wqkv, bqkv, wp, bp, bias = _block_inputs(rng, w, n, c, h, nw)
    keep = (np.asarray([0.0, 1.25, 1.25, 0.0, 1.25, 0.0, 1.25, 1.25],
                       np.float32) if use_keep else None)
    got = fused_block.fused_attention_block(
        T(x), T(g), T(be), T(wqkv.T.copy()), T(bqkv), T(wp.T.copy()), T(bp),
        T(bias), None if keep is None else T(keep)).numpy()
    interp = np.asarray(jblock.fused_attention_block(
        x, g, be, wqkv, bqkv, wp, bp, bias, keep, interpret=True))
    assert _rel(got, interp) <= 2e-2
    want = np.asarray(jblock._reference(x, g, be, wqkv, bqkv, wp, bp, bias,
                                        keep, 1e-5))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
    if keep is not None:
        np.testing.assert_array_equal(got[keep == 0], x[keep == 0])


def _mlp_xla_fp32(x, g, be, w1, b1, w2, b2, keep, eps=1e-5):
    """fp32 XLA formulation of the block MLP half (SwinBlock's XLA path)."""
    xn = (x - x.mean(-1, keepdims=True)) * jax.lax.rsqrt(
        x.var(-1, keepdims=True) + eps) * g + be
    y = jax.nn.gelu(xn @ w1 + b1, approximate=False) @ w2 + b2
    if keep is not None:
        y = y * keep[:, None]
    return x + y


@pytest.mark.parametrize("t,use_keep", [(256, True), (50, False)],
                         ids=["keep", "ragged"])
def test_fused_ln_mlp_residual_matches_jax(rng, t, use_keep):
    c = 16
    x = rng.normal(size=(t, c)).astype(np.float32)
    g = (rng.normal(size=(c,)) * 0.1 + 1).astype(np.float32)
    be = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    w1 = (rng.normal(size=(c, 4 * c)) * 0.2).astype(np.float32)
    b1 = (rng.normal(size=(4 * c,)) * 0.1).astype(np.float32)
    w2 = (rng.normal(size=(4 * c, c)) * 0.2).astype(np.float32)
    b2 = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    keep = ((rng.random(t) > 0.3) / 0.7).astype(np.float32) if use_keep else None
    got = block_mlp.fused_ln_mlp_residual(
        T(x), T(g), T(be), T(w1.T.copy()), T(b1), T(w2.T.copy()), T(b2),
        None if keep is None else T(keep)).numpy()
    interp = np.asarray(jmlp.fused_ln_mlp_residual(
        x, g, be, w1, b1, w2, b2, keep, 1e-5, True))
    assert _rel(got, interp) <= 2e-2
    # _reference rounds the matmul operands to bf16 like the kernel
    ref_bf16 = np.asarray(jmlp._reference(x, g, be, w1, b1, w2, b2, keep,
                                          1e-5))
    assert _rel(got, ref_bf16) <= 2e-2
    want = np.asarray(_mlp_xla_fp32(x, g, be, w1, b1, w2, b2, keep))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
    if keep is not None:
        np.testing.assert_array_equal(got[keep == 0], x[keep == 0])


def test_dispatch_takes_plain_version_on_cpu(rng):
    """A CPU tensor never reaches a kernel wrapper: counts stay 0."""
    from facialmmt_tpu_torch.ops import kernels

    kernels.reset_launch_counts()
    q, k, v, bias = _attention_inputs(rng, 1, 2, 8, 8, 16)
    attention.fused_attention(T(q), T(k), T(v), T(bias))
    assert kernels.launch_counts() == {
        "fused_attention": 0, "fused_attention_block": 0,
        "fused_ln_mlp_residual": 0, "fused_ln_mlp_residual_bwd": 0,
        "fused_attention_block_bwd": 0, "fused_attention_block_bwd_spill": 0}
