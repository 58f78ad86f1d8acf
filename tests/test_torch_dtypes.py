"""Kernels 1-6 in the tokens' own dtype (the port under --compute_dtype
float32), on the CPU.

The JAX kernels read x in its own dtype: fp32 tokens keep their LN
statistics, residual, out and dx in fp32.  Two things are held here:
  * the plain versions that the CUDA kernels are compared with on the card,
    on fp32 tokens that bf16 cannot represent, against the JAX package's
    `_reference` (and jax.vjp of it) on the same fp32 tokens: out and dx come
    back in fp32.  Tolerances: 1e-4 of max|out| where both sides compute in
    fp32 (kernels 1, 2, 5, 6: another summation order); 2e-2 where JAX's
    reference rounds its matmul operands to bf16 (kernels 3 and 4: the JAX
    suite's kernel bound), with the fp32 residual then held exactly where
    keep is 0;
  * what each autograd Function hands its kernel for CUDA tensors (the
    operand preparation, `kernel_operands` / `bwd_kernel_operands`): fp32
    tokens stay fp32 and bf16 stay bf16, weights go in bf16, the bias and
    keep in fp32, and any other token dtype raises instead of a quiet cast.
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

SAME_MATH = 1e-4     # fp32 on both sides, another summation order
BF16_REF = 2e-2      # JAX's reference rounds the matmul operands to bf16

T = torch.from_numpy


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _not_bf16(a):
    """fp32 values that bf16 does not hold: a rounding to bf16 shows."""
    a = np.asarray(a, np.float32)
    assert not np.array_equal(
        np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)), a)
    return a


def _attn_inputs(rng, w=8, n=49, c=32, h=2, nw=4, keep=True):
    return dict(
        x=_not_bf16(rng.normal(size=(w, n, c))),
        gamma=(rng.normal(size=c) * 0.1 + 1).astype(np.float32),
        beta=(rng.normal(size=c) * 0.1).astype(np.float32),
        wqkv=(rng.normal(size=(c, 3 * c)) * 0.1).astype(np.float32),
        bqkv=(rng.normal(size=3 * c) * 0.05).astype(np.float32),
        wproj=(rng.normal(size=(c, c)) * 0.1).astype(np.float32),
        bproj=(rng.normal(size=c) * 0.05).astype(np.float32),
        bias=(rng.normal(size=(nw, h, n, n)) * 0.5).astype(np.float32),
        dy=_not_bf16(rng.normal(size=(w, n, c))),
        keep=(np.tile([0.0, 1.25], w // 2).astype(np.float32) if keep
              else None))


def _mlp_inputs(rng, t=200, c=32, keep=True):
    return dict(
        x=_not_bf16(rng.normal(size=(t, c))),
        gamma=(rng.normal(size=c) * 0.1 + 1).astype(np.float32),
        beta=(rng.normal(size=c) * 0.1).astype(np.float32),
        w1=(rng.normal(size=(c, 4 * c)) * 0.1).astype(np.float32),
        b1=(rng.normal(size=4 * c) * 0.05).astype(np.float32),
        w2=(rng.normal(size=(4 * c, c)) * 0.1).astype(np.float32),
        b2=(rng.normal(size=c) * 0.05).astype(np.float32),
        dy=_not_bf16(rng.normal(size=(t, c))),
        keep=(np.tile([0.0, 1.25], t // 2).astype(np.float32) if keep
              else None))


@pytest.mark.parametrize("sq,sk", [(32, 32), (24, 40)], ids=["self", "cross"])
def test_kernel1_plain_on_fp32_matches_jax_reference(rng, sq, sk):
    q = _not_bf16(rng.normal(size=(3, 2, sq, 16)) * 0.2)
    k, v = (_not_bf16(rng.normal(size=(3, 2, sk, 16))) for _ in range(2))
    bias = np.where(rng.random((3, sk)) > 0.3, 0.0, -1e30).astype(np.float32)
    got = attention.fused_attention_plain(T(q), T(k), T(v), T(bias))
    assert got.dtype == torch.float32
    want = np.asarray(jattn._reference_attention(q, k, v, jnp.asarray(bias)))
    assert want.dtype == np.float32
    assert _rel(got.numpy(), want) <= SAME_MATH


@pytest.mark.parametrize("keep", [False, True], ids=["nokeep", "keep"])
def test_kernel2_plain_on_fp32_matches_jax_reference(rng, keep):
    a = _attn_inputs(rng, keep=keep)
    k = None if a["keep"] is None else T(a["keep"])
    got = fused_block.fused_attention_block_plain(
        T(a["x"]), T(a["gamma"]), T(a["beta"]), T(a["wqkv"].T.copy()),
        T(a["bqkv"]), T(a["wproj"].T.copy()), T(a["bproj"]), T(a["bias"]), k)
    assert got.dtype == torch.float32
    want = np.asarray(jblock._reference(
        a["x"], a["gamma"], a["beta"], a["wqkv"], a["bqkv"], a["wproj"],
        a["bproj"], a["bias"], a["keep"], 1e-5))
    assert want.dtype == np.float32
    assert _rel(got.numpy(), want) <= SAME_MATH
    if keep:      # keep 0: the fp32 token passes through unrounded
        np.testing.assert_array_equal(got.numpy()[0], a["x"][0])


@pytest.mark.parametrize("keep", [False, True], ids=["nokeep", "keep"])
def test_kernel3_plain_on_fp32_matches_jax_reference(rng, keep):
    a = _mlp_inputs(rng, keep=keep)
    k = None if a["keep"] is None else T(a["keep"])
    got = block_mlp.fused_ln_mlp_residual_plain(
        T(a["x"]), T(a["gamma"]), T(a["beta"]), T(a["w1"].T.copy()),
        T(a["b1"]), T(a["w2"].T.copy()), T(a["b2"]), k)
    assert got.dtype == torch.float32
    want = np.asarray(jmlp._reference(
        a["x"], a["gamma"], a["beta"], a["w1"], a["b1"], a["w2"], a["b2"],
        a["keep"], 1e-5))
    assert want.dtype == np.float32
    assert _rel(got.numpy(), want) <= BF16_REF
    if keep:      # both keep the residual in fp32: exact where keep is 0
        zero = a["keep"] == 0
        np.testing.assert_array_equal(got.numpy()[zero], a["x"][zero])
        np.testing.assert_array_equal(want[zero], a["x"][zero])


def _hold(names, got, want, tol):
    for name, g, w in zip(names, got, want):
        if name == "bias":
            g, w = g.sum(0), w.sum(0)
        assert g.shape == w.shape, name
        assert np.abs(g - w).max() / (np.abs(w).max() or 1.0) <= tol, name


@pytest.mark.parametrize("keep", [False, True], ids=["nokeep", "keep"])
def test_kernel4_plain_on_fp32_matches_jax_reference_vjp(rng, keep):
    a = _mlp_inputs(rng, keep=keep)
    names = ("x", "gamma", "beta", "w1", "b1", "w2", "b2")
    k = None if a["keep"] is None else jnp.asarray(a["keep"])
    _, vjp = jax.vjp(lambda *p: jmlp._reference(*p, k, 1e-5),
                     *[jnp.asarray(a[n]) for n in names])
    want = [np.asarray(g) for g in vjp(jnp.asarray(a["dy"]))]
    assert want[0].dtype == np.float32
    out = block_mlp.fused_ln_mlp_residual_bwd_plain(
        T(a["x"]), T(a["dy"]), T(a["gamma"]), T(a["beta"]),
        T(a["w1"].T.copy()), T(a["b1"]), T(a["w2"].T.copy()),
        None if k is None else T(a["keep"]))
    assert out[0].dtype == torch.float32
    dx, dgamma, dbeta, dw1, db1, dw2, db2 = (o.numpy() for o in out)
    _hold(names, [dx, dgamma, dbeta, dw1.T, db1, dw2.T, db2], want, BF16_REF)
    if keep:      # keep 0: dx is dy itself, in fp32
        zero = a["keep"] == 0
        np.testing.assert_array_equal(dx[zero], a["dy"][zero])


@pytest.mark.parametrize("keep", [False, True], ids=["nokeep", "keep"])
@pytest.mark.parametrize("variant", ["resident", "spill"])
def test_kernels56_plain_on_fp32_match_jax_reference_vjp(rng, variant, keep):
    a = _attn_inputs(rng, keep=keep)
    names = ("x", "gamma", "beta", "wqkv", "bqkv", "wproj", "bproj", "bias")
    k = None if a["keep"] is None else jnp.asarray(a["keep"])
    _, vjp = jax.vjp(lambda *p: jblock._reference(*p, k, 1e-5),
                     *[jnp.asarray(a[n]) for n in names])
    want = [np.asarray(g) for g in vjp(jnp.asarray(a["dy"]))]
    assert want[0].dtype == np.float32
    fn = (fused_block.fused_attention_block_bwd_plain if variant == "resident"
          else fused_block.fused_attention_block_bwd_spill_plain)
    out = fn(T(a["x"]), T(a["dy"]), T(a["gamma"]), T(a["beta"]),
             T(a["wqkv"].T.copy()), T(a["bqkv"]), T(a["wproj"].T.copy()),
             T(a["bias"]), None if k is None else T(a["keep"]))
    assert out[0].dtype == torch.float32
    dx, dgamma, dbeta, dwqkv, dbqkv, dwproj, dbproj, dbias = (
        o.numpy() for o in out)
    _hold(names, [dx, dgamma, dbeta, dwqkv.T, dbqkv, dwproj.T, dbproj, dbias],
          want, SAME_MATH)


def _operands(kind, dtype, rng):
    """(prepared operands, which of them are tokens) for the operand
    preparation of each Function, from inputs whose tokens are `dtype`."""
    if kind == "attention":
        q, k, v = (torch.randn(2, 2, 8, 16).to(dtype) for _ in range(3))
        return attention.kernel_operands(q, k, v, torch.zeros(2, 8)), 3
    if kind.startswith("mlp"):
        a = _mlp_inputs(rng, t=16, c=16)
        x, dy = T(a["x"]).to(dtype), T(a["dy"]).to(dtype)
        w = [T(a[n]) for n in ("gamma", "beta")] + [
            T(a["w1"].T.copy()), T(a["b1"]), T(a["w2"].T.copy())]
        if kind == "mlp":
            return block_mlp.kernel_operands(x, *w, T(a["b2"]),
                                             T(a["keep"])), 1
        return block_mlp.bwd_kernel_operands(x, dy, *w, T(a["keep"])), 2
    a = _attn_inputs(rng, w=4, n=16, c=16, h=2, nw=1)
    x, dy = T(a["x"]).to(dtype), T(a["dy"]).to(dtype)
    w = [T(a[n]) for n in ("gamma", "beta")] + [
        T(a["wqkv"].T.copy()), T(a["bqkv"]), T(a["wproj"].T.copy())]
    if kind == "block":
        return fused_block.kernel_operands(x, *w, T(a["bproj"]), T(a["bias"]),
                                           T(a["keep"])), 1
    return fused_block.bwd_kernel_operands(x, dy, *w, T(a["bias"]),
                                           T(a["keep"])), 2


KINDS = ["attention", "block", "block_bwd", "mlp", "mlp_bwd"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("kind", KINDS)
def test_functions_hand_kernels_the_tokens_own_dtype(rng, kind, dtype):
    """The tokens go to the kernel in their own dtype (no cast: fp32 stays
    fp32), contiguous and detached; the weights in bf16; the attention bias,
    the window bias and keep in fp32."""
    ops, tokens = _operands(kind, dtype, rng)
    assert all(t.dtype == dtype and t.is_contiguous() and not t.requires_grad
               for t in ops[:tokens])
    rest = [t for t in ops[tokens:] if t is not None]
    fp32 = {"attention": 1, "block": 2, "block_bwd": 2, "mlp": 1,
            "mlp_bwd": 1}[kind]
    assert all(t.dtype == torch.bfloat16 for t in rest[:-fp32])
    assert all(t.dtype == torch.float32 for t in rest[-fp32:])


@pytest.mark.parametrize("kind", KINDS)
def test_functions_refuse_other_token_dtypes(rng, kind):
    """fp16 tokens: no kernel instantiation takes them, so the operand
    preparation raises rather than cast them."""
    with pytest.raises(ValueError, match="kernels 1-6 take"):
        _operands(kind, torch.float16, rng)
