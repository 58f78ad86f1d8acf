"""Kernels 1-11 in the tokens' own dtype (the port under --compute_dtype
float32), on the CPU.

The JAX kernels read x (the attention cores q, k, v) in its own dtype: fp32
tokens keep their LN statistics, residual, probabilities, out and dx in
fp32.  Two things are held here:
  * the plain versions that the CUDA kernels are compared with on the card
    (for kernels 7, 8-10 and 11 the autograd Functions themselves, which
    take them on CPU tensors), on fp32 tokens that bf16 cannot represent,
    against the JAX package's `_reference`, `_whole_reference`, interpret-
    mode kernel (and jax.vjp of a reference) on the same fp32 tokens: out
    and dx come back in fp32.  Tolerances: 1e-4 of max|out| where both
    sides compute in fp32 (kernels 1, 2, 5-10: another summation order);
    2e-2 where JAX rounds its matmul operands to bf16 (kernels 3, 4 and 11:
    the JAX suite's kernel bound), with the fp32 residual then held exactly
    where keep is 0;
  * what each autograd Function hands its kernel for CUDA tensors (the
    operand preparation, `kernel_operands` / `bwd_kernel_operands` /
    `whole_kernel_operands`): fp32 tokens stay fp32 and bf16 stay bf16,
    weights go in bf16, the attention, block and whole-block bias and keep
    in fp32, the window cores' bias in bf16 (as they store it), and any
    other token dtype raises instead of a quiet cast.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facialmmt_tpu.ops.pallas import attention as jattn
from facialmmt_tpu.ops.pallas import block_mlp as jmlp
from facialmmt_tpu.ops.pallas import fused_block as jblock
from facialmmt_tpu.ops.pallas import merge_kernel as jmerge
from facialmmt_tpu.ops.pallas import window_attention as jwa
from facialmmt_tpu_torch.ops.kernels import (attention, block_mlp,
                                             fused_block, merge_kernel,
                                             window_attention)

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


def _whole_inputs(rng, w=8, n=49, c=32, h=2, nw=4):
    """JAX-layout inputs of the whole block: the attention half's, then
    gamma2, beta2, w1 (C, 4C), b1, w2 (4C, C), b2."""
    a, m = _attn_inputs(rng, w, n, c, h, nw), _mlp_inputs(rng, 1, c)
    return ([a[k] for k in ("x", "gamma", "beta", "wqkv", "bqkv", "wproj",
                            "bproj", "bias")]
            + [m[k] for k in ("gamma", "beta", "w1", "b1", "w2", "b2")])


WHOLE_TRANSPOSED = (3, 5, 10, 12)   # wqkv, wproj, w1, w2: JAX (in, out)


def _whole_port(args):
    return [T(a.T.copy()) if i in WHOLE_TRANSPOSED else T(a)
            for i, a in enumerate(args)]


def test_kernel7_function_on_fp32_matches_jax_whole_reference(rng):
    """FusedWholeBlock on fp32 CPU tensors (its plain version) against JAX's
    _whole_reference, which keeps y, LN2 and the residual in x's dtype."""
    args = _whole_inputs(rng)
    got = fused_block.fused_whole_block(*_whole_port(args))
    assert got.dtype == torch.float32
    want = np.asarray(jblock._whole_reference(*args, 1e-5))
    assert want.dtype == np.float32
    assert _rel(got.numpy(), want) <= SAME_MATH


WINDOW_FUNCTIONS = {
    "fused": (window_attention.fused_window_attention,
              lambda *a: jwa.fused_window_attention(*a, 2, True)),
    "paired": (window_attention.paired_window_attention,
               lambda *a: jwa.paired_window_attention(*a, 2, True)),
    "v2": (window_attention.fused_window_attention_v2,
           lambda *a: jax.jit(lambda *b: jwa.fused_window_attention_v2(
               *b, 4, True))(*a)),
}


@pytest.mark.parametrize("nw", [4, 1], ids=["nW4", "nW1"])
@pytest.mark.parametrize("variant", sorted(WINDOW_FUNCTIONS))
def test_kernels8_10_functions_on_fp32_match_jax_kernels(rng, variant, nw):
    """The window-attention Functions on fp32 CPU tensors against the JAX
    kernels in interpret mode on the same fp32 q, k, v (both round only the
    bias to bf16; probabilities and out stay fp32) and against _reference
    on the bf16-rounded bias."""
    port, jax_kernel = WINDOW_FUNCTIONS[variant]
    q = _not_bf16(rng.normal(size=(8, 3, 49, 32)) * 32 ** -0.5)
    k, v = (_not_bf16(rng.normal(size=(8, 3, 49, 32))) for _ in range(2))
    bias = rng.normal(size=(nw, 3, 49, 49)).astype(np.float32)
    got = port(T(q), T(k), T(v), T(bias))
    assert got.dtype == torch.float32
    want = np.asarray(jax_kernel(q, k, v, bias))
    assert want.dtype == np.float32
    assert _rel(got.numpy(), want) <= SAME_MATH
    rounded = jnp.asarray(bias).astype(jnp.bfloat16).astype(jnp.float32)
    assert _rel(got.numpy(), np.asarray(jwa._reference(q, k, v, rounded))) \
        <= SAME_MATH


@pytest.mark.parametrize("b,l,c4,c2", [(2, 49, 384, 192), (1, 30, 64, 32)])
def test_kernel11_function_on_fp32_matches_jax(rng, b, l, c4, c2):
    """fused_merge on fp32 CPU rows against the JAX kernel in interpret mode
    and its _reference: fp32 statistics, the bf16 product, fp32 out."""
    x = _not_bf16(rng.normal(size=(b, l, c4)))
    g = (1 + 0.1 * rng.normal(size=c4)).astype(np.float32)
    be = (0.1 * rng.normal(size=c4)).astype(np.float32)
    w = (rng.normal(size=(c4, c2)) / np.sqrt(c4)).astype(np.float32)
    got = merge_kernel.fused_merge(T(x), T(g), T(be), T(w))
    assert got.dtype == torch.float32
    for want in (jmerge.fused_merge(x, g, be, w, 1e-5, True),
                 jmerge._reference(x, g, be, w)):
        want = np.asarray(want)
        assert want.dtype == np.float32
        assert _rel(got.numpy(), want) <= BF16_REF


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
    if kind == "window":
        q, k, v = (torch.randn(4, 2, 16, 16).to(dtype) for _ in range(3))
        return window_attention.kernel_operands(
            q, k, v, torch.randn(2, 2, 16, 16)), 3
    if kind == "merge":
        x = T(_not_bf16(rng.normal(size=(2, 6, 64)))).to(dtype)
        return merge_kernel.kernel_operands(
            x, torch.ones(64), torch.zeros(64), torch.randn(64, 32)), 1
    if kind == "whole":
        args = _whole_port(_whole_inputs(rng, w=4, n=16, c=16, h=2, nw=1))
        return fused_block.whole_kernel_operands(args[0].to(dtype),
                                                 *args[1:]), 1
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


KINDS = ["attention", "block", "block_bwd", "mlp", "mlp_bwd", "window",
         "merge", "whole"]
# which of the operands after the tokens go to the kernel in fp32 (the rest
# in bf16)
FP32_OPERANDS = {"attention": (0,), "block": (6, 7), "block_bwd": (5, 6),
                 "mlp": (6,), "mlp_bwd": (5,), "window": (), "merge": (),
                 "whole": (6,)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("kind", KINDS)
def test_functions_hand_kernels_the_tokens_own_dtype(rng, kind, dtype):
    """The tokens go to the kernel in their own dtype (no cast: fp32 stays
    fp32), contiguous and detached; the weights in bf16; the attention bias,
    the block and whole-block bias and keep in fp32, the window cores' bias
    in bf16."""
    ops, tokens = _operands(kind, dtype, rng)
    assert all(t.dtype == dtype and t.is_contiguous() and not t.requires_grad
               for t in ops[:tokens])
    rest = [t for t in ops[tokens:] if t is not None]
    assert [t.dtype for t in rest] == [
        torch.float32 if i in FP32_OPERANDS[kind] else torch.bfloat16
        for i in range(len(rest))]


@pytest.mark.parametrize("kind", KINDS)
def test_functions_refuse_other_token_dtypes(rng, kind):
    """fp16 tokens: no kernel instantiation takes them, so the operand
    preparation raises rather than cast them."""
    with pytest.raises(ValueError, match="kernels 1-11 take"):
        _operands(kind, torch.float16, rng)
