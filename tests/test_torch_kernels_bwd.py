"""The port's plain backward versions of the two Swin block halves against
the JAX package, on the CPU.

Each plain backward (written out step by step, the arithmetic the CUDA
kernels repeat) is held against two JAX oracles on the same numpy inputs:
jax.vjp of the kernel module's `_reference`, and the Pallas backward kernel in
interpret mode.  Tolerance: max|d| <= 2e-2 * max|grad| per output, the JAX
suite's own kernel bound (the formulations round to bf16 at different
points); the bias cotangent is compared by its sum over window groups, the
only part of it that is defined.  A second, tight oracle is torch autograd of
the plain forward in fp32.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facialmmt_tpu.ops.pallas import block_mlp as jax_mlp
from facialmmt_tpu.ops.pallas import fused_block as jax_block
from facialmmt_tpu_torch.ops.kernels import block_mlp, fused_block

BOUND = 2e-2
ATTN_NAMES = "x gamma beta wqkv bqkv wproj bproj bias".split()
MLP_NAMES = "x gamma beta w1 b1 w2 b2".split()


def _bf16_values(a):
    """numpy fp32 array holding bf16-representable values."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _attn_inputs(seed, w=8, n=49, c=96, h=3, nw=4, keep=False):
    """The shapes of the JAX suite's _attn_block_args, weights in JAX layout
    (wqkv (C, 3C), wproj (C, C) as in @ out)."""
    rng = np.random.default_rng(seed)
    return dict(
        x=_bf16_values(rng.normal(size=(w, n, c))),
        gamma=(rng.normal(size=c) * 0.1 + 1).astype(np.float32),
        beta=(rng.normal(size=c) * 0.1).astype(np.float32),
        wqkv=(rng.normal(size=(c, 3 * c)) * 0.05).astype(np.float32),
        bqkv=(rng.normal(size=3 * c) * 0.05).astype(np.float32),
        wproj=(rng.normal(size=(c, c)) * 0.05).astype(np.float32),
        bproj=(rng.normal(size=c) * 0.05).astype(np.float32),
        bias=(rng.normal(size=(nw, h, n, n)) * 0.5).astype(np.float32),
        dy=_bf16_values(rng.normal(size=(w, n, c))),
        keep=(rng.choice([0.0, 1.43], size=w).astype(np.float32)
              if keep else None))


@functools.lru_cache(maxsize=None)
def _attn_oracles(variant: str, keep: bool):
    """(inputs, vjp of _reference, Pallas backward in interpret mode), each a
    list of numpy arrays in ATTN_NAMES order."""
    a = _attn_inputs(3, keep=keep)
    x = jnp.asarray(a["x"], jnp.bfloat16)
    dy = jnp.asarray(a["dy"], jnp.bfloat16)
    args = tuple(jnp.asarray(a[k]) for k in ATTN_NAMES[1:])
    k = None if a["keep"] is None else jnp.asarray(a["keep"])
    _, vjp = jax.vjp(lambda *p: jax_block._reference(*p, k, 1e-5), x, *args)
    ref = vjp(dy)
    if variant == "resident":
        _, vjp = jax.vjp(lambda *p: jax_block.fused_attention_block(
            *p, k, 16, 1e-5, True), x, *args)
        pal = vjp(dy)
    else:
        gamma, beta, wqkv, bqkv, wproj, _, bias = args
        pal = jax_block._bwd_impl_spill(x, gamma, beta, wqkv, bqkv, wproj, bias,
                                        k, dy, pairs=2, eps=1e-5,
                                        interpret=True)[:8]
    as_np = lambda grads: [np.asarray(g, np.float32) for g in grads]
    return a, as_np(ref), as_np(pal)


def _port_attn_bwd(a, variant: str, dtype):
    """The port's plain backward on the same inputs; returns numpy arrays in
    ATTN_NAMES order, weights back in the JAX layout."""
    t = lambda v, dt=torch.float32: torch.tensor(v).to(dt)
    fn = (fused_block.fused_attention_block_bwd_plain if variant == "resident"
          else fused_block.fused_attention_block_bwd_spill_plain)
    out = fn(t(a["x"], dtype), t(a["dy"], dtype), t(a["gamma"]), t(a["beta"]),
             t(a["wqkv"].T.copy()), t(a["bqkv"]), t(a["wproj"].T.copy()),
             t(a["bias"]), None if a["keep"] is None else t(a["keep"]))
    dx, dgamma, dbeta, dwqkv, dbqkv, dwproj, dbproj, dbias = (
        o.float().numpy() for o in out)
    return [dx, dgamma, dbeta, dwqkv.T, dbqkv, dwproj.T, dbproj, dbias]


def _hold(names, got, want, what):
    for name, g, w in zip(names, got, want):
        if name == "bias":
            g, w = g.sum(0), w.sum(0)
        assert g.shape == w.shape, (what, name)
        denom = np.abs(w).max() or 1.0
        assert np.abs(g - w).max() / denom < BOUND, (what, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("keep", [False, True], ids=["nokeep", "keep"])
@pytest.mark.parametrize("variant", ["resident", "spill"])
def test_attention_block_bwd_plain_matches_jax(variant, keep, dtype):
    a, ref, pallas = _attn_oracles(variant, keep)
    got = _port_attn_bwd(a, variant, dtype)
    _hold(ATTN_NAMES, got, ref, "vjp of _reference")
    _hold(ATTN_NAMES, got, pallas, "Pallas backward, interpret mode")
    assert not got[-1][1:].any()        # the bias cotangent sits in group 0


def _mlp_inputs(seed, t, c=96, keep=False):
    rng = np.random.default_rng(seed)
    return dict(
        x=_bf16_values(rng.normal(size=(t, c))),
        gamma=(rng.normal(size=c) * 0.1 + 1).astype(np.float32),
        beta=(rng.normal(size=c) * 0.1).astype(np.float32),
        w1=(rng.normal(size=(c, 4 * c)) * 0.05).astype(np.float32),
        b1=(rng.normal(size=4 * c) * 0.05).astype(np.float32),
        w2=(rng.normal(size=(4 * c, c)) * 0.05).astype(np.float32),
        b2=(rng.normal(size=c) * 0.05).astype(np.float32),
        dy=_bf16_values(rng.normal(size=(t, c))),
        keep=(rng.choice([0.0, 1.43], size=t).astype(np.float32)
              if keep else None))


@functools.lru_cache(maxsize=None)
def _mlp_oracles(t: int, keep: bool):
    a = _mlp_inputs(5, t, keep=keep)
    x = jnp.asarray(a["x"], jnp.bfloat16)
    dy = jnp.asarray(a["dy"], jnp.bfloat16)
    args = tuple(jnp.asarray(a[k]) for k in MLP_NAMES[1:])
    k = None if a["keep"] is None else jnp.asarray(a["keep"])
    _, vjp_ref = jax.vjp(lambda *p: jax_mlp._reference(*p, k, 1e-5), x, *args)
    _, vjp_pal = jax.vjp(lambda *p: jax_mlp.fused_ln_mlp_residual(
        *p, k, 1e-5, True), x, *args)
    as_np = lambda grads: [np.asarray(g, np.float32) for g in grads]
    return a, as_np(vjp_ref(dy)), as_np(vjp_pal(dy))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("keep", [False, True], ids=["nokeep", "keep"])
@pytest.mark.parametrize("t", [256, 300])
def test_ln_mlp_residual_bwd_plain_matches_jax(t, keep, dtype):
    a, ref, pallas = _mlp_oracles(t, keep)
    tt = lambda v, dt=torch.float32: torch.tensor(v).to(dt)
    out = block_mlp.fused_ln_mlp_residual_bwd_plain(
        tt(a["x"], dtype), tt(a["dy"], dtype), tt(a["gamma"]), tt(a["beta"]),
        tt(a["w1"].T.copy()), tt(a["b1"]), tt(a["w2"].T.copy()),
        None if a["keep"] is None else tt(a["keep"]))
    dx, dgamma, dbeta, dw1, db1, dw2, db2 = (o.float().numpy() for o in out)
    got = [dx, dgamma, dbeta, dw1.T, db1, dw2.T, db2]
    _hold(MLP_NAMES, got, ref, "vjp of _reference")
    _hold(MLP_NAMES, got, pallas, "Pallas backward, interpret mode")


def test_bias_gradient_reaches_the_table():
    """Through the consumer's shape, full = table_bias[None] + mask[:, None]
    (the SwinBlock wiring): the group-0 bias cotangent of the port's autograd
    Function gives the table gradient that JAX autodiff of the reference
    gives, because the broadcast's vjp sums over the window groups."""
    a = _attn_inputs(7)
    rng = np.random.default_rng(8)
    h, n, nw = 3, 49, 4
    bias_hnn = (rng.normal(size=(h, n, n)) * 0.5).astype(np.float32)
    mask = np.where(rng.random((nw, n, n)) > 0.7, -100.0, 0.0).astype(np.float32)

    def through(b, f):
        full = b[None] + jnp.asarray(mask)[:, None]
        return jnp.sum(f(jnp.asarray(a["x"], jnp.bfloat16),
                         *[jnp.asarray(a[k]) for k in ATTN_NAMES[1:-1]], full)
                       .astype(jnp.float32) ** 2)

    want = np.asarray(jax.grad(through)(
        jnp.asarray(bias_hnn),
        lambda *p: jax_block._reference(*p, None, 1e-5)))

    table = torch.tensor(bias_hnn, requires_grad=True)
    t = torch.tensor
    out = fused_block.fused_attention_block(
        t(a["x"]), t(a["gamma"]), t(a["beta"]), t(a["wqkv"].T.copy()),
        t(a["bqkv"]), t(a["wproj"].T.copy()), t(a["bproj"]),
        table[None] + t(mask)[:, None])
    out.float().square().sum().backward()
    got = table.grad.numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < BOUND


def _autograd_oracle(plain_forward, inputs, dy, keep):
    leaves = [torch.tensor(v, dtype=torch.float64).requires_grad_()
              for v in inputs]
    out = plain_forward(*leaves, keep)
    return torch.autograd.grad(out, leaves, torch.tensor(dy,
                                                         dtype=torch.float64))


@pytest.mark.parametrize("variant", ["resident", "spill"])
def test_attention_block_bwd_plain_matches_torch_autograd(variant):
    """Same arithmetic with no bf16 anywhere (fp64 inputs; the plain versions
    take their LN statistics and sums in fp32, as the kernels do): the
    step-by-step backward agrees with autograd of the plain forward to 1e-5
    of max|grad| per output, the bias by its group sum."""
    a = _attn_inputs(11, w=4, n=16, c=32, h=2, nw=2, keep=True)
    order = ("x", "gamma", "beta", "wqkv", "bqkv", "wproj", "bproj", "bias")
    vals = dict(a, wqkv=a["wqkv"].T.copy(), wproj=a["wproj"].T.copy())
    keep = torch.tensor(a["keep"], dtype=torch.float64)
    want = _autograd_oracle(fused_block.fused_attention_block_plain,
                            [vals[k] for k in order], a["dy"], keep)
    f64 = lambda k: torch.tensor(vals[k], dtype=torch.float64)
    fn = (fused_block.fused_attention_block_bwd_plain if variant == "resident"
          else fused_block.fused_attention_block_bwd_spill_plain)
    got = fn(f64("x"), f64("dy"), f64("gamma"), f64("beta"), f64("wqkv"),
             f64("bqkv"), f64("wproj"), f64("bias"), keep)
    for name, g, w in zip(order, got, want):
        g, w = g.double(), w.double()
        if name == "bias":
            g, w = g.sum(0), w.sum(0)
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max()), name


def test_ln_mlp_residual_bwd_plain_matches_torch_autograd():
    a = _mlp_inputs(13, 70, c=32, keep=True)
    vals = dict(a, w1=a["w1"].T.copy(), w2=a["w2"].T.copy())
    keep = torch.tensor(a["keep"], dtype=torch.float64)
    want = _autograd_oracle(block_mlp.fused_ln_mlp_residual_plain,
                            [vals[k] for k in MLP_NAMES], a["dy"], keep)
    f64 = lambda k: torch.tensor(vals[k], dtype=torch.float64)
    got = block_mlp.fused_ln_mlp_residual_bwd_plain(
        f64("x"), f64("dy"), f64("gamma"), f64("beta"), f64("w1"), f64("b1"),
        f64("w2"), keep)
    for name, g, w in zip(MLP_NAMES, got, want):
        assert float((g.double() - w).abs().max()) <= \
            1e-5 * float(w.abs().max()), name


@pytest.mark.parametrize("half", ["attention", "mlp"])
def test_autograd_functions_return_parameter_dtypes(half):
    """The Functions the model calls: on the CPU their backward is the plain
    version; every gradient comes back in its input's dtype and `keep` gets
    none."""
    if half == "attention":
        a = _attn_inputs(17, w=4, n=16, c=32, h=2, nw=2, keep=True)
        vals = dict(a, wqkv=a["wqkv"].T.copy(), wproj=a["wproj"].T.copy())
        leaves = [torch.tensor(vals[k]).requires_grad_() for k in ATTN_NAMES]
        fn = fused_block.fused_attention_block
    else:
        a = _mlp_inputs(19, 40, c=32, keep=True)
        vals = dict(a, w1=a["w1"].T.copy(), w2=a["w2"].T.copy())
        leaves = [torch.tensor(vals[k]).requires_grad_() for k in MLP_NAMES]
        fn = block_mlp.fused_ln_mlp_residual
    keep = torch.tensor(a["keep"]).requires_grad_()
    fn(*leaves, keep).square().sum().backward()
    assert keep.grad is None
    for leaf in leaves:
        assert leaf.grad is not None and leaf.grad.dtype == leaf.dtype
        assert leaf.grad.shape == leaf.shape
        assert torch.isfinite(leaf.grad).all()


def test_backward_dispatch_is_by_width():
    assert [fused_block.backward_variant(c) for c in (96, 192, 384, 768)] == \
        ["resident", "resident", "resident", "spill"]


def test_kernel_wrappers_raise_on_cpu_tensors():
    """A CUDA wrapper never gives way to the plain version."""
    a = _mlp_inputs(23, 32, c=32)
    t = torch.tensor
    with pytest.raises(ValueError, match="CUDA"):
        block_mlp.fused_ln_mlp_residual_bwd_cuda(
            t(a["x"]), t(a["dy"]), t(a["gamma"]), t(a["beta"]),
            t(a["w1"].T.copy()), t(a["b1"]), t(a["w2"].T.copy()))
    b = _attn_inputs(29, w=2, n=16, c=32, h=2, nw=1)
    args = (t(b["x"]), t(b["dy"]), t(b["gamma"]), t(b["beta"]),
            t(b["wqkv"].T.copy()), t(b["bqkv"]), t(b["wproj"].T.copy()),
            t(b["bias"]))
    for fn in (fused_block.fused_attention_block_bwd_cuda,
               fused_block.fused_attention_block_bwd_spill_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            fn(*args)
