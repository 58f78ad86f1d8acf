"""Kernel 1's gradients: ops/kernels/attention.py::FusedAttention.

The text tower sends train-mode attention to kernel 1 when its attention
dropout is 0, so the kernel's output has to carry the gradient of q, k and v.
FusedAttention's backward is torch autograd of the plain version recomputed
from the saved inputs, as JAX's custom_vjp is the vjp of
_reference_attention (facialmmt_tpu/ops/pallas/attention.py).  Here, on the
CPU, the Function's gradients are held against autograd of the plain version
and against jax.vjp of _reference_attention at atol 1e-5, rtol 1e-4 (fp32;
the summation order differs).  tests/test_torch_gpu.py holds a text layer's
gradients through the kernel on the card against the plain path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facialmmt_tpu.ops.pallas import attention as jattn
from facialmmt_tpu_torch.ops.kernels import attention

T = torch.from_numpy


def _inputs(rng, b, h, sq, sk, d):
    q = (rng.normal(size=(b, h, sq, d)) * d ** -0.5).astype(np.float32)
    k = rng.normal(size=(b, h, sk, d)).astype(np.float32)
    v = rng.normal(size=(b, h, sk, d)).astype(np.float32)
    bias = np.where(rng.random((b, sk)) > 0.3, 0.0, -1e30).astype(np.float32)
    bias[-1] = -1e30   # a fully padded row: every key masked
    dout = rng.normal(size=(b, h, sq, d)).astype(np.float32)
    return q, k, v, bias, dout


def _grads(fn, q, k, v, bias, dout):
    leaves = [T(a).requires_grad_() for a in (q, k, v)]
    out = fn(*leaves, T(bias))
    return out, torch.autograd.grad(out, leaves, T(dout))


def test_fused_attention_is_an_autograd_function(rng):
    """The dispatch goes through FusedAttention on every device: its output
    carries the Function's backward node, not the plain version's graph."""
    assert issubclass(attention.FusedAttention, torch.autograd.Function)
    q, k, v, bias, _ = _inputs(rng, 2, 2, 8, 8, 16)
    out = attention.fused_attention(T(q).requires_grad_(), T(k), T(v),
                                    T(bias))
    assert type(out.grad_fn).__name__ == "FusedAttentionBackward"


@pytest.mark.parametrize("sq,sk", [(24, 24), (16, 40)], ids=["self", "cross"])
def test_fused_attention_backward_matches_plain_and_jax(rng, monkeypatch, sq,
                                                        sk):
    """fused_attention_cuda replaced by the plain version (the kernel needs
    the card): q, k, v gradients through the Function equal autograd of the
    plain version and JAX's vjp of _reference_attention."""
    monkeypatch.setattr(attention, "fused_attention_cuda",
                        attention.fused_attention_plain)
    q, k, v, bias, dout = _inputs(rng, 3, 2, sq, sk, 16)
    out, got = _grads(attention.fused_attention, q, k, v, bias, dout)
    want_out, want = _grads(attention.fused_attention_plain, q, k, v, bias,
                            dout)
    torch.testing.assert_close(out, want_out, atol=1e-5, rtol=1e-4)
    _, vjp = jax.vjp(lambda a, b_, c: jattn._reference_attention(
        a, b_, c, jnp.asarray(bias)), q, k, v)
    jax_grads = vjp(dout)
    for g, w, j in zip(got, want, jax_grads):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5, rtol=1e-4)
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=1e-5,
                                   rtol=1e-4)


def test_fully_padded_row_has_finite_gradients(rng):
    """A batch row whose keys are all -1e30 gets the uniform softmax; its
    gradients are finite, equal JAX's, and v's spreads dout evenly over the
    keys."""
    q, k, v, bias, dout = _inputs(rng, 2, 2, 8, 12, 16)
    _, (dq, dk, dv) = _grads(attention.fused_attention, q, k, v, bias, dout)
    for g in (dq, dk, dv):
        assert torch.isfinite(g).all()
    _, vjp = jax.vjp(lambda a, b_, c: jattn._reference_attention(
        a, b_, c, jnp.asarray(bias)), q, k, v)
    for g, j in zip((dq, dk, dv), vjp(dout)):
        np.testing.assert_allclose(g[-1].numpy(), np.asarray(j)[-1],
                                   atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(
        dv[-1].numpy(), np.broadcast_to(dout[-1].sum(1, keepdims=True) / 12,
                                        dv[-1].shape), atol=1e-5, rtol=1e-4)
