"""The port's window-attention and merge-tail modules against the JAX Pallas
kernels (CPU).

On the CPU each port function runs its plain PyTorch version; it is held
  * against the JAX kernel run in interpret mode and against the JAX
    `_reference` on the bf16-rounded bias at rtol = atol = 2e-3, the JAX
    suite's own bound for these kernels (test_pallas.py: the kernels store the
    bias in bf16), and 4e-3 for the merge tail (bf16 matmul operands,
    test_pallas.py::test_fused_merge_matches_reference);
  * in its gradients against jax.grad of the JAX `_reference`.
tests/test_torch_gpu.py compares each CUDA kernel with its plain version on
the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facialmmt_tpu.ops.pallas import merge_kernel as jmerge
from facialmmt_tpu.ops.pallas import window_attention as jwa
from facialmmt_tpu_torch.ops.kernels import merge_kernel, window_attention

T = torch.from_numpy
TOL = dict(rtol=2e-3, atol=2e-3)

# name -> (port function, JAX kernel in interpret mode with a tiling that
# divides the test shapes)
VARIANTS = {
    "fused": (window_attention.fused_window_attention,
              lambda q, k, v, b: jwa.fused_window_attention(q, k, v, b, 2,
                                                            True)),
    "paired": (window_attention.paired_window_attention,
               lambda q, k, v, b: jwa.paired_window_attention(q, k, v, b, 2,
                                                              True)),
    "v2": (window_attention.fused_window_attention_v2,
           lambda q, k, v, b: jax.jit(
               lambda *a: jwa.fused_window_attention_v2(*a, 4, True))(
                   q, k, v, b)),
}


def _qkvb(rng, w, h, n, hd, nw):
    q = (rng.normal(size=(w, h, n, hd)) * 0.2).astype(np.float32)
    k = rng.normal(size=(w, h, n, hd)).astype(np.float32)
    v = rng.normal(size=(w, h, n, hd)).astype(np.float32)
    bias = rng.normal(size=(nw, h, n, n)).astype(np.float32)
    return q, k, v, bias


def _bf16_round(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("nw", [4, 1], ids=["nW4", "nW1"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_window_attention_matches_jax(rng, variant, nw):
    port, jax_kernel = VARIANTS[variant]
    q, k, v, bias = _qkvb(rng, 8, 3, 49, 32, nw)
    got = port(T(q), T(k), T(v), T(bias)).numpy()
    interp = np.asarray(jax_kernel(q, k, v, bias))
    np.testing.assert_allclose(got, interp, **TOL)
    want = np.asarray(jwa._reference(q, k, v, jnp.asarray(_bf16_round(bias))))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
    # the plain version is that of all three: the bias is rounded through bf16
    plain = window_attention.window_attention_plain(T(q), T(k), T(v), T(bias))
    np.testing.assert_array_equal(got, plain.numpy())
    exact = np.asarray(jwa._reference(q, k, v, jnp.asarray(bias)))
    assert np.abs(got - exact).max() > 1e-5


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_window_attention_bias_indexing(rng, variant):
    """Window w reads bias row w % nW; a pair (2c, 2c+1) and a group of 4 read
    the rows of their own windows."""
    port, _ = VARIANTS[variant]
    w, h, n, hd, nw = 8, 1, 49, 32, 4
    q, k, v, _ = _qkvb(rng, w, h, n, hd, nw)
    bias = np.zeros((nw, h, n, n), np.float32)
    bias[3, :, :, 1:] = -1e9          # windows 3 and 7 attend only to key 0
    got = port(T(q), T(k), T(v), T(bias)).numpy()
    np.testing.assert_allclose(got[3, 0, 5], v[3, 0, 0], rtol=1e-4)
    np.testing.assert_allclose(got[7, 0, 9], v[7, 0, 0], rtol=1e-4)
    # the other windows see the zero rows: a plain softmax over all keys
    want = np.asarray(jwa._reference(q, k, v, jnp.asarray(bias)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_window_attention_grads_match_jax(rng, variant):
    """The Function's backward differentiates the exact formulation on the
    unrounded bias, as jax.vjp of `_reference` does in the JAX package."""
    port, _ = VARIANTS[variant]
    arrays = _qkvb(rng, 4, 2, 49, 32, 2)
    cot = rng.normal(size=arrays[0].shape).astype(np.float32)
    want = jax.grad(lambda *a: (jwa._reference(*a) * cot).sum(),
                    argnums=(0, 1, 2, 3))(*map(jnp.asarray, arrays))
    leaves = [T(a).requires_grad_() for a in arrays]
    (port(*leaves) * T(cot)).sum().backward()
    for name, leaf, w in zip("qkvb", leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   err_msg=name, **TOL)
    # only the inputs that ask for a gradient get one
    q, k, v, b = (T(a) for a in arrays)
    v.requires_grad_()
    port(q, k, v, b).sum().backward()
    assert v.grad is not None and q.grad is None and b.grad is None


def test_paired_window_attention_raises_on_odd_counts(rng):
    paired = window_attention.paired_window_attention
    q, k, v, bias = (T(a) for a in _qkvb(rng, 3, 1, 16, 16, 1))
    with pytest.raises(ValueError, match="even W"):
        paired(q, k, v, bias)
    q, k, v, bias = (T(a) for a in _qkvb(rng, 6, 1, 16, 16, 3))
    with pytest.raises(ValueError, match="even W"):
        paired(q, k, v, bias)
    assert paired(*(T(a) for a in _qkvb(rng, 6, 1, 16, 16, 1))).shape == \
        (6, 1, 16, 16)


@pytest.mark.parametrize("w,nw,group,want", [(8, 4, 4, 4), (6, 1, 4, 3),
                                             (6, 2, 4, 2), (9, 9, 4, 3),
                                             (7, 1, 4, 1), (8, 4, 9, 4)])
def test_v2_group_follows_the_jax_rule(w, nw, group, want):
    """`group` shrinks until it divides W and, when nW > 1, nW (JAX:
    window_attention.py:297-299); a block holds at most 4 windows."""
    assert window_attention._group_size(w, nw, group) == want


def test_wrappers_refuse_cpu_tensors(rng):
    """A CUDA wrapper never quietly runs its plain version."""
    q, k, v, bias = (T(a) for a in _qkvb(rng, 2, 1, 16, 16, 1))
    for fn in (window_attention.fused_window_attention_cuda,
               window_attention.paired_window_attention_cuda,
               window_attention.fused_window_attention_v2_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            fn(q, k, v, bias)
        assert fn.launches == 0
    with pytest.raises(ValueError, match="CUDA"):
        merge_kernel.fused_merge_cuda(torch.zeros(1, 4, 32), torch.ones(32),
                                      torch.zeros(32), torch.zeros(32, 16))
    assert merge_kernel.fused_merge_cuda.launches == 0


@pytest.mark.parametrize("b,l,c4,c2", [(2, 49, 384, 192), (1, 196, 768, 384)])
def test_fused_merge_matches_jax(rng, b, l, c4, c2):
    x = rng.normal(size=(b, l, c4)).astype(np.float32)
    g = rng.normal(size=(c4,)).astype(np.float32)
    be = rng.normal(size=(c4,)).astype(np.float32)
    w = (rng.normal(size=(c4, c2)) * 0.05).astype(np.float32)
    got = merge_kernel.fused_merge(T(x), T(g), T(be), T(w)).numpy()
    interp = np.asarray(jmerge.fused_merge(x, g, be, w, 1e-5, True))
    np.testing.assert_allclose(got, interp, rtol=4e-3, atol=4e-3)
    want = np.asarray(jmerge._reference(x, g, be, w))
    np.testing.assert_allclose(got, want, rtol=4e-3, atol=4e-3)
    # gradients: both sides differentiate the bf16-operand formulation, whose
    # cotangents pass through a bf16 rounding (one bf16 ulp is 2^-8 relative)
    cot = rng.normal(size=got.shape).astype(np.float32)
    grads = jax.grad(lambda *a: (jmerge._reference(*a) * cot).sum(),
                     argnums=(0, 1, 2, 3))(*map(jnp.asarray, (x, g, be, w)))
    leaves = [T(a).requires_grad_() for a in (x, g, be, w)]
    (merge_kernel.fused_merge(*leaves) * T(cot)).sum().backward()
    for name, leaf, want_grad in zip(("x", "gamma", "beta", "w"), leaves,
                                     grads):
        want_grad = np.asarray(want_grad)
        np.testing.assert_allclose(
            leaf.grad.numpy(), want_grad, err_msg=name, rtol=4e-3,
            atol=4e-3 * float(np.abs(want_grad).max()))
