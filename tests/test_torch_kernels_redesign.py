"""The algorithms of kernel 1 (csrc/attention.cu) and kernel 11
(csrc/merge_kernel.cu) written out in PyTorch, against the plain versions and
the JAX package.

A CUDA kernel cannot run here, so what it computes is mirrored step by step:
  * kernel 1: keys in tiles of 64, scores in the log2 domain, the running max
    from -inf, P rounded to bf16 before P v, the last partial tile masked;
    without the rounding it equals the fp32 plain version and JAX's
    _reference_attention at atol 1e-5, rtol 1e-4 (summation order only); with
    it, in bf16, the plain version within the kernels' 2e-2 bound; its fp32
    instantiation (q, k, v, P and v rounded to TF32 as mma.sync's operands)
    within TF32_BOUND of the fp32 plain version and JAX's fp32 reference;
  * kernel 11: the tile plan (which block computes which output tile, how
    many blocks, how much shared memory) and the chunked LayerNorm + product,
    against fused_merge_plain and JAX's _reference at 4e-3 (the JAX suite's
    merge bound: bf16 matmul operands).
tests/test_torch_gpu.py holds the kernels themselves against the plain
versions on the card.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facialmmt_tpu.ops.pallas import attention as jattn
from facialmmt_tpu.ops.pallas import merge_kernel as jmerge
from facialmmt_tpu_torch.ops.kernels import attention, merge_kernel

T = torch.from_numpy
KERNEL_BOUND = 2e-2
LOG2E = 1.4426950408889634

# csrc/attention.cu
KEY_TILE = 64

# csrc/merge_kernel.cu
MERGE_BM = 64         # rows per block
MERGE_BN = 192        # output columns per block
MERGE_BK = 64         # input columns per stage
MERGE_STAGES = 3
SMS = 132             # H100 SXM
SMEM_OPTIN = 232448   # bytes a Hopper block can use
# Swin-tiny's three stage transitions at 64 faces: (T, K = 4C, M = 2C)
TRANSITIONS = [(64 * 28 * 28, 384, 192), (64 * 14 * 14, 768, 384),
               (64 * 7 * 7, 1536, 768)]


# the fp32 instantiation: operands keep TF32's 10 mantissa bits (relative
# rounding 2^-11), accumulated in fp32 over 16-64 terms of mixed sign
TF32_BOUND = 2e-3


def tf32(x):
    """x rounded to TF32 as cvt.rna.tf32.f32 does: to the nearest value with
    a 10-bit mantissa, ties away from zero (the low 13 bits cleared)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def live_tiles(bias):
    """Per batch row, the key tiles the kernel computes: up to the tile of
    the last real key (bias > -1e29); all of them for a fully padded row."""
    real = bias > -1e29
    last = torch.where(real, torch.arange(bias.shape[1]), -1).amax(-1)
    return [math.ceil(bias.shape[1] / KEY_TILE) if j < 0
            else int(j) // KEY_TILE + 1 for j in last]


def tiled_attention(q, k, v, bias, round_p=True, skip=True,
                    operands_tf32=False):
    """csrc/attention.cu's per-row algorithm in fp32: for each tile of 64 keys
    (the last one zero-filled past Sk and masked to -inf) x = (q.k + bias)
    log2(e), m' = max(m, max x) with m = -inf at the start, alpha = 2^(m -
    m'), p = 2^(x - m'), l = l alpha + sum p, O = O alpha + bf16(p) v; the
    output is O / l.  With `skip`, a batch row stops after live_tiles.  With
    `operands_tf32` (the fp32 instantiation) q, k, v and p are rounded to
    TF32 where they enter the products instead."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    q, k, v, bias = q.float(), k.float(), v.float(), bias.float()
    if operands_tf32:
        q, k, v = tf32(q), tf32(k), tf32(v)
    m = torch.full((b, h, sq, 1), -math.inf)
    l = torch.zeros((b, h, sq, 1))
    o = torch.zeros((b, h, sq, d))
    live = torch.tensor(live_tiles(bias))
    for tile, k0 in enumerate(range(0, sk, KEY_TILE)):
        # rows past their live tiles keep m, l and O as they are
        on = (tile < live if skip else torch.ones(b, dtype=torch.bool))
        on = on[:, None, None, None]
        nk = min(KEY_TILE, sk - k0)
        pad = KEY_TILE - nk
        kt = torch.nn.functional.pad(k[:, :, k0:k0 + nk], (0, 0, 0, pad))
        vt = torch.nn.functional.pad(v[:, :, k0:k0 + nk], (0, 0, 0, pad))
        bt = torch.nn.functional.pad(bias[:, k0:k0 + nk], (0, pad))
        x = (torch.einsum("bhqd,bhkd->bhqk", q, kt) * LOG2E
             + (bt * LOG2E)[:, None, None, :])
        x[..., nk:] = -math.inf
        mn = torch.maximum(m, x.amax(-1, keepdim=True))
        alpha = torch.exp2(m - mn)
        p = torch.exp2(x - mn)
        l = torch.where(on, l * alpha + p.sum(-1, keepdim=True), l)
        if operands_tf32:
            p = tf32(p)
        elif round_p:
            p = p.to(torch.bfloat16).float()
        o = torch.where(on, o * alpha + p @ vt, o)
        m = torch.where(on, mn, m)
    return o / l


def _attention_inputs(rng, b, h, sq, sk, d):
    """q pre-scaled; a random (non-contiguous) -1e30 key mask; the last batch
    row fully padded."""
    q = (rng.normal(size=(b, h, sq, d)) * d ** -0.5).astype(np.float32)
    k = rng.normal(size=(b, h, sk, d)).astype(np.float32)
    v = rng.normal(size=(b, h, sk, d)).astype(np.float32)
    bias = np.where(rng.random((b, sk)) > 0.3, 0.0, -1e30).astype(np.float32)
    bias[-1] = -1e30
    return q, k, v, bias


@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("sk", [157, 130, 38])
def test_tiled_attention_matches_plain_and_jax(rng, sk, d):
    """Sk of the audio tower (157), one not a multiple of the tile (130) and
    one under a tile (38), queries of another length (40)."""
    q, k, v, bias = _attention_inputs(rng, 3, 2, 40, sk, d)
    exact = tiled_attention(T(q), T(k), T(v), T(bias), round_p=False).numpy()
    plain = attention.fused_attention_plain(T(q), T(k), T(v), T(bias))
    np.testing.assert_allclose(exact, plain.numpy(), atol=1e-5, rtol=1e-4)
    want = np.asarray(jattn._reference_attention(q, k, v, jnp.asarray(bias)))
    np.testing.assert_allclose(exact, want, atol=1e-5, rtol=1e-4)
    # the fully padded row: the uniform softmax, the mean of v, never NaN
    np.testing.assert_allclose(exact[-1], np.broadcast_to(
        v[-1].mean(axis=1, keepdims=True), exact[-1].shape), atol=1e-5,
        rtol=1e-4)

    # in bf16, with P rounded where the kernel rounds it
    qb, kb, vb = (T(a).to(torch.bfloat16) for a in (q, k, v))
    rounded = tiled_attention(qb, kb, vb, T(bias)).numpy()
    assert np.isfinite(rounded).all()
    plain_bf16 = attention.fused_attention_plain(qb, kb, vb, T(bias)).float()
    assert _rel(rounded, plain_bf16.numpy()) <= KERNEL_BOUND
    jax_bf16 = jattn._reference_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), jnp.asarray(bias))
    assert _rel(rounded, np.asarray(jax_bf16, np.float32)) <= KERNEL_BOUND


def test_tf32_rounds_as_cvt_rna():
    """Ten mantissa bits kept, to nearest, ties away from zero, the sign
    apart; values TF32 holds stay as they are."""
    ulp = 2.0 ** -10
    x = torch.tensor([1.0, 1 + ulp, 1 + ulp / 2, 1 + ulp / 2 - 2 ** -20,
                      -(1 + ulp / 2), 3.0, 0.0, -2.5])
    want = torch.tensor([1.0, 1 + ulp, 1 + ulp, 1.0, -(1 + ulp), 3.0, 0.0,
                         -2.5])
    assert torch.equal(tf32(x), want)


@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("sk", [512, 157])
def test_tf32_instantiation_matches_plain_and_jax(rng, sk, d):
    """The fp32 instantiation (--compute_dtype float32): q, k, v, P and v
    rounded to TF32 where they enter the products, the softmax in fp32; the
    fp32 plain version and JAX's fp32 reference within TF32_BOUND, about a
    tenth of the bf16 kernel's error; the fully padded row the mean of v."""
    q, k, v, bias = _attention_inputs(rng, 3, 2, 40, sk, d)
    got = tiled_attention(T(q), T(k), T(v), T(bias),
                          operands_tf32=True).numpy()
    plain = attention.fused_attention_plain(T(q), T(k), T(v), T(bias))
    assert plain.dtype == torch.float32
    assert _rel(got, plain.numpy()) <= TF32_BOUND
    want = np.asarray(jattn._reference_attention(q, k, v, jnp.asarray(bias)))
    assert _rel(got, want) <= TF32_BOUND
    bf16 = tiled_attention(*(T(a).to(torch.bfloat16) for a in (q, k, v)),
                           T(bias)).numpy()
    assert _rel(got, want) < _rel(bf16, want)
    np.testing.assert_allclose(got[-1], np.broadcast_to(
        v[-1].mean(axis=1, keepdims=True), got[-1].shape), atol=2e-3,
        rtol=2e-3)


@pytest.mark.parametrize("round_p", [False, True])
def test_skipped_tail_tiles_change_no_bit(rng, round_p):
    """Trailing tiles of padding only (one row with a real key in its first
    tile only, one with a real key in its second): skipping them gives the
    same bits as computing them, p = 0 and alpha = 1 exactly; the fully
    padded row computes every tile."""
    q, k, v, bias = _attention_inputs(rng, 3, 2, 24, 200, 32)
    bias[0, 10:] = -1e30
    bias[1, 100:] = -1e30
    assert live_tiles(T(bias)) == [1, 2, 4]
    args = (T(q), T(k), T(v), T(bias))
    assert torch.equal(tiled_attention(*args, round_p=round_p),
                       tiled_attention(*args, round_p=round_p, skip=False))


def test_tiled_attention_resets_after_a_padded_tile(rng):
    """A row whose first key tile is all padding: that tile's keys first
    hold the running max (-1e30 log2 e, with p = 1 each), and the first real
    tile's alpha = 2^(-1.4e30 - m') = 0 drops them; the keys of a tile past
    the real ones get p = 0."""
    q, k, v, bias = _attention_inputs(rng, 2, 2, 16, 157, 32)
    bias[0] = 0.0
    bias[0, :KEY_TILE] = -1e30
    bias[0, 2 * KEY_TILE:] = -1e30
    got = tiled_attention(T(q), T(k), T(v), T(bias), round_p=False).numpy()
    want = np.asarray(jattn._reference_attention(q, k, v, jnp.asarray(bias)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
    real = slice(KEY_TILE, 2 * KEY_TILE)
    np.testing.assert_allclose(got[0], attention.fused_attention_plain(
        T(q[:1, :, :, :]), T(k[:1, :, real]), T(v[:1, :, real]),
        T(np.zeros((1, KEY_TILE), np.float32)))[0].numpy(), atol=1e-5,
        rtol=1e-4)


def merge_plan(t, m):
    """csrc/merge_kernel.cu's launch: one block per 64-row x 192-column
    output tile.  Returns the grid."""
    return math.ceil(t / MERGE_BM), math.ceil(m / MERGE_BN)


def merge_smem_bytes(k):
    """Shared memory of one block: gamma and beta (bf16), the rows' scale
    and shift (fp32), and the ring of stages, each an x chunk (64 x 64, rows
    padded to 72) and a w chunk (64 x 192, rows padded to 200); the output
    tile is staged over the first stage."""
    a128 = lambda n: (n + 127) // 128 * 128
    stage = MERGE_BM * (MERGE_BK + 8) * 2 + MERGE_BK * (MERGE_BN + 8) * 2
    assert MERGE_BM * (MERGE_BN + 8) * 2 <= stage
    return a128(2 * k * 2) + a128(2 * MERGE_BM * 4) + MERGE_STAGES * stage


@pytest.mark.parametrize("t,k,m", TRANSITIONS + [(1, 384, 192),
                                                 (1000, 768, 384),
                                                 (130, 48, 208)])
def test_merge_tile_plan_covers_every_output_once(t, k, m):
    gx, gy = merge_plan(t, m)
    seen = np.zeros((t, m), np.int32)
    for bx in range(gx):
        for by in range(gy):
            seen[bx * MERGE_BM:(bx + 1) * MERGE_BM,
                 by * MERGE_BN:(by + 1) * MERGE_BN] += 1
    assert (seen == 1).all()
    assert merge_smem_bytes(k) <= SMEM_OPTIN


@pytest.mark.parametrize("t,k,m", TRANSITIONS)
def test_merge_tile_plan_fills_the_card(t, k, m):
    """At every Swin-tiny transition of a 64-face pack the grid has at least
    one block per SM; at the first (M = 192) one column tile holds every
    column, so no second column tile reads x again; at K = 1536 a block fits
    the shared memory the wrapper checks (fmmt_fused_merge_smem: 111,104
    bytes), twice over, so that two blocks share an SM."""
    gx, gy = merge_plan(t, m)
    assert gx * gy >= SMS
    if m == 192:
        assert gy == 1
    assert merge_smem_bytes(1536) == 111104
    assert 2 * (merge_smem_bytes(1536) + 1024) <= 228 * 1024


def chunked_merge(x, gamma, beta, w, eps=1e-5):
    """The kernel's arithmetic: fp32 two-pass statistics of each bf16 row,
    then K in chunks of 64, each normalised as (x rstd - mean rstd) gamma +
    beta, rounded to bf16 and multiplied into an fp32 accumulator; the
    result rounded once to bf16."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((xf - mean) ** 2).mean(-1, keepdim=True) + eps)
    acc = torch.zeros(x.shape[:-1] + (w.shape[1],))
    for k0 in range(0, x.shape[-1], MERGE_BK):
        cols = slice(k0, k0 + MERGE_BK)
        xn = ((xf[..., cols] * rstd - mean * rstd) * gamma[cols].float()
              + beta[cols].float()).to(torch.bfloat16).float()
        acc += xn @ w[cols].float()
    return acc.to(torch.bfloat16)


@pytest.mark.parametrize("b,l,c4,c2", [(2, 49, 384, 192), (1, 30, 48, 208),
                                       (1, 5, 1536, 768)])
def test_chunked_merge_matches_plain_and_jax(rng, b, l, c4, c2):
    x = rng.normal(size=(b, l, c4)).astype(np.float32)
    g = (1 + 0.1 * rng.normal(size=c4)).astype(np.float32)
    be = (0.1 * rng.normal(size=c4)).astype(np.float32)
    w = (rng.normal(size=(c4, c2)) / np.sqrt(c4)).astype(np.float32)
    xb, gb, bb, wb = (T(a).to(torch.bfloat16) for a in (x, g, be, w))
    got = chunked_merge(xb, gb, bb, wb).float().numpy()
    plain = merge_kernel.fused_merge_plain(xb, gb, bb, wb).float().numpy()
    assert _rel(got, plain) <= 4e-3
    want = jmerge._reference(*(jnp.asarray(a, jnp.bfloat16)
                               for a in (x, g, be, w)))
    assert _rel(got, np.asarray(want, np.float32)) <= 4e-3
