"""Kernel 6 (the spill variant of csrc/attention_block_bwd.cu) and kernel 7
(the whole block, csrc/attention_block.cu's second entry point) written out
in PyTorch, against the plain versions and the JAX package.

A CUDA kernel cannot run here, so what the two compute is mirrored step by
step with the helpers of the mirrors of the kernels whose device code they
reuse (tests/test_torch_kernels_bwd_redesign.py for kernel 5's sequence,
tests/test_torch_kernels_swin_redesign.py for kernels 2 and 3), and their
launch plans are checked from the constants of csrc/tile_gemm.cuh and
csrc/attention_block_bwd.cu:
  * kernel 6's plan at stage 3 of a 150-image batch (T = 7,350 token rows,
    C = 768, 24 heads, nW = 1): the row tiles, the split-T slices, the
    window runs, at least 132 blocks for every device kernel but the
    fixed-order sums, shared memory within the 232,448 bytes a Hopper block
    can take;
  * kernel 6's arithmetic: kernel 5's, but dbqkv summed from the
    bf16-rounded dq | dk | dv (JAX `_bwd_impl_spill` sums the dqkv its
    kernel emits).  Without the bf16 rounding the mirror equals the fp32
    plain version to 1e-5 of max|grad| per output (summation order only);
    with it, in bf16, it stays within the kernels' 2e-2 bound of the plain
    version and of `_bwd_impl_spill` in interpret mode;
  * kernel 7's plan and arithmetic: the attention half's device kernels
    with proj leaving, per row and column tile of y, the (mean, M2) of its
    bf16-rounded outputs (from those of 8-column groups), merged in column
    order in fc1's prologue into LN2's statistics, then fc1 + GELU and
    fc2 + residual.  The merge equals
    the two-pass statistics to fp32 rounding; without the bf16 rounding the
    mirror equals the plain version and JAX's `_whole_reference` at atol
    1e-5, rtol 1e-4; with it it stays within 2e-2 of the plain version and
    of JAX's `fused_whole_block` in interpret mode.
tests/test_torch_gpu.py holds the kernels themselves against the plain
versions on the card, two launches bit for bit.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import test_torch_kernels_bwd_redesign as bwd
from tests import test_torch_kernels_swin_redesign as fwd
from facialmmt_tpu.ops.pallas import fused_block as jblock
from facialmmt_tpu_torch.ops.kernels import fused_block

T = torch.from_numpy
BOUND = 2e-2
EPS = 1e-5

# Swin-tiny stage 3 in the 150-image auxiliary batch
AUX_W, AUX_C, AUX_HEADS, N = 150, 768, 24, 49


# ----------------------------------------------------------------- plans --

def test_spill_plan_at_stage_3_fills_the_card():
    """T = 7,350 rows are 57 full 128-row tiles and one of 54; dWqkv (2304 x
    768: 108 tiles of 128 x 128) takes 3 token slices and dWproj (36 tiles)
    8, so each product launches >= 2 x 132 blocks, with fp32 partials of
    slices x the product; the window pass takes runs of 4 windows, 38 runs x
    24 heads."""
    t = AUX_W * N
    assert (t // bwd.GEMM_BM, t % bwd.GEMM_BM) == (57, 54)
    slices = {name: bwd.split_plan(m, AUX_C, t)
              for name, m in (("dWqkv", 3 * AUX_C), ("dWproj", AUX_C))}
    assert slices == {"dWqkv": (3, 2496), "dWproj": (8, 960)}
    for m, (s, _) in ((3 * AUX_C, slices["dWqkv"]),
                      (AUX_C, slices["dWproj"])):
        assert len(bwd.wgrad_blocks(m, AUX_C, t)) >= 2 * bwd.SMS
        assert s * m * AUX_C * 4 <= 22 * 2 ** 20     # partials, bytes
    groups, per = bwd.win_plan(AUX_W, AUX_HEADS)
    assert (groups, per) == (38, 4) and per <= 27
    for name, blocks, smem in bwd.attn_bwd_plan(AUX_W, AUX_C, AUX_HEADS):
        assert blocks >= bwd.SMS, (name, blocks)
        assert smem <= bwd.SMEM_OPTIN, (name, smem)
    assert fused_block.backward_variant(AUX_C) == "spill"


@pytest.mark.parametrize("c,parts", [(96, 1), (192, 2), (384, 3), (768, 6),
                                     (32, 1)])
def test_ln2_partials_cover_each_row_once(c, parts):
    """proj's column tiles (128, 96 or 64 wide, the widest that divides C;
    64 at C = 32, half of it real) give a row `parts` (mean, M2) partials
    whose columns cover C once; fc1 merges them in column order."""
    bn = fwd.tile_n(c)
    cover = np.zeros(c, np.int32)
    counts = []
    for j in range(math.ceil(c / bn)):
        cols = min(bn, c - j * bn)
        cover[j * bn:j * bn + cols] += 1
        counts.append(cols)
    assert len(counts) == parts and (cover == 1).all()


# ------------------------------------------------------------ arithmetic --

@pytest.mark.parametrize("w,n,c,h,nw,keep", [(4, 16, 32, 2, 2, True),
                                             (3, 49, 64, 2, 1, False)],
                         ids=["16-shifted-keep", "49-hd32"])
def test_spill_mirror_matches_plain(rng, w, n, c, h, nw, keep):
    """Kernel 6's sequence with the rounded dbqkv: fp32 to 1e-5 of the fp32
    plain spill backward, bf16 within 2e-2 of the bf16 one; at hd = 32, the
    stage-3 head dim, 147 rows in two 128-row tiles, the last partial."""
    a = bwd._attn_inputs(rng, w, n, c, h, nw, keep)
    args, k = bwd._port_args(a, bwd.ATTN_ORDER, ("wqkv", "wproj"),
                             torch.float32)
    exact, _ = bwd.attn_bwd_mirror(*args, k, rnd=False, spill=True)
    plain = fused_block.fused_attention_block_bwd_spill_plain(*args, k)
    bwd._hold(bwd.ATTN_NAMES, exact, plain, 1e-5, "plain, fp32")
    bf = [t.to(torch.bfloat16) if t.dim() != 4 else t for t in args]
    rounded, _ = bwd.attn_bwd_mirror(*bf, k, rnd=True, spill=True)
    plain_bf16 = fused_block.fused_attention_block_bwd_spill_plain(*bf, k)
    bwd._hold(bwd.ATTN_NAMES, rounded, plain_bf16, BOUND, "plain, bf16")
    assert not rounded[-1][1:].any()          # the bias cotangent in group 0


def test_spill_mirror_matches_jax_interpret(rng):
    """Against JAX's spill backward kernel in interpret mode (two grid cells
    of one window pair, weight gradients outside as K = T products) on the
    same inputs, weights in JAX layout."""
    a = bwd._attn_inputs(rng, 4, 16, 32, 2, 2, True)
    args, k = bwd._port_args(a, bwd.ATTN_ORDER, ("wqkv", "wproj"),
                             torch.bfloat16)
    got, _ = bwd.attn_bwd_mirror(*args, k, rnd=True, spill=True)
    j = jnp.asarray
    want = jblock._bwd_impl_spill(
        j(a["x"], jnp.bfloat16), j(a["gamma"]), j(a["beta"]), j(a["wqkv"]),
        j(a["bqkv"]), j(a["wproj"]), j(a["bias"]), j(a["keep"]),
        j(a["dy"], jnp.bfloat16), 1, EPS, True)
    dx, dg, db, dwqkv, dbqkv, dwp, dbp, dbias = (np.asarray(o, np.float32)
                                                 for o in want[:8])
    bwd._hold(bwd.ATTN_NAMES, got,
              [dx, dg, db, dwqkv.T, dbqkv, dwp.T, dbp, dbias], BOUND,
              "JAX _bwd_impl_spill, interpret mode")


def test_spill_dbqkv_sums_the_rounded_dq_dk_dv(rng):
    """The spill variant's fixed-order dbqkv equals the row sum of the
    bf16-rounded dq | dk | dv to fp32 order, much closer than the sum of
    the unrounded ones is; the resident variant's is the other way round."""
    a = bwd._attn_inputs(rng, 6, 49, 32, 2, 1, False)
    args, k = bwd._port_args(a, bwd.ATTN_ORDER, ("wqkv", "wproj"),
                             torch.bfloat16)
    got, dqkv32 = bwd.attn_bwd_mirror(*args, k, rnd=True, spill=True)
    resident, _ = bwd.attn_bwd_mirror(*args, k, rnd=True)
    rounded = bwd._bf(dqkv32, True).double().sum(0)
    unrounded = dqkv32.double().sum(0)
    gap = float((rounded - unrounded).abs().max())
    err = float((got[4].double() - rounded).abs().max())
    assert err <= 1e-5 * float(rounded.abs().max())
    assert err < 0.05 * gap
    assert float((resident[4].double() - unrounded).abs().max()) < 0.05 * gap
    plain = fused_block.fused_attention_block_bwd_spill_plain(*args, k)[4]
    assert bwd._rel(got[4].numpy(), plain.numpy()) <= BOUND


def ln2_partials(y, bn):
    """proj's kResidualStats epilogue: per row, each 8-column group of the
    rounded y gives (mean, M2) (two passes over its 8 values); each half of
    a tile's real groups merges in column order (mean = sum mean_g / g, M2 =
    sum M2_g + 8 sum (mean_g - mean)^2), then the two halves (n = 4 G
    columns each: mean = (a + b) / 2, M2 = M2_a + M2_b + n / 2 (b - a)^2).
    Returns per tile (mean, M2, columns)."""
    parts = []
    for j0 in range(0, y.shape[1], bn):
        tile = y[:, j0:j0 + bn]
        groups = tile.reshape(tile.shape[0], -1, 8)
        mean_g = groups.sum(2) * 0.125
        m2_g = (groups - mean_g[..., None]).square().sum(2)
        half = mean_g.shape[1] // 2
        halves = []
        for h0 in (0, half):
            mg, m2g = mean_g[:, h0:h0 + half], m2_g[:, h0:h0 + half]
            mean = mg.sum(1) / half
            halves.append((mean, m2g.sum(1)
                           + 8 * (mg - mean[:, None]).square().sum(1)))
        (ma, m2a), (mb, m2b) = halves
        parts.append((0.5 * (ma + mb), m2a + m2b + 4 * half * (mb - ma) ** 2,
                      tile.shape[1]))
    return parts


def merged_stats(parts, k):
    """fc1's kLnParts prologue: mean = sum n_j mean_j / K, M2 = sum (M2_j +
    n_j (mean_j - mean)^2), in column order; (rstd, -mean rstd)."""
    total = torch.zeros_like(parts[0][0])
    for mean_j, _, n_j in parts:
        total = total + mean_j * n_j
    mean = total / k
    m2 = torch.zeros_like(mean)
    for mean_j, m2_j, n_j in parts:
        m2 = m2 + (m2_j + n_j * (mean_j - mean).square())
    rstd = torch.rsqrt(m2 / k + EPS)
    return rstd[:, None], (-mean * rstd)[:, None]


@pytest.mark.parametrize("c", [768, 96, 32])
def test_merged_ln2_statistics_equal_the_two_pass_ones(rng, c):
    """Six, one and one (half-tile) partials a row: the merge gives the
    two-pass (rstd, -mean rstd) to 1e-6 relative, on rows with a large mean
    (the case the centred M2 is for)."""
    y = T(rng.normal(size=(300, c)).astype(np.float32) * 2.0 + 5.0)
    y = bwd._bf(y, True)
    got = merged_stats(ln2_partials(y, fwd.tile_n(c)), c)
    want = bwd.row_stats(y)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w_.numpy(), rtol=1e-6,
                                   atol=1e-6)


def whole_block_mirror(x, gamma, beta, wqkv, bqkv, wproj, bproj, bias,
                       gamma2, beta2, w1, b1, w2, b2, rnd):
    """Kernel 7: the attention half's mirror (y rounded by proj's epilogue),
    LN2's statistics merged from proj's per-tile partials, fc1 (LN2 in its
    prologue, 64-wide K chunks, bias, GELU), fc2 (bias, residual)."""
    w, n, c = x.shape
    y = fwd.attention_block_mirror(x, gamma, beta, wqkv, bqkv, wproj, bproj,
                                   bias, None, rnd).reshape(w * n, c)
    rstd, shift = merged_stats(ln2_partials(y, fwd.tile_n(c)), c)
    yn = bwd._bf((y * rstd + shift) * gamma2.float() + beta2.float(), rnd)
    h = bwd.chunked(yn, w1.float()) + b1.float()
    h = bwd._bf(0.5 * h * (1.0 + torch.erf(h * 2.0 ** -0.5)), rnd)
    out = y + bwd.chunked(h, w2.float()) + b2.float()
    return bwd._bf(out, rnd).reshape(w, n, c)


def _whole_inputs(rng, w, n, c, h, nw):
    x, g, be, wqkv, bqkv, wp, bp, bias = fwd._block_inputs(rng, w, n, c, h, nw)
    g2 = (rng.normal(size=(c,)) * 0.1 + 1).astype(np.float32)
    be2 = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    w1 = (rng.normal(size=(c, 4 * c)) / np.sqrt(c)).astype(np.float32)
    b1 = (rng.normal(size=(4 * c,)) * 0.1).astype(np.float32)
    w2 = (rng.normal(size=(4 * c, c)) / np.sqrt(4 * c)).astype(np.float32)
    b2 = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    return x, g, be, wqkv, bqkv, wp, bp, bias, g2, be2, w1, b1, w2, b2


@pytest.mark.parametrize("w,n,c,h,nw", [(6, 49, 32, 2, 2), (2, 49, 192, 2, 1)],
                         ids=["49-shifted-C32", "49-C192-two-partials"])
def test_whole_block_mirror_matches_plain_and_jax(rng, w, n, c, h, nw):
    """294 and 98 packed rows in 128-row tiles, the last partial; C = 32
    (one partial over half a 64-column tile) and C = 192 (two 96-column
    partials a row).  fp32: the plain version and JAX's _whole_reference at
    atol 1e-5, rtol 1e-4; bf16: within 2e-2 of the plain version and, at
    C = 32, of JAX's fused_whole_block in interpret mode."""
    a = _whole_inputs(rng, w, n, c, h, nw)
    port = [T(v.T.copy() if i in (3, 5, 10, 12) else v)
            for i, v in enumerate(a)]
    exact = whole_block_mirror(*port, rnd=False).numpy()
    plain = fused_block.fused_whole_block_plain(*port).numpy()
    np.testing.assert_allclose(exact, plain, atol=1e-5, rtol=1e-4)
    want = np.asarray(jblock._whole_reference(*a, EPS))
    np.testing.assert_allclose(exact, want, atol=1e-5, rtol=1e-4)

    bf = [p if i == 7 else p.to(torch.bfloat16) for i, p in enumerate(port)]
    rounded = whole_block_mirror(*bf, rnd=True).numpy()
    plain_bf16 = fused_block.fused_whole_block_plain(*bf).float().numpy()
    assert bwd._rel(rounded, plain_bf16) <= BOUND
    if c == 32:
        interp = np.asarray(jblock.fused_whole_block(*a, interpret=True))
        assert bwd._rel(rounded, interp) <= BOUND
