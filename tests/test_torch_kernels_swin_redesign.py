"""The algorithms of kernel 2 (csrc/attention_block.cu) and kernel 3
(csrc/block_mlp.cu) written out in PyTorch, against the plain versions and
the JAX package.

A CUDA kernel cannot run here, so what the two kernels compute is mirrored
step by step, and their launch plans are checked from the constants of
csrc/tile_gemm.cuh and csrc/attention_block.cu:
  * the plans: every (row, column) of each tiled product and every (window,
    head) of the attention pass is computed by exactly one block; at each
    Swin-tiny stage of a 64-face pack every device kernel launches at least
    132 blocks (the H100's SMs); every block's shared memory fits the 232,448
    bytes a Hopper block can take, the products' two to an SM; each weight
    byte is read once per 128-row tile;
  * the arithmetic: LayerNorm statistics in fp32 (two-pass), LN applied and
    rounded to bf16 before the product, 64-wide K chunks summed in fp32, the
    epilogues (bias; exact-erf GELU; the q scale; keep and the fp32
    residual), q / k / v, the probabilities and the head outputs
    rounded to bf16.  Without the bf16 rounding the mirror equals the fp32
    plain versions and JAX's references at atol 1e-5, rtol 1e-4 (summation
    order only); with it, in bf16, it stays within the kernels' 2e-2 bound of
    the plain versions and of the JAX kernels in interpret mode.
tests/test_torch_gpu.py holds the kernels themselves against the plain
versions on the card.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facialmmt_tpu.ops.pallas import block_mlp as jmlp
from facialmmt_tpu.ops.pallas import fused_block as jblock
from facialmmt_tpu_torch.ops.kernels import block_mlp, fused_block

T = torch.from_numpy
KERNEL_BOUND = 2e-2
EPS = 1e-5
SMS = 132               # H100 SXM
SMEM_OPTIN = 232448     # bytes a Hopper block can use
SMEM_PER_SM = 233472    # of which each resident block also holds 1 KB

# csrc/tile_gemm.cuh
GEMM_BM = 128           # rows of a block's tile
GEMM_BK = 64            # K per ring stage
GEMM_STAGES = 3
# csrc/attention_block.cu
UNITS = 2               # (window, head) units a block
ROWS = 64               # window rows, padded

FACES = 64
SWIN_STAGES = [(56, 96, 3), (28, 192, 6), (14, 384, 12), (7, 768, 24)]


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


# ----------------------------------------------------------------- plans --

def tile_n(n):
    """The product's tile width: 128 where it divides N, else 96, else 64."""
    return 128 if n % 128 == 0 else (96 if n % 96 == 0 else 64)


def gemm_blocks(m, n):
    """Block b of the 1-D grid -> (m0, n0, width): the column tiles of one
    row tile are adjacent."""
    bn = tile_n(n)
    ntn = math.ceil(n / bn)
    return [((b // ntn) * GEMM_BM, (b % ntn) * bn, bn)
            for b in range(math.ceil(m / GEMM_BM) * ntn)]


def gemm_smem(n, k, ln):
    """gamma and beta (bf16) and the rows' statistics (float2) with a
    LayerNorm prologue, the ring (A chunk 128 x 64 and B chunk width x 64,
    bf16, unpadded under the 128-byte swizzle) 1024-aligned, and 1 KB of
    slack to align the dynamic base at run time; the fp32 output tile is
    staged over the ring."""
    up = lambda v, a: (v + a - 1) // a * a
    stage = GEMM_BM * GEMM_BK * 2 + tile_n(n) * GEMM_BK * 2
    assert GEMM_BM * (tile_n(n) + 4) * 4 <= GEMM_STAGES * stage
    stats = up(2 * k * 2, 128) if ln else 0
    ring = up(stats + (GEMM_BM * 8 if ln else 0), 1024)
    return ring + GEMM_STAGES * stage + 1024


def stats_blocks(m, k):
    """row_stats_kernel: lanes a row = the smallest of 4, 8, 16, 32 that
    covers K / 8 (32 at most); 8 warps a block."""
    lanes = 4
    while lanes < 32 and lanes * 8 < k:
        lanes *= 2
    return math.ceil(m / (8 * (32 // lanes)))


def window_units(w, heads):
    """Block b, slot g -> unit b * 2 + g = window * heads + head."""
    blocks = math.ceil(w * heads / UNITS)
    return [divmod(b * UNITS + g, heads) for b in range(blocks)
            for g in range(UNITS) if b * UNITS + g < w * heads]


def window_smem(hd):
    return UNITS * 3 * ROWS * (hd + 8) * 2


def attention_block_plan(w, c, heads, n=49):
    """(name, blocks, shared memory) of kernel 2's four device kernels."""
    rows = w * n
    return [("LN1 statistics", stats_blocks(rows, c), 0),
            ("qkv", len(gemm_blocks(rows, 3 * c)), gemm_smem(3 * c, c, True)),
            ("attention", math.ceil(w * heads / UNITS), window_smem(c // heads)),
            ("proj", len(gemm_blocks(rows, c)), gemm_smem(c, c, False))]


def mlp_plan(t, c):
    """(name, blocks, shared memory) of kernel 3's three device kernels."""
    return [("LN2 statistics", stats_blocks(t, c), 0),
            ("fc1", len(gemm_blocks(t, 4 * c)), gemm_smem(4 * c, c, True)),
            ("fc2", len(gemm_blocks(t, c)), gemm_smem(c, 4 * c, False))]


STAGE_IDS = [f"stage{i}" for i in range(4)]


@pytest.mark.parametrize("m,n", [(3136, 768), (3136, 2304), (294, 96),
                                 (300, 32), (1, 16), (12544, 1536)])
def test_gemm_tile_plan_covers_every_output_once(m, n):
    seen = np.zeros((m, n), np.int8)
    for m0, n0, bn in gemm_blocks(m, n):
        seen[m0:m0 + GEMM_BM, n0:n0 + bn] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("w,heads", [(64, 24), (7, 3), (256, 12)])
def test_window_pass_covers_every_window_and_head_once(w, heads):
    units = window_units(w, heads)
    assert sorted(units) == [(i, h) for i in range(w) for h in range(heads)]


@pytest.mark.parametrize("stage", range(4), ids=STAGE_IDS)
def test_plans_fill_the_card_and_fit_shared_memory(stage):
    res, c, heads = SWIN_STAGES[stage]
    w, t = FACES * (res // 7) ** 2, FACES * res * res
    for name, blocks, smem in (attention_block_plan(w, c, heads)
                               + mlp_plan(t, c)):
        assert blocks >= SMS, (name, blocks)
        assert smem <= SMEM_OPTIN, (name, smem)
    # qkv and fc1 with the LayerNorm prologue, proj and fc2 without: two
    # blocks an SM each
    for n_out, k, ln in ((3 * c, c, True), (c, c, False), (4 * c, c, True),
                         (c, 4 * c, False)):
        assert 2 * (gemm_smem(n_out, k, ln) + 1024) <= SMEM_PER_SM


@pytest.mark.parametrize("stage", range(4), ids=STAGE_IDS)
def test_weight_bytes_into_the_sms_per_launch(stage):
    """Each 128-row tile reads each weight byte once.  Against the first
    versions (W x 4 x 8 C^2 bytes for kernel 2, every 16-row tile of a
    window reloading Wqkv and Wproj; T x C^2 for kernel 3, every 16-row tile
    of 32 tokens reloading W1 and W2): 10.45x and 8x less at stages 0-2,
    10.24x and 7.84x at stage 3, where T = W N = 3136 is 24.5 tiles of
    128."""
    res, c, heads = SWIN_STAGES[stage]
    w, t = FACES * (res // 7) ** 2, FACES * res * res
    weight = lambda blocks, k: sum(bn * k * 2 for _, _, bn in blocks)
    k2 = (weight(gemm_blocks(w * 49, 3 * c), c)
          + weight(gemm_blocks(w * 49, c), c))
    assert k2 == math.ceil(w * 49 / GEMM_BM) * 8 * c * c
    k3 = (weight(gemm_blocks(t, 4 * c), c)
          + weight(gemm_blocks(t, c), 4 * c))
    assert k3 == math.ceil(t / GEMM_BM) * 16 * c * c
    assert round(w * 4 * 8 * c * c / k2, 2) == (10.24 if stage == 3 else 10.45)
    assert round(t * c * c / k3, 2) == (7.84 if stage == 3 else 8.0)


# ------------------------------------------------------------ arithmetic --

def _bf(t, on):
    return t.to(torch.bfloat16).float() if on else t


def row_stats(x):
    """(rstd, -mean rstd) per row, fp32, two passes."""
    mean = x.sum(-1, keepdim=True) / x.shape[-1]
    var = (x - mean).square().sum(-1, keepdim=True) / x.shape[-1]
    rstd = torch.rsqrt(var + EPS)
    return rstd, -mean * rstd


def tile_gemm(a, b, bias, *, ln=None, epi, rnd, q_cols=0, q_scale=1.0,
              res=None, keep=None, keep_div=1):
    """csrc/tile_gemm.cuh in fp32: A' (LN applied per chunk and rounded to
    bf16 with `ln` = (gamma, beta)), the product summed over 64-wide K
    chunks, then bias and the epilogue, rounded once."""
    a = a.float()
    if ln is not None:
        scale, shift = row_stats(a)
        a = _bf((a * scale + shift) * ln[0].float() + ln[1].float(), rnd)
    b = b.float()
    acc = torch.zeros(a.shape[0], b.shape[0])
    for k0 in range(0, a.shape[1], GEMM_BK):
        acc = acc + a[:, k0:k0 + GEMM_BK] @ b[:, k0:k0 + GEMM_BK].t()
    y = acc + bias.float()
    if epi == "gelu":
        y = 0.5 * y * (1.0 + torch.erf(y * 2.0 ** -0.5))
    elif epi == "scale_q":
        y = torch.cat([y[:, :q_cols] * q_scale, y[:, q_cols:]], dim=1)
    else:
        if keep is not None:
            rows = torch.arange(a.shape[0]) // keep_div
            y = y * keep.float()[rows][:, None]
        y = res.float() + y
    return _bf(y, rnd)


def window_pass(qkv, bias, w, n, c, heads, rnd):
    """The attention pass: per (window, head) the 64-row padded tiles of q,
    k, v, fp32 scores + bias over the N real keys, fp32 softmax,
    probabilities rounded, P v in fp32, the head output rounded into its
    columns of the (W N, C) rows."""
    hd, nw = c // heads, bias.shape[0]
    out = torch.zeros(w * n, c)
    for win, head in window_units(w, heads):
        rows = qkv[win * n:(win + 1) * n]
        q, k, v = (torch.zeros(ROWS, hd) for _ in range(3))
        for i, t in enumerate((q, k, v)):
            t[:n] = rows[:, i * c + head * hd:i * c + (head + 1) * hd]
        s = q @ k.t()
        s[:n, :n] = s[:n, :n] + bias[win % nw, head].float()
        s[:, n:] = -math.inf
        p = _bf(torch.softmax(s[:n], dim=-1), rnd)
        out[win * n:(win + 1) * n, head * hd:(head + 1) * hd] = _bf(p @ v,
                                                                     rnd)
    return out


def attention_block_mirror(x, gamma, beta, wqkv, bqkv, wproj, bproj, bias,
                           keep, rnd):
    """Kernel 2: statistics, qkv (LN1, bias, q scale), the attention pass,
    proj (bias, keep, residual)."""
    w, n, c = x.shape
    heads = bias.shape[1]
    rows = x.reshape(w * n, c).float()
    qkv = tile_gemm(rows, wqkv, bqkv, ln=(gamma, beta), epi="scale_q",
                    rnd=rnd, q_cols=c, q_scale=(c // heads) ** -0.5)
    heads_out = window_pass(qkv, bias, w, n, c, heads, rnd)
    return tile_gemm(heads_out, wproj, bproj, epi="residual", rnd=rnd,
                     res=rows, keep=keep, keep_div=n).reshape(w, n, c)


def mlp_mirror(x, gamma, beta, w1, b1, w2, b2, keep, rnd):
    """Kernel 3: statistics, fc1 (LN2, bias, GELU), fc2 (bias, keep,
    residual)."""
    h = tile_gemm(x, w1, b1, ln=(gamma, beta), epi="gelu", rnd=rnd)
    return tile_gemm(h, w2, b2, epi="residual", rnd=rnd, res=x.float(),
                     keep=keep)


def _block_inputs(rng, w, n, c, h, nw):
    x = rng.normal(size=(w, n, c)).astype(np.float32)
    gamma = (rng.normal(size=(c,)) * 0.1 + 1).astype(np.float32)
    beta = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    wqkv = (rng.normal(size=(c, 3 * c)) / np.sqrt(c)).astype(np.float32)
    bqkv = (rng.normal(size=(3 * c,)) * 0.1).astype(np.float32)
    wproj = (rng.normal(size=(c, c)) / np.sqrt(c)).astype(np.float32)
    bproj = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    bias = (rng.normal(size=(nw, h, n, n)) * 0.5).astype(np.float32)
    if nw > 1:   # shifted-window style mask rows
        bias += np.where(rng.random((nw, 1, n, n)) > 0.7, -100.0, 0.0
                         ).astype(np.float32)
    return x, gamma, beta, wqkv, bqkv, wproj, bproj, bias


@pytest.mark.parametrize("n,nw,use_keep", [(49, 2, True), (49, 1, False),
                                           (16, 2, False)],
                         ids=["49-shifted-keep", "49-plain", "16-shifted"])
def test_attention_block_mirror_matches_plain_and_jax(rng, n, nw, use_keep):
    """6 windows of 49 rows: 294 packed rows in three 128-row tiles, the last
    partial, windows straddling tiles; C = 32 in 2 heads of 16."""
    w, c, h = 6, 32, 2
    x, g, be, wqkv, bqkv, wp, bp, bias = _block_inputs(rng, w, n, c, h, nw)
    keep = (np.asarray([0.0, 1.25, 1.25, 0.0, 1.25, 1.25], np.float32)
            if use_keep else None)
    keep_t = None if keep is None else T(keep)
    port = (T(x), T(g), T(be), T(wqkv.T.copy()), T(bqkv), T(wp.T.copy()),
            T(bp), T(bias))
    exact = attention_block_mirror(*port, keep_t, rnd=False).numpy()
    plain = fused_block.fused_attention_block_plain(*port, keep_t).numpy()
    np.testing.assert_allclose(exact, plain, atol=1e-5, rtol=1e-4)
    want = np.asarray(jblock._reference(x, g, be, wqkv, bqkv, wp, bp, bias,
                                        keep, EPS))
    np.testing.assert_allclose(exact, want, atol=1e-5, rtol=1e-4)

    bf = [t.to(torch.bfloat16) for t in port[:7]] + [port[7]]
    rounded = attention_block_mirror(*bf, keep_t, rnd=True).numpy()
    plain_bf16 = fused_block.fused_attention_block_plain(*bf, keep_t).float()
    assert _rel(rounded, plain_bf16.numpy()) <= KERNEL_BOUND
    interp = np.asarray(jblock.fused_attention_block(
        x, g, be, wqkv, bqkv, wp, bp, bias, keep, interpret=True))
    assert _rel(rounded, interp) <= KERNEL_BOUND
    if keep is not None:   # keep = 0: x passes through, rounded once
        np.testing.assert_array_equal(rounded[keep == 0],
                                      bf[0].float().numpy()[keep == 0])


def _mlp_xla_fp32(x, g, be, w1, b1, w2, b2, keep):
    """fp32 XLA formulation of the block MLP half (SwinBlock's XLA path)."""
    xn = (x - x.mean(-1, keepdims=True)) * jax.lax.rsqrt(
        x.var(-1, keepdims=True) + EPS) * g + be
    y = jax.nn.gelu(xn @ w1 + b1, approximate=False) @ w2 + b2
    if keep is not None:
        y = y * keep[:, None]
    return x + y


@pytest.mark.parametrize("t,use_keep", [(300, True), (128, False)],
                         ids=["ragged-keep", "one-tile"])
def test_mlp_mirror_matches_plain_and_jax(rng, t, use_keep):
    """C = 32, HID = 128 (fc1 in 128-wide column tiles, fc2 in 64-wide ones
    with half the tile past N); T = 300 leaves a partial row tile."""
    c = 32
    x = rng.normal(size=(t, c)).astype(np.float32)
    g = (rng.normal(size=(c,)) * 0.1 + 1).astype(np.float32)
    be = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    w1 = (rng.normal(size=(c, 4 * c)) / np.sqrt(c)).astype(np.float32)
    b1 = (rng.normal(size=(4 * c,)) * 0.1).astype(np.float32)
    w2 = (rng.normal(size=(4 * c, c)) / np.sqrt(4 * c)).astype(np.float32)
    b2 = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    keep = ((rng.random(t) > 0.3) / 0.7).astype(np.float32) if use_keep else None
    keep_t = None if keep is None else T(keep)
    port = (T(x), T(g), T(be), T(w1.T.copy()), T(b1), T(w2.T.copy()), T(b2))
    exact = mlp_mirror(*port, keep_t, rnd=False).numpy()
    plain = block_mlp.fused_ln_mlp_residual_plain(*port, keep_t).numpy()
    np.testing.assert_allclose(exact, plain, atol=1e-5, rtol=1e-4)
    want = np.asarray(_mlp_xla_fp32(x, g, be, w1, b1, w2, b2, keep))
    np.testing.assert_allclose(exact, want, atol=1e-5, rtol=1e-4)

    bf = [p.to(torch.bfloat16) for p in port]
    rounded = mlp_mirror(*bf, keep_t, rnd=True).numpy()
    plain_bf16 = block_mlp.fused_ln_mlp_residual_plain(*bf, keep_t).float()
    assert _rel(rounded, plain_bf16.numpy()) <= KERNEL_BOUND
    interp = np.asarray(jmlp.fused_ln_mlp_residual(
        x, g, be, w1, b1, w2, b2, keep, EPS, True))
    assert _rel(rounded, interp) <= KERNEL_BOUND
    ref_bf16 = np.asarray(jmlp._reference(x, g, be, w1, b1, w2, b2, keep,
                                          EPS))
    assert _rel(rounded, ref_bf16) <= KERNEL_BOUND
