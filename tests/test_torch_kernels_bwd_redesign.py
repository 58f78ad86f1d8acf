"""The algorithms of kernel 4 (csrc/block_mlp_bwd.cu) and kernel 5
(csrc/attention_block_bwd.cu) written out in PyTorch, against the plain
versions and the JAX package.

A CUDA kernel cannot run here, so what the two backwards compute is mirrored
step by step, and their launch plans are checked from the constants of
csrc/tile_gemm.cuh, csrc/swin_bwd.cuh and csrc/attention_block_bwd.cu:
  * the plans: every output element of each product (the hidden layer's dual
    product, the split-T weight-gradient products with their token slices)
    and every (window, head) unit of the window pass is computed by exactly
    one block, every row by one LayerNorm-backward block, every partial row
    by one fixed-order sum; at each Swin-tiny stage of a 150-image batch
    (kernel 5: stages 0-2, the widths it serves) every device kernel but the
    fixed-order sums launches at least 132 blocks (the H100's SMs; the
    split-T products aim at two an SM); shared memory fits the 232,448
    bytes a Hopper block can take, the products' two to an SM.  The sums
    reduce partial rows of a few thousand elements and are exempt;
  * the arithmetic: xn = bf16(LN(x)) and dyk = bf16(dy keep), products summed
    over 64-wide K chunks, the GELU backward in the dual product's epilogue
    with db1's column partials per 128-row tile, the window pass's softmax,
    its vjp and the transposed products with per-block dbias and per-warp
    dbqkv partials, the LayerNorm backward with per-block column partials,
    the weight gradients as per-slice partials, and every cross-block sum
    in the kernels' fixed order.  Without the bf16 rounding the mirrors
    equal the fp32 plain versions to 1e-5 of max|grad| per output (summation
    order only); with it, in bf16, they stay within the kernels' 2e-2 bound
    (tests/test_torch_kernels_bwd.py's BOUND) of the plain versions and of
    the JAX `_bwd_impl_pallas` kernels in interpret mode.
tests/test_torch_gpu.py holds the kernels themselves against the plain
versions on the card, and two launches bit for bit.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facialmmt_tpu.ops.pallas import block_mlp as jmlp
from facialmmt_tpu.ops.pallas import fused_block as jblock
from facialmmt_tpu_torch.ops.kernels import block_mlp, fused_block

BOUND = 2e-2
EPS = 1e-5
SMS = 132               # H100 SXM
SMEM_OPTIN = 232448     # bytes a Hopper block can use
SMEM_PER_SM = 233472    # of which each resident block also holds 1 KB

# csrc/tile_gemm.cuh
GEMM_BM = 128           # rows of a block's tile
GEMM_BK = 64            # K per ring stage
GEMM_STAGES = 3
DUAL_BN = 64            # the dual product's tile width
DUAL_STAGES = 2
SUM_ROWS = 32           # partial rows a fixed-order sum adds in one group
# csrc/swin_bwd.cuh
LN_WARPS = 8
LN_ROWS = 32            # rows a LayerNorm-backward block
# csrc/attention_block_bwd.cu
WIN_WARPS = 4
ROWS = 64               # window rows, padded
WIN_BLOCKS = 8 * 132    # the window pass's wanted block count

AUX_IMAGES = 150
SWIN_STAGES = [(56, 96, 3), (28, 192, 6), (14, 384, 12), (7, 768, 24)]
STAGE_IDS = [f"stage{i}" for i in range(4)]


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) or 1.0))


# ----------------------------------------------------------------- plans --

def tile_n(n):
    return 128 if n % 128 == 0 else (96 if n % 96 == 0 else 64)


def split_plan(m, n, t):
    """(slices, rows): T cut into slices of whole 64-row chunks, enough that
    the output tiles times the slices give two blocks an SM."""
    tiles = math.ceil(m / GEMM_BM) * math.ceil(n / tile_n(n))
    chunks = math.ceil(t / GEMM_BK)
    want = max(min(math.ceil(2 * SMS / tiles), chunks), 1)
    rows = math.ceil(chunks / want) * GEMM_BK
    return math.ceil(t / rows), rows


def wgrad_blocks(m, n, t):
    """Block b -> (slice, m0, n0, width, t0, t1) of the split-T product."""
    slices, rows = split_plan(m, n, t)
    bn = tile_n(n)
    ntn = math.ceil(n / bn)
    tiles = math.ceil(m / GEMM_BM) * ntn
    out = []
    for b in range(slices * tiles):
        s, tile = divmod(b, tiles)
        out.append((s, (tile // ntn) * GEMM_BM, (tile % ntn) * bn, bn,
                    s * rows, min(t, (s + 1) * rows)))
    return out


def gemm_blocks(m, n, bn=None):
    bn = bn or tile_n(n)
    ntn = math.ceil(n / bn)
    return [((b // ntn) * GEMM_BM, (b % ntn) * bn, bn)
            for b in range(math.ceil(m / GEMM_BM) * ntn)]


def win_plan(w, heads):
    """(groups, per): blocks (head, g), g taking windows g per .. + per - 1."""
    groups = min(math.ceil(WIN_BLOCKS / heads), w)
    per = math.ceil(w / groups)
    return math.ceil(w / per), per


def sum_rows_levels(r):
    """The group counts of the fixed-order sum of r partial rows: groups of
    SUM_ROWS consecutive rows, level after level, the last one 1."""
    levels = []
    while r > SUM_ROWS:
        r = math.ceil(r / SUM_ROWS)
        levels.append(r)
    return levels + [1]


def up(v, a):
    return (v + a - 1) // a * a


def gemm_smem(n, k, ln):
    stage = GEMM_BM * GEMM_BK * 2 + tile_n(n) * GEMM_BK * 2
    stats = up(2 * k * 2, 128) if ln else 0
    ring = up(stats + (GEMM_BM * 8 if ln else 0), 1024)
    return ring + GEMM_STAGES * stage + 1024


def dual_smem():
    stage = 2 * GEMM_BM * GEMM_BK * 2 + 2 * DUAL_BN * GEMM_BK * 2
    assert 2 * GEMM_BM * (DUAL_BN + 4) * 4 <= DUAL_STAGES * stage
    return DUAL_STAGES * stage + 1024


def wgrad_smem(n):
    bn = tile_n(n)
    stage = GEMM_BM * GEMM_BK * 2 + math.ceil(bn / 64) * 64 * 128
    assert GEMM_BM * (bn + 4) * 4 <= GEMM_STAGES * stage
    return GEMM_STAGES * stage + 1024


def ln_bwd_smem(c):
    return LN_WARPS * 3 * c * 4


def win_smem(hd):
    return (4 * ROWS * (hd + 8) * 2 + 2 * ROWS * (ROWS + 8) * 2
            + ROWS * ROWS * 4 + WIN_WARPS * 3 * hd * 4)


def stats_blocks(m, k):
    lanes = 4
    while lanes < 32 and lanes * 8 < k:
        lanes *= 2
    return math.ceil(m / (8 * (32 // lanes)))


def mlp_bwd_plan(t, c):
    """(name, blocks, shared memory) of kernel 4's device kernels."""
    hid = 4 * c
    return [("LN2 statistics", stats_blocks(t, c), 0),
            ("xn, dyk", math.ceil(t * c / 8 / 256), 0),
            ("h, dgm, GELU backward", len(gemm_blocks(t, hid, DUAL_BN)),
             dual_smem()),
            ("dxn", len(gemm_blocks(t, c)), gemm_smem(c, hid, False)),
            ("LN backward", math.ceil(t / LN_ROWS), ln_bwd_smem(c)),
            ("dW1", len(wgrad_blocks(hid, c, t)), wgrad_smem(c)),
            ("dW2", len(wgrad_blocks(c, hid, t)), wgrad_smem(hid))]


def attn_bwd_plan(w, c, heads, n=49):
    """(name, blocks, shared memory) of kernel 5's device kernels."""
    t = w * n
    return [("LN1 statistics", stats_blocks(t, c), 0),
            ("xn, dyk", math.ceil(t * c / 8 / 256), 0),
            ("qkv", len(gemm_blocks(t, 3 * c)), gemm_smem(3 * c, c, True)),
            ("dattn", len(gemm_blocks(t, c)), gemm_smem(c, c, False)),
            ("window pass", heads * win_plan(w, heads)[0],
             win_smem(c // heads)),
            ("dxn", len(gemm_blocks(t, c)), gemm_smem(c, 3 * c, False)),
            ("LN backward", math.ceil(t / LN_ROWS), ln_bwd_smem(c)),
            ("dWqkv", len(wgrad_blocks(3 * c, c, t)), wgrad_smem(c)),
            ("dWproj", len(wgrad_blocks(c, c, t)), wgrad_smem(c))]


@pytest.mark.parametrize("m,n,t", [(384, 96, 470400), (96, 384, 470400),
                                   (1152, 384, 29400), (3072, 768, 7350),
                                   (96, 32, 300), (48, 64, 1)])
def test_split_t_plan_covers_every_output_and_token_once(m, n, t):
    seen = np.zeros((m, n), np.int32)
    tokens = {}
    for s, m0, n0, bn, t0, t1 in wgrad_blocks(m, n, t):
        seen[m0:m0 + GEMM_BM, n0:n0 + bn] += 1
        tokens[s] = (t0, t1)
        assert t0 < t1
    slices, _ = split_plan(m, n, t)
    assert (seen == slices).all()     # every output once in every slice
    cover = np.zeros(t, np.int32)
    for t0, t1 in tokens.values():
        cover[t0:t1] += 1
    assert (cover == 1).all()


@pytest.mark.parametrize("t,hid", [(470400, 384), (300, 128), (7350, 3072)])
def test_dual_plan_covers_the_hidden_layer_once(t, hid):
    seen = np.zeros((math.ceil(t / GEMM_BM) * GEMM_BM, hid), np.int8)
    for m0, n0, bn in gemm_blocks(t, hid, DUAL_BN):
        seen[m0:m0 + GEMM_BM, n0:n0 + bn] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("w,heads", [(9600, 3), (600, 12), (7, 3), (1, 2)])
def test_window_pass_covers_every_window_and_head_once(w, heads):
    groups, per = win_plan(w, heads)
    units = sorted((win, head) for head in range(heads) for g in range(groups)
                   for win in range(g * per, min(w, (g + 1) * per)))
    assert units == [(i, h) for i in range(w) for h in range(heads)]
    assert all(g * per < w for g in range(groups))    # no empty block


@pytest.mark.parametrize("r", [1, 32, 33, 1024, 14700, 3675])
def test_fixed_order_sum_visits_every_partial_row_once(r):
    rows = list(range(r))
    for g in sum_rows_levels(r):
        rows = [sum(rows[i:i + SUM_ROWS]) for i in range(0, len(rows),
                                                          SUM_ROWS)]
        assert len(rows) == g
    assert rows == [r * (r - 1) // 2]


@pytest.mark.parametrize("stage", range(4), ids=STAGE_IDS)
def test_plans_fill_the_card_and_fit_shared_memory(stage):
    res, c, heads = SWIN_STAGES[stage]
    w, t = AUX_IMAGES * (res // 7) ** 2, AUX_IMAGES * res * res
    plans = mlp_bwd_plan(t, c)
    if c <= fused_block.RESIDENT_MAX_C:
        plans += attn_bwd_plan(w, c, heads)
    for name, blocks, smem in plans:
        assert blocks >= SMS, (name, blocks)
        assert smem <= SMEM_OPTIN, (name, smem)
    # the products two to an SM
    for smem in (dual_smem(), wgrad_smem(c), wgrad_smem(4 * c),
                 gemm_smem(c, 4 * c, False), gemm_smem(c, 3 * c, False)):
        assert 2 * (smem + 1024) <= SMEM_PER_SM


# ------------------------------------------------------------ arithmetic --

def _bf(t, on):
    return t.to(torch.bfloat16).float() if on else t


def row_stats(x):
    """(rstd, -mean rstd) per row, fp32, two passes."""
    mean = x.sum(-1, keepdim=True) / x.shape[-1]
    var = (x - mean).square().sum(-1, keepdim=True) / x.shape[-1]
    rstd = torch.rsqrt(var + EPS)
    return rstd, -mean * rstd


def chunked(a, b):
    """A (M, K) B (N, K)^T summed over 64-wide K chunks in fp32."""
    acc = torch.zeros(a.shape[0], b.shape[0])
    for k0 in range(0, a.shape[1], GEMM_BK):
        acc = acc + a[:, k0:k0 + GEMM_BK] @ b[:, k0:k0 + GEMM_BK].t()
    return acc


def sum_rows(part):
    """The fixed-order sum of partial rows (R, ...): groups of SUM_ROWS
    consecutive rows added in order, level after level."""
    while part.shape[0] > 1:
        groups = []
        for g0 in range(0, part.shape[0], SUM_ROWS):
            s = torch.zeros_like(part[0])
            for r in range(g0, min(part.shape[0], g0 + SUM_ROWS)):
                s = s + part[r]
            groups.append(s)
        part = torch.stack(groups)
    return part[0]


def wgrad(a, b):
    """out = A^T B over token rows: one fp32 partial per slice, each summed
    over 64-row chunks, then the fixed-order sum of the slices."""
    t, m = a.shape
    slices, rows = split_plan(m, b.shape[1], t)
    parts = []
    for s in range(slices):
        acc = torch.zeros(m, b.shape[1])
        for k0 in range(s * rows, min(t, (s + 1) * rows), GEMM_BK):
            k1 = min(t, (s + 1) * rows, k0 + GEMM_BK)
            acc = acc + a[k0:k1].t() @ b[k0:k1]
        parts.append(acc)
    return sum_rows(torch.stack(parts))


def prep_rows(x, dy, gamma, beta, kvec, rnd):
    """Statistics, xn = bf16((x rstd + shift) gamma + beta), dyk."""
    rstd, shift = row_stats(x)
    xn = _bf((x * rstd + shift) * gamma.float() + beta.float(), rnd)
    return rstd, shift, xn, _bf(dy * kvec[:, None], rnd)


def ln_bwd_rows(dxn, x, dy, rstd, shift, gamma, kvec, rnd):
    """dx and the fixed-order sums of dgamma | dbeta | dy keep: block b
    takes rows 32 b..; warp w rows 32 b + w + 8 i, i = 0..3, summed in i;
    the 8 warps' sums added in warp order."""
    t, c = dxn.shape
    xh = x * rstd + shift
    dxh = dxn * gamma.float()
    m1 = dxh.sum(-1, keepdim=True) / c
    m2 = (dxh * xh).sum(-1, keepdim=True) / c
    dx = _bf(dy + rstd * (dxh - m1 - xh * m2), rnd)
    terms = torch.cat([dxn * xh, dxn, dy * kvec[:, None]], dim=1)
    blocks = math.ceil(t / LN_ROWS)
    terms = torch.cat([terms, torch.zeros(blocks * LN_ROWS - t, 3 * c)])
    terms = terms.reshape(blocks, LN_ROWS // LN_WARPS, LN_WARPS, 3 * c)
    per_warp = torch.zeros(blocks, LN_WARPS, 3 * c)
    for i in range(LN_ROWS // LN_WARPS):
        per_warp = per_warp + terms[:, i]
    part = torch.zeros(blocks, 3 * c)
    for w in range(LN_WARPS):
        part = part + per_warp[:, w]
    return dx, sum_rows(part).reshape(3, c)


def mlp_bwd_mirror(x, dy, gamma, beta, w1, b1, w2, keep, rnd):
    """Kernel 4: (dx, dgamma, dbeta, dw1, db1, dw2, db2)."""
    x, dy = x.float(), dy.float()
    t, c = x.shape
    kvec = torch.ones(t) if keep is None else keep.float()
    rstd, shift, xn, dyk = prep_rows(x, dy, gamma, beta, kvec, rnd)
    w1f, w2f = w1.float(), w2.float()
    h = chunked(xn, w1f) + b1.float()
    dgm = chunked(dyk, w2f.t())
    cdf = 0.5 * (1.0 + torch.erf(h * 2.0 ** -0.5))
    pdf = torch.exp(-0.5 * h * h) * 0.3989422804014327
    g = _bf(h * cdf, rnd)
    dh32 = dgm * (cdf + h * pdf)
    dh = _bf(dh32, rnd)
    # db1: the dual product's per-tile column sums, rows in order
    tiles = [dh32[m0:m0 + GEMM_BM] for m0 in range(0, t, GEMM_BM)]
    part = []
    for tile in tiles:
        s = torch.zeros(tile.shape[1])
        for r in range(tile.shape[0]):
            s = s + tile[r]
        part.append(s)
    db1 = sum_rows(torch.stack(part))
    dxn = chunked(dh, w1f.t())
    dx, (dgamma, dbeta, db2) = ln_bwd_rows(dxn, x, dy, rstd, shift, gamma,
                                           kvec, rnd)
    return dx, dgamma, dbeta, wgrad(dh, xn), db1, wgrad(dyk, g), db2


def window_pass(qkv, dattn, bias, w, n, c, heads, rnd):
    """The window pass: per (head, block) its windows in order, 64-row padded
    tiles, the fp32 softmax and its vjp, the five products, the block's fp32
    dbias sum and per-warp dbqkv column sums.  Returns attn (T, C), dqkv
    (T, 3C) (rounded with `rnd`), the unrounded dq | dk | dv, dbqkv (3C) and
    dbias (h, N, N)."""
    hd, nw = c // heads, bias.shape[0]
    scale = hd ** -0.5
    t = w * n
    attn = torch.zeros(t, c)
    dqkv = torch.zeros(t, 3 * c)
    dqkv32 = torch.zeros(t, 3 * c)
    groups, per = win_plan(w, heads)
    dbqkv_part = torch.zeros(groups, 3 * c)
    dbias_part = torch.zeros(groups, heads, n, n)
    for head in range(heads):
        for g in range(groups):
            dbacc = torch.zeros(n, n)
            colacc = torch.zeros(WIN_WARPS, 3, hd)
            for win in range(g * per, min(w, (g + 1) * per)):
                rows = slice(win * n, (win + 1) * n)
                tiles = []
                for src, col0 in ((qkv, head * hd), (qkv, c + head * hd),
                                  (qkv, 2 * c + head * hd),
                                  (dattn, head * hd)):
                    tile = torch.zeros(ROWS, hd)
                    tile[:n] = src[rows, col0:col0 + hd]
                    tiles.append(tile)
                q, k, v, da = tiles
                s = q @ k.t()
                s[:n, :n] = s[:n, :n] + bias[win % nw, head].float()
                s[:, n:] = -math.inf
                p = torch.zeros(ROWS, ROWS)
                p[:n] = torch.softmax(s[:n], dim=-1)
                dp = da @ v.t()
                ds = p * (dp - (p * dp).sum(-1, keepdim=True))
                dbacc = dbacc + ds[:n, :n]
                pr, dsr = _bf(p, rnd), _bf(ds, rnd)
                outs = ((pr @ v), (dsr @ k) * scale, dsr.t() @ q, pr.t() @ da)
                attn[rows, head * hd:(head + 1) * hd] = _bf(outs[0][:n], rnd)
                for which, o in enumerate(outs[1:]):
                    cols = slice(which * c + head * hd,
                                 which * c + (head + 1) * hd)
                    dqkv32[rows, cols] = o[:n]
                    dqkv[rows, cols] = _bf(o[:n], rnd)
                    colacc[:, which] = colacc[:, which] + o.reshape(
                        WIN_WARPS, 16, hd).sum(1)
            dbias_part[g, head] = dbacc
            tot = torch.zeros(3, hd)
            for wp in range(WIN_WARPS):
                tot = tot + colacc[wp]
            for which in range(3):
                dbqkv_part[g, which * c + head * hd:
                           which * c + (head + 1) * hd] = tot[which]
    return (attn, dqkv, dqkv32, sum_rows(dbqkv_part),
            sum_rows(dbias_part.reshape(groups, -1)).reshape(heads, n, n))


def attn_bwd_mirror(x, dy, gamma, beta, wqkv, bqkv, wproj, bias, keep, rnd):
    """Kernel 5: (dx, dgamma, dbeta, dwqkv, dbqkv, dwproj, dbproj, dbias in
    group 0), and the unrounded dq | dk | dv."""
    w, n, c = x.shape
    heads = bias.shape[1]
    t = w * n
    xr, dyr = x.reshape(t, c).float(), dy.reshape(t, c).float()
    kvec = (torch.ones(t) if keep is None
            else keep.float().repeat_interleave(n))
    rstd, shift, xn, dyk = prep_rows(xr, dyr, gamma, beta, kvec, rnd)
    # qkv: the forward's product, LN1 in its prologue, bias, the q scale
    qkv = chunked(xn, wqkv.float()) + bqkv.float()
    qkv[:, :c] = qkv[:, :c] * (c // heads) ** -0.5
    qkv = _bf(qkv, rnd)
    dattn = _bf(chunked(dyk, wproj.float().t()), rnd)
    attn, dqkv, dqkv32, dbqkv, dbias = window_pass(qkv, dattn, bias, w, n, c,
                                                   heads, rnd)
    dxn = chunked(dqkv, wqkv.float().t())
    dx, (dgamma, dbeta, dbproj) = ln_bwd_rows(dxn, xr, dyr, rstd, shift,
                                              gamma, kvec, rnd)
    return ((dx.reshape(w, n, c), dgamma, dbeta, wgrad(dqkv, xn), dbqkv,
             wgrad(dyk, attn), dbproj, fused_block._group0(dbias,
                                                           bias.shape[0])),
            dqkv32)


def _attn_inputs(rng, w, n, c, h, nw, keep):
    bfv = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
    bias = (rng.normal(size=(nw, h, n, n)) * 0.5).astype(np.float32)
    if nw > 1:   # shifted-window style mask rows
        bias += np.where(rng.random((nw, 1, n, n)) > 0.7, -100.0, 0.0
                         ).astype(np.float32)
    return dict(
        x=bfv(rng.normal(size=(w, n, c))), dy=bfv(rng.normal(size=(w, n, c))),
        gamma=(rng.normal(size=c) * 0.1 + 1).astype(np.float32),
        beta=(rng.normal(size=c) * 0.1).astype(np.float32),
        wqkv=(rng.normal(size=(c, 3 * c)) / np.sqrt(c)).astype(np.float32),
        bqkv=(rng.normal(size=3 * c) * 0.1).astype(np.float32),
        wproj=(rng.normal(size=(c, c)) / np.sqrt(c)).astype(np.float32),
        bias=bias,
        keep=(rng.choice([0.0, 1.43], size=w).astype(np.float32)
              if keep else None))


def _port_args(a, order, transposed, dtype):
    """Torch tensors in `order`, the weights in torch Linear layout, every
    operand in `dtype` but the bias (fp32); and keep (fp32) or None."""
    t = lambda k: torch.tensor(a[k].T.copy() if k in transposed else a[k])
    out = [t(k) if k == "bias" else t(k).to(dtype) for k in order]
    keep = None if a["keep"] is None else torch.tensor(a["keep"])
    return out, keep


ATTN_ORDER = ("x", "dy", "gamma", "beta", "wqkv", "bqkv", "wproj", "bias")
ATTN_NAMES = ("dx", "dgamma", "dbeta", "dwqkv", "dbqkv", "dwproj", "dbproj",
              "dbias")


def _hold(names, got, want, bound, what):
    """Every output within bound * max|want|; a bias cotangent by its sum
    over window groups, the only part of it that is defined."""
    for name, g, w in zip(names, got, want):
        g, w = (np.asarray(v.float() if torch.is_tensor(v) else v, np.float32)
                for v in (g, w))
        if name == "dbias":
            g, w = g.sum(0), w.sum(0)
        assert g.shape == w.shape, (what, name)
        assert _rel(g, w) <= bound, (what, name, _rel(g, w))


@pytest.mark.parametrize("w,n,nw,keep", [(4, 16, 2, True), (6, 49, 1, False),
                                         (3, 49, 3, True)],
                         ids=["16-shifted-keep", "49-plain",
                              "49-shifted-keep"])
def test_attention_bwd_mirror_matches_plain(rng, w, n, nw, keep):
    """C = 32 in 2 heads of 16; 49-row windows pack 294 or 147 rows into
    128-row tiles, windows straddling tiles, the last tile partial."""
    a = _attn_inputs(rng, w, n, 32, 2, nw, keep)
    args, k = _port_args(a, ATTN_ORDER, ("wqkv", "wproj"), torch.float32)
    exact, _ = attn_bwd_mirror(*args, k, rnd=False)
    plain = fused_block.fused_attention_block_bwd_plain(*args, k)
    _hold(ATTN_NAMES, exact, plain, 1e-5, "plain, fp32")
    bf = [t.to(torch.bfloat16) if t.dim() != 4 else t for t in args]
    rounded, _ = attn_bwd_mirror(*bf, k, rnd=True)
    plain_bf16 = fused_block.fused_attention_block_bwd_plain(*bf, k)
    _hold(ATTN_NAMES, rounded, plain_bf16, BOUND, "plain, bf16")
    assert not rounded[-1][1:].any()          # the bias cotangent in group 0


def test_attention_bwd_mirror_matches_jax_interpret(rng):
    """Against JAX's resident backward kernel in interpret mode (two grid
    cells of one window pair) on the same inputs, weights in JAX layout."""
    a = _attn_inputs(rng, 4, 16, 32, 2, 2, True)
    args, k = _port_args(a, ATTN_ORDER, ("wqkv", "wproj"), torch.bfloat16)
    got, _ = attn_bwd_mirror(*args, k, rnd=True)
    j = jnp.asarray
    want = jblock._bwd_impl_pallas(
        j(a["x"], jnp.bfloat16), j(a["gamma"]), j(a["beta"]), j(a["wqkv"]),
        j(a["bqkv"]), j(a["wproj"]), j(a["bias"]), j(a["keep"]),
        j(a["dy"], jnp.bfloat16), 1, EPS, True)
    dx, dg, db, dwqkv, dbqkv, dwp, dbp, dbias = (np.asarray(o, np.float32)
                                                 for o in want[:8])
    _hold(ATTN_NAMES, got,
          [dx, dg, db, dwqkv.T, dbqkv, dwp.T, dbp, dbias], BOUND,
          "JAX _bwd_impl_pallas, interpret mode")


def test_dbqkv_sums_the_unrounded_dq_dk_dv(rng):
    """The resident kernel sums dq | dk | dv before their bf16 rounding (the
    JAX kernel's fused_block.py:415); the spill variant sums the rounded
    ones.  The mirror's fixed-order dbqkv equals the row sum of its fp32
    dqkv to fp32 order, much closer than the sum of the rounded dqkv is."""
    a = _attn_inputs(rng, 6, 49, 32, 2, 1, False)
    args, k = _port_args(a, ATTN_ORDER, ("wqkv", "wproj"), torch.bfloat16)
    got, dqkv32 = attn_bwd_mirror(*args, k, rnd=True)
    dbqkv = got[4]
    unrounded = dqkv32.double().sum(0)
    rounded = _bf(dqkv32, True).double().sum(0)
    err = float((dbqkv.double() - unrounded).abs().max())
    gap = float((rounded - unrounded).abs().max())
    assert err <= 1e-5 * float(unrounded.abs().max())
    assert err < 0.05 * gap
    plain = fused_block.fused_attention_block_bwd_plain(*args, k)[4]
    assert _rel(dbqkv.numpy(), plain.numpy()) <= BOUND


def _mlp_inputs(rng, t, c, keep):
    bfv = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
    return dict(
        x=bfv(rng.normal(size=(t, c))), dy=bfv(rng.normal(size=(t, c))),
        gamma=(rng.normal(size=c) * 0.1 + 1).astype(np.float32),
        beta=(rng.normal(size=c) * 0.1).astype(np.float32),
        w1=(rng.normal(size=(c, 4 * c)) / np.sqrt(c)).astype(np.float32),
        b1=(rng.normal(size=4 * c) * 0.1).astype(np.float32),
        w2=(rng.normal(size=(4 * c, c)) / np.sqrt(4 * c)).astype(np.float32),
        keep=(((rng.random(t) > 0.3) / 0.7).astype(np.float32)
              if keep else None))


MLP_ORDER = ("x", "dy", "gamma", "beta", "w1", "b1", "w2")
MLP_NAMES = ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2")


@pytest.mark.parametrize("t,keep", [(300, True), (128, False), (1100, False)],
                         ids=["ragged-keep", "one-tile", "34-ln-blocks"])
def test_mlp_bwd_mirror_matches_plain(rng, t, keep):
    """C = 32, HID = 128: the dual product in two 64-wide column tiles, T =
    300 a partial 128-row tile and a partial LayerNorm block; T = 1100 puts
    35 LayerNorm-backward partial rows through two levels of the sum."""
    a = _mlp_inputs(rng, t, 32, keep)
    args, k = _port_args(a, MLP_ORDER, ("w1", "w2"), torch.float32)
    exact = mlp_bwd_mirror(*args, k, rnd=False)
    plain = block_mlp.fused_ln_mlp_residual_bwd_plain(*args, k)
    _hold(MLP_NAMES, exact, plain, 1e-5, "plain, fp32")
    bf = [x.to(torch.bfloat16) for x in args]
    rounded = mlp_bwd_mirror(*bf, k, rnd=True)
    plain_bf16 = block_mlp.fused_ln_mlp_residual_bwd_plain(*bf, k)
    _hold(MLP_NAMES, rounded, plain_bf16, BOUND, "plain, bf16")


@pytest.mark.parametrize("keep", [False, True], ids=["nokeep", "keep"])
def test_mlp_bwd_mirror_matches_jax_interpret(rng, keep):
    """Against JAX's MLP backward kernel in interpret mode, two grid cells of
    128 tokens, on the same inputs, weights in JAX layout."""
    a = _mlp_inputs(rng, 256, 32, keep)
    args, k = _port_args(a, MLP_ORDER, ("w1", "w2"), torch.bfloat16)
    got = mlp_bwd_mirror(*args, k, rnd=True)
    j = jnp.asarray
    want = jmlp._bwd_impl_pallas(
        j(a["x"], jnp.bfloat16), j(a["gamma"]), j(a["beta"]), j(a["w1"]),
        j(a["b1"]), j(a["w2"]), jnp.zeros(32), None if k is None
        else j(a["keep"]), j(a["dy"], jnp.bfloat16), 128, EPS, True)
    dx, dg, db, dw1, db1, dw2, db2 = (np.asarray(o, np.float32)
                                      for o in want[:7])
    _hold(MLP_NAMES, got,
          [dx, dg, db, dw1.T, db1, dw2.T, db2], BOUND,
          "JAX _bwd_impl_pallas, interpret mode")
