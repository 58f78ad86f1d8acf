"""The Hopper design of kernels 8-10 (csrc/window_attention.cu) written out in
PyTorch, against the plain version and the JAX package.

A CUDA kernel cannot run here, so what it computes is mirrored step by step:
  * the launch plan (`window_attention.launch_plan`, which the wrappers
    use): every (window, head) unit taken exactly once, every unit of a block
    on that block's bias rows, at least 2 blocks per SM of an H100 at every
    Swin stage of a 64-face pack for each entry point, shared memory within a
    Hopper block's 227 KB, ring slots reused in order;
  * the shared-memory layout: every lane address of the fragment loads and
    output stores lands on its element under the TMA's swizzle, with no bank
    conflict, where dense rows without it would conflict;
  * one block's walk: the bias fragment built once with -inf past N, then
    the units in ring order through zero-padded 64-row tiles, with the
    kernel's rounding points (P and the output in bf16), held against
    window_attention_plain, JAX's `_reference` and its Pallas kernel in
    interpret mode at the kernels' 2e-2 bound.
tests/test_torch_gpu.py holds the kernel itself against the plain version on
the card.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facialmmt_tpu.ops.pallas import window_attention as jwa
from facialmmt_tpu_torch.ops.kernels import window_attention as wa

T = torch.from_numpy
KERNEL_BOUND = 2e-2
SMS = 132             # H100 SXM
SMEM_OPTIN = 232448   # bytes a Hopper block can use
BANKS = 32            # 4-byte shared-memory banks
LOG2E = 1.4426950408889634
# The Swin-tiny stages of a 64-face pack: (W, heads, nW) for the shifted
# blocks' bias and the unshifted blocks' (nW = 1); stage 3 has one window a
# face.
STAGE_SHAPES = [(4096, 3, 64), (4096, 3, 1), (1024, 6, 16), (1024, 6, 1),
                (256, 12, 4), (256, 12, 1), (64, 24, 1)]
ENTRY_CONC = {"fused": lambda w, nw: 1, "paired": lambda w, nw: 2,
              "v2": lambda w, nw: wa._group_size(w, nw, 4)}


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def block_walk(plan, nw, b):
    """csrc/window_attention.cu's decode of block b: its head, and for each
    window slot its bias row and the windows of its walk in order."""
    head, rest = b % plan.heads, b // plan.heads
    f0 = (rest // plan.row_groups) * plan.chunk
    units = min(plan.chunk, plan.faces - f0)
    slots = []
    for g in range(plan.conc):
        row = (rest % plan.row_groups) * plan.conc + g
        slots.append((row % nw, [(f0 + i) * plan.per_face + row
                                 for i in range(units)]))
    return head, slots


def _plans():
    for w, h, nw in STAGE_SHAPES:
        for entry, conc in ENTRY_CONC.items():
            yield (f"{entry}-W{w}-nW{nw}", w, h, nw,
                   wa.launch_plan(w, h, 32, nw, conc(w, nw), SMS))


PLANS = list(_plans())


@pytest.mark.parametrize("label,w,h,nw,plan", PLANS, ids=[p[0] for p in PLANS])
def test_plan_covers_every_unit_once_on_its_bias_rows(label, w, h, nw, plan):
    assert plan.blocks >= 2 * SMS        # at least 2 blocks per SM
    taken = np.zeros((w, h), np.int64)
    for b in range(plan.blocks):
        head, slots = block_walk(plan, nw, b)
        for bias_row, windows in slots:
            assert windows and all(x % nw == bias_row for x in windows)
            np.add.at(taken[:, head], windows, 1)
    assert (taken == 1).all()


@pytest.mark.parametrize("hd", wa.HEAD_DIMS)
def test_plan_fits_shared_memory(hd):
    for conc in range(1, wa.MAX_SIDE_BY_SIDE + 1):
        stages = wa.ring_stages(hd, conc)
        smem = wa.launch_plan(4 * conc, 1, hd, 1, conc, SMS).smem
        tiles = conc * stages * 3 * 64 * 2 * hd
        assert stages >= 2 and smem <= SMEM_OPTIN
        assert smem == 1024 + tiles + 8 * conc * stages
        assert (stages == wa.MAX_STAGES) == (
            wa.smem_bytes(hd, conc, wa.MAX_STAGES) <= SMEM_OPTIN)
    # a chunk that does not divide the faces leaves a short last one
    plan = wa.launch_plan(28, 3, hd, 4, 1, SMS, chunk=3)
    assert (plan.faces, plan.chunks, plan.blocks) == (7, 3, 36)


def ring_events(units, stages):
    """The order of csrc/window_attention.cu's walk for one window slot:
    ("issue", unit, slot) and ("wait", unit, slot, parity); a slot is
    refilled only after the barrier that ends the unit it held."""
    events = [("issue", i, i % stages) for i in range(min(stages, units))]
    for i in range(units):
        events.append(("wait", i, i % stages, (i // stages) & 1))
        events.append(("done", i, i % stages))
        if i + stages < units:
            events.append(("issue", i + stages, (i + stages) % stages))
    return events


@pytest.mark.parametrize("units,stages", [(1, 3), (2, 3), (7, 3), (32, 3),
                                          (5, 2)])
def test_ring_slots_are_reused_in_order(units, stages):
    held = {}                   # slot -> unit in it, until that unit is done
    filled = [0] * stages       # completed phases of each slot's mbarrier
    for ev in ring_events(units, stages):
        kind, unit, slot = ev[:3]
        if kind == "issue":
            assert slot not in held, "refilled before its unit was done"
            held[slot] = unit
            filled[slot] += 1
        elif kind == "wait":
            # the k-th wait on a slot passes parity k & 1, once the slot's
            # k-th fill has landed, and it holds this unit
            assert held[slot] == unit and ev[3] == (filled[slot] - 1) & 1
        else:
            assert held.pop(slot) == unit
    assert not held and sum(filled) == units


def tile_offset(hd, r, c):
    """Where element c (even) of row r of a tile lies, in bytes: dense rows
    of rb = 2 hd bytes whose 16-byte piece j the TMA's swizzle stores at
    j ^ ((r / (128 / rb)) % (rb / 16))."""
    rb = 2 * hd
    piece = ((c >> 3) ^ (r // (128 // rb))) & (rb // 16 - 1)
    return r * rb + (piece << 4) + 2 * (c & 7)


def row_off(hd, r):
    """csrc/window_attention.cu's Tile::row_off: row r with its swizzle
    folded in."""
    rb = 2 * hd
    return r * rb + (((r // (128 // rb)) & (rb // 16 - 1)) << 4)


def piece(off, p):
    """Tile::piece: the same row's piece p, one XOR."""
    return off ^ (p << 4)


def lane_addresses(hd):
    """The kernel's shared-memory accesses of one warp, as (what, expected
    (row, column) per lane, byte offset per lane, bytes a lane), from its
    lane offsets: the q A fragment, the k and v B fragments (ldmatrix x4,
    8 lanes a matrix) and the 4-byte output pairs."""
    rb = 2 * hd
    lanes = range(32)
    for r0 in range(0, 64, 16):
        qa = [piece(row_off(hd, r0 + l % 16), l // 16) for l in lanes]
        for ks in range(hd // 16):
            yield ("q", [(r0 + l % 16, 16 * ks + 8 * (l // 16)) for l in lanes],
                   [piece(o, 2 * ks) for o in qa], 16)
        oo = [row_off(hd, r0 + l // 4) + 4 * (l % 4) for l in lanes]
        for jn in range(hd // 8):
            for half in (0, 8):
                yield ("out", [(r0 + half + l // 4, 8 * jn + 2 * (l % 4))
                               for l in lanes],
                       [piece(o, jn) + half * rb for o in oo], 4)
    kb = [piece(row_off(hd, l % 8 + 8 * (l // 16)), l // 8 % 2) for l in lanes]
    vb = [piece(row_off(hd, l % 16), l // 16) for l in lanes]
    for blk in range(4):
        for ks in range(hd // 16):
            yield ("k", [(16 * blk + l % 8 + 8 * (l // 16),
                          16 * ks + 8 * (l // 8 % 2)) for l in lanes],
                   [piece(o, 2 * ks) + 16 * blk * rb for o in kb], 16)
        for jn in range(0, hd // 8, 2):
            yield ("v", [(16 * blk + l % 16, 8 * (jn + l // 16)) for l in lanes],
                   [piece(o, jn) + 16 * blk * rb for o in vb], 16)


def _banks(offsets, width):
    """Bank conflicts of one shared-memory access: the most distinct 4-byte
    words that fall on one of the 32 banks."""
    words = {}
    for off in offsets:
        for b in range(off // 4, (off + width) // 4):
            words.setdefault(b % BANKS, set()).add(b)
    return max(len(s) for s in words.values())


@pytest.mark.parametrize("hd", wa.HEAD_DIMS)
def test_lane_addresses_hit_their_elements_without_bank_conflicts(hd):
    rb = 2 * hd
    for r in range(64):     # the swizzle keeps every row's pieces a permutation
        assert sorted(tile_offset(hd, r, 8 * j) - r * rb
                      for j in range(hd // 8)) == list(range(0, rb, 16))
    for what, cells, offsets, width in lane_addresses(hd):
        assert offsets == [tile_offset(hd, r, c) for r, c in cells], what
        # ldmatrix serves 8 lanes' 16-byte rows a phase, a 4-byte access
        # all 32 lanes at once
        phases = 8 if width == 16 else 32
        for p in range(0, 32, phases):
            assert _banks(offsets[p:p + phases], width) == 1, what
    # dense rows without the swizzle: the conflicts it avoids
    dense = [r * 2 * hd + 4 * tig for r in range(8) for tig in range(4)]
    assert _banks(dense, 4) == {16: 2, 32: 4, 64: 8}[hd]


def bias_fragment(bias_row, n):
    """The 64 x 64 bias a slot's 4 warps hold in registers: its bf16 values,
    -inf at keys and rows past N."""
    frag = torch.full((64, 64), -math.inf)
    frag[:n, :n] = bias_row.to(torch.bfloat16).float()
    return frag


def unit_pass(qt, kt, vt, frag, n):
    """One unit on the tiles of its ring slot, as each warp computes it: fp32
    scores + bias, max over the keys (0 for a padded row), exp(s - m) as
    2^(s log2(e) - m log2(e)), sum, the probabilities rounded to bf16 before
    P v, the output rounded once."""
    s = qt @ kt.T + frag
    m = s.amax(-1, keepdim=True)
    real = (torch.arange(64) < n)[:, None]
    m = torch.where(real, m, torch.zeros_like(m))
    e = torch.exp2(s * LOG2E - m * LOG2E)
    inv = torch.where(real, 1.0 / e.sum(-1, keepdim=True), torch.zeros_like(m))
    p = (e * inv).to(torch.bfloat16).float()
    return (p @ vt).to(torch.bfloat16).float()


def mirror_launch(q, k, v, bias, conc, chunk=0):
    """Every block of the launch plan, walked as the kernel walks it; q, k, v
    bf16-valued fp32 (W, h, N, hd), bias fp32.  Returns out (W, h, N, hd)."""
    w, h, n, hd = q.shape
    nw = bias.shape[0]
    plan = wa.launch_plan(w, h, hd, nw, conc, SMS, chunk)
    out = torch.full_like(q, math.nan)
    for b in range(plan.blocks):
        head, slots = block_walk(plan, nw, b)
        for bias_row, windows in slots:
            frag = bias_fragment(bias[bias_row, head], n)      # once a block
            ring = torch.zeros(plan.stages, 3, 64, hd)         # rows N.. stay 0
            for i, win in enumerate(windows):
                slot = ring[i % plan.stages]
                for t, src in enumerate((q, k, v)):
                    slot[t, :n] = src[win, head]               # the bulk copy
                o = unit_pass(slot[0], slot[1], slot[2], frag, n)
                slot[0] = o                      # staged in the slot's q rows
                out[win, head] = slot[0, :n]
    return out


def _inputs(rng, w, h, n, hd, nw):
    bf = lambda a: torch.tensor(a, dtype=torch.float32).to(
        torch.bfloat16).float()
    bias = rng.normal(size=(nw, h, n, n))
    if nw > 1:
        bias += np.where(rng.random((nw, 1, n, n)) > 0.7, -100.0, 0.0)
    return (bf(rng.normal(size=(w, h, n, hd)) * hd ** -0.5),
            bf(rng.normal(size=(w, h, n, hd))),
            bf(rng.normal(size=(w, h, n, hd))),
            torch.tensor(bias, dtype=torch.float32))


@pytest.mark.parametrize("hd", [16, 32])
@pytest.mark.parametrize("n", [49, 16])
@pytest.mark.parametrize("nw", [4, 1])
def test_block_walk_matches_plain_and_jax(rng, nw, n, hd):
    q, k, v, bias = _inputs(rng, 8, 2, n, hd, nw)
    got = mirror_launch(q, k, v, bias, 1, chunk=1 if nw > 1 else 3)
    assert torch.isfinite(got).all()
    plain = wa.window_attention_plain(q, k, v, bias)
    assert _rel(got, plain) <= KERNEL_BOUND
    arrays = [a.numpy() for a in (q, k, v)]
    rounded = jnp.asarray(bias.numpy()).astype(jnp.bfloat16)
    assert _rel(got, jwa._reference(*arrays, rounded.astype(jnp.float32))) \
        <= KERNEL_BOUND
    assert _rel(got, jwa.fused_window_attention(*arrays, bias.numpy(), 2,
                                                True)) <= KERNEL_BOUND


def test_block_walk_is_the_same_for_every_tiling(rng):
    """Windows side by side and the chunk (a short last one included) change
    no arithmetic: every tiling gives the same bits, as the card test of the
    kernel holds."""
    q, k, v, bias = _inputs(rng, 24, 2, 49, 32, 4)
    base = mirror_launch(q, k, v, bias, 1)
    for conc, chunk in ((1, 4), (1, 5), (2, 0), (4, 0), (4, 5)):
        assert torch.equal(mirror_launch(q, k, v, bias, conc, chunk), base)


# --- the fp32 instantiation (the model under --compute_dtype float32) ---


@pytest.mark.parametrize("hd", wa.HEAD_DIMS)
def test_fp32_plan_fits_shared_memory(hd):
    """fp32 tiles are twice as large: the ring takes the most stages (3 at
    most, down to 1) that fit a Hopper block, for every head dim and
    windows side by side the wrappers accept."""
    for conc in range(1, wa.MAX_SIDE_BY_SIDE + 1):
        stages = wa.ring_stages(hd, conc, 4)
        smem = wa.launch_plan(4 * conc, 1, hd, 1, conc, SMS, elem=4).smem
        assert 1 <= stages <= wa.MAX_STAGES and smem <= SMEM_OPTIN
        assert smem == 1024 + conc * stages * (3 * 64 * 4 * hd + 8)
        assert stages == wa.MAX_STAGES or \
            wa.smem_bytes(hd, conc, stages + 1, 4) > SMEM_OPTIN
    # Swin's head dim: three stages up to 3 windows, two at 4
    assert [wa.ring_stages(32, c, 4) for c in range(1, 5)] == [3, 3, 3, 2]
    # bf16 keeps its rings
    assert [wa.ring_stages(64, c) for c in range(1, 5)] == [3, 3, 3, 2]


def f32_row_off(hd, r):
    """Tile::row_off for fp32 rows of rb = 4 hd bytes: the swizzle of the
    row's width, none for 256-byte rows (hd 64)."""
    rb = 4 * hd
    if rb > 128:
        return r * rb
    return r * rb + (((r // (128 // rb)) & (rb // 16 - 1)) << 4)


def f32_tile(hd, values):
    """A tile in shared memory as the TMA leaves it: {byte offset: value}
    for the 64 x hd fp32 `values` (piece j of row r at piece j ^ sw(r))."""
    return {piece(f32_row_off(hd, r), c // 4) + 4 * (c % 4): values[r, c]
            for r in range(64) for c in range(hd)}


def ldmatrix_x4(mem, addresses):
    """ldmatrix .x4 .b16 on 32-bit elements: lanes 8i..8i+7 pass the rows of
    matrix i, and lane l receives 32-bit word l % 4 of row l / 4 of each."""
    return [[mem[addresses[8 * i + l // 4] + 4 * (l % 4)] for i in range(4)]
            for l in range(32)]


def mma_1688(c, a, b):
    """mma.sync m16n8k8 (tf32, no rounding here) from the lanes' registers:
    a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4], a3 = A[g+8][t+4];
    b0 = B[t][g], b1 = B[t+4][g]; c += D[g][2t, 2t+1], D[g+8][2t, 2t+1]."""
    A, B = np.zeros((16, 8)), np.zeros((8, 8))
    for l in range(32):
        g, t = divmod(l, 4)
        A[g, t], A[g + 8, t], A[g, t + 4], A[g + 8, t + 4] = a[l]
        B[t, g], B[t + 4, g] = b[l]
    D = A @ B
    for l in range(32):
        g, t = divmod(l, 4)
        c[l] = [c[l][0] + D[g, 2 * t], c[l][1] + D[g, 2 * t + 1],
                c[l][2] + D[g + 8, 2 * t], c[l][3] + D[g + 8, 2 * t + 1]]


@pytest.mark.parametrize("hd", wa.HEAD_DIMS)
def test_fp32_fragments_compute_the_unit(rng, hd):
    """One warp's work on fp32 tiles, register by register, as
    csrc/window_attention.cu's fp32 instantiation addresses it: q A and k B
    fragments by ldmatrix from the bf16 lane offsets, the scores, P v with
    P's A fragment the score registers relabelled (s0, s2, s1, s3) and v's
    B fragment by 32-bit loads at the lane's two row offsets, the output
    pairs into the warp's q rows and out through the 16-byte row copy: the
    tile's S = q k^T and S v, exactly (no rounding in the emulation)."""
    n, rows = 49, 64
    q, k, v = (np.zeros((rows, hd)) for _ in range(3))
    for t in (q, k, v):
        t[:n] = rng.normal(size=(n, hd))
    mem_q, mem_k, mem_v = f32_tile(hd, q), f32_tile(hd, k), f32_tile(hd, v)
    rb = 4 * hd
    lanes = range(32)
    kbo = [piece(f32_row_off(hd, l % 8 + 8 * (l // 16)), l // 8 % 2)
           for l in lanes]
    vo0 = [piece(f32_row_off(hd, 2 * (l % 4)), l // 4 // 4) + 4 * (l // 4 % 4)
           for l in lanes]
    vo1 = [piece(f32_row_off(hd, 2 * (l % 4) + 1), l // 4 // 4)
           + 4 * (l // 4 % 4) for l in lanes]
    out = np.full((rows, hd), np.nan)
    for r0 in range(0, n, 16):
        qa = [piece(f32_row_off(hd, r0 + l % 16), l // 16) for l in lanes]
        sc = [[[0.0] * 4 for _ in lanes] for _ in range(8)]
        for ks in range(hd // 8):
            a = ldmatrix_x4(mem_q, [piece(o, 2 * ks) for o in qa])
            for jj in range(4):
                b = ldmatrix_x4(mem_k, [piece(o, 2 * ks) + 16 * jj * rb
                                        for o in kbo])
                mma_1688(sc[2 * jj], a, [x[:2] for x in b])
                mma_1688(sc[2 * jj + 1], a, [x[2:] for x in b])
        s = np.zeros((16, rows))
        for j in range(8):
            for l in lanes:
                g, t = divmod(l, 4)
                s[g, 8 * j + 2 * t:8 * j + 2 * t + 2] = sc[j][l][:2]
                s[g + 8, 8 * j + 2 * t:8 * j + 2 * t + 2] = sc[j][l][2:]
        np.testing.assert_allclose(s, q[r0:r0 + 16] @ k.T, rtol=1e-12,
                                   atol=1e-12)
        # P v with the scores as P: any matrix checks the indexing
        oc = [[[0.0] * 4 for _ in lanes] for _ in range(hd // 8)]
        for j in range(8):
            pa = [[sc[j][l][0], sc[j][l][2], sc[j][l][1], sc[j][l][3]]
                  for l in lanes]
            for jn in range(hd // 8):
                b = [[mem_v[(vo0[l] ^ (2 * jn << 4)) + 8 * j * rb],
                      mem_v[(vo1[l] ^ (2 * jn << 4)) + 8 * j * rb]]
                     for l in lanes]
                mma_1688(oc[jn], pa, b)
        oo32 = [piece(f32_row_off(hd, r0 + l // 4), l % 4 // 2)
                + 8 * (l % 4 % 2) for l in lanes]
        for jn in range(hd // 8):
            for l in lanes:
                at = oo32[l] ^ (2 * jn << 4)
                for e, off in enumerate((at, at + 4, at + 8 * rb,
                                         at + 8 * rb + 4)):
                    mem_q[off] = oc[jn][l][e]
        for r in range(r0, min(r0 + 16, n)):
            for p in range(rb // 16):
                base = piece(f32_row_off(hd, r), p)
                out[r, 4 * p:4 * p + 4] = [mem_q[base + 4 * i]
                                           for i in range(4)]
    np.testing.assert_allclose(out[:n], (q @ k.T @ v)[:n], rtol=1e-10,
                               atol=1e-10)


@pytest.mark.parametrize("hd,conflicts", [(16, 2), (32, 1), (64, 4)])
def test_fp32_lane_addresses_bank_conflicts(hd, conflicts):
    """At Swin's head dim (32: 128-byte rows under the 128-byte swizzle)
    the fp32 fragment loads are free of bank conflicts: ldmatrix's 8-lane
    phases and the 32 lanes' 4-byte v loads; hd 16 (64-byte rows) and
    unswizzled hd 64 have a few on the v loads."""
    lanes = range(32)
    worst = 1
    for r0 in range(0, 64, 16):
        qa = [piece(f32_row_off(hd, r0 + l % 16), l // 16) for l in lanes]
        for ks in range(hd // 8):
            offs = [piece(o, 2 * ks) for o in qa]
            for p in range(0, 32, 8):
                assert _banks(offs[p:p + 8], 16) == (1 if hd < 64 else 8)
    for jn in range(hd // 8):
        for row in (0, 1):
            offs = [(piece(f32_row_off(hd, 2 * (l % 4) + row), l // 16)
                     + 4 * (l // 4 % 4)) ^ (2 * jn << 4) for l in lanes]
            worst = max(worst, _banks(offs, 4))
    assert worst == conflicts
