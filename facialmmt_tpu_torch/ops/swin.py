"""Swin-tiny backbone (counterpart of facialmmt_tpu/ops/swin.py; reference
modules/SwinTransformer/Swin_Transformer.py).

Window-resident layout: each stage partitions its tokens into windows once;
every block works on (B, H*W, C) rows in window layout, and a shifted block's
cyclic shift + re-partition is one static row gather before the attention
half and its inverse after it.  Patch embedding is a patch matmul; the head
is LN -> flatten -> Linear -> BatchNorm1d.

SwinConfig's three implementation fields choose the route (every route
computes the same function; a value outside the sets below raises ValueError
when the module is built):
  attention_impl  'auto'   the block's attention half in one kernel with its
                           backward kernels (ops/kernels/fused_block.py);
                  'xla'    plain LN1 -> qkv -> per-head attention with fp32
                           scores -> proj, torch autograd;
                  'pallas' that composition, the attention core on
                           ops/kernels/window_attention.py::
                           fused_window_attention;
                  'pair'   the same on paired_window_attention where the
                           window count is even and the shift mask's group
                           count even or 1, on fused_window_attention
                           elsewhere (the last stage at an odd face count);
  mlp_impl        'auto', 'pallas'  the MLP half in one kernel with its
                           backward kernel (ops/kernels/block_mlp.py);
                  'xla'    plain LN2 -> fc1 -> exact GELU -> fc2;
  merge_impl      'raster' window_reverse -> strided 2x2 concat ->
                           window_partition around each PatchMerging;
                  'window' one index_select from a stage's window layout into
                           the next one's (merge_gather_index);
                  'auto'   MERGE_AUTO.
Each field selects its own half; none overrides another.

Train mode (module.train()): stochastic depth draws one multiplier per image
and block half (0 with probability rate, else 1/keep_prob) from a
torch.Generator, handed to the kernels as `keep` or multiplied in on the plain
routes; the head's BatchNorm normalises with batch statistics and updates its
running statistics in place.  drop_rate / attn_drop_rate > 0 draw from the
same generator.  The kernels carry drop-path only, so a training forward
follows the JAX package's per-half rule (facialmmt_tpu/ops/swin.py
SwinBlock / WindowAttention): either rate above 0 sends an 'auto' attention
half to the plain composition with the 'xla' core, attn_drop_rate above 0
sends a 'pallas' / 'pair' core to the 'xla' core, and drop_rate above 0
sends an 'auto' / 'pallas' MLP half to the plain one.  In eval dropout is the
identity and every half keeps its route.

Remat: when resolve_remat(cfg.remat, images, 512) holds and a graph is being
built, each block runs under torch.utils.checkpoint
(ops/layers.py::checkpointed; JAX: nn.remat on each block above 512 packed
images): the drop-path multipliers are drawn before it and passed in, and
the recompute in the backward runs the block's forward kernels a second
time.  Under a data shard (parallel/context.py) the head's BatchNorm takes
the statistics of the global batch (sums over the data ranks).

Parameter and buffer names follow the reference state_dict
(torch_export.export_swin_backbone), including the persistent
`relative_position_index` and, on shifted blocks, `attn_mask` buffers.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from facialmmt_tpu_torch.config import SwinConfig, resolve_remat
from facialmmt_tpu_torch.ops.kernels.block_mlp import fused_ln_mlp_residual
from facialmmt_tpu_torch.ops.kernels.fused_block import fused_attention_block
from facialmmt_tpu_torch.ops.kernels.window_attention import (
    fused_window_attention, paired_window_attention)
from facialmmt_tpu_torch.ops.layers import checkpointed, dropout, gelu_erf
from facialmmt_tpu_torch.parallel import context

ATTENTION_IMPLS = ("xla", "pallas", "pair", "auto")
MLP_IMPLS = ("xla", "pallas", "auto")
MERGE_IMPLS = ("raster", "window", "auto")
# What merge_impl='auto' resolves to.  Timed by chip_smoke.py on the three
# stage transitions of a 64-face Swin-tiny pack in bf16, six runs (NVIDIA H100
# 80GB HBM3, 700.00 W): window layout 0.56-0.71 ms forward and 1.5-4.2 ms
# forward + backward, raster layout 0.76-1.00 and 2.8-7.0 ms, the window layout
# faster in every run; the whole forward is 0.1 to 0.5 ms shorter of 22 ms.
# The rows are the same, so no result changes.
MERGE_AUTO = "window"


def _check_impl(field: str, value, allowed) -> None:
    if value not in allowed:
        raise ValueError(f"SwinConfig.{field}={value!r}: expected one of "
                         f"{allowed}")


def relative_position_index(window_size: int) -> np.ndarray:
    """(ws*ws, ws*ws) indices into the (2ws-1)^2 relative-position table."""
    ws = window_size
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def shifted_window_mask(h: int, w: int, window_size: int,
                        shift: int) -> np.ndarray:
    """(num_windows, N, N) additive SW-MSA mask, -100 on cross-region pairs."""
    img = np.zeros((h, w))
    cnt = 0
    spans = (slice(0, -window_size), slice(-window_size, -shift),
             slice(-shift, None))
    for hs in spans:
        for ws_ in spans:
            img[hs, ws_] = cnt
            cnt += 1
    win = img.reshape(h // window_size, window_size, w // window_size,
                      window_size).transpose(0, 2, 1, 3)
    win = win.reshape(-1, window_size * window_size)
    mask = win[:, None, :] - win[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


def sample_drop_path_keep(b: int, rate: float, generator, device):
    """(b,) fp32 stochastic-depth multipliers, timm DropPath semantics: 0 with
    probability `rate`, else 1 / (1 - rate)."""
    keep_prob = 1.0 - rate
    mask = context.rand((b,), generator, device) < keep_prob
    return mask.float() / keep_prob


def window_partition(x, ws: int):
    """(B, H, W, C) -> (B*nW, ws*ws, C), windows faces-major."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_reverse(windows, ws: int, h: int, w: int):
    """(B*nW, ws*ws, C) -> (B, H, W, C)."""
    c = windows.shape[-1]
    b = windows.shape[0] // (h * w // ws // ws)
    x = windows.reshape(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


def _window_layout_index(h: int, w: int, ws: int) -> np.ndarray:
    i, j = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    return ((i // ws) * (w // ws) + (j // ws)) * (ws * ws) + (i % ws) * ws + j % ws


def merge_gather_index(sh: int, sw: int, ws_s: int, ws_n: int) -> np.ndarray:
    """(L/4, 4) row map of window-resident patch merging: row j of the NEXT
    stage's window layout (windows of ws_n) concatenates rows [g0, g1, g2, g3]
    of the CURRENT stage's window layout (windows of ws_s) in the reference's
    x0, x1, x2, x3 order.  One gather in place of window_reverse + strided
    slices + window_partition."""
    nh, nw = sh // 2, sw // 2
    cur = _window_layout_index(sh, sw, ws_s).flatten()   # raster -> row
    nxt = _window_layout_index(nh, nw, ws_n).flatten()   # merged raster -> row
    raster_of_next = np.empty(nh * nw, np.int64)
    raster_of_next[nxt] = np.arange(nh * nw)
    rows, cols = np.divmod(raster_of_next, nw)
    out = np.empty((nh * nw, 4), np.int64)
    for t, (dr, dc) in enumerate(((0, 0), (1, 0), (0, 1), (1, 1))):
        out[:, t] = cur[(2 * rows + dr) * sw + (2 * cols + dc)]
    return out


def shifted_window_perms(h: int, w: int, ws: int,
                         shift: int) -> tuple[np.ndarray, np.ndarray]:
    """Row permutations of the window layout that realise roll(-shift) +
    re-partition (x_shifted = x[perm]) and its inverse (x = x_shifted[inv])."""
    base = _window_layout_index(h, w, ws)
    i, j = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    perm = np.zeros(h * w, np.int64)
    perm[base] = base[(i + shift) % h, (j + shift) % w]
    inv = np.zeros_like(perm)
    inv[perm] = np.arange(h * w)
    return perm, inv


class WindowAttention(nn.Module):
    """W-MSA with relative position bias; holds the attention half's
    parameters under the reference's names.  The 'auto' route reads them from
    SwinBlock and never calls forward."""

    def __init__(self, dim: int, window_size: int, eff_window: int,
                 num_heads: int, qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * window_size - 1) ** 2, num_heads))
        nn.init.trunc_normal_(self.relative_position_bias_table, std=0.02)
        self.register_buffer("relative_position_index",
                             torch.from_numpy(relative_position_index(eff_window)))
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def relative_bias(self):
        """(h, N, N) fp32 relative-position bias."""
        n = self.relative_position_index.shape[0]
        idx = self.relative_position_index.reshape(-1)
        bias = self.relative_position_bias_table.float()[idx]
        return bias.reshape(n, n, self.num_heads).permute(2, 0, 1)

    def forward(self, x, mask=None, impl: str = "xla", *,
                attn_drop: float = 0.0, proj_drop: float = 0.0,
                generator: torch.Generator | None = None):
        """x (W, N, C) normalised window rows; mask (nW, N, N) additive or
        None.  impl 'pallas' / 'pair' put the attention core on its kernel
        ('pair' where W is even and nW even or 1; windows that do not pair
        go one to a block through fused_window_attention), 'xla' on per-head
        slices of the packed qkv with fp32 scores."""
        w, n, c = x.shape
        nh = self.num_heads
        hd = c // nh
        scale = hd ** -0.5
        qkv = self.qkv(x)
        rel = self.relative_bias()
        nw = 1 if mask is None else mask.shape[0]
        if impl == "pair" and (w % 2 or (nw > 1 and nw % 2)):
            impl = "pallas"
        if impl in ("pallas", "pair") and self.training and attn_drop > 0.0:
            impl = "xla"      # the window kernels carry no dropout
        if impl in ("pallas", "pair"):
            # the kernels take (W, h, N, hd); the transposes are copies here
            q, k, v = qkv.reshape(w, n, 3, nh, hd).permute(2, 0, 3, 1, 4)
            bias = rel[None] if mask is None else rel[None] + mask.float()[:, None]
            core = (fused_window_attention if impl == "pallas"
                    else paired_window_attention)
            out = core((q * scale).contiguous(), k.contiguous(),
                       v.contiguous(), bias)
            out = out.permute(0, 2, 1, 3).reshape(w, n, c)
        else:
            outs = []
            with torch.autocast(x.device.type, enabled=False):
                for head in range(nh):
                    q, k, v = (qkv[..., i * c + head * hd:i * c + (head + 1) * hd]
                               for i in range(3))
                    s = torch.bmm((q * scale).float(),
                                  k.float().transpose(1, 2)) + rel[head]
                    if mask is not None:
                        s = (s.reshape(w // nw, nw, n, n)
                             + mask.float()).reshape(w, n, n)
                    p = torch.softmax(s, dim=-1).to(qkv.dtype)
                    p = dropout(p, attn_drop, self.training, generator)
                    outs.append(torch.bmm(p, v))
            out = torch.cat(outs, dim=-1)
        return dropout(self.proj(out), proj_drop, self.training, generator)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class SwinBlock(nn.Module):
    """One (S)W-MSA + MLP block over window-layout rows (B, H*W, C)."""

    def __init__(self, dim: int, input_resolution: tuple[int, int],
                 num_heads: int, window_size: int = 7, shift_size: int = 0,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 drop: float = 0.0, attn_drop: float = 0.0,
                 drop_path: float = 0.0):
        super().__init__()
        self.drop, self.attn_drop, self.drop_path = drop, attn_drop, drop_path
        h, w = input_resolution
        ws, shift = window_size, shift_size
        if min(h, w) <= ws:
            ws, shift = min(h, w), 0   # whole-input window (reference :192-195)
        self.dim, self.ws, self.shift = dim, ws, shift
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, window_size, ws, num_heads, qkv_bias)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        if shift > 0:
            self.register_buffer("attn_mask", torch.from_numpy(
                shifted_window_mask(h, w, ws, shift)))
            perm, inv = shifted_window_perms(h, w, ws, shift)
            self.register_buffer("perm", torch.from_numpy(perm), persistent=False)
            self.register_buffer("inv", torch.from_numpy(inv), persistent=False)
        else:
            self.attn_mask = None

    def window_bias(self):
        """(nW, h, N, N) fp32: relative-position bias plus the shift mask."""
        rel = self.attn.relative_bias()[None]
        if self.attn_mask is None:
            return rel.contiguous()
        return (rel + self.attn_mask.float()[:, None]).contiguous()

    def forward(self, x, keep_attn=None, keep_mlp=None,
                attention_impl: str = "auto", mlp_impl: str = "auto",
                generator: torch.Generator | None = None):
        """keep_attn / keep_mlp: optional (B,) per-image stochastic-depth
        multipliers of the two halves.  attention_impl / mlp_impl: the route
        of each half (module docstring); `generator` feeds the dropouts,
        which in a training forward send a half off its kernel as the JAX
        package's rule does (module docstring)."""
        dropping = self.training and (self.drop > 0.0 or self.attn_drop > 0.0)
        if attention_impl == "auto" and not dropping:
            x = self._attention_half_fused(x, keep_attn)
        else:
            x = self._attention_half(
                x, keep_attn, "xla" if attention_impl == "auto"
                else attention_impl, generator)
        if mlp_impl == "xla" or (self.training and self.drop > 0.0):
            return self._mlp_half(x, keep_mlp, generator)
        b, l, c = x.shape
        out = fused_ln_mlp_residual(
            x.reshape(b * l, c).contiguous(), self.norm2.weight,
            self.norm2.bias, self.mlp.fc1.weight, self.mlp.fc1.bias,
            self.mlp.fc2.weight, self.mlp.fc2.bias,
            None if keep_mlp is None else keep_mlp.repeat_interleave(l))
        return out.reshape(b, l, c)

    def _attention_half_fused(self, x, keep):
        """LN1 commutes with the row gather, so a shifted block permutes raw x
        and the residual is added inside the kernel before the inverse."""
        b, l, c = x.shape
        n = self.ws * self.ws
        a = self.attn
        qkv_b = (a.qkv.bias if a.qkv.bias is not None
                 else torch.zeros(3 * c, dtype=x.dtype, device=x.device))
        xp = x[:, self.perm] if self.shift > 0 else x
        y = fused_attention_block(
            xp.reshape(b * (l // n), n, c).contiguous(), self.norm1.weight,
            self.norm1.bias, a.qkv.weight, qkv_b, a.proj.weight, a.proj.bias,
            self.window_bias(),
            None if keep is None else keep.repeat_interleave(l // n))
        x = y.reshape(b, l, c)
        return x[:, self.inv] if self.shift > 0 else x

    def _attention_half(self, x, keep, impl, generator):
        b, l, c = x.shape
        n = self.ws * self.ws
        y = layer_norm(self.norm1, x)
        if self.shift > 0:
            y = y[:, self.perm]
        y = self.attn(y.reshape(b * (l // n), n, c), self.attn_mask, impl,
                      attn_drop=self.attn_drop, proj_drop=self.drop,
                      generator=generator).reshape(b, l, c)
        if self.shift > 0:
            y = y[:, self.inv]
        return x + _drop_path(y, keep)

    def _mlp_half(self, x, keep, generator):
        y = gelu_erf(self.mlp.fc1(layer_norm(self.norm2, x)))
        y = dropout(y, self.drop, self.training, generator)
        y = dropout(self.mlp.fc2(y), self.drop, self.training, generator)
        return x + _drop_path(y, keep)


def _drop_path(y, keep):
    """y (B, L, C) scaled per image by the (B,) multipliers, in y's dtype."""
    return y if keep is None else (y * keep[:, None, None]).to(y.dtype)


class PatchMerging(nn.Module):
    """2x2 concat (x0, x1, x2, x3 order) + LN + Linear(4C -> 2C, no bias).

    layout='raster': the input is (B, H*W, C) raster rows and so is the
    output.  layout='window': the input is the stage's window-layout rows
    (windows of `window_size`) and the output comes out in the NEXT stage's
    window layout (windows of `next_window_size`) through one row gather.  The
    per-row arithmetic is the same, so the two agree exactly up to row order."""

    def __init__(self, input_resolution: tuple[int, int], dim: int,
                 layout: str = "raster", window_size: int = 7,
                 next_window_size: int = 7):
        super().__init__()
        self.input_resolution = input_resolution
        self.layout = layout
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        if layout == "window":
            idx = merge_gather_index(*input_resolution, window_size,
                                     next_window_size)
            self.register_buffer("index", torch.from_numpy(idx.reshape(-1)),
                                 persistent=False)

    def gather(self, x):
        """(B, L, C) -> (B, L/4, 4C): each output row's 2x2 neighbourhood."""
        h, w = self.input_resolution
        b, l, c = x.shape
        if self.layout == "window":
            return x.index_select(1, self.index).reshape(b, l // 4, 4 * c)
        x = x.reshape(b, h, w, c)
        return torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                          x[:, 1::2, 1::2]], dim=-1).reshape(b, l // 4, 4 * c)

    def forward(self, x):
        return self.reduction(layer_norm(self.norm, self.gather(x)))


class PatchEmbed(nn.Module):
    """p x p stride-p patchify as one patch matmul, + optional LN.  The weight
    keeps the reference's Conv2d layout (E, C, p, p)."""

    def __init__(self, cfg: SwinConfig):
        super().__init__()
        p = cfg.patch_size
        self.patch_size = p
        self.proj = nn.Conv2d(cfg.in_chans, cfg.embed_dim, p, stride=p)
        self.norm = nn.LayerNorm(cfg.embed_dim, eps=1e-5) if cfg.patch_norm else None

    def forward(self, x):
        """x (B, H, W, C) channel-last -> (B, H/p * W/p, E)."""
        p = self.patch_size
        b, h, w, c = x.shape
        patches = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
        patches = patches.reshape(b, (h // p) * (w // p), p * p * c)
        wt = self.proj.weight.permute(0, 2, 3, 1).reshape(self.proj.weight.shape[0], -1)
        y = F.linear(patches.to(wt.dtype), wt, self.proj.bias)
        return layer_norm(self.norm, y) if self.norm is not None else y


def layer_norm(norm: nn.LayerNorm, x):
    """nn.LayerNorm with fp32 statistics, returned in x's dtype."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight.float(),
                        norm.bias.float(), norm.eps).to(x.dtype)


class BasicLayer(nn.Module):
    def __init__(self, blocks, downsample):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample


BN_MOMENTUM = 0.9   # share of the old running statistic kept per update


class SwinTransformer(nn.Module):
    """patchify -> stages -> LN -> flatten -> Linear -> BatchNorm1d."""

    def __init__(self, cfg: SwinConfig):
        super().__init__()
        _check_impl("attention_impl", cfg.attention_impl, ATTENTION_IMPLS)
        _check_impl("mlp_impl", cfg.mlp_impl, MLP_IMPLS)
        _check_impl("merge_impl", cfg.merge_impl, MERGE_IMPLS)
        self.cfg = cfg
        self.merge_layout = (MERGE_AUTO if cfg.merge_impl == "auto"
                             else cfg.merge_impl)
        self.patch_embed = PatchEmbed(cfg)
        res = cfg.patches_resolution
        dpr = np.linspace(0, cfg.drop_path_rate, sum(cfg.depths))
        self.layers = nn.ModuleList()
        for s, depth in enumerate(cfg.depths):
            sres = (res[0] // 2 ** s, res[1] // 2 ** s)
            dim = cfg.embed_dim * 2 ** s
            first = sum(cfg.depths[:s])
            blocks = [SwinBlock(dim, sres, cfg.num_heads[s], cfg.window_size,
                                0 if d % 2 == 0 else cfg.window_size // 2,
                                cfg.mlp_ratio, cfg.qkv_bias, cfg.drop_rate,
                                cfg.attn_drop_rate, float(dpr[first + d]))
                      for d in range(depth)]
            down = None
            if s < len(cfg.depths) - 1:
                down = PatchMerging(
                    sres, dim, self.merge_layout,
                    min(cfg.window_size, *sres),
                    min(cfg.window_size, sres[0] // 2, sres[1] // 2))
            self.layers.append(BasicLayer(blocks, down))
        final = cfg.num_features
        final_tokens = (res[0] // 2 ** (len(cfg.depths) - 1)) * \
            (res[1] // 2 ** (len(cfg.depths) - 1))
        self.output_layer = nn.Sequential(
            nn.LayerNorm(final, eps=1e-5), nn.Flatten(1),
            nn.Linear(final_tokens * final, cfg.out_feature_dim),
            nn.BatchNorm1d(cfg.out_feature_dim, eps=1e-5, momentum=0.1))

    def forward(self, x, *, generator: torch.Generator | None = None,
                use_running_average: bool | None = None, keeps=None,
                attention_impl: str | None = None):
        """x (B, H, W, 3) normalised, channel-last -> (B, out_feature_dim).

        In train mode each block half with a drop-path rate > 0 draws its
        per-image multiplier from `generator`; `keeps`, a list of
        (keep_attn, keep_mlp) per block, overrides the draw.
        `use_running_average` overrides the BatchNorm mode, which otherwise
        follows the module's (running statistics in eval, batch statistics
        in train).  `attention_impl` overrides cfg.attention_impl for this
        call."""
        cfg = self.cfg
        attn_impl = attention_impl or cfg.attention_impl
        _check_impl("attention_impl", attn_impl, ATTENTION_IMPLS)
        x = dropout(self.patch_embed(x), cfg.drop_rate, self.training,
                    generator)
        shard = context.current()
        remat = torch.is_grad_enabled() and resolve_remat(
            cfg.remat, x.shape[0] * (shard.parts if shard else 1), 512)
        res = cfg.patches_resolution
        blk = 0
        in_window_layout = False
        for s, layer in enumerate(self.layers):
            sh, sw = res[0] // 2 ** s, res[1] // 2 ** s
            ws = min(cfg.window_size, sh, sw)
            b, _, c = x.shape
            # enter the window layout once per stage, unless the previous
            # stage's window-layout merge already emitted it
            if not in_window_layout:
                x = window_partition(x.reshape(b, sh, sw, c), ws).reshape(
                    b, sh * sw, c)
            for block in layer.blocks:
                if keeps is not None:
                    keep_attn, keep_mlp = keeps[blk]
                elif self.training and block.drop_path > 0.0:
                    keep_attn, keep_mlp = (
                        sample_drop_path_keep(b, block.drop_path, generator,
                                              x.device) for _ in range(2))
                else:
                    keep_attn = keep_mlp = None
                x = (checkpointed(block, x, keep_attn, keep_mlp, attn_impl,
                                  cfg.mlp_impl, generator=generator)
                     if remat else block(x, keep_attn, keep_mlp, attn_impl,
                                         cfg.mlp_impl, generator))
                blk += 1
            in_window_layout = (layer.downsample is not None
                                and self.merge_layout == "window")
            if not in_window_layout:
                x = window_reverse(x.reshape(-1, ws * ws, c), ws, sh, sw)
                x = x.reshape(b, sh * sw, c)
            if layer.downsample is not None:
                x = layer.downsample(x)
        ln, _, lin, bn = self.output_layer
        x = layer_norm(ln, x).flatten(1)
        x = lin(x.to(lin.weight.dtype)).float()
        ura = (not self.training if use_running_average is None
               else use_running_average)
        if ura:
            mean, var = bn.running_mean.float(), bn.running_var.float()
        else:
            # batch statistics; the running variance takes the BIASED batch
            # variance, as flax's BatchNorm does (torch's takes the unbiased)
            if shard is None:
                mean = x.mean(0)
                var = (x - mean).square().mean(0)
            else:                       # of the global batch
                from facialmmt_tpu_torch.parallel.comm import all_reduce_sum

                n = x.shape[0] * shard.parts
                mean = all_reduce_sum(x.sum(0), shard.group) / n
                var = all_reduce_sum((x - mean).square().sum(0),
                                     shard.group) / n
            with torch.no_grad():
                bn.running_mean.mul_(BN_MOMENTUM).add_(
                    mean.to(bn.running_mean.dtype), alpha=1 - BN_MOMENTUM)
                bn.running_var.mul_(BN_MOMENTUM).add_(
                    var.to(bn.running_var.dtype), alpha=1 - BN_MOMENTUM)
        return ((x - mean) * torch.rsqrt(var + bn.eps) * bn.weight.float()
                + bn.bias.float())


def swin_flops(cfg: SwinConfig) -> int:
    """Analytic multiply-accumulates of one image's forward, the reference's
    flops() (reference Swin_Transformer.py:149-160, 276-288, 333-337,
    383-389, 424-429), as the JAX package counts them."""
    flops = 0
    ho, wo = cfg.patches_resolution
    flops += ho * wo * cfg.embed_dim * cfg.in_chans * cfg.patch_size ** 2
    if cfg.patch_norm:
        flops += ho * wo * cfg.embed_dim
    dim = cfg.embed_dim
    for stage in range(len(cfg.depths)):
        h = ho // (2 ** stage)
        w = wo // (2 ** stage)
        d = int(dim * 2 ** stage)
        ws = min(cfg.window_size, h)
        n = ws * ws
        heads = cfg.num_heads[stage]
        per_win = n * d * 3 * d + heads * n * (d // heads) * n * 2 + n * d * d
        nw = h * w / n
        per_block = (d * h * w * 2 + nw * per_win
                     + 2 * h * w * d * d * cfg.mlp_ratio)
        flops += int(per_block * cfg.depths[stage])
        if stage < len(cfg.depths) - 1:
            flops += h * w * d + (h // 2) * (w // 2) * 4 * d * 2 * d
    flops += cfg.num_features * ho * wo // (4 ** (len(cfg.depths) - 1))
    flops += (49 * cfg.num_features) * cfg.out_feature_dim
    return int(flops)
