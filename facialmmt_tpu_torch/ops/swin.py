"""Swin-tiny backbone (counterpart of facialmmt_tpu/ops/swin.py; reference
modules/SwinTransformer/Swin_Transformer.py).

Window-resident layout: each stage partitions its tokens into windows once;
every block works on (B, H*W, C) rows in window layout, and a shifted block's
cyclic shift + re-partition is one static row gather before the attention
half and its inverse after it.  The attention half of every block is
ops/kernels/fused_block.py and the MLP half ops/kernels/block_mlp.py, each an
autograd Function with hand-written forward and backward kernels.  Patch
embedding is a patch matmul; patch merging uses the raster layout; the head
is LN -> flatten -> Linear -> BatchNorm1d.

Train mode (module.train()): stochastic depth draws one multiplier per image
and block half (0 with probability rate, else 1/keep_prob) from a
torch.Generator and hands it to the kernels as `keep`; the head's BatchNorm
normalises with batch statistics and updates its running statistics in place.

Parameter and buffer names follow the reference state_dict
(torch_export.export_swin_backbone), including the persistent
`relative_position_index` and, on shifted blocks, `attn_mask` buffers.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from facialmmt_tpu_torch.config import SwinConfig
from facialmmt_tpu_torch.ops.kernels.block_mlp import fused_ln_mlp_residual
from facialmmt_tpu_torch.ops.kernels.fused_block import fused_attention_block


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
    mask = torch.rand(b, generator=generator, device=device) < keep_prob
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
    """Holds the attention half's parameters under the reference's names."""

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
                 drop_path: float = 0.0):
        super().__init__()
        self.drop_path = drop_path
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

    def forward(self, x, keep_attn=None, keep_mlp=None):
        """keep_attn / keep_mlp: optional (B,) per-image stochastic-depth
        multipliers of the two halves, repeated per window / per token."""
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
            None if keep_attn is None else keep_attn.repeat_interleave(l // n))
        x = y.reshape(b, l, c)
        if self.shift > 0:
            x = x[:, self.inv]
        out = fused_ln_mlp_residual(
            x.reshape(b * l, c).contiguous(), self.norm2.weight,
            self.norm2.bias, self.mlp.fc1.weight, self.mlp.fc1.bias,
            self.mlp.fc2.weight, self.mlp.fc2.bias,
            None if keep_mlp is None else keep_mlp.repeat_interleave(l))
        return out.reshape(b, l, c)


class PatchMerging(nn.Module):
    """Raster 2x2 concat (x0, x1, x2, x3 order) + LN + Linear(4C -> 2C, no bias)."""

    def __init__(self, input_resolution: tuple[int, int], dim: int):
        super().__init__()
        self.input_resolution = input_resolution
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        h, w = self.input_resolution
        b, l, c = x.shape
        x = x.reshape(b, h, w, c)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], dim=-1).reshape(b, l // 4, 4 * c)
        return self.reduction(layer_norm(self.norm, x))


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
        self.cfg = cfg
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
                                cfg.mlp_ratio, cfg.qkv_bias,
                                float(dpr[first + d]))
                      for d in range(depth)]
            down = (PatchMerging(sres, dim) if s < len(cfg.depths) - 1
                    else None)
            self.layers.append(BasicLayer(blocks, down))
        final = cfg.num_features
        final_tokens = (res[0] // 2 ** (len(cfg.depths) - 1)) * \
            (res[1] // 2 ** (len(cfg.depths) - 1))
        self.output_layer = nn.Sequential(
            nn.LayerNorm(final, eps=1e-5), nn.Flatten(1),
            nn.Linear(final_tokens * final, cfg.out_feature_dim),
            nn.BatchNorm1d(cfg.out_feature_dim, eps=1e-5, momentum=0.1))

    def forward(self, x, *, generator: torch.Generator | None = None,
                use_running_average: bool | None = None, keeps=None):
        """x (B, H, W, 3) normalised, channel-last -> (B, out_feature_dim).

        In train mode each block half with a drop-path rate > 0 draws its
        per-image multiplier from `generator`; `keeps`, a list of
        (keep_attn, keep_mlp) per block, overrides the draw.
        `use_running_average` overrides the BatchNorm mode, which otherwise
        follows the module's (running statistics in eval, batch statistics
        in train)."""
        cfg = self.cfg
        if cfg.drop_rate or cfg.attn_drop_rate:
            raise NotImplementedError(
                "Swin drop_rate / attn_drop_rate > 0 (the reference config "
                "has both at 0.0; the block kernels carry drop-path only)")
        x = self.patch_embed(x)
        res = cfg.patches_resolution
        blk = 0
        for s, layer in enumerate(self.layers):
            sh, sw = res[0] // 2 ** s, res[1] // 2 ** s
            ws = min(cfg.window_size, sh, sw)
            b, _, c = x.shape
            x = window_partition(x.reshape(b, sh, sw, c), ws).reshape(b, sh * sw, c)
            for block in layer.blocks:
                if keeps is not None:
                    keep_attn, keep_mlp = keeps[blk]
                elif self.training and block.drop_path > 0.0:
                    keep_attn, keep_mlp = (
                        sample_drop_path_keep(b, block.drop_path, generator,
                                              x.device) for _ in range(2))
                else:
                    keep_attn = keep_mlp = None
                x = block(x, keep_attn, keep_mlp)
                blk += 1
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
            mean = x.mean(0)
            var = (x - mean).square().mean(0)
            with torch.no_grad():
                bn.running_mean.mul_(BN_MOMENTUM).add_(
                    mean.to(bn.running_mean.dtype), alpha=1 - BN_MOMENTUM)
                bn.running_var.mul_(BN_MOMENTUM).add_(
                    var.to(bn.running_var.dtype), alpha=1 - BN_MOMENTUM)
        return ((x - mean) * torch.rsqrt(var + bn.eps) * bn.weight.float()
                + bn.bias.float())
