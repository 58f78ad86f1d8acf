"""Plain PyTorch reference of FacialMMT T+A+V (NUSTM/FacialMMT, ACL 2023):
Swin-T FER over face crops, gumbel-softmax, the frame-importance filter, a
RoBERTa/BERT dialogue tower, the audio and vision utterance encoders, two
MulT crossmodal stacks and additive pooling.

It follows the published equations in float32 with no kernels, no packing
and one utterance at a time, in the textbook Swin layout (cyclic roll and
window partition per block).  Its parameter and buffer names are those of
the reference state_dict, so the weights the benchmark draws load into it
and into the program alike.  It imports nothing of the program.

Every product goes through `Precision`, which rounds both operands to the
precision the reference is asked to compute in: 'fp32' (the reference),
'bf16' or 'fp8' (the correctness control: operands and results in e4m3,
gradients in e5m2, each under a per-tensor scale).  With the TF32 switches
off (see `strict_fp32`) 'fp32' is true float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

FP8_MAX = 448.0      # largest finite float8_e4m3fn
FP8_GRAD_MAX = 57344.0   # largest finite float8_e5m2


def strict_fp32():
    """float32 products without TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Precision:
    """The rounding applied to each operand of a product."""

    def __init__(self, name: str = "fp32"):
        self.set(name)

    def set(self, name: str):
        if name not in ("fp32", "bf16", "fp8"):
            raise ValueError(f"precision {name!r}")
        self.name = name

    def q(self, t):
        if self.name == "fp32":
            return t.float()
        if self.name == "bf16":
            return t.to(torch.bfloat16).float()
        return _Fp8.apply(t.float())

    def out(self, t):
        """A product's result as the precision stores it: fp8 computes
        each product into fp8; fp32 and bf16 keep an fp32 sum."""
        return _Fp8.apply(t) if self.name == "fp8" else t

    def linear(self, x, w, b=None):
        y = self.out(F.linear(self.q(x), self.q(w)))
        return y if b is None else y + b.float()

    def matmul(self, a, b):
        return self.out(torch.matmul(self.q(a), self.q(b)))


def _fp8(t, dtype, top):
    """t rounded to `dtype` under a per-tensor scale that maps its largest
    magnitude to `top`."""
    scale = top / t.abs().amax().clamp(min=1e-30)
    return (t * scale).to(dtype).float() / scale


class _Fp8(torch.autograd.Function):
    """A product operand in fp8 as fp8 training computes it: e4m3 in the
    forward, its incoming gradient in e5m2 in the backward, each under a
    per-tensor scale."""

    @staticmethod
    def forward(ctx, t):
        return _fp8(t, torch.float8_e4m3fn, FP8_MAX)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2, FP8_GRAD_MAX)


class Lin(nn.Module):
    def __init__(self, d_in, d_out, bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(d_out, d_in))
        self.bias = nn.Parameter(torch.zeros(d_out)) if bias else None


class LN(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))


def layer_norm(ln, x, eps):
    x = x.float()
    u = x.mean(-1, keepdim=True)
    s = (x - u).square().mean(-1, keepdim=True)
    return (x - u) / torch.sqrt(s + eps) * ln.weight.float() + ln.bias.float()


def gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def attention(p: Precision, q, k, v, heads, bias=None):
    """q, k, v (B, S, E) -> (B, Sq, E); bias broadcasts over (B, h, Sq, Sk)."""
    b, sq, e = q.shape
    sk = k.shape[1]
    hd = e // heads
    qh = q.reshape(b, sq, heads, hd).transpose(1, 2) * hd ** -0.5
    kh = k.reshape(b, sk, heads, hd).transpose(1, 2)
    vh = v.reshape(b, sk, heads, hd).transpose(1, 2)
    s = p.matmul(qh, kh.transpose(-1, -2))
    if bias is not None:
        s = s + bias
    out = p.matmul(torch.softmax(s, dim=-1), vh)
    return out.transpose(1, 2).reshape(b, sq, e)


# ------------------------------------------------------------------- Swin --

def relative_position_index(ws):
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    return (rel[:, :, 0] + ws - 1) * (2 * ws - 1) + rel[:, :, 1] + ws - 1


def shift_mask(h, w, ws, shift):
    img = np.zeros((h, w))
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    win = img.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3)
    win = win.reshape(-1, ws * ws)
    return np.where(win[:, None, :] != win[:, :, None], -100.0,
                    0.0).astype(np.float32)


def partition(x, ws):
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def unpartition(x, ws, b, h, w):
    c = x.shape[-1]
    x = x.reshape(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


class WinAttn(nn.Module):
    def __init__(self, dim, window, eff_window, heads):
        super().__init__()
        self.heads = heads
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads))
        self.register_buffer("relative_position_index", torch.from_numpy(
            relative_position_index(eff_window).astype(np.int64)))
        self.qkv = Lin(dim, 3 * dim)
        self.proj = Lin(dim, dim)


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = Lin(dim, hidden)
        self.fc2 = Lin(hidden, dim)


class SwinBlock(nn.Module):
    def __init__(self, dim, res, heads, window, shift, mlp_ratio):
        super().__init__()
        ws = window
        if min(res) <= window:
            ws, shift = min(res), 0
        self.res, self.ws, self.shift, self.heads = res, ws, shift, heads
        self.norm1 = LN(dim)
        self.attn = WinAttn(dim, window, ws, heads)
        self.norm2 = LN(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        if shift:
            self.register_buffer("attn_mask", torch.from_numpy(
                shift_mask(res[0], res[1], ws, shift)))
        else:
            self.attn_mask = None

    def forward(self, p, x, keep_attn=None, keep_mlp=None):
        """x (B, H, W, C) raster; keep_*: (B,) drop-path multipliers."""
        b, h, w, c = x.shape
        ws, n = self.ws, self.ws * self.ws
        y = layer_norm(self.norm1, x, 1e-5)
        if self.shift:
            y = torch.roll(y, (-self.shift, -self.shift), (1, 2))
        win = partition(y, ws)                                  # (B*nW, n, C)
        a = self.attn
        qkv = p.linear(win, a.qkv.weight, a.qkv.bias)
        rel = a.relative_position_bias_table.float()[
            a.relative_position_index.reshape(-1)].reshape(n, n, self.heads)
        bias = rel.permute(2, 0, 1)[None]                       # (1, h, n, n)
        if self.attn_mask is not None:
            nw = self.attn_mask.shape[0]
            bias = (bias + self.attn_mask[:, None]).repeat(b, 1, 1, 1)
        out = attention(p, qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:],
                        self.heads, bias)
        out = p.linear(out, a.proj.weight, a.proj.bias)
        y = unpartition(out, ws, b, h, w)
        if self.shift:
            y = torch.roll(y, (self.shift, self.shift), (1, 2))
        if keep_attn is not None:
            y = y * keep_attn[:, None, None, None]
        x = x + y
        y = layer_norm(self.norm2, x, 1e-5)
        y = p.linear(gelu(p.linear(y, self.mlp.fc1.weight, self.mlp.fc1.bias)),
                     self.mlp.fc2.weight, self.mlp.fc2.bias)
        if keep_mlp is not None:
            y = y * keep_mlp[:, None, None, None]
        return x + y


class Merge(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.norm = LN(4 * dim)
        self.reduction = Lin(4 * dim, 2 * dim, bias=False)

    def forward(self, p, x):
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], dim=-1)
        return p.linear(layer_norm(self.norm, x, 1e-5), self.reduction.weight)


class Stage(nn.Module):
    def __init__(self, blocks, downsample):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample


class PatchEmbed(nn.Module):
    def __init__(self, cin, dim, patch):
        super().__init__()
        self.patch = patch
        self.proj = nn.Module()
        self.proj.weight = nn.Parameter(torch.zeros(dim, cin, patch, patch))
        self.proj.bias = nn.Parameter(torch.zeros(dim))
        self.norm = LN(dim)


class BN(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))
        self.register_buffer("running_mean", torch.zeros(d))
        self.register_buffer("running_var", torch.ones(d))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))


class Swin(nn.Module):
    """Swin-T: patchify, stages, LN -> flatten -> Linear -> BatchNorm1d."""

    def __init__(self, s):
        super().__init__()
        self.s = s
        self.patch_embed = PatchEmbed(s["in_chans"], s["embed_dim"],
                                      s["patch_size"])
        r = s["img_size"] // s["patch_size"]
        self.layers = nn.ModuleList()
        for i, depth in enumerate(s["depths"]):
            res = (r // 2 ** i, r // 2 ** i)
            dim = s["embed_dim"] * 2 ** i
            blocks = [SwinBlock(dim, res, s["num_heads"][i], s["window_size"],
                                0 if d % 2 == 0 else s["window_size"] // 2,
                                s["mlp_ratio"]) for d in range(depth)]
            down = Merge(dim) if i < len(s["depths"]) - 1 else None
            self.layers.append(Stage(blocks, down))
        final = s["embed_dim"] * 2 ** (len(s["depths"]) - 1)
        tokens = (r // 2 ** (len(s["depths"]) - 1)) ** 2
        self.output_layer = nn.Module()
        self.output_layer.add_module("0", LN(final))
        self.output_layer.add_module("2", Lin(tokens * final,
                                              s["out_feature_dim"]))
        self.output_layer.add_module("3", BN(s["out_feature_dim"]))

    def blocks(self):
        return [blk for layer in self.layers for blk in layer.blocks]

    def forward(self, p, x, keeps=None, batch_stats=False):
        """x (B, H, W, 3) normalised.  keeps: one (keep_attn, keep_mlp) per
        block.  batch_stats: BatchNorm on the batch's statistics, updating
        the running ones (train mode), else on the running ones."""
        s = self.s
        b, h, w, c = x.shape
        pt = s["patch_size"]
        patches = x.reshape(b, h // pt, pt, w // pt, pt, c).permute(
            0, 1, 3, 2, 4, 5).reshape(b, h // pt, w // pt, pt * pt * c)
        wt = self.patch_embed.proj.weight
        wt = wt.permute(0, 2, 3, 1).reshape(wt.shape[0], -1)
        x = layer_norm(self.patch_embed.norm,
                       p.linear(patches, wt, self.patch_embed.proj.bias), 1e-5)
        i = 0
        for layer in self.layers:
            for blk in layer.blocks:
                ka, km = keeps[i] if keeps is not None else (None, None)
                x = blk(p, x, ka, km)
                i += 1
            if layer.downsample is not None:
                x = layer.downsample(p, x)
        ln, lin, bn = (self.output_layer._modules[k] for k in ("0", "2", "3"))
        x = layer_norm(ln, x, 1e-5).reshape(b, -1)
        x = p.linear(x, lin.weight, lin.bias)
        if batch_stats:
            mean = x.mean(0)
            var = (x - mean).square().mean(0)
            with torch.no_grad():
                bn.running_mean.mul_(0.9).add_(0.1 * mean.detach())
                bn.running_var.mul_(0.9).add_(0.1 * var.detach())
        else:
            mean, var = bn.running_mean, bn.running_var
        return (x - mean) / torch.sqrt(var + 1e-5) * bn.weight + bn.bias


class SwinFER(nn.Module):
    def __init__(self, s, num_labels):
        super().__init__()
        self.swin = Swin(s)
        self.linear = Lin(s["out_feature_dim"], 64)
        self.classifier = Lin(64, num_labels)

    def forward(self, p, x, keeps=None, batch_stats=False):
        h = torch.relu(p.linear(self.swin(p, x, keeps, batch_stats),
                                self.linear.weight, self.linear.bias))
        return p.linear(h, self.classifier.weight, self.classifier.bias)


# ------------------------------------------------------------- text tower --

class _Dense(nn.Module):
    def __init__(self, d_in, d_out, norm):
        super().__init__()
        self.dense = Lin(d_in, d_out)
        if norm:
            self.LayerNorm = LN(d_out)


class TextLayer(nn.Module):
    def __init__(self, h, ff):
        super().__init__()
        self.attention = nn.Module()
        self.attention.self = nn.Module()
        for n in ("query", "key", "value"):
            setattr(self.attention.self, n, Lin(h, h))
        self.attention.output = _Dense(h, h, True)
        self.intermediate = _Dense(h, ff, False)
        self.output = _Dense(ff, h, True)


class TextTower(nn.Module):
    """Post-LN RoBERTa / BERT encoder."""

    def __init__(self, t):
        super().__init__()
        self.t = t
        h = t["hidden_size"]
        self.embeddings = nn.Module()
        self.embeddings.word_embeddings = nn.Module()
        self.embeddings.word_embeddings.weight = nn.Parameter(
            torch.zeros(t["vocab_size"], h))
        self.embeddings.position_embeddings = nn.Module()
        self.embeddings.position_embeddings.weight = nn.Parameter(
            torch.zeros(t["max_position_embeddings"], h))
        self.embeddings.token_type_embeddings = nn.Module()
        self.embeddings.token_type_embeddings.weight = nn.Parameter(
            torch.zeros(t["type_vocab_size"], h))
        self.embeddings.LayerNorm = LN(h)
        self.encoder = nn.Module()
        self.encoder.layer = nn.ModuleList(
            TextLayer(h, t["intermediate_size"])
            for _ in range(t["num_layers"]))

    def forward(self, p, ids, mask):
        t, e = self.t, self.embeddings
        eps = t["layer_norm_eps"]
        ids = ids.long()
        if t["model_type"] == "roberta":
            real = (ids != t["pad_token_id"]).long()
            pos = torch.cumsum(real, 1) * real + t["pad_token_id"]
        else:
            pos = torch.arange(ids.shape[1], device=ids.device)[None]
        x = (e.word_embeddings.weight[ids] + e.position_embeddings.weight[pos]
             + e.token_type_embeddings.weight[0])
        x = layer_norm(e.LayerNorm, x, eps)
        bias = ((1.0 - mask.float()) * -1e30)[:, None, None, :]
        for lyr in self.encoder.layer:
            sa = lyr.attention.self
            ctx = attention(p, p.linear(x, sa.query.weight, sa.query.bias),
                            p.linear(x, sa.key.weight, sa.key.bias),
                            p.linear(x, sa.value.weight, sa.value.bias),
                            t["num_heads"], bias)
            ao = lyr.attention.output
            x = layer_norm(ao.LayerNorm,
                           p.linear(ctx, ao.dense.weight, ao.dense.bias) + x,
                           eps)
            inter = gelu(p.linear(x, lyr.intermediate.dense.weight,
                                  lyr.intermediate.dense.bias))
            o = lyr.output
            x = layer_norm(o.LayerNorm,
                           p.linear(inter, o.dense.weight, o.dense.bias) + x,
                           eps)
        return x


# ------------------------------------------------------ utterance encoders --

class EncLayer(nn.Module):
    def __init__(self, h, ff):
        super().__init__()
        self.transformer_self_attention = nn.Module()
        sa = nn.Module()
        for n in ("query", "key", "value"):
            setattr(sa, n, Lin(h, h))
        self.transformer_self_attention.selfatt = sa
        self.transformer_self_attention.dense_norm = _Dense(h, h, True)
        self.intermediate = _Dense(h, ff, False)
        self.output = _Dense(ff, h, True)


class UttEncoder(nn.Module):
    """Learned positions, post-LN layers, (1 - mask) * -10000 key bias."""

    def __init__(self, e, layers, max_len):
        super().__init__()
        self.e = e
        self.position_embeddings = nn.Module()
        self.position_embeddings.weight = nn.Parameter(
            torch.zeros(max_len, e["hidden_size"]))
        self.layer = nn.ModuleList(EncLayer(e["hidden_size"],
                                            e["intermediate_size"])
                                   for _ in range(layers))

    def forward(self, p, x, mask):
        eps = self.e["layer_norm_eps"]
        x = x + self.position_embeddings.weight[:x.shape[1]][None]
        bias = ((1.0 - mask.float()) * -10000.0)[:, None, None, :]
        for lyr in self.layer:
            sa = lyr.transformer_self_attention
            s = sa.selfatt
            ctx = attention(p, p.linear(x, s.query.weight, s.query.bias),
                            p.linear(x, s.key.weight, s.key.bias),
                            p.linear(x, s.value.weight, s.value.bias),
                            self.e["num_attention_heads"], bias)
            dn = sa.dense_norm
            x = layer_norm(dn.LayerNorm,
                           p.linear(ctx, dn.dense.weight, dn.dense.bias) + x,
                           eps)
            inter = gelu(p.linear(x, lyr.intermediate.dense.weight,
                                  lyr.intermediate.dense.bias))
            o = lyr.output
            x = layer_norm(o.LayerNorm,
                           p.linear(inter, o.dense.weight, o.dense.bias) + x,
                           eps)
        return x


# ------------------------------------------------------------- crossmodal --

def sinusoids(rows, dim):
    half = dim // 2
    freq = np.exp(np.arange(half, dtype=np.float64)
                  * -(math.log(10000) / (half - 1)))
    ang = np.arange(rows, dtype=np.float64)[:, None] * freq[None]
    table = np.concatenate([np.sin(ang), np.cos(ang)], 1)
    table[0] = 0
    return table.astype(np.float32)


class CMLayer(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.self_attn = nn.Module()
        self.self_attn.in_proj_weight = nn.Parameter(torch.zeros(3 * d, d))
        self.self_attn.in_proj_bias = nn.Parameter(torch.zeros(3 * d))
        self.self_attn.out_proj = Lin(d, d)
        self.fc1 = Lin(d, 4 * d)
        self.fc2 = Lin(4 * d, d)
        self.layer_norms = nn.ModuleList([LN(d), LN(d)])


class Crossmodal(nn.Module):
    """Pre-LN MulT stack: sqrt(d) scaling, channel-0 sinusoidal positions,
    one LayerNorm for q, k and v, a final LayerNorm."""

    def __init__(self, d, heads, layers, max_positions):
        super().__init__()
        self.d, self.heads = d, heads
        self.register_buffer("version", torch.tensor([2.0]))
        self.embed_positions = nn.Module()
        self.embed_positions.register_buffer("_float_tensor", torch.zeros(1))
        self.register_buffer("table", torch.from_numpy(
            sinusoids(max_positions + 1, d)), persistent=False)
        self.layers = nn.ModuleList(CMLayer(d) for _ in range(layers))
        self.layer_norm = LN(d)

    def embed(self, z):
        rows = torch.arange(1, z.shape[1] + 1, device=z.device)[None]
        idx = torch.where(z[:, :, 0] != 0, rows, 0)
        return math.sqrt(self.d) * z + self.table[idx]

    def forward(self, p, x_in, kv_in):
        x, kv = self.embed(x_in), self.embed(kv_in)
        d = self.d
        for lyr in self.layers:
            ln0, ln1 = lyr.layer_norms
            a = lyr.self_attn
            w, b = a.in_proj_weight, a.in_proj_bias
            kvn = layer_norm(ln0, kv, 1e-5)
            h = attention(p, p.linear(layer_norm(ln0, x, 1e-5), w[:d], b[:d]),
                          p.linear(kvn, w[d:2 * d], b[d:2 * d]),
                          p.linear(kvn, w[2 * d:], b[2 * d:]), self.heads)
            x = x + p.linear(h, a.out_proj.weight, a.out_proj.bias)
            h = gelu(p.linear(layer_norm(ln1, x, 1e-5), lyr.fc1.weight,
                              lyr.fc1.bias))
            x = x + p.linear(h, lyr.fc2.weight, lyr.fc2.bias)
        return layer_norm(self.layer_norm, x, 1e-5)


class Pool(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.query_vector = nn.Parameter(torch.zeros(d))
        self.P = Lin(d, d)
        self.Q = Lin(d, d)
        self.value = Lin(d, 1)

    def forward(self, p, x, mask):
        h = torch.tanh(p.linear(x, self.P.weight, self.P.bias)
                       + p.linear(self.query_vector, self.Q.weight,
                                  self.Q.bias))
        s = p.linear(h, self.value.weight, self.value.bias)[..., 0]
        s = s.masked_fill(mask == 0, -1e30)
        return torch.einsum("bs,bsd->bd", torch.softmax(s, -1), x)


class Multimodal(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.c = c
        d, data, t = c["hidden_size"], c["data"], c["text"]
        self.prefix = "roberta" if t["model_type"] == "roberta" else "bert"
        self.add_module(self.prefix, TextTower(t))
        self.text_linear = Lin(t["hidden_size"], d)
        self.audio_linear = Lin(data["audio_feat_dim"], d)
        self.audio_utt_transformer = UttEncoder(
            c["encoder"], c["audio_utt_transformer_num"],
            data["audio_utt_max_len"])
        self.vision_linear = Lin(data["vision_feat_dim"] + c["num_labels"], d)
        self.vision_utt_transformer = UttEncoder(
            c["encoder"], c["vision_utt_transformer_num"],
            data["vision_utt_max_len"])
        self.attention = Pool(d)
        max_pos = max(data["text_utt_max_len"] + data["audio_utt_max_len"]
                      + data["vision_utt_max_len"], 16)
        self.CrossModalTrans_TA = Crossmodal(
            d, c["crossmodal_ta"]["num_heads"], c["crossmodal_ta"]["layers"],
            max_pos)
        self.CrossModalTrans_TA_V = Crossmodal(
            d, c["crossmodal_ta_v"]["num_heads"],
            c["crossmodal_ta_v"]["layers"], max_pos)
        self.classifier = Lin(d, c["num_labels"])

    def text_features(self, p, ids, mask, sep, utt):
        """The utterance's word span of the encoded dialogue: (1, Lt, d)
        features and (1, Lt) mask."""
        enc = getattr(self, self.prefix)(p, ids, mask)
        lin = p.linear(enc, self.text_linear.weight, self.text_linear.bias)
        seps = np.flatnonzero(sep[0].cpu().numpy())
        lt = self.c["data"]["text_utt_max_len"]
        off = 2 if self.prefix == "roberta" else 1
        feats = torch.zeros((1, lt, lin.shape[-1]), device=lin.device)
        if utt < len(seps):
            start = 1 if utt == 0 else int(seps[utt - 1]) + off
            length = int(seps[utt]) - start
            length = max(0, min(length, lt))
            feats[0, :length] = lin[0, start:start + length]
        else:
            length = 0
        tmask = torch.zeros((1, lt), device=lin.device)
        tmask[0, :length] = 1
        return feats, tmask

    def fuse(self, p, text, tmask, audio, amask, vision, vmask):
        a = self.audio_utt_transformer(
            p, p.linear(audio, self.audio_linear.weight,
                        self.audio_linear.bias),
            amask)
        v = self.vision_utt_transformer(
            p, p.linear(vision, self.vision_linear.weight,
                        self.vision_linear.bias), vmask)
        ta = self.CrossModalTrans_TA
        fused = torch.cat([ta(p, text, a), ta(p, a, text)], 1)
        tav = self.CrossModalTrans_TA_V
        fused = torch.cat([tav(p, fused, v), tav(p, v, fused)], 1)
        pooled = self.attention(p, fused, torch.cat([tmask, amask, vmask], 1))
        return p.linear(pooled, self.classifier.weight, self.classifier.bias)


class FacialMMT(nn.Module):
    """The two branches under the reference's names."""

    def __init__(self, c):
        super().__init__()
        self.c = c
        self.prec = Precision("fp32")
        self.swin_model = SwinFER(c["swin"], c["num_labels"])
        self.multimodal = Multimodal(c)


# ---------------------------------------------------------- face transforms --

def _keys_cubic(x):
    f = np.float32
    out = ((f(1.5) * x - f(2.5)) * x) * x + f(1.0)
    far = ((f(-0.5) * x + f(2.5)) * x - f(4.0)) * x + f(2.0)
    out = np.where(x >= 1.0, far, out)
    return np.where(x >= 2.0, f(0.0), out)


def resize_weights(n_in, n_out):
    """(n_out, n_in) interpolation matrix of jax.image.resize: Keys cubic
    (a = -0.5) when enlarging, an antialiased triangle when shrinking, each
    row renormalised over the taps inside the image."""
    f32 = np.float32
    scale = f32(n_out) / f32(n_in)
    shrink = n_out < n_in
    inv = f32(1.0) / scale
    kscale = max(inv, f32(1.0)) if shrink else f32(1.0)
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kscale
    w = (np.maximum(f32(0.0), f32(1.0) - np.abs(x)) if shrink
         else _keys_cubic(x))
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0).T.astype(np.float32)


def face_eval_transform(faces, size, mean=0.5, std=0.5):
    """uint8 (N, h, w, 3) -> (N, size, size, 3) normalised float32."""
    x = faces.float()
    _, h, w, _ = x.shape
    if h != size:
        wh = torch.from_numpy(resize_weights(h, size)).to(x.device)
        ww = torch.from_numpy(resize_weights(w, size)).to(x.device)
        x = torch.einsum("oh,nhwc->nowc", wh, x)
        x = torch.einsum("pw,nowc->nopc", ww, x)
    return (x / 255.0 - mean) / std


# ---------------------------------------------------------------- serving --

def frame_filter(feats, probs, n_faces, threshold, flips=()):
    """feats (F, D), probs (F, C) of one utterance with n_faces real rows ->
    (F, D + C) features and (F,) mask: frames whose <p, p> exceeds the
    threshold, in order (all frames when none does).  `flips`: rows whose
    keep decision is inverted (a confidence within rounding of the
    threshold)."""
    f = feats.shape[0]
    real = torch.arange(f, device=feats.device) < n_faces
    keep = (probs.square().sum(-1) > threshold) & real
    for i in flips:
        keep[i] = ~keep[i]
    if not bool(keep.any()):
        keep = real
    order = torch.argsort((~keep).to(torch.int8), stable=True)
    kept = int(keep.sum())
    mask = (torch.arange(f, device=feats.device) < kept).float()
    out = torch.cat([feats[order], probs[order]], -1) * mask[:, None]
    return out, mask


@torch.no_grad()
def serve_one(model, req, noise, threshold_margin=0.0):
    """One served utterance.  req holds the padded arrays of one request
    (ids, mask, sep (1, L); utt; audio (1, La, da), amask (1, La); vision
    (Fv, dv) with n_faces real rows; faces uint8 (n, h, w, 3)); noise
    (n, C) Gumbel draws.  Returns (fer_logits (n, C), fer_probs (n, C),
    answers): answers are the probability vectors under every choice of the
    keep decisions of frames whose confidence lies within threshold_margin
    of the threshold (one vector when none does)."""
    c, p = model.c, model.prec
    n = req["faces"].shape[0]
    x = face_eval_transform(req["faces"], c["data"]["swin_img_size"],
                            c["data"]["normalize_mean"][0],
                            c["data"]["normalize_std"][0])
    fer_logits = model.swin_model(p, x) if n else torch.zeros(
        (0, c["num_labels"]), device=x.device)
    fer = torch.softmax((fer_logits + noise) / c["tau"], -1)
    mm = model.multimodal
    text, tmask = mm.text_features(p, req["ids"], req["mask"], req["sep"],
                                   req["utt"])
    fv = c["data"]["vision_utt_max_len"]
    probs = torch.zeros((fv, c["num_labels"]), device=x.device)
    probs[:n] = fer
    vision = req["vision"].float()
    thr = c["facial_emo_impor_threshold"]
    conf = probs[:n].square().sum(-1)
    near = [int(i) for i in torch.nonzero(
        (conf - thr).abs() <= threshold_margin).flatten()][:4]
    answers = []
    for bits in range(2 ** len(near)):
        flips = [near[k] for k in range(len(near)) if bits >> k & 1]
        vfeat, vmask = frame_filter(vision, probs, n, thr, flips)
        logits = mm.fuse(p, text, tmask, req["audio"].float(), req["amask"],
                         vfeat[None], vmask[None])
        answers.append(torch.softmax(logits[0], -1))
    return fer_logits, fer, answers
