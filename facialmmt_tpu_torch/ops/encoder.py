"""Post-LN self-attention utterance encoder (counterpart of
facialmmt_tpu/ops/encoder.py; reference modules/Transformer.py:65-227).

Learned positions added to the inputs; per layer multi-head self-attention
with the additive (1 - mask) * -10000 bias, post-LN residual blocks, an
exact-erf GELU FFN and TF-style LayerNorm.  Parameter names follow the
reference state_dict (torch_export.export_utt_encoder).
"""

from __future__ import annotations

import torch
from torch import nn

from facialmmt_tpu_torch.config import EncoderConfig
from facialmmt_tpu_torch.ops.kernels.attention import fused_attention
from facialmmt_tpu_torch.ops.layers import (LayerNormTF, TorchLinear,
                                            column_input, dropout, gelu_erf,
                                            row_linear)

ADDITIVE_MASK_VALUE = -10000.0  # reference convention (src/models.py:157)
# Key length from which the fusion stacks take the attention kernel, as the
# JAX package gates its Pallas kernel; no MELD shape (S = 32, 38, 157, 195)
# reaches it, so those stacks run plain matmul + softmax.
FUSED_MIN_KEYS = 256


def multihead_attention(q, k, v, num_heads: int, key_bias=None,
                        attn_mask=None, attn_dropout: float = 0.0,
                        generator: torch.Generator | None = None,
                        head_split=None):
    """q (B, Sq, E) unscaled, k/v (B, Sk, E) -> (B, Sq, E).  key_bias (B, Sk)
    is an additive padding bias, attn_mask an additive (Sq, Sk) mask.  Kernel
    1 on a CUDA tensor when Sk >= FUSED_MIN_KEYS, there is no attn_mask and
    no attention-probability dropout is active (attn_dropout is the ACTIVE
    rate: 0 in eval); plain fp32-softmax attention otherwise.  A
    tensor-parallel layer passes its local heads (E and num_heads divided by
    tp) and `head_split`, so the dropout mask is its heads' part of the
    whole layer's (ops/layers.py::dropout)."""
    b, sq, e = q.shape
    sk = k.shape[1]
    hd = e // num_heads
    qh = (q * hd ** -0.5).reshape(b, sq, num_heads, hd).transpose(1, 2)
    kh = k.reshape(b, sk, num_heads, hd).transpose(1, 2)
    vh = v.reshape(b, sk, num_heads, hd).transpose(1, 2)
    if (q.is_cuda and sk >= FUSED_MIN_KEYS and attn_mask is None
            and attn_dropout == 0.0):
        if key_bias is None:
            key_bias = torch.zeros((b, sk), device=q.device)
        ctx = fused_attention(qh.contiguous(), kh.contiguous(),
                              vh.contiguous(), key_bias.float().contiguous())
    else:
        scores = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
        if key_bias is not None:
            scores = scores + key_bias.float()[:, None, None, :]
        if attn_mask is not None:
            scores = scores + attn_mask.float()
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        probs = dropout(probs, attn_dropout, True, generator, head_split)
        ctx = torch.matmul(probs, vh)
    return ctx.transpose(1, 2).reshape(b, sq, e)


class _SelfAtt(nn.Module):
    def __init__(self, h: int):
        super().__init__()
        self.query = TorchLinear(h, h)
        self.key = TorchLinear(h, h)
        self.value = TorchLinear(h, h)


class _DenseNorm(nn.Module):
    def __init__(self, h: int, out_h: int, eps: float):
        super().__init__()
        self.dense = TorchLinear(h, out_h)
        self.LayerNorm = LayerNormTF(out_h, eps)


class EncoderLayer(nn.Module):
    """attention -> dense + LN(res) -> GELU FFN -> dense + LN(res).

    Tensor-parallel when parallel/mesh.py::shard_model_ sets `tp`: query,
    key, value and intermediate.dense hold this rank's output rows
    (column-parallel, num_heads / tp local heads), dense_norm.dense and
    output.dense its input columns (row-parallel, summed over the model
    group); the LayerNorms and biases of the row-parallel products are
    whole."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        h = cfg.hidden_size
        self.num_heads = cfg.num_attention_heads
        self.hidden_dropout = cfg.hidden_dropout_prob
        self.attn_dropout = cfg.attention_probs_dropout_prob
        self.transformer_self_attention = nn.Module()
        self.transformer_self_attention.selfatt = _SelfAtt(h)
        self.transformer_self_attention.dense_norm = _DenseNorm(
            h, h, cfg.layer_norm_eps)
        self.intermediate = nn.Module()
        self.intermediate.dense = TorchLinear(h, cfg.intermediate_size)
        self.output = _DenseNorm(cfg.intermediate_size, h, cfg.layer_norm_eps)
        self.tp = None

    def forward(self, x, bias, generator=None):
        sa = self.transformer_self_attention
        train = self.training
        tp = self.tp
        xc = column_input(x, tp)
        ctx = multihead_attention(
            sa.selfatt.query(xc), sa.selfatt.key(xc), sa.selfatt.value(xc),
            self.num_heads // (tp.size if tp else 1), bias,
            attn_dropout=self.attn_dropout if train else 0.0,
            generator=generator, head_split=tp and tp.head_split(1))
        attn_out = dropout(row_linear(ctx, sa.dense_norm.dense, tp),
                           self.hidden_dropout, train, generator)
        x = sa.dense_norm.LayerNorm(attn_out, x)
        inter = gelu_erf(self.intermediate.dense(column_input(x, tp)))
        out = dropout(row_linear(inter, self.output.dense, tp),
                      self.hidden_dropout, train, generator)
        return self.output.LayerNorm(out, x)


class UttTransEncoder(nn.Module):
    """Learned-positional post-LN encoder stack."""

    def __init__(self, cfg: EncoderConfig, num_layers: int, max_len: int):
        super().__init__()
        self.position_embeddings = nn.Embedding(max_len, cfg.hidden_size)
        nn.init.normal_(self.position_embeddings.weight, std=1.0)
        self.layer = nn.ModuleList(EncoderLayer(cfg)
                                   for _ in range(num_layers))

    def forward(self, feature_input, mask=None, generator=None):
        """feature_input (B, S, H); mask (B, S) binary, 1 = valid; `generator`
        feeds the dropouts in train mode."""
        s = feature_input.shape[1]
        pos = self.position_embeddings.weight[:s].to(feature_input.dtype)
        x = feature_input + pos[None]
        bias = (None if mask is None
                else (1.0 - mask.float()) * ADDITIVE_MASK_VALUE)
        for layer in self.layer:
            x = layer(x, bias, generator)
        return x
