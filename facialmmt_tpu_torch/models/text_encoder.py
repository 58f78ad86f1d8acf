"""RoBERTa/BERT dialogue text encoder (counterpart of
facialmmt_tpu/models/text_encoder.py; reference src/models.py:72-104).

  * RoBERTa position ids: pads get padding_idx, real tokens padding_idx +
    their running count; BERT: plain arange, token type 0 everywhere;
  * post-LN layers, exact-erf GELU, LayerNorm eps from the config;
  * padding bias (1 - mask) * -1e30 over the keys;
  * attention through kernel 1 (ops/kernels/attention.py) on a CUDA tensor;
    the plain version on the CPU, and in train mode with attention-probability
    dropout active (the mask cannot be applied inside the kernel; the JAX
    package takes its plain path there too);
  * hidden dropout after the embeddings and after both dense outputs.
Parameter names follow the HF state_dict (torch_export.export_hf_text_encoder).
"""

from __future__ import annotations

import torch
from torch import nn

from facialmmt_tpu_torch.config import TextEncoderConfig
from facialmmt_tpu_torch.ops.kernels.attention import fused_attention
from facialmmt_tpu_torch.ops.encoder import multihead_attention
from facialmmt_tpu_torch.ops.layers import (LayerNormTF, TorchLinear, dropout,
                                            gelu_erf)

BIG_NEG = -1e30


def roberta_position_ids(input_ids, padding_idx: int):
    mask = (input_ids != padding_idx).to(torch.int64)
    return torch.cumsum(mask, dim=1) * mask + padding_idx


class _Dense(nn.Module):
    def __init__(self, d_in: int, d_out: int, eps: float | None = None):
        super().__init__()
        self.dense = TorchLinear(d_in, d_out)
        if eps is not None:
            self.LayerNorm = LayerNormTF(d_out, eps)


class TextEncoderLayer(nn.Module):
    def __init__(self, cfg: TextEncoderConfig):
        super().__init__()
        h = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.hidden_dropout = cfg.hidden_dropout_prob
        self.attn_dropout = cfg.attention_probs_dropout_prob
        self.attention = nn.Module()
        self.attention.self = nn.Module()
        for name in ("query", "key", "value"):
            setattr(self.attention.self, name, TorchLinear(h, h))
        self.attention.output = _Dense(h, h, cfg.layer_norm_eps)
        self.intermediate = _Dense(h, cfg.intermediate_size)
        self.output = _Dense(cfg.intermediate_size, h, cfg.layer_norm_eps)

    def forward(self, x, bias, generator=None):
        b, s, h = x.shape
        nh = self.num_heads
        hd = h // nh
        sa = self.attention.self
        train = self.training
        if train and self.attn_dropout > 0.0:
            ctx = multihead_attention(sa.query(x), sa.key(x), sa.value(x), nh,
                                      bias, attn_dropout=self.attn_dropout,
                                      generator=generator)
        else:
            def heads(t):
                return t.reshape(b, s, nh, hd).transpose(1, 2).contiguous()

            ctx = fused_attention(heads(sa.query(x) * hd ** -0.5),
                                  heads(sa.key(x)), heads(sa.value(x)), bias)
            ctx = ctx.transpose(1, 2).reshape(b, s, h)
        ao = self.attention.output
        x = ao.LayerNorm(dropout(ao.dense(ctx), self.hidden_dropout, train,
                                 generator) + x)
        inter = gelu_erf(self.intermediate.dense(x))
        out = dropout(self.output.dense(inter), self.hidden_dropout, train,
                      generator)
        return self.output.LayerNorm(out + x)


class TextEncoder(nn.Module):
    """(B, S) ids + mask -> last hidden state (B, S, hidden_size)."""

    def __init__(self, cfg: TextEncoderConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.embeddings = nn.Module()
        self.embeddings.word_embeddings = nn.Embedding(cfg.vocab_size, h)
        self.embeddings.position_embeddings = nn.Embedding(
            cfg.max_position_embeddings, h)
        self.embeddings.token_type_embeddings = nn.Embedding(
            cfg.type_vocab_size, h)
        self.embeddings.LayerNorm = LayerNormTF(h, cfg.layer_norm_eps)
        self.encoder = nn.Module()
        self.encoder.layer = nn.ModuleList(TextEncoderLayer(cfg)
                                           for _ in range(cfg.num_layers))

    def forward(self, input_ids, attention_mask, generator=None):
        cfg = self.cfg
        emb = self.embeddings
        input_ids = input_ids.long()
        if cfg.model_type == "roberta":
            pos_ids = roberta_position_ids(input_ids, cfg.pad_token_id)
        else:
            pos_ids = torch.arange(input_ids.shape[1],
                                   device=input_ids.device)[None, :]
        x = (emb.word_embeddings(input_ids).float()
             + emb.position_embeddings(pos_ids).float()
             + emb.token_type_embeddings.weight[0].float())
        dtype = emb.word_embeddings.weight.dtype
        x = dropout(emb.LayerNorm(x), cfg.hidden_dropout_prob, self.training,
                    generator).to(dtype)
        bias = ((1.0 - attention_mask.float()) * BIG_NEG).contiguous()
        for layer in self.encoder.layer:
            x = layer(x, bias, generator)
        return x
