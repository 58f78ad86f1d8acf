"""RoBERTa/BERT dialogue text encoder (counterpart of
facialmmt_tpu/models/text_encoder.py; reference src/models.py:72-104).

  * RoBERTa position ids: pads get padding_idx, real tokens padding_idx +
    their running count; BERT: plain arange, token type 0 everywhere;
  * post-LN layers, exact-erf GELU, LayerNorm eps from the config; at
    inference on the card each residual add and LayerNorm is one kernel
    pass and the GELU stays in the activations' dtype (ops/layers.py);
  * padding bias (1 - mask) * -1e30 over the keys;
  * attention through kernel 1 (ops/kernels/attention.py) on a CUDA tensor;
    the plain version on the CPU, and in train mode with attention-probability
    dropout active (the mask cannot be applied inside the kernel; the JAX
    package takes its plain path there too);
  * hidden dropout after the embeddings and after both dense outputs;
  * each layer under torch.utils.checkpoint when resolve_remat(cfg.remat,
    B * S, 4096) holds (JAX: nn.remat on each layer above 4096 tokens), its
    dropout masks replayed in the recompute (ops/layers.py::checkpointed);
  * tensor-parallel layers (parallel/mesh.py::shard_model_ sets `tp`):
    query, key, value and intermediate.dense column-parallel,
    attention.output.dense and output.dense row-parallel, the attention on
    num_heads / tp local heads (kernel 1 at eval); embeddings, LayerNorms
    and residuals whole.
Parameter names follow the HF state_dict (torch_export.export_hf_text_encoder).
"""

from __future__ import annotations

import torch
from torch import nn

from facialmmt_tpu_torch.config import TextEncoderConfig, resolve_remat
from facialmmt_tpu_torch.ops.kernels.attention import fused_attention
from facialmmt_tpu_torch.ops.encoder import multihead_attention
from facialmmt_tpu_torch.ops.layers import (LayerNormTF, TorchLinear,
                                            checkpointed, column_input,
                                            dropout, gelu_erf, row_linear)
from facialmmt_tpu_torch.parallel import context

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
        self.tp = None

    def forward(self, x, bias, generator=None):
        b, s, h = x.shape
        tp = self.tp
        nh = self.num_heads // (tp.size if tp else 1)
        hd = h // self.num_heads
        hl = nh * hd                      # this rank's width of q, k, v
        sa = self.attention.self
        train = self.training
        xc = column_input(x, tp)
        if train and self.attn_dropout > 0.0:
            ctx = multihead_attention(sa.query(xc), sa.key(xc), sa.value(xc),
                                      nh, bias, attn_dropout=self.attn_dropout,
                                      generator=generator,
                                      head_split=tp and tp.head_split(1))
        else:
            def heads(t):
                return t.reshape(b, s, nh, hd).transpose(1, 2).contiguous()

            ctx = fused_attention(heads(sa.query(xc) * hd ** -0.5),
                                  heads(sa.key(xc)), heads(sa.value(xc)), bias)
            ctx = ctx.transpose(1, 2).reshape(b, s, hl)
        ao = self.attention.output
        x = ao.LayerNorm(dropout(row_linear(ctx, ao.dense, tp),
                                 self.hidden_dropout, train, generator), x)
        inter = gelu_erf(self.intermediate.dense(column_input(x, tp)))
        out = dropout(row_linear(inter, self.output.dense, tp),
                      self.hidden_dropout, train, generator)
        return self.output.LayerNorm(out, x)


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
        shard = context.current()
        tokens = input_ids.numel() * (shard.parts if shard else 1)
        remat = (torch.is_grad_enabled()
                 and resolve_remat(cfg.remat, tokens, 4096))
        for layer in self.encoder.layer:
            x = (checkpointed(layer, x, bias, generator=generator) if remat
                 else layer(x, bias, generator))
        return x
