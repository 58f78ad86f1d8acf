"""Pre-LN crossmodal (MulT-style) transformer encoder (counterpart of
facialmmt_tpu/ops/crossmodal.py; reference modules/CrossmodalTransformer.py).

Preserved semantics:
  * inputs scaled by sqrt(embed_dim) BEFORE the positional embedding;
  * positions keyed off channel 0 of the features: position i takes sinusoidal
    row i + 1 when x[i, 0] != 0 and the zero row otherwise;
  * one packed (3E, E) qkv projection (in_proj_weight);
  * no key-padding mask (masking happens at the final pooling);
  * the SAME first LayerNorm normalises q, k and v in cross-attention mode;
  * the optional banded future mask;
  * final LayerNorm (eps 1e-5) after the stack.
Parameter and buffer names follow the reference state_dict
(torch_export.export_crossmodal), including the `version` and
`embed_positions._float_tensor` buffers.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from facialmmt_tpu_torch.ops.encoder import multihead_attention
from facialmmt_tpu_torch.ops.layers import (LayerNormTF, XavierLinear,
                                            column_input, dropout, gelu_erf,
                                            row_linear)


def sinusoidal_table(num_rows: int, embedding_dim: int) -> np.ndarray:
    """fairseq sinusoidal table [sin | cos], row 0 zeroed."""
    half = embedding_dim // 2
    emb = math.log(10000) / (half - 1)
    freq = np.exp(np.arange(half, dtype=np.float64) * -emb)
    angles = np.arange(num_rows, dtype=np.float64)[:, None] * freq[None, :]
    table = np.concatenate([np.sin(angles), np.cos(angles)], axis=1)
    if embedding_dim % 2 == 1:
        table = np.concatenate([table, np.zeros((num_rows, 1))], axis=1)
    table[0, :] = 0
    return table.astype(np.float32)


def channel0_positional_embedding(x, table):
    """x (B, S, D) -> (B, S, D) rows of `table` keyed off channel 0."""
    s = x.shape[1]
    rows = torch.arange(1, s + 1, device=x.device)[None, :]
    idx = torch.where(x[:, :, 0] != 0, rows, 0)
    return table[idx]


def banded_future_mask(tq: int, tk: int, device) -> torch.Tensor:
    """(Tq, Tk) additive: -1e30 where j - i >= 1 + |tk - tq|."""
    i = torch.arange(tq, device=device)[:, None]
    j = torch.arange(tk, device=device)[None, :]
    return torch.where(j - i >= 1 + abs(tk - tq), -1e30, 0.0)


class PackedMultiheadAttention(nn.Module):
    """fairseq-style MHA with one packed (3E, E) qkv projection.

    Tensor-parallel (`tp` set by parallel/mesh.py::shard_model_): the packed
    weight holds rows [r E/tp, (r+1) E/tp) of EACH of its q, k and v blocks,
    stacked (3E/tp, E), the same for the bias; out_proj is row-parallel."""

    def __init__(self, embed_dim: int, num_heads: int,
                 attn_dropout: float = 0.0):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.attn_dropout = attn_dropout
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        nn.init.xavier_uniform_(self.in_proj_weight)
        self.out_proj = XavierLinear(embed_dim, embed_dim)
        self.tp = None

    def forward(self, query, key, value, attn_bias=None, generator=None):
        """query (B, Tq, E), key/value (B, Tk, E), attn_bias (Tq, Tk) or
        None; under tp the inputs have been through column_input."""
        tp = self.tp
        w = self.in_proj_weight
        e = w.shape[0] // 3
        bias = self.in_proj_bias
        cd = w.dtype
        q = F.linear(query.to(cd), w[:e], bias[:e])
        k = F.linear(key.to(cd), w[e:2 * e], bias[e:2 * e])
        v = F.linear(value.to(cd), w[2 * e:], bias[2 * e:])
        # no key-padding mask; the banded mask keeps the plain path
        ctx = multihead_attention(
            q, k, v, self.num_heads // (tp.size if tp else 1),
            attn_mask=attn_bias,
            attn_dropout=self.attn_dropout if self.training else 0.0,
            generator=generator, head_split=tp and tp.head_split(1))
        return row_linear(ctx, self.out_proj, tp)


class CrossModalLayer(nn.Module):
    """Pre-LN block (reference modules/CrossmodalTransformer.py:98-171).
    Tensor-parallel when `tp` is set: the attention as above, fc1
    column-parallel, fc2 row-parallel."""

    def __init__(self, embed_dim: int, num_heads: int, attn_mask: bool = False,
                 attn_dropout: float = 0.0, gelu_dropout: float = 0.0,
                 res_dropout: float = 0.0):
        super().__init__()
        self.attn_mask = attn_mask
        self.gelu_dropout = gelu_dropout
        self.res_dropout = res_dropout
        self.self_attn = PackedMultiheadAttention(embed_dim, num_heads,
                                                  attn_dropout)
        self.fc1 = XavierLinear(embed_dim, 4 * embed_dim)
        self.fc2 = XavierLinear(4 * embed_dim, embed_dim)
        self.layer_norms = nn.ModuleList([LayerNormTF(embed_dim, 1e-5),
                                          LayerNormTF(embed_dim, 1e-5)])
        self.num_heads = num_heads
        self.tp = None

    def forward(self, x, x_k=None, x_v=None, generator=None):
        ln0, ln1 = self.layer_norms
        train = self.training
        tp = self.tp
        xq = ln0(x)
        bias = None
        if self.attn_mask:
            tk = xq.shape[1] if x_k is None else x_k.shape[1]
            bias = banded_future_mask(xq.shape[1], tk, x.device)
        xq = column_input(xq, tp)
        if x_k is None and x_v is None:
            h = self.self_attn(xq, xq, xq, bias, generator)
        else:
            h = self.self_attn(xq, column_input(ln0(x_k), tp),
                               column_input(ln0(x_v), tp), bias, generator)
        x = x + dropout(h, self.res_dropout, train, generator)
        h = dropout(gelu_erf(self.fc1(column_input(ln1(x), tp))),
                    self.gelu_dropout, train, generator,
                    tp and tp.head_split(2))
        return x + dropout(row_linear(h, self.fc2, tp), self.res_dropout,
                           train, generator)


class CrossModalTransformerEncoder(nn.Module):
    """Call with (x,) for self-attention, (x, x_k, x_v) for cross-attention;
    shapes (batch, seq, embed_dim)."""

    def __init__(self, embed_dim: int, num_heads: int, layers: int,
                 attn_mask: bool = False, max_positions: int = 1024,
                 attn_dropout: float = 0.0, gelu_dropout: float = 0.0,
                 res_dropout: float = 0.0, embed_dropout: float = 0.0):
        super().__init__()
        self.embed_scale = math.sqrt(embed_dim)
        self.embed_dropout = embed_dropout
        self.register_buffer("version", torch.tensor([2.0]))
        self.embed_positions = nn.Module()
        self.embed_positions.register_buffer("_float_tensor", torch.zeros(1))
        self.register_buffer(
            "pos_table",
            torch.from_numpy(sinusoidal_table(max_positions + 1, embed_dim)),
            persistent=False)
        self.layers = nn.ModuleList(
            CrossModalLayer(embed_dim, num_heads, attn_mask, attn_dropout,
                            gelu_dropout, res_dropout)
            for _ in range(layers))
        self.layer_norm = LayerNormTF(embed_dim, 1e-5)

    def _embed(self, z, generator):
        pe = channel0_positional_embedding(z, self.pos_table).to(z.dtype)
        return dropout(self.embed_scale * z + pe, self.embed_dropout,
                       self.training, generator)

    def forward(self, x_in, x_in_k=None, x_in_v=None, generator=None):
        x = self._embed(x_in, generator)
        cross = x_in_k is not None and x_in_v is not None
        if cross:
            x_k = self._embed(x_in_k, generator)
            x_v = self._embed(x_in_v, generator)
        for layer in self.layers:
            x = (layer(x, x_k, x_v, generator) if cross
                 else layer(x, generator=generator))
        return self.layer_norm(x)
