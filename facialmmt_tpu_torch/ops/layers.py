"""Core layers shared across the port (counterpart of facialmmt_tpu/ops/layers.py)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

NEG_INF = -1e30  # large-negative instead of -inf: fully masked rows stay finite


def dropout(x, p: float, training: bool,
            generator: torch.Generator | None = None):
    """Inverted dropout whose mask is drawn from an explicit generator (the
    default generator of x's device when None); identity in eval or p = 0."""
    if not training or p == 0.0:
        return x
    mask = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return x * mask.to(x.dtype) / (1.0 - p)


class TorchLinear(nn.Linear):
    """nn.Linear (default torch init) that computes in its weight's dtype:
    the input is cast first, as the JAX TorchLinear casts to its `dtype`."""

    def forward(self, x):
        return F.linear(x.to(self.weight.dtype), self.weight, self.bias)


class XavierLinear(TorchLinear):
    """Linear with xavier_uniform weight + zero bias, as the crossmodal stack
    uses (reference modules/CrossmodalTransformer.py:188-193)."""

    def reset_parameters(self):
        nn.init.xavier_uniform_(self.weight)
        if self.bias is not None:
            nn.init.zeros_(self.bias)


class LayerNormTF(nn.Module):
    """TF-style LayerNorm: eps inside the square root, biased variance, fp32
    statistics; returns the input's dtype."""

    def __init__(self, dim: int, eps: float = 1e-12):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        xf = x.float()
        u = xf.mean(-1, keepdim=True)
        s = (xf - u).square().mean(-1, keepdim=True)
        y = (xf - u) * torch.rsqrt(s + self.eps)
        y = self.weight.float() * y + self.bias.float()
        return y.to(x.dtype)


class AdditiveAttention(nn.Module):
    """Masked additive-attention pooling (reference modules/Transformer.py:8-45):
    score_t = v^T tanh(P(x_t) + Q(q)); alpha = softmax(score + mask); out = alpha @ x.
    Returns the squeezed input when seq_len == 1, as the reference does."""

    def __init__(self, inputs_dim: int, hidden_dim: int):
        super().__init__()
        self.query_vector = nn.Parameter(torch.randn(inputs_dim))
        self.P = TorchLinear(inputs_dim, hidden_dim)
        self.Q = TorchLinear(inputs_dim, hidden_dim)
        self.value = TorchLinear(hidden_dim, 1)

    def forward(self, inputs, mask=None):
        """inputs (B, S, D); mask (B, S) with 1 = valid."""
        b, seq_len, _ = inputs.shape
        if seq_len == 1:
            return inputs[:, 0], torch.ones((b, 1), dtype=inputs.dtype,
                                            device=inputs.device)
        h = torch.tanh(self.P(inputs) + self.Q(self.query_vector))
        scores = self.value(h)[..., 0]
        if mask is not None:
            scores = scores.masked_fill(mask == 0, NEG_INF)
        alpha = torch.softmax(scores.float(), dim=-1).to(inputs.dtype)
        return torch.einsum("bs,bsd->bd", alpha, inputs), alpha


def gelu_erf(x):
    """Exact-erf GELU computed in fp32, returned in x's dtype."""
    return F.gelu(x.float()).to(x.dtype)
