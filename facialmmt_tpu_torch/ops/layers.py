"""Core layers shared across the port (counterpart of facialmmt_tpu/ops/layers.py)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from facialmmt_tpu_torch.ops.kernels.add_layernorm import fused_add_layernorm
from facialmmt_tpu_torch.parallel import context

NEG_INF = -1e30  # large-negative instead of -inf: fully masked rows stay finite


def dropout(x, p: float, training: bool,
            generator: torch.Generator | None = None, split=None):
    """Inverted dropout whose mask is drawn from an explicit generator (the
    default generator of x's device when None); identity in eval or p = 0.
    The mask is drawn by parallel/context.py::rand: at the global shape
    under a data shard, and with `split` = (dim, parts, index) at `parts`
    times x's size on `dim` (a tensor-parallel rank's heads or hidden
    units), keeping this rank's part."""
    if not training or p == 0.0:
        return x
    mask = context.rand(x.shape, generator, x.device, split=split) >= p
    return x * mask.to(x.dtype) / (1.0 - p)


def checkpointed(fn, *args, generator: torch.Generator | None = None):
    """fn(*args, generator) under torch.utils.checkpoint (non-reentrant):
    its activations are recomputed in the backward instead of kept.
    torch.utils.checkpoint restores only the default generators before the
    recompute, so the draws `fn` takes from an explicit `generator` are
    replayed here: the recompute starts from the generator's state at the
    forward, under the forward's data shard, and the generator is put back
    where the step left it afterwards.  The recompute thus uses the
    forward's dropout masks and the generator ends the step where a step
    without checkpointing leaves it."""
    from torch.utils.checkpoint import checkpoint

    start = None if generator is None else generator.get_state()
    shard = context.current()
    calls = []

    def run(*a):
        calls.append(None)
        if len(calls) == 1:
            return fn(*a, generator)
        now = None if generator is None else generator.get_state()
        if generator is not None:
            generator.set_state(start)
        try:
            with context.restore(shard):
                return fn(*a, generator)
        finally:
            if generator is not None:
                generator.set_state(now)

    return checkpoint(run, *args, use_reentrant=False)


def column_input(x, tp):
    """The input of a column-parallel product of a tensor-parallel layer
    (`tp`: its parallel/comm.py::ModelShard, None when the layer is whole):
    the identity, whose backward sums the gradient over the model group."""
    if tp is None:
        return x
    from facialmmt_tpu_torch.parallel.comm import copy_to_model

    return copy_to_model(x, tp.group)


def row_linear(x, linear: nn.Linear, tp):
    """linear(x) where `linear` is row-parallel under `tp`: this rank's
    partial product, summed over the model group, then the (replicated)
    bias."""
    if tp is None:
        return linear(x)
    from facialmmt_tpu_torch.parallel.comm import reduce_from_model

    y = reduce_from_model(F.linear(x.to(linear.weight.dtype), linear.weight),
                          tp.group)
    return y if linear.bias is None else y + linear.bias.to(y.dtype)


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
    statistics; returns the input's dtype.  forward(x, residual) normalises
    x + residual, the post-LN block's sum: at inference on the card one
    kernel pass (ops/kernels/add_layernorm.py), under grad or on the CPU the
    add and the fp32 chain."""

    def __init__(self, dim: int, eps: float = 1e-12):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x, residual=None):
        return fused_add_layernorm(x, residual, self.weight, self.bias,
                                   self.eps)


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
    """Exact-erf GELU computed in fp32, returned in x's dtype.  At inference
    on the card in x's own dtype: PyTorch's CUDA GELU computes a bf16 input
    in fp32 registers and rounds once, the same bits without the fp32
    copies; under grad the chain autograd has always differentiated."""
    if x.is_cuda and not torch.is_grad_enabled():
        return F.gelu(x)
    return F.gelu(x.float()).to(x.dtype)
