"""Gumbel-softmax (reference src/models.py:31-32, F.gumbel_softmax(logits, tau)).

Sampled mode: y = softmax((logits + g) / tau), g = -log(-log(U)), with the
uniform draw taken from an explicit torch.Generator or passed in as `noise`
(the tests pass the same numpy noise to the JAX package and to this one).
Deterministic mode (runtime.deterministic_gumbel): y = softmax(logits / tau).
"""

from __future__ import annotations

import torch


def gumbel_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel draws g = -log(-log(U)), U ~ U(tiny, 1), fp32."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    u = u.clamp_(min=tiny)
    return -torch.log(-torch.log(u))


def gumbel_softmax(logits, tau: float = 1.0, *, deterministic: bool = False,
                   generator: torch.Generator | None = None,
                   noise: torch.Tensor | None = None):
    """Soft gumbel-softmax sample, matching torch F.gumbel_softmax(hard=False).
    Sampled mode needs either `noise` (Gumbel draws of logits' shape) or a
    `generator` on logits' device."""
    if deterministic:
        return torch.softmax(logits / tau, dim=-1)
    if noise is None:
        if generator is None:
            raise ValueError("sampled gumbel-softmax needs a generator or noise")
        noise = gumbel_noise(logits.shape, generator, logits.device)
    y = (logits.float() + noise.float()) / tau
    return torch.softmax(y, dim=-1).to(logits.dtype)
