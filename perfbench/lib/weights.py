"""Weights drawn from the run's seed, on the device, in a few large calls.

Every parameter of the reference module is a view of one flat buffer drawn
in bfloat16 (the type the program serves in, so the program and the
reference hold the same values): matrices and biases N(0, 0.02^2), norm and
BatchNorm scales 1 + N(0, 0.02^2), the pooling query N(0, 1).  Buffers keep
what the module built (BatchNorm running statistics 0 and 1, index and mask
tables)."""

from __future__ import annotations

import torch

STD = 0.02


def weight_generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device).manual_seed(seed % (2 ** 63))


@torch.no_grad()
def draw_(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Fill `model`'s parameters in place from `seed` (see module doc)."""
    params = list(model.named_parameters())
    device = params[0][1].device
    total = sum(p.numel() for _, p in params)
    flat = torch.empty(total, dtype=torch.bfloat16, device=device)
    flat.normal_(0.0, STD, generator=weight_generator(seed, device))
    flat = flat.float()
    at = 0
    for name, p in params:
        part = flat[at:at + p.numel()].view_as(p)
        at += p.numel()
        leaf = name.rsplit(".", 1)[-1]
        if name.endswith("query_vector"):
            part = part / STD
        elif p.dim() == 1 and leaf == "weight":
            part = part + 1.0
        p.copy_(part)
    return model


def state_dict(model: torch.nn.Module) -> dict:
    """The weights the program is handed: the reference's state_dict."""
    return {k: v for k, v in model.state_dict().items()}
