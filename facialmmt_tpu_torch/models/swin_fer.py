"""Swin FER model: shared backbone + emotion head (counterpart of
facialmmt_tpu/models/swin_fer.py; reference src/models.py:14-37).

Head: Linear(512 -> 64) -> ReLU -> Linear(64 -> num_labels); in target-task
mode the logits pass through gumbel-softmax(tau).
"""

from __future__ import annotations

import torch
from torch import nn

from facialmmt_tpu_torch.config import FacialMMTConfig
from facialmmt_tpu_torch.ops.gumbel import gumbel_softmax
from facialmmt_tpu_torch.ops.layers import TorchLinear
from facialmmt_tpu_torch.ops.swin import SwinTransformer


class SwinForAffwildClassification(nn.Module):
    def __init__(self, cfg: FacialMMTConfig):
        super().__init__()
        self.cfg = cfg
        self.swin = SwinTransformer(cfg.swin)
        self.linear = TorchLinear(cfg.swin.out_feature_dim, 64)
        self.classifier = TorchLinear(64, cfg.num_labels)

    def forward(self, images, *, is_trg_task: bool = False,
                generator: torch.Generator | None = None,
                noise: torch.Tensor | None = None, keeps=None,
                attention_impl: str | None = None):
        """images (N, H, W, 3) normalised, channel-last.  Returns logits, or
        in target-task mode the gumbel-softmax distribution (sampled from
        `generator` / `noise` unless runtime.deterministic_gumbel).  In train
        mode `generator` also feeds the backbone's stochastic depth (`keeps`
        overrides that draw) and `attention_impl` overrides
        swin.attention_impl for this call (see SwinTransformer.forward)."""
        x = torch.relu(self.linear(self.swin(
            images, generator=generator, keeps=keeps,
            attention_impl=attention_impl)))
        logits = self.classifier(x)
        if not is_trg_task:
            return logits
        return gumbel_softmax(logits, self.cfg.tau,
                              deterministic=self.cfg.runtime.deterministic_gumbel,
                              generator=generator, noise=noise)
