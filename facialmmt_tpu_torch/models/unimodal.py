"""The V-only utterance model (counterpart of
facialmmt_tpu/models/unimodal.py; reference src/models.py:192-223):
Linear(512 -> 768) -> 2-layer post-LN encoder -> additive-attention pool ->
dropout -> Linear(768 -> 7).  Parameter names are the reference's, so a
released `unimodal_model_V.pt` loads with load_state_dict(strict=True).
It reaches no kernel: the encoder's 32-key attention is below the attention
kernel's key threshold (ops/encoder.py::FUSED_MIN_KEYS).
"""

from __future__ import annotations

import torch
from torch import nn

from facialmmt_tpu_torch.config import FacialMMTConfig
from facialmmt_tpu_torch.ops.encoder import UttTransEncoder
from facialmmt_tpu_torch.ops.layers import (AdditiveAttention, TorchLinear,
                                            dropout)


class MeldUttTransformer(nn.Module):
    def __init__(self, cfg: FacialMMTConfig):
        super().__init__()
        h, d = cfg.hidden_size, cfg.data
        self.dropout = cfg.encoder.hidden_dropout_prob
        self.modality_linear = TorchLinear(d.vision_feat_dim, h)
        self.utt_transformer = UttTransEncoder(
            cfg.encoder, cfg.vision_utt_transformer_num, d.vision_utt_max_len)
        self.attention = AdditiveAttention(h, h)
        self.classifier = TorchLinear(h, cfg.num_labels)

    def forward(self, inputs, utt_mask,
                generator: torch.Generator | None = None):
        """inputs (B, vision_utt_max_len, vision_feat_dim), utt_mask (B, L)
        with 1 = valid; `generator` feeds the dropouts in train mode.
        Returns logits (B, num_labels)."""
        x = self.utt_transformer(self.modality_linear(inputs), utt_mask,
                                 generator)
        pooled, _ = self.attention(x, utt_mask)
        pooled = dropout(pooled, self.dropout, self.training, generator)
        return self.classifier(pooled)
