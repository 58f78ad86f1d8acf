"""T+A+V crossmodal fusion model (counterpart of
facialmmt_tpu/models/multimodal.py; reference src/models.py:41-188).

  text:   unique dialogues -> TextEncoder -> Linear -> gather per utterance
          (dia_idx) -> span extraction;
  audio:  Linear -> UttTransEncoder (audio_utt_transformer_num layers);
  vision: Linear(512 + 7 -> H) -> UttTransEncoder;
  fusion: one shared CrossModalTrans_TA applied T->A and A->T, concatenated,
          then one shared CrossModalTrans_TA_V applied (T|A)<->V;
  pool:   additive attention over the concatenated mask -> classifier.

Only the T+A+V crossmodal configuration is ported so far; the modality
subsets and concat fusion of the appendix raise.
"""

from __future__ import annotations

import torch
from torch import nn

from facialmmt_tpu_torch.config import FacialMMTConfig, resolve_text_config
from facialmmt_tpu_torch.models.text_encoder import TextEncoder
from facialmmt_tpu_torch.ops.crossmodal import CrossModalTransformerEncoder
from facialmmt_tpu_torch.ops.encoder import UttTransEncoder
from facialmmt_tpu_torch.ops.layers import (AdditiveAttention, TorchLinear,
                                            dropout)
from facialmmt_tpu_torch.ops.span_extract import extract_utt_spans


def text_prefix(cfg: FacialMMTConfig) -> str:
    """State-dict attribute of the text tower, named after the checkpoint as
    the reference does (reference src/models.py:73-76)."""
    return "roberta" if "roberta" in cfg.plm_name else "bert"


class MultiModalTransformerForClassification(nn.Module):
    def __init__(self, cfg: FacialMMTConfig):
        super().__init__()
        if cfg.choice_modality != "T+A+V" or cfg.modality_fuse != "crossmodal":
            raise NotImplementedError(
                "only choice_modality='T+A+V' with crossmodal fusion is ported")
        self.cfg = cfg
        h = cfg.hidden_size
        d = cfg.data
        text_cfg = resolve_text_config(cfg)
        self.is_roberta = text_cfg.model_type == "roberta"
        self.text_prefix = text_prefix(cfg)
        setattr(self, self.text_prefix, TextEncoder(text_cfg))
        self.text_linear = TorchLinear(text_cfg.hidden_size, h)
        self.audio_linear = TorchLinear(d.audio_feat_dim, h)
        self.audio_utt_transformer = UttTransEncoder(
            cfg.encoder, cfg.audio_utt_transformer_num, d.audio_utt_max_len)
        self.vision_linear = TorchLinear(cfg.vision_emb_dim, h)
        self.vision_utt_transformer = UttTransEncoder(
            cfg.encoder, cfg.vision_utt_transformer_num, d.vision_utt_max_len)
        self.attention = AdditiveAttention(h, h)
        max_pos = max(d.text_utt_max_len + d.audio_utt_max_len
                      + d.vision_utt_max_len, 16)
        def crossmodal(cm):
            return CrossModalTransformerEncoder(
                h, cm.num_heads, cm.layers, cm.attn_mask, max_pos,
                cm.attn_dropout, cm.gelu_dropout, cm.res_dropout,
                cm.embed_dropout)

        self.CrossModalTrans_TA = crossmodal(cfg.crossmodal_ta)
        self.CrossModalTrans_TA_V = crossmodal(cfg.crossmodal_ta_v)
        self.classifier = TorchLinear(h, cfg.num_labels)

    def forward(self, dia_input_ids, dia_input_mask, dia_sep_mask,
                audio_inputs, audio_mask, vision_inputs, vision_mask,
                utt_in_dia_idx, dia_idx=None, generator=None):
        """dia_* (num_dia, L) unique dialogues; dia_idx (B,) gathers them per
        utterance (None = one dialogue per utterance); vision_inputs
        (B, F, vision_feat_dim + num_labels) already filtered; `generator`
        feeds the dropouts in train mode.  -> logits."""
        cfg = self.cfg
        g = generator
        enc = getattr(self, self.text_prefix)(dia_input_ids, dia_input_mask, g)
        text_lin = self.text_linear(enc)
        if dia_idx is not None:
            dia_idx = dia_idx.long()
            text_lin = text_lin[dia_idx]
            dia_sep_mask = dia_sep_mask[dia_idx]
        text_feat, text_mask = extract_utt_spans(
            text_lin, dia_sep_mask, utt_in_dia_idx,
            max_utt_len=cfg.data.text_utt_max_len, is_roberta=self.is_roberta)

        audio = self.audio_utt_transformer(self.audio_linear(audio_inputs),
                                           audio_mask, g)
        vision = self.vision_utt_transformer(self.vision_linear(vision_inputs),
                                             vision_mask, g)

        cm_ta, cm_tav = self.CrossModalTrans_TA, self.CrossModalTrans_TA_V
        ta = torch.cat([cm_ta(text_feat, audio, audio, g),
                        cm_ta(audio, text_feat, text_feat, g)], dim=1)
        final_feat = torch.cat([cm_tav(ta, vision, vision, g),
                                cm_tav(vision, ta, ta, g)], dim=1)
        final_mask = torch.cat([text_mask, audio_mask.to(text_mask.dtype),
                                vision_mask.to(text_mask.dtype)], dim=1)
        pooled, _ = self.attention(final_feat, final_mask)
        pooled = dropout(pooled, cfg.encoder.hidden_dropout_prob,
                         self.training, g)
        return self.classifier(pooled)
