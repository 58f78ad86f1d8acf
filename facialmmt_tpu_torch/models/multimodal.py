"""Multimodal fusion model (counterpart of facialmmt_tpu/models/multimodal.py;
reference src/models.py:41-188, and (Appendix)CCAC2023/src/models.py:10-225
for the modality subsets and concat fusion).

  text:   unique dialogues -> TextEncoder -> Linear -> gather per utterance
          (dia_idx) -> span extraction;
  audio:  Linear -> UttTransEncoder (audio_utt_transformer_num layers);
  vision: Linear -> UttTransEncoder;
  fusion (crossmodal, T+A+V): one shared CrossModalTrans_TA applied T->A and
          A->T, concatenated on the sequence axis, then one shared
          CrossModalTrans_TA_V applied (T|A)<->V; T+A stops after the first
          stack, T+V has its own CrossModalTrans_TV;
  fusion (concat): each stream pooled by the one `attention` module, the
          pooled vectors concatenated, then `multimodal_linear`;
  T only: the span tokens pooled alone;
  pool:   additive attention over the concatenated mask -> classifier.

Only the towers the configuration uses are built, so a state_dict of a
subset loads with strict=True.  `vision_in_dim` is the width of the vision
features the model is given: cfg.vision_emb_dim (InceptionResnet 512 + the
7-d FER distribution) behind the FER pipeline, the raw feature width on the
feature datasets (M3ED, MELD dialogues), where flax infers it.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from facialmmt_tpu_torch.config import FacialMMTConfig, resolve_text_config
from facialmmt_tpu_torch.models.text_encoder import TextEncoder
from facialmmt_tpu_torch.ops.crossmodal import CrossModalTransformerEncoder
from facialmmt_tpu_torch.ops.encoder import UttTransEncoder
from facialmmt_tpu_torch.ops.layers import (AdditiveAttention, TorchLinear,
                                            dropout)
from facialmmt_tpu_torch.ops.span_extract import extract_utt_spans
from facialmmt_tpu_torch.parallel import context
from facialmmt_tpu_torch.utils.observability import trace_span


def text_prefix(cfg: FacialMMTConfig) -> str:
    """State-dict attribute of the text tower, named after the checkpoint as
    the reference does (reference src/models.py:73-76)."""
    return "roberta" if "roberta" in cfg.plm_name else "bert"


def crossmodal_stack(cfg: FacialMMTConfig, cm, max_positions: int):
    return CrossModalTransformerEncoder(
        cfg.hidden_size, cm.num_heads, cm.layers, cm.attn_mask, max_positions,
        cm.attn_dropout, cm.gelu_dropout, cm.res_dropout, cm.embed_dropout)


class MultiModalTransformerForClassification(nn.Module):
    def __init__(self, cfg: FacialMMTConfig,
                 vision_in_dim: Optional[int] = None):
        super().__init__()
        if cfg.modality_fuse not in ("crossmodal", "concat"):
            raise ValueError(f"unknown modality_fuse {cfg.modality_fuse!r}")
        self.cfg = cfg
        self.use_audio = "A" in cfg.choice_modality
        self.use_vision = "V" in cfg.choice_modality
        h = cfg.hidden_size
        d = cfg.data
        text_cfg = resolve_text_config(cfg)
        self.is_roberta = text_cfg.model_type == "roberta"
        self.text_prefix = text_prefix(cfg)
        setattr(self, self.text_prefix, TextEncoder(text_cfg))
        self.text_linear = TorchLinear(text_cfg.hidden_size, h)
        if self.use_audio:
            self.audio_linear = TorchLinear(d.audio_feat_dim, h)
            self.audio_utt_transformer = UttTransEncoder(
                cfg.encoder, cfg.audio_utt_transformer_num,
                d.audio_utt_max_len)
        if self.use_vision:
            self.vision_linear = TorchLinear(
                vision_in_dim or cfg.vision_emb_dim, h)
            self.vision_utt_transformer = UttTransEncoder(
                cfg.encoder, cfg.vision_utt_transformer_num,
                d.vision_utt_max_len)
        self.attention = AdditiveAttention(h, h)
        self.fuse = ("text" if not (self.use_audio or self.use_vision)
                     else cfg.modality_fuse)
        max_pos = max(d.text_utt_max_len + d.audio_utt_max_len
                      + d.vision_utt_max_len, 16)
        if self.fuse == "crossmodal":
            if self.use_audio:
                self.CrossModalTrans_TA = crossmodal_stack(
                    cfg, cfg.crossmodal_ta, max_pos)
                if self.use_vision:
                    self.CrossModalTrans_TA_V = crossmodal_stack(
                        cfg, cfg.crossmodal_ta_v, max_pos)
            else:
                self.CrossModalTrans_TV = crossmodal_stack(
                    cfg, cfg.crossmodal_ta, max_pos)
        elif self.fuse == "concat":
            streams = 1 + self.use_audio + self.use_vision
            self.multimodal_linear = TorchLinear(streams * h, h)
        self.classifier = TorchLinear(h, cfg.num_labels)

    def forward(self, dia_input_ids, dia_input_mask, dia_sep_mask,
                audio_inputs=None, audio_mask=None, vision_inputs=None,
                vision_mask=None, utt_in_dia_idx=None, dia_idx=None,
                generator=None):
        """dia_* (num_dia, L) unique dialogues; dia_idx (B,) gathers them per
        utterance (None = one dialogue per utterance; under a data shard the
        dialogue slots of every rank are gathered first); vision_inputs
        (B, F, vision_in_dim), already filtered behind the FER pipeline; the
        streams the configuration does not use are ignored; `generator`
        feeds the dropouts in train mode.  -> logits (B, num_labels)."""
        g = generator
        with trace_span("fmmt.model.text"):
            text_feat, text_mask = self._text(dia_input_ids, dia_input_mask,
                                              dia_sep_mask, utt_in_dia_idx,
                                              dia_idx, g)
        feats, masks = [text_feat], [text_mask]
        with trace_span("fmmt.model.encoders"):
            if self.use_audio:
                feats.append(self.audio_utt_transformer(
                    self.audio_linear(audio_inputs), audio_mask, g))
                masks.append(audio_mask.to(text_mask.dtype))
            if self.use_vision:
                feats.append(self.vision_utt_transformer(
                    self.vision_linear(vision_inputs), vision_mask, g))
                masks.append(vision_mask.to(text_mask.dtype))
        if self.fuse == "crossmodal":
            with trace_span("fmmt.model.crossmodal"):
                feats, masks = [self._crossmodal(feats, g)], [
                    torch.cat(masks, dim=1)]
        with trace_span("fmmt.model.head"):
            if self.fuse == "concat":
                pooled = self.multimodal_linear(torch.cat(
                    [self.attention(f, m)[0] for f, m in zip(feats, masks)],
                    dim=-1))
            else:       # the text alone, or the crossmodal streams
                pooled, _ = self.attention(feats[0], masks[0])
            pooled = dropout(pooled, self.cfg.encoder.hidden_dropout_prob,
                             self.training, g)
            return self.classifier(pooled)

    def _text(self, dia_input_ids, dia_input_mask, dia_sep_mask,
              utt_in_dia_idx, dia_idx, g):
        """The text tower over the unique dialogues, text_linear, each
        utterance's dialogue gathered, its span extracted: (feat, mask)."""
        enc = getattr(self, self.text_prefix)(dia_input_ids, dia_input_mask, g)
        text_lin = self.text_linear(enc)
        if dia_idx is not None:
            shard = context.current()
            if shard is not None:     # dia_idx holds global slot indices
                from facialmmt_tpu_torch.parallel.comm import gather_rows

                text_lin = gather_rows(text_lin, shard.group)
                dia_sep_mask = gather_rows(dia_sep_mask, shard.group)
            dia_idx = dia_idx.long()
            text_lin = text_lin[dia_idx]
            dia_sep_mask = dia_sep_mask[dia_idx]
        return extract_utt_spans(
            text_lin, dia_sep_mask, utt_in_dia_idx,
            max_utt_len=self.cfg.data.text_utt_max_len,
            is_roberta=self.is_roberta)

    def _crossmodal(self, feats, g):
        """The crossmodal stacks over the text stream and the others,
        concatenated on the sequence axis."""
        text_feat, other = feats[0], feats[1]
        cm = (self.CrossModalTrans_TA if self.use_audio
              else self.CrossModalTrans_TV)
        fused = torch.cat([cm(text_feat, other, other, g),
                           cm(other, text_feat, text_feat, g)], dim=1)
        if self.use_audio and self.use_vision:
            vision = feats[2]
            cm_tav = self.CrossModalTrans_TA_V
            fused = torch.cat([cm_tav(fused, vision, vision, g),
                               cm_tav(vision, fused, fused, g)], dim=1)
        return fused
