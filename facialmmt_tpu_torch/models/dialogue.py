"""Dialogue-level multimodal model (counterpart of
facialmmt_tpu/models/dialogue.py; reference
(Appendix)CCAC2023/src/models.py:228-385).

One sample is one whole dialogue: audio and vision come as (B, D, L, feat),
with the dialogue axis D and the per-utterance frame axis L, and the
crossmodal fusion runs across the DIALOGUE axis (utterances attend to each
other), where the utterance-level model fuses the frames of one utterance.

  * audio / vision: reshape to (B*D, L, feat) -> linear -> post-LN encoder ->
    additive pooling (one `attention_pooling` shared by both streams) ->
    (B, D, H);
  * text: the dialogue's token encoding; the feature at each utterance-final
    sep token becomes that utterance's vector (scatter_sep_features, the
    reference's masked_select and repack by curr_numUtt_in_dia, :318-329);
  * crossmodal: the shared TA stack both directions, concatenated on the
    FEATURE axis -> multimodal_linear2 (2H -> H); then the shared TA_V stack
    with vision both ways, concatenated -> the SAME multimodal_linear2 ->
    per-utterance logits.  Both stacks take up to 256 positions;
  * concat: the three per-utterance vectors concatenated -> multimodal_linear.

The reference emits (num_valid_utt, 7) through masked_select; here logits are
(B, D, num_labels) beside dia_mask, and consumers select with the mask.
"""

from __future__ import annotations

import torch
from torch import nn

from facialmmt_tpu_torch.config import FacialMMTConfig, resolve_text_config
from facialmmt_tpu_torch.models.multimodal import crossmodal_stack, text_prefix
from facialmmt_tpu_torch.models.text_encoder import TextEncoder
from facialmmt_tpu_torch.ops.encoder import UttTransEncoder
from facialmmt_tpu_torch.ops.layers import (AdditiveAttention, TorchLinear,
                                            dropout)

DIALOGUE_MAX_POSITIONS = 256


def scatter_sep_features(text_feats, sep_mask, max_dia_len: int):
    """(B, L, H) dialogue features and their sep mask -> (B, max_dia_len, H)
    where slot u holds the feature at the u-th sep position; seps past
    max_dia_len are dropped and slots without a sep stay zero."""
    sep = sep_mask.long()
    slot = torch.cumsum(sep, dim=1) - 1                  # 0-based utterance
    valid = (sep == 1) & (slot < max_dia_len)
    safe_slot = torch.where(valid, slot, torch.zeros_like(slot))
    b, _, h = text_feats.shape
    out = text_feats.new_zeros((b, max_dia_len, h))
    contrib = text_feats * valid[:, :, None].to(text_feats.dtype)
    batch_idx = torch.arange(b, device=sep.device)[:, None].expand_as(slot)
    return out.index_put((batch_idx, safe_slot), contrib, accumulate=True)


class DialogueMultiModalTransformer(nn.Module):
    def __init__(self, cfg: FacialMMTConfig):
        """The feature widths and lengths come from cfg.data (the data's, as
        main._adapt_static_shapes sets them); vision is the raw features."""
        super().__init__()
        if cfg.modality_fuse not in ("crossmodal", "concat"):
            raise ValueError(f"unknown modality_fuse {cfg.modality_fuse!r}")
        self.cfg = cfg
        h = cfg.hidden_size
        d = cfg.data
        self.attention_pooling = AdditiveAttention(h, h)
        self.audio_linear = TorchLinear(d.audio_feat_dim, h)
        self.audio_utt_transformer = UttTransEncoder(
            cfg.encoder, cfg.audio_utt_transformer_num, d.audio_utt_max_len)
        self.vision_linear = TorchLinear(d.vision_feat_dim, h)
        self.vision_utt_transformer = UttTransEncoder(
            cfg.encoder, cfg.vision_utt_transformer_num, d.vision_utt_max_len)
        text_cfg = resolve_text_config(cfg)
        self.text_prefix = text_prefix(cfg)
        setattr(self, self.text_prefix, TextEncoder(text_cfg))
        self.text_linear = TorchLinear(text_cfg.hidden_size, h)
        if cfg.modality_fuse == "crossmodal":
            self.multimodal_linear2 = TorchLinear(2 * h, h)
            self.CrossModalTrans_TA = crossmodal_stack(
                cfg, cfg.crossmodal_ta, DIALOGUE_MAX_POSITIONS)
            self.CrossModalTrans_TA_V = crossmodal_stack(
                cfg, cfg.crossmodal_ta_v, DIALOGUE_MAX_POSITIONS)
        else:
            self.multimodal_linear = TorchLinear(3 * h, h)
        self.classifier = TorchLinear(h, cfg.num_labels)

    def _utt_stream(self, x, mask, linear, encoder, g):
        b, d_max, l, feat = x.shape
        xf = x.reshape(b * d_max, l, feat)
        mf = mask.reshape(b * d_max, l)
        y = encoder(linear(xf), mf, g)
        pooled, _ = self.attention_pooling(y, mf)
        return pooled.reshape(b, d_max, -1)

    def forward(self, dia_input_ids, dia_input_mask, dia_sep_mask,
                audio_inputs, audio_mask, vision_inputs, vision_mask,
                dia_mask, generator=None):
        """audio_inputs (B, D, La, da), vision_inputs (B, D, Lv, dv), their
        masks (B, D, L*), dia_mask (B, D); `generator` feeds the dropouts in
        train mode.  -> logits (B, D, num_labels)."""
        cfg = self.cfg
        g = generator
        d_max = dia_mask.shape[1]
        audio = self._utt_stream(audio_inputs, audio_mask, self.audio_linear,
                                 self.audio_utt_transformer, g)
        vision = self._utt_stream(vision_inputs, vision_mask,
                                  self.vision_linear,
                                  self.vision_utt_transformer, g)
        enc = getattr(self, self.text_prefix)(dia_input_ids, dia_input_mask, g)
        text = scatter_sep_features(self.text_linear(enc), dia_sep_mask, d_max)

        if cfg.modality_fuse == "crossmodal":
            linear2 = self.multimodal_linear2
            cm_ta, cm_tav = self.CrossModalTrans_TA, self.CrossModalTrans_TA_V
            ta = linear2(torch.cat([cm_ta(text, audio, audio, g),
                                    cm_ta(audio, text, text, g)], dim=-1))
            fused = linear2(torch.cat([cm_tav(ta, vision, vision, g),
                                       cm_tav(vision, ta, ta, g)], dim=-1))
        else:
            fused = self.multimodal_linear(
                torch.cat([text, audio, vision], dim=-1))
        fused = dropout(fused, cfg.encoder.hidden_dropout_prob, self.training,
                        g)
        return self.classifier(fused)
