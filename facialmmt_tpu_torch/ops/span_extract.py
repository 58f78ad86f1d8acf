"""Vectorized per-utterance word-span extraction from dialogue encodings
(counterpart of facialmmt_tpu/ops/span_extract.py; reference
src/models.py:117-150).

Span arithmetic over the sep positions s_0 < s_1 < ...:
  * utterance 0:  start = 1, length = s_0 - 1;
  * utterance u > 0: start = s_{u-1} + off, length = s_u - s_{u-1} - off,
    with off = 2 for RoBERTa (</s></s> between utterances) and 1 for BERT;
  * a truncated dialogue without the utterance's sep gives an all-zero row.
"""

from __future__ import annotations

import torch


def spans_from_sep_mask(sep_mask, utt_idx, is_roberta: bool):
    """(start, length, valid) of each target utterance's word span, each (B,).
    sep_mask (B, L) {0,1}; utt_idx (B,) position of the utterance in its
    dialogue."""
    sep = sep_mask.to(torch.int64)
    utt_idx = utt_idx.to(torch.int64)
    csum = torch.cumsum(sep, dim=1)
    num_seps = csum[:, -1]
    positions = torch.arange(sep.shape[1], device=sep.device)[None, :]

    def sep_position(n):
        hit = (sep == 1) & (csum == n[:, None])
        return torch.where(hit, positions, 0).sum(dim=1)

    s_u = sep_position(utt_idx + 1)
    s_prev = sep_position(utt_idx)
    off = 2 if is_roberta else 1
    is_first = utt_idx == 0
    start = torch.where(is_first, torch.ones_like(s_u), s_prev + off)
    length = torch.where(is_first, s_u - 1, s_u - s_prev - off)
    valid = num_seps >= utt_idx + 1
    length = torch.where(valid, length.clamp(min=0), 0)
    return start, length, valid


def extract_utt_spans(text_feats, sep_mask, utt_idx, *, max_utt_len: int,
                      is_roberta: bool):
    """Gather each target utterance's word-level features: text_feats
    (B, L, H) -> (feats (B, max_utt_len, H), mask (B, max_utt_len) int32),
    zero past each utterance's clamped length."""
    start, length, _ = spans_from_sep_mask(sep_mask, utt_idx, is_roberta)
    length = length.clamp(max=max_utt_len)
    t = torch.arange(max_utt_len, device=text_feats.device)[None, :]
    idx = (start[:, None] + t).clamp(0, text_feats.shape[1] - 1)
    out = torch.gather(text_feats, 1,
                       idx[:, :, None].expand(-1, -1, text_feats.shape[2]))
    mask = t < length[:, None]
    out = out * mask[:, :, None].to(out.dtype)
    return out, mask.to(torch.int32)
