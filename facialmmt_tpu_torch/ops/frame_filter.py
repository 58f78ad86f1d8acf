"""Frame-importance filtering and repacking (counterpart of
facialmmt_tpu/ops/frame_filter.py; reference train.py:60-133).

confidence = <p, p> per frame; frames at or below the threshold are dropped,
survivors are compacted to the front in their original order, and each
survivor's FER distribution is concatenated onto its feature.  An utterance
whose every frame is filtered keeps all its frames.
"""

from __future__ import annotations

import torch


def scatter_face_probs(flat_probs, face_utt_id, face_pos, num_utts: int,
                       max_faces: int):
    """Scatter packed per-face distributions (N, C) to (num_utts, max_faces, C);
    slots with face_utt_id == -1 (padding) or face_pos >= max_faces add
    nothing."""
    valid = (face_utt_id >= 0) & (face_pos < max_faces)
    utt = torch.where(valid, face_utt_id, 0).long()
    pos = torch.where(valid, face_pos, 0).long()
    c = flat_probs.shape[-1]
    out = torch.zeros((num_utts * max_faces, c), dtype=flat_probs.dtype,
                      device=flat_probs.device)
    contrib = flat_probs * valid[:, None].to(flat_probs.dtype)
    out.index_add_(0, utt * max_faces + pos, contrib)
    return out.reshape(num_utts, max_faces, c)


def frame_keep_mask(probs, face_mask, threshold):
    """keep = (sum p^2 > threshold) & mask, falling back to the full mask for
    an utterance whose every frame was filtered.  (B, F) bool."""
    face_mask = face_mask.bool()
    conf = probs.float().square().sum(-1)
    keep = (conf > threshold) & face_mask
    return torch.where(keep.any(dim=1, keepdim=True), keep, face_mask)


def frame_importance_filter(vision_feats, probs, face_mask, threshold):
    """vision_feats (B, F, D), probs (B, F, C), face_mask (B, F) ->
    (vision_concat (B, F, D + C), new_mask (B, F) int32)."""
    keep = frame_keep_mask(probs, face_mask, threshold)
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    kept = keep.sum(dim=1)
    new_mask = (torch.arange(keep.shape[1], device=keep.device)[None, :]
                < kept[:, None])
    feats = torch.gather(vision_feats, 1,
                         order[:, :, None].expand(-1, -1, vision_feats.shape[2]))
    new_probs = torch.gather(probs, 1,
                             order[:, :, None].expand(-1, -1, probs.shape[2]))
    m = new_mask[:, :, None].to(vision_feats.dtype)
    out = torch.cat([feats * m, new_probs.to(vision_feats.dtype) * m], dim=-1)
    return out, new_mask.to(torch.int32)
