"""Multiply-accumulate counts of the dialogue-level FacialMMT
(models/dialogue.py; reference/dialogue.py), in lib/flops.py's terms: the
products of the text tower, the utterance encoders, the pooling, the
crossmodal stacks and the linear layers at given sizes.  A dialogue's
real sizes (its tokens, each valid utterance's frames and rows) give the
work the model needs; its padded sizes (the whole token budget, every slot
at the full frame and row caps) the work the padded grid computes.  The
counts are MACs; FLOPs are twice as many."""

from __future__ import annotations

from perfbench.lib.flops import crossmodal_macs, encoder_macs


def stream_macs(c: dict, length: int, feat_dim: int, layers: int) -> int:
    """One utterance slot's Linear, utterance encoder and pooling (P and
    the value vector a position) at `length` frames or rows."""
    d = c["hidden_size"]
    return (length * feat_dim * d
            + encoder_macs(layers, length, d, c["encoder"]["intermediate_size"])
            + length * (d * d + d))


def forward_macs(c: dict, tokens: int, frames, rows) -> int:
    """One dialogue's forward: `tokens` of text, and for each of its
    utterance slots `frames[u]` audio frames and `rows[u]` vision rows."""
    t, d, data = c["text"], c["hidden_size"], c["data"]
    n = len(frames)
    macs = (encoder_macs(t["num_layers"], tokens, t["hidden_size"],
                         t["intermediate_size"])
            + tokens * t["hidden_size"] * d)
    macs += sum(stream_macs(c, f, data["audio_feat_dim"],
                            c["audio_utt_transformer_num"]) for f in frames)
    macs += sum(stream_macs(c, r, data["vision_feat_dim"],
                            c["vision_utt_transformer_num"]) for r in rows)
    ta, tav = c["crossmodal_ta"]["layers"], c["crossmodal_ta_v"]["layers"]
    macs += 2 * crossmodal_macs(ta, n, n, d) + 2 * crossmodal_macs(tav, n, n,
                                                                   d)
    macs += 2 * n * 2 * d * d + n * d * c["num_labels"]
    return int(macs)


def padded_forward_macs(c: dict, slots: int) -> int:
    """One dialogue's forward on the padded grid: the token budget and
    `slots` slots at the frame and row caps."""
    data = c["data"]
    return forward_macs(c, data["max_seq_length"],
                        [data["audio_utt_max_len"]] * slots,
                        [data["vision_utt_max_len"]] * slots)


def train_macs(forward: int) -> int:
    """Forward and backward: 3 x the forward."""
    return 3 * forward
