"""Analytic operation counts of the T+A+V model (counterpart of
facialmmt_tpu/utils/flops.py): the whole-model extension of the reference's
per-module Swin flops() (reference Swin_Transformer.py:149-160, mirrored by
ops/swin.py::swin_flops).

The counts are multiply-accumulates (MACs), the reference's convention;
FLOPs are twice as many.  A model-FLOPs utilisation (mfu) of a measured step
is 2 * MACs / seconds / H100_BF16_PEAK_FLOPS.
"""

from __future__ import annotations

from facialmmt_tpu_torch.config import FacialMMTConfig
from facialmmt_tpu_torch.ops.swin import swin_flops


def transformer_encoder_macs(layers: int, seq: int, d_model: int,
                             d_ff: int) -> int:
    """Per-stack MACs of a standard encoder: QKV+output projections
    (4·L·d²), score and value matmuls (2·L²·d), FFN (2·L·d·d_ff)."""
    per = 4 * seq * d_model ** 2 + 2 * seq * seq * d_model \
        + 2 * seq * d_model * d_ff
    return layers * per


def crossmodal_macs(layers: int, lq: int, lkv: int, d: int) -> int:
    """One direction of a MulT crossmodal stack (ops/crossmodal.py):
    Q proj (lq·d²), K/V projs (2·lkv·d²), out proj (lq·d²), scores+values
    (2·lq·lkv·d), FFN 4x (2·lq·d·4d)."""
    per = 2 * lq * d ** 2 + 2 * lkv * d ** 2 + 2 * lq * lkv * d \
        + 8 * lq * d ** 2
    return layers * per


def eval_step_macs(cfg: FacialMMTConfig, batch_utts: int, unique_dias: int,
                   faces: int) -> int:
    """Dominant-term MACs of one T+A+V eval batch: Swin over the packed
    faces + text tower over the unique dialogues + per-utterance towers and
    crossmodal fusion.  The first two terms are exact; the fusion terms
    assume full (unmasked) sequence lengths, a few % high."""
    t = cfg.text
    d = cfg.hidden_size
    la = cfg.data.audio_utt_max_len
    lv = cfg.data.vision_utt_max_len
    lt = cfg.data.text_utt_max_len

    macs = faces * swin_flops(cfg.swin)
    macs += unique_dias * transformer_encoder_macs(
        t.num_layers, cfg.data.max_seq_length, t.hidden_size,
        t.intermediate_size)
    # per utterance: audio / vision projections and self-attention encoders
    macs += batch_utts * (la * 768 * 768 + lv * (512 + 7) * d)
    macs += batch_utts * transformer_encoder_macs(
        cfg.audio_utt_transformer_num, la, d,
        cfg.encoder.intermediate_size)
    macs += batch_utts * transformer_encoder_macs(
        cfg.vision_utt_transformer_num, lv, d,
        cfg.encoder.intermediate_size)
    # crossmodal: T<->A (shared weights, 2 directions), (T||A)<->V
    macs += batch_utts * (
        crossmodal_macs(cfg.crossmodal_ta.layers, lt, la, d)
        + crossmodal_macs(cfg.crossmodal_ta.layers, la, lt, d)
        + crossmodal_macs(cfg.crossmodal_ta_v.layers, lt + la, lv, d)
        + crossmodal_macs(cfg.crossmodal_ta_v.layers, lv, lt + la, d))
    # pooling + classifier
    macs += batch_utts * (lt + la + lv) * d
    return int(macs)


# The dense bf16 peak of one NVIDIA H100 SXM5 80GB (NVIDIA's data sheet,
# without sparsity, at the full 700 W power limit; `nvidia-smi` names the
# card "NVIDIA H100 80GB HBM3"): the denominator of an mfu share.
H100_BF16_PEAK_FLOPS = 989.4e12
