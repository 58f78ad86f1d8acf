"""Multiply-accumulate counts of FacialMMT, frozen from the program's
`utils/flops.py` and `ops/swin.py::swin_flops` (the reference's Swin flops(),
Swin_Transformer.py:149-160), extended to the sizes of one request and to
training.  The counts are MACs; FLOPs are twice as many."""

from __future__ import annotations

# one NVIDIA H100 SXM5 80GB, dense bf16, NVIDIA's data sheet (700 W)
H100_BF16_PEAK_FLOPS = 989.4e12


def swin_macs(s: dict) -> int:
    """One image's forward MACs of the Swin backbone and its head."""
    flops = 0
    ho = wo = s["img_size"] // s["patch_size"]
    flops += ho * wo * s["embed_dim"] * s["in_chans"] * s["patch_size"] ** 2
    flops += ho * wo * s["embed_dim"]
    dim = s["embed_dim"]
    depths = s["depths"]
    for stage in range(len(depths)):
        h, w = ho // (2 ** stage), wo // (2 ** stage)
        d = int(dim * 2 ** stage)
        ws = min(s["window_size"], h)
        n = ws * ws
        heads = s["num_heads"][stage]
        per_win = n * d * 3 * d + heads * n * (d // heads) * n * 2 + n * d * d
        nw = h * w / n
        per_block = (d * h * w * 2 + nw * per_win
                     + 2 * h * w * d * d * s["mlp_ratio"])
        flops += int(per_block * depths[stage])
        if stage < len(depths) - 1:
            flops += h * w * d + (h // 2) * (w // 2) * 4 * d * 2 * d
    final = dim * 2 ** (len(depths) - 1)
    flops += final * ho * wo // (4 ** (len(depths) - 1))
    flops += (49 * final) * s["out_feature_dim"]
    return int(flops)


def encoder_macs(layers, seq, d_model, d_ff):
    """QKV + output projections, scores and values, FFN."""
    return layers * (4 * seq * d_model ** 2 + 2 * seq * seq * d_model
                     + 2 * seq * d_model * d_ff)


def crossmodal_macs(layers, lq, lkv, d):
    return layers * (2 * lq * d ** 2 + 2 * lkv * d ** 2 + 2 * lq * lkv * d
                     + 8 * lq * d ** 2)


def fusion_macs(c: dict, lt, la, lv) -> int:
    """One utterance's projections, utterance encoders, crossmodal stacks
    and pooling, at sequence lengths lt (text span), la, lv."""
    d = c["hidden_size"]
    ff = c["encoder"]["intermediate_size"]
    macs = la * 768 * 768 + lv * (512 + 7) * d
    macs += encoder_macs(c["audio_utt_transformer_num"], la, d, ff)
    macs += encoder_macs(c["vision_utt_transformer_num"], lv, d, ff)
    ta, tav = c["crossmodal_ta"]["layers"], c["crossmodal_ta_v"]["layers"]
    macs += (crossmodal_macs(ta, lt, la, d) + crossmodal_macs(ta, la, lt, d)
             + crossmodal_macs(tav, lt + la, lv, d)
             + crossmodal_macs(tav, lv, lt + la, d))
    return macs + (lt + la + lv) * d


def text_macs(c: dict, tokens) -> int:
    t = c["text"]
    return encoder_macs(t["num_layers"], tokens, t["hidden_size"],
                        t["intermediate_size"])


def eval_step_macs(c: dict, batch_utts, unique_dias, faces) -> int:
    """The program's utils/flops.py count of one T+A+V eval batch at full
    lengths (kept equal to it by a test)."""
    data = c["data"]
    return int(faces * swin_macs(c["swin"])
               + unique_dias * text_macs(c, data["max_seq_length"])
               + batch_utts * fusion_macs(c, data["text_utt_max_len"],
                                          data["audio_utt_max_len"],
                                          data["vision_utt_max_len"]))


def request_macs(c: dict, w: dict) -> int:
    """One served request at its real sizes (traffic.Traffic.work)."""
    return int(w["faces"] * swin_macs(c["swin"]) + text_macs(c, w["tokens"])
               + fusion_macs(c, w["span"], w["audio"], w["faces"]))


def aux_step_macs(c: dict, images) -> int:
    """An auxiliary FER step: forward and backward (3 x forward) of the Swin
    branch over `images`."""
    return 3 * images * swin_macs(c["swin"])


def target_step_macs(c: dict, works, dialogues) -> int:
    """A target step over utterances `works` of `dialogues` distinct
    dialogues (each of works[0]["tokens"] tokens): the Swin forward without
    a graph (1 x), text and fusion forward and backward (3 x)."""
    return int(sum(w["faces"] * swin_macs(c["swin"])
                   + 3 * fusion_macs(c, w["span"], w["audio"], w["faces"])
                   for w in works)
               + 3 * dialogues * text_macs(c, works[0]["tokens"]))
