"""The target task's training forward in plain PyTorch: the T+A+V model of
reference/facialmmt.py in train mode over a whole batch, as the program's
target step computes it (the Swin pass without a graph and with batch
statistics, Gumbel-softmax, the frame filter, then text and fusion with
dropout), and a copy of the in-memory MELD batch layout.

Its random draws are the program's, taken from the same torch.Generator in
the same order and at the same shapes: the faces' colour jitter, each Swin
block's two drop-path multipliers, the Gumbel noise, then every dropout
mask in the order the forward meets it (text: embeddings, then per layer
attention probabilities, attention output, output; the audio and vision
encoders likewise; the crossmodal stacks' attention probabilities; the
pooled vector).  The masks of a text layer are drawn before the layer runs,
which changes no draw, so that the layer can be recomputed in the backward
(torch.utils.checkpoint) with the same masks."""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from perfbench.reference.facialmmt import gelu, layer_norm


class Draws:
    def __init__(self, generator, device):
        self.g, self.device = generator, device

    def rand(self, shape):
        return torch.rand(tuple(shape), generator=self.g, device=self.device)

    def mask(self, shape, p):
        """A dropout mask (kept where U >= p), or None when p is 0."""
        return None if p == 0.0 else self.rand(shape) >= p


def dropped(x, mask, p):
    return x if mask is None else x * mask.to(x.dtype) / (1.0 - p)


def drop_path_keeps(draws, s, b):
    rates = np.linspace(0, s["drop_path_rate"], sum(s["depths"]))
    keeps = []
    for r in rates:
        if r > 0.0:
            keep = 1.0 - float(r)
            keeps.append(tuple((draws.rand((b,)) < keep).float() / keep
                               for _ in range(2)))
        else:
            keeps.append((None, None))
    return keeps


def _attention_dropped(p, q, k, v, heads, bias, mask, rate):
    """attention() with dropout on the probabilities."""
    b, sq, e = q.shape
    sk = k.shape[1]
    hd = e // heads
    qh = q.reshape(b, sq, heads, hd).transpose(1, 2) * hd ** -0.5
    kh = k.reshape(b, sk, heads, hd).transpose(1, 2)
    vh = v.reshape(b, sk, heads, hd).transpose(1, 2)
    s = p.matmul(qh, kh.transpose(-1, -2))
    if bias is not None:
        s = s + bias
    probs = dropped(torch.softmax(s, dim=-1), mask, rate)
    return p.matmul(probs, vh).transpose(1, 2).reshape(b, sq, e)


def _post_ln_layer(p, x, bias, heads, eps, q, k, v, dense, ln1, inter, out,
                   ln2, masks, rates):
    m_attn, m_ao, m_out = masks
    r_attn, r_hidden = rates
    ctx = _attention_dropped(p, p.linear(x, q.weight, q.bias),
                             p.linear(x, k.weight, k.bias),
                             p.linear(x, v.weight, v.bias), heads, bias,
                             m_attn, r_attn)
    x = layer_norm(ln1, dropped(p.linear(ctx, dense.weight, dense.bias),
                                m_ao, r_hidden) + x, eps)
    h = gelu(p.linear(x, inter.weight, inter.bias))
    return layer_norm(ln2, dropped(p.linear(h, out.dense.weight,
                                            out.dense.bias), m_out, r_hidden)
                      + x, eps)


def _layer_masks(draws, b, heads, s, h, rates):
    return (draws.mask((b, heads, s, s), rates[0]),
            draws.mask((b, s, h), rates[1]), draws.mask((b, s, h), rates[1]))


def text_train(tower, p, ids, mask, draws):
    t, e = tower.t, tower.embeddings
    eps = t["layer_norm_eps"]
    rates = (t["attention_probs_dropout_prob"], t["hidden_dropout_prob"])
    ids = ids.long()
    real = (ids != t["pad_token_id"]).long()
    pos = torch.cumsum(real, 1) * real + t["pad_token_id"]
    x = (e.word_embeddings.weight[ids] + e.position_embeddings.weight[pos]
         + e.token_type_embeddings.weight[0])
    x = layer_norm(e.LayerNorm, x, eps)
    x = dropped(x, draws.mask(x.shape, rates[1]), rates[1])
    bias = ((1.0 - mask.float()) * -1e30)[:, None, None, :]
    b, s, h = x.shape
    for lyr in tower.encoder.layer:
        masks = _layer_masks(draws, b, t["num_heads"], s, h, rates)
        sa, ao = lyr.attention.self, lyr.attention.output

        def run(x, bias, m1, m2, m3, lyr=lyr, sa=sa, ao=ao):
            return _post_ln_layer(p, x, bias, t["num_heads"], eps, sa.query,
                                  sa.key, sa.value, ao.dense, ao.LayerNorm,
                                  lyr.intermediate.dense, lyr.output,
                                  lyr.output.LayerNorm, (m1, m2, m3), rates)

        x = checkpoint(run, x, bias, *masks, use_reentrant=False)
    return x


def encoder_train(enc, p, x, mask, draws):
    e = enc.e
    rates = (e["attention_probs_dropout_prob"], e["hidden_dropout_prob"])
    x = x + enc.position_embeddings.weight[:x.shape[1]][None]
    bias = ((1.0 - mask.float()) * -10000.0)[:, None, None, :]
    b, s, h = x.shape
    for lyr in enc.layer:
        masks = _layer_masks(draws, b, e["num_attention_heads"], s, h, rates)
        sa = lyr.transformer_self_attention
        x = _post_ln_layer(p, x, bias, e["num_attention_heads"],
                           e["layer_norm_eps"], sa.selfatt.query,
                           sa.selfatt.key, sa.selfatt.value,
                           sa.dense_norm.dense, sa.dense_norm.LayerNorm,
                           lyr.intermediate.dense, lyr.output,
                           lyr.output.LayerNorm, masks, rates)
    return x


def crossmodal_train(cm, p, x_in, kv_in, draws, cfg):
    for key in ("gelu_dropout", "res_dropout", "embed_dropout"):
        if cfg[key]:
            raise ValueError(f"the reference draws no {key}")
    rate = cfg["attn_dropout"]
    x, kv = cm.embed(x_in), cm.embed(kv_in)
    d, heads = cm.d, cm.heads
    b, tq, tk = x.shape[0], x.shape[1], kv.shape[1]
    for lyr in cm.layers:
        ln0, ln1 = lyr.layer_norms
        a = lyr.self_attn
        w, bb = a.in_proj_weight, a.in_proj_bias
        kvn = layer_norm(ln0, kv, 1e-5)
        m = draws.mask((b, heads, tq, tk), rate)
        h = _attention_dropped(
            p, p.linear(layer_norm(ln0, x, 1e-5), w[:d], bb[:d]),
            p.linear(kvn, w[d:2 * d], bb[d:2 * d]),
            p.linear(kvn, w[2 * d:], bb[2 * d:]), heads, None, m, rate)
        x = x + p.linear(h, a.out_proj.weight, a.out_proj.bias)
        h = gelu(p.linear(layer_norm(ln1, x, 1e-5), lyr.fc1.weight,
                          lyr.fc1.bias))
        x = x + p.linear(h, lyr.fc2.weight, lyr.fc2.bias)
    return layer_norm(cm.layer_norm, x, 1e-5)


def utt_spans(feats, sep, utt, max_len, off):
    """Each target utterance's word span (a copy of the program's
    ops/span_extract.py arithmetic)."""
    sep = sep.long()
    utt = utt.long()
    csum = torch.cumsum(sep, 1)
    pos = torch.arange(sep.shape[1], device=sep.device)[None]

    def at(n):
        return torch.where((sep == 1) & (csum == n[:, None]), pos, 0).sum(1)

    s_u, s_prev = at(utt + 1), at(utt)
    first = utt == 0
    start = torch.where(first, torch.ones_like(s_u), s_prev + off)
    length = torch.where(first, s_u - 1, s_u - s_prev - off)
    length = torch.where(csum[:, -1] >= utt + 1, length.clamp(min=0), 0)
    length = length.clamp(max=max_len)
    t = torch.arange(max_len, device=feats.device)[None]
    idx = (start[:, None] + t).clamp(0, feats.shape[1] - 1)
    out = torch.gather(feats, 1, idx[:, :, None].expand(-1, -1,
                                                         feats.shape[2]))
    m = t < length[:, None]
    return out * m[:, :, None].to(out.dtype), m.float()


def frame_filter_batch(feats, probs, face_mask, threshold):
    """The frame-importance filter over a batch (the program's
    ops/frame_filter.py semantics)."""
    face_mask = face_mask.bool()
    keep = (probs.square().sum(-1) > threshold) & face_mask
    keep = torch.where(keep.any(1, keepdim=True), keep, face_mask)
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    new_mask = (torch.arange(keep.shape[1], device=keep.device)[None]
                < keep.sum(1)[:, None])
    f = torch.gather(feats, 1, order[:, :, None].expand(-1, -1,
                                                        feats.shape[2]))
    pr = torch.gather(probs, 1, order[:, :, None].expand(-1, -1,
                                                         probs.shape[2]))
    m = new_mask[:, :, None].float()
    return torch.cat([f * m, pr * m], -1), new_mask.float()


def target_logits(model, batch, faces, draws):
    """Logits of the target step's forward over `batch` (device tensors of
    the packed layout; `faces` the augmented, normalised face buffer)."""
    c, p = model.c, model.prec
    nf = c["data"]["vision_utt_max_len"]
    with torch.no_grad():
        keeps = drop_path_keeps(draws, c["swin"], faces.shape[0])
        logits = model.swin_model(p, faces, keeps, batch_stats=True)
        u = draws.rand(logits.shape).clamp_(
            min=torch.finfo(torch.float32).tiny)
        fer = torch.softmax((logits - torch.log(-torch.log(u))) / c["tau"], -1)
    b = batch["vision_feats"].shape[0]
    uid, pos = batch["face_utt_id"].long(), batch["face_pos"].long()
    valid = (uid >= 0) & (pos < nf)
    slot = torch.where(valid, uid, 0) * nf + torch.where(valid, pos, 0)
    probs = torch.zeros((b * nf, fer.shape[-1]), device=fer.device)
    probs.index_add_(0, slot, fer * valid[:, None].float())
    probs = probs.reshape(b, nf, -1)
    face_mask = torch.arange(nf, device=fer.device)[None] \
        < batch["n_faces"][:, None]
    vision, vmask = frame_filter_batch(
        batch["vision_feats"].float(), probs, face_mask,
        c["facial_emo_impor_threshold"])
    mm = model.multimodal
    enc = text_train(getattr(mm, mm.prefix), p, batch["dia_input_ids"],
                     batch["dia_input_mask"], draws)
    text = p.linear(enc, mm.text_linear.weight, mm.text_linear.bias)
    dia = batch["dia_idx"].long()
    text, tmask = utt_spans(text[dia], batch["dia_sep_mask"][dia],
                            batch["utt_in_dia_idx"],
                            c["data"]["text_utt_max_len"],
                            2 if mm.prefix == "roberta" else 1)
    amask = batch["audio_mask"].float()
    a = encoder_train(mm.audio_utt_transformer, p,
                      p.linear(batch["audio_inputs"].float(),
                               mm.audio_linear.weight, mm.audio_linear.bias),
                      amask, draws)
    v = encoder_train(mm.vision_utt_transformer, p,
                      p.linear(vision, mm.vision_linear.weight,
                               mm.vision_linear.bias), vmask, draws)
    ta, tav = mm.CrossModalTrans_TA, mm.CrossModalTrans_TA_V
    fused = torch.cat([crossmodal_train(ta, p, text, a, draws,
                                        c["crossmodal_ta"]),
                       crossmodal_train(ta, p, a, text, draws,
                                        c["crossmodal_ta"])], 1)
    fused = torch.cat([crossmodal_train(tav, p, fused, v, draws,
                                        c["crossmodal_ta_v"]),
                       crossmodal_train(tav, p, v, fused, draws,
                                        c["crossmodal_ta_v"])], 1)
    pooled = mm.attention(p, fused, torch.cat([tmask, amask, vmask], 1))
    rate = c["encoder"]["hidden_dropout_prob"]
    pooled = dropped(pooled, draws.mask(pooled.shape, rate), rate)
    return p.linear(pooled, mm.classifier.weight, mm.classifier.bias)


# ------------------------------------------------------------ the batches --

def meld_arrays(tree, n_utts, n_dias, faces, seed):
    """The in-memory MELD dataset's arrays: `n_utts` utterances round-robin
    over `n_dias` dialogues of full-length token rows, `faces` faces each;
    the layout of the program's data/meld.py::SyntheticMeldDataset."""
    d = tree["data"]
    rng = np.random.default_rng([seed % (2 ** 63), 13])
    length = d["max_seq_length"]
    per = -(-n_utts // n_dias)
    ids = rng.integers(3, tree["text"]["vocab_size"],
                       size=(n_dias, length)).astype(np.int32)
    sep = np.zeros((n_dias, length), np.int32)
    span = max((length - 2) // per, 2)
    for u in range(per):
        sep[:, min(1 + (u + 1) * span - 1, length - 1)] = 1
    n_faces = np.minimum(faces, d["vision_utt_max_len"]).astype(np.int32)
    return {
        "split": "synthetic", "f_max": d["vision_utt_max_len"],
        "input_ids": ids, "input_mask": np.ones((n_dias, length), np.int32),
        "sep_mask": sep, "dia_of": np.arange(n_utts) % n_dias,
        "pos_of": np.arange(n_utts) // n_dias,
        "audio": rng.standard_normal((n_utts, d["audio_utt_max_len"],
                                      d["audio_feat_dim"]), dtype=np.float32),
        "audio_mask": np.ones((n_utts, d["audio_utt_max_len"]), np.int32),
        "vision": rng.standard_normal((n_utts, d["vision_utt_max_len"],
                                       d["vision_feat_dim"]),
                                      dtype=np.float32),
        "n_faces": n_faces,
        "vision_mask": (np.arange(d["vision_utt_max_len"])[None]
                        < n_faces[:, None]).astype(np.int32),
        "labels": rng.integers(0, tree["num_labels"],
                               size=n_utts).astype(np.int32),
        "face_seed": int(rng.integers(0, 2 ** 31)),
    }


def meld_batch(a, idx, capacity, face_px):
    """The batch of rows `idx` in the packed-face layout, as the program's
    dataset builds it (a copy of its get_batch)."""
    idx = np.asarray(list(idx))
    b = len(idx)
    slots = {}
    dia_idx = np.zeros(b, np.int32)
    for j, i in enumerate(idx):
        dia_idx[j] = slots.setdefault(int(a["dia_of"][i]), len(slots))
    first = next(iter(slots))
    by_slot = {v: k for k, v in slots.items()}
    rows = [by_slot.get(s, first) for s in range(b)]
    n_faces = a["n_faces"][idx]
    need = int(n_faces.sum())
    if need > capacity:
        return None
    uid = np.full(capacity, -1, np.int32)
    pos = np.zeros(capacity, np.int32)
    uid[:need] = np.repeat(np.arange(b), n_faces)
    pos[:need] = np.concatenate([np.arange(k) for k in n_faces]
                                or [np.zeros(0, np.int32)])
    raw = np.zeros((capacity, face_px, face_px, 3), np.uint8)
    rng = np.random.default_rng([a["face_seed"], *idx.tolist()])
    raw[:need] = rng.integers(0, 256, size=(need, face_px, face_px, 3),
                              dtype=np.uint8)
    return {"dia_input_ids": a["input_ids"][rows],
            "dia_input_mask": a["input_mask"][rows],
            "dia_sep_mask": a["sep_mask"][rows], "dia_idx": dia_idx,
            "utt_in_dia_idx": a["pos_of"][idx].astype(np.int32),
            "audio_inputs": a["audio"][idx],
            "audio_mask": a["audio_mask"][idx],
            "vision_feats": a["vision"][idx],
            "vision_mask": a["vision_mask"][idx], "n_faces": n_faces,
            "faces_raw": raw, "face_utt_id": uid, "face_pos": pos,
            "labels": a["labels"][idx]}
