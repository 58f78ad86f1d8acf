"""Plain PyTorch reference of the dialogue-level FacialMMT of the CCAC2023
appendix ((Appendix)CCAC2023/src/models.py:228-385): one sample is a whole
dialogue of D utterance slots, each slot's audio frames and vision rows run
through an utterance encoder and pooled, the text tower encodes the joined
dialogue and each utterance takes the feature at its [SEP], and the two MulT
crossmodal stacks attend across the dialogue axis.

  audio, vision: (D, L, dim) -> Linear -> post-LN encoder -> additive
                 pooling (one pooling module for both) -> (D, H);
  text:          the BERT tower over [CLS] u1 [SEP] u2 [SEP] ... -> Linear;
                 slot u holds the feature at the u-th [SEP];
  fusion:        TA both ways, concatenated on the feature axis ->
                 multimodal_linear2; TA_V with vision both ways ->
                 the same multimodal_linear2; dropout; classifier.

Float32 with no kernels, one dialogue at a time, in the layers of
reference/facialmmt.py and the train-mode blocks of reference/target.py
(encoder_train, crossmodal_train, _post_ln_layer); it imports nothing of
the program.  Parameter names and their order are the program's state_dict
(models/dialogue.py), so the weights the benchmark draws load into both.

Departures from (Appendix)CCAC2023/src/models.py:228-385, each as the
program has them:
  * logits are (1, D, classes) beside dia_mask; the loss selects the valid
    slots with the mask (the appendix masked-selects (valid, classes));
  * the text tower's attribute is named as the program names it, `roberta`
    for the chinese-roberta-wwm-ext-large checkpoint though it is a
    BertModel;
  * the crossmodal stacks hold 256 positions (the dialogue axis);
  * slots without a [SEP] (padding, or past a truncated dialogue's last
    utterance) hold a zero text vector.

Dropout: the masks of a whole batch are drawn first, from a generator in
the state the program's had, in the program's order (audio encoder, vision
encoder, text tower, TA both ways, TA_V both ways, the final dropout; within
a stack layer by layer, within a layer attention probabilities, attention
output, output), and `Replay` hands each dialogue its part.  A batch's loss
is the mean over its valid utterances, so a dialogue's gradient is weighted
by its share of them; the fp32 backward then never holds more than one
dialogue's activations."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from perfbench.reference.facialmmt import (Crossmodal, Lin, Pool, Precision,
                                           TextTower, UttEncoder, layer_norm)
from perfbench.reference.target import (_layer_masks, _post_ln_layer,
                                        crossmodal_train, dropped,
                                        encoder_train)

DIALOGUE_MAX_POSITIONS = 256


class Dialogue(nn.Module):
    """The dialogue model with crossmodal fusion, T+A+V."""

    def __init__(self, c):
        super().__init__()
        if c["modality_fuse"] != "crossmodal":
            raise ValueError("the reference holds the crossmodal fusion only")
        self.c = c
        self.prec = Precision("fp32")
        d, data, t = c["hidden_size"], c["data"], c["text"]
        self.attention_pooling = Pool(d)
        self.audio_linear = Lin(data["audio_feat_dim"], d)
        self.audio_utt_transformer = UttEncoder(
            c["encoder"], c["audio_utt_transformer_num"],
            data["audio_utt_max_len"])
        self.vision_linear = Lin(data["vision_feat_dim"], d)
        self.vision_utt_transformer = UttEncoder(
            c["encoder"], c["vision_utt_transformer_num"],
            data["vision_utt_max_len"])
        self.prefix = "roberta" if "roberta" in c["plm_name"] else "bert"
        self.add_module(self.prefix, TextTower(t))
        self.text_linear = Lin(t["hidden_size"], d)
        self.multimodal_linear2 = Lin(2 * d, d)
        self.CrossModalTrans_TA = Crossmodal(
            d, c["crossmodal_ta"]["num_heads"], c["crossmodal_ta"]["layers"],
            DIALOGUE_MAX_POSITIONS)
        self.CrossModalTrans_TA_V = Crossmodal(
            d, c["crossmodal_ta_v"]["num_heads"],
            c["crossmodal_ta_v"]["layers"], DIALOGUE_MAX_POSITIONS)
        self.classifier = Lin(d, c["num_labels"])


class NoDropout:
    """Draws for eval: no mask anywhere."""

    def mask(self, shape, p):
        return None


class Replay:
    """Draws that hand dialogue `i` its part of the masks drawn for the
    whole batch (draw_masks), in the order they were drawn."""

    def __init__(self, masks, i):
        self.masks, self.i, self.at = masks, i, 0

    def mask(self, shape, p):
        if p == 0.0:
            return None
        m, per = self.masks[self.at]
        self.at += 1
        part = m[self.i * per:(self.i + 1) * per]
        if tuple(part.shape) != tuple(shape):
            raise ValueError(f"mask {self.at - 1}: drawn {tuple(part.shape)}"
                             f" for dialogue {self.i}, asked {tuple(shape)}")
        return part

    def done(self):
        if self.at != len(self.masks):
            raise ValueError(f"{len(self.masks) - self.at} masks unused")


def draw_masks(c, draws, b, d_max, la, lv, s):
    """Every dropout mask of a train step over `b` dialogues of `d_max`
    slots, `la` / `lv` frames a slot and `s` tokens, in the program's order:
    [(mask, rows a dialogue on its first axis)]."""
    out = []
    e, t = c["encoder"], c["text"]
    h = c["hidden_size"]
    rates = (e["attention_probs_dropout_prob"], e["hidden_dropout_prob"])
    for layers, length in ((c["audio_utt_transformer_num"], la),
                           (c["vision_utt_transformer_num"], lv)):
        for _ in range(layers):
            out += [(m, d_max) for m in _layer_masks(
                draws, b * d_max, e["num_attention_heads"], length, h, rates)]
    t_rates = (t["attention_probs_dropout_prob"], t["hidden_dropout_prob"])
    out.append((draws.mask((b, s, t["hidden_size"]), t_rates[1]), 1))
    for _ in range(t["num_layers"]):
        out += [(m, 1) for m in _layer_masks(
            draws, b, t["num_heads"], s, t["hidden_size"], t_rates)]
    for key in ("crossmodal_ta", "crossmodal_ta", "crossmodal_ta_v",
                "crossmodal_ta_v"):
        cm = c[key]
        for _ in range(cm["layers"]):
            out.append((draws.mask((b, cm["num_heads"], d_max, d_max),
                                   cm["attn_dropout"]), 1))
    out.append((draws.mask((b, d_max, h), rates[1]), 1))
    return [(m, per) for m, per in out if m is not None]


def bert_train(tower, p, ids, mask, draws):
    """The BERT tower in train mode (positions 0..S-1, token type 0,
    (1 - mask) * -1e30 key bias), each layer recomputed in the backward
    with its masks (reference/target.py::text_train's scheme)."""
    t, e = tower.t, tower.embeddings
    eps = t["layer_norm_eps"]
    rates = (t["attention_probs_dropout_prob"], t["hidden_dropout_prob"])
    ids = ids.long()
    pos = torch.arange(ids.shape[1], device=ids.device)[None]
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


def sep_features(feats, sep, d_max):
    """(1, S, H) features -> (1, d_max, H): slot u the feature at the u-th
    [SEP], zero where there is none."""
    at = torch.nonzero(sep[0]).flatten()[:d_max]
    out = feats.new_zeros((d_max, feats.shape[-1]))
    out = out.index_copy(0, torch.arange(len(at), device=feats.device),
                         feats[0, at])
    return out[None]


def dialogue_logits(model, one, draws):
    """Logits (1, D, classes) of one dialogue; `one` holds its arrays as
    device tensors, each with a leading axis of 1 (get_batch's keys)."""
    c, p = model.c, model.prec
    d_max = one["dia_mask"].shape[1]

    def stream(x, m, linear, enc):
        x = x[0].float()
        y = encoder_train(enc, p, p.linear(x, linear.weight, linear.bias),
                          m[0], draws)
        return model.attention_pooling(p, y, m[0])[None]

    audio = stream(one["audio_inputs"], one["audio_mask"],
                   model.audio_linear, model.audio_utt_transformer)
    vision = stream(one["vision_inputs"], one["vision_mask"],
                    model.vision_linear, model.vision_utt_transformer)
    enc = bert_train(getattr(model, model.prefix), p, one["dia_input_ids"],
                     one["dia_input_mask"], draws)
    text = sep_features(p.linear(enc, model.text_linear.weight,
                                 model.text_linear.bias),
                        one["dia_sep_mask"], d_max)
    l2 = model.multimodal_linear2
    ta, tav = model.CrossModalTrans_TA, model.CrossModalTrans_TA_V
    x = p.linear(torch.cat([
        crossmodal_train(ta, p, text, audio, draws, c["crossmodal_ta"]),
        crossmodal_train(ta, p, audio, text, draws, c["crossmodal_ta"])],
        -1), l2.weight, l2.bias)
    x = p.linear(torch.cat([
        crossmodal_train(tav, p, x, vision, draws, c["crossmodal_ta_v"]),
        crossmodal_train(tav, p, vision, x, draws, c["crossmodal_ta_v"])],
        -1), l2.weight, l2.bias)
    rate = c["encoder"]["hidden_dropout_prob"]
    x = dropped(x, draws.mask(x.shape, rate), rate)
    return p.linear(x, model.classifier.weight, model.classifier.bias)


def step_grads(model, batch, params, draws):
    """(loss, gradients of `params`) of one train step over `batch` (device
    tensors, get_batch's keys): the mean cross-entropy over the valid
    utterances, a dialogue at a time, each dialogue's gradients weighted by
    its share of the batch's valid utterances."""
    dm = batch["dia_mask"]
    b, d_max = dm.shape
    masks = draw_masks(model.c, draws, b, d_max,
                       batch["audio_inputs"].shape[2],
                       batch["vision_inputs"].shape[2],
                       batch["dia_input_ids"].shape[1])
    total = float(dm.sum())
    grads = [torch.zeros_like(q) for q in params]
    loss = 0.0
    for i in range(b):
        replay = Replay(masks, i)
        logits = dialogue_logits(model, {k: v[i:i + 1]
                                         for k, v in batch.items()}, replay)
        replay.done()
        keep = dm[i].bool()
        part = F.cross_entropy(logits[0][keep], batch["labels"][i][keep]
                               .long(), reduction="sum") / total
        for g, gi in zip(grads, torch.autograd.grad(
                part, params, allow_unused=True, materialize_grads=True)):
            g.add_(gi)
        loss += float(part.detach())
    return loss, grads
