"""The port's dialogue-level model (models/dialogue.py,
make_dialogue_train_step) against the benchmark's plain reference
(perfbench/reference/dialogue.py) on the CPU in float32, at a tiny BERT
tower (TextEncoderConfig.tiny("bert")), 2-layer encoders at 64, 2 dialogues
of D = 5 slots (one with 2 empty slots), on the seed's random weights:
eval logits under dia_mask; the train step's loss and every leaf's
gradient with every dropout on and the same draws; one clipped AdamW
update.  Beside them: the cell's configuration file resolves to the
published tower without building weights; the model's, step's and
dataset's spans and slot counter; M3edDialogueDataset.from_arrays against
the pickle constructor."""

import copy
import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch

from facialmmt_tpu_torch.config import TextEncoderConfig, resolve_text_config
from facialmmt_tpu_torch.data.m3ed import M3edDialogueDataset
from facialmmt_tpu_torch.models.dialogue import DialogueMultiModalTransformer
from facialmmt_tpu_torch.train.optim import SingleTaskState
from facialmmt_tpu_torch.train.steps import (make_dialogue_eval_step,
                                             make_dialogue_train_step)
from facialmmt_tpu_torch.utils import observability as obs
from perfbench.lib import check_train, weights
from perfbench.lib import config as cfgmod
from perfbench.reference import dialogue as rd
from perfbench.reference.facialmmt import Precision
from perfbench.reference.target import Draws
from tests import torch_bridge  # noqa: F401  (one intra-op thread)

CONFIG = "m3ed_dia_tav_chinese_roberta_large"
B, D, LA, LV, L = 2, 5, 7, 4, 40
UTTS = (5, 3)
SEED, DRAW_SEED = 5, 9
# Float32 on both sides: what differs is the order of the sums (about 1e-7
# of a value).  Operands rounded to bf16 move the logits by about 3e-3 of
# their largest and the gradients by about 5e-3 of a leaf's norm
# (test_a_bf16_forward_fails_the_tolerances), so 1e-4 sits between.
REL = 1e-4
# The update test's rate: at 1e-3 a step stands some 1e4 ulps above the
# LayerNorm scales of 1; at the configured 7e-6 the ulp of 1.2e-7 would be
# 2 % of it.
LR = 1e-3


def _tree():
    tree = copy.deepcopy(cfgmod.config_file(CONFIG)["config"])
    tree.update(hidden_size=64, audio_utt_transformer_num=2,
                vision_utt_transformer_num=2)
    tree["encoder"].update(hidden_size=64, num_attention_heads=4,
                           intermediate_size=128)
    for key in ("crossmodal_ta", "crossmodal_ta_v"):
        tree[key].update(embed_dim=64, num_heads=4)
    tree["text"] = dict(dataclasses.asdict(TextEncoderConfig.tiny("bert")),
                        layer_norm_eps=1e-12)
    tree["data"].update(max_seq_length=L, audio_utt_max_len=LA,
                        vision_utt_max_len=LV, audio_feat_dim=12,
                        vision_feat_dim=8)
    tree["optim"]["trg_lr"] = LR
    return tree


def _arrays():
    """Two dialogues of 5 and 3 utterances in get_batch's layout: [CLS] u1
    [SEP] u2 [SEP] ..., zero features past each slot's frames or rows and in
    the empty slots, a vision-less utterance possible."""
    rng = np.random.default_rng(0)
    ids, mask, sep = (np.zeros((B, L), np.int32) for _ in range(3))
    for b, n in enumerate(UTTS):
        row, s = [101], [0]
        for _ in range(n):
            k = int(rng.integers(1, 6))
            row += list(rng.integers(104, 512, k)) + [102]
            s += [0] * k + [1]
        ids[b, :len(row)], mask[b, :len(row)], sep[b, :len(s)] = row, 1, s
    dia = (np.arange(D)[None] < np.asarray(UTTS)[:, None]).astype(np.int32)
    am = ((np.arange(LA)[None, None] < rng.integers(1, LA + 1, (B, D))[
        ..., None]) * dia[..., None]).astype(np.int32)
    vm = ((np.arange(LV)[None, None] < rng.integers(0, LV + 1, (B, D))[
        ..., None]) * dia[..., None]).astype(np.int32)
    return {
        "dia_input_ids": ids, "dia_input_mask": mask, "dia_sep_mask": sep,
        "audio_inputs": (rng.standard_normal((B, D, LA, 12))
                         * am[..., None]).astype(np.float32),
        "audio_mask": am,
        "vision_inputs": (rng.standard_normal((B, D, LV, 8))
                          * vm[..., None]).astype(np.float32),
        "vision_mask": vm, "dia_mask": dia,
        "labels": (rng.integers(0, 7, (B, D)) * dia).astype(np.int32)}


@pytest.fixture(scope="module")
def pair():
    """(tree, reference, port model, batch as tensors) on the seed's
    weights."""
    tree = _tree()
    ref = rd.Dialogue(tree)
    weights.draw_(ref, SEED)
    model = DialogueMultiModalTransformer(cfgmod.program_config(tree))
    model.float().load_state_dict(ref.state_dict(), strict=True)
    batch = {k: torch.from_numpy(v) for k, v in _arrays().items()}
    return tree, ref, model, batch


def _ref_logits(ref, batch, prec="fp32"):
    ref.prec = Precision(prec)
    ref.eval()
    try:
        with torch.no_grad():
            return torch.cat([rd.dialogue_logits(
                ref, {k: v[i:i + 1] for k, v in batch.items()},
                rd.NoDropout()) for i in range(B)])
    finally:
        ref.prec = Precision("fp32")


def _port_logits(model, batch):
    logits, _ = make_dialogue_eval_step(model, compute_dtype="float32")(
        batch)
    return logits


def _gap(got, want):
    """Largest gap over the largest magnitude of `want`."""
    return float((got - want).abs().max() / want.abs().max())


def _leaf_gaps(got, want):
    """Per leaf: the norm of the gap over the larger of the leaf's norm and
    the median leaf's (check_train.compare's grad_gap)."""
    norms = [float(w.norm()) for w in want]
    med = float(np.median(norms))
    return [float((g - w).norm()) / max(n, med)
            for g, w, n in zip(got, want, norms)]


def _port_step(tree, model, batch):
    """(loss, each leaf's gradient, each leaf's change) of one train step
    of the port, the schedule past warm-up as the benchmark sets it."""
    cfg = cfgmod.program_config(tree)
    state = SingleTaskState.create(model, cfg.optim, 10000)
    state.opt.set_count(int(10000 * cfg.optim.warm_up))
    grads, opt_step = {}, state.opt.step

    def capture(*a, **kw):
        grads.update({n: p.grad.detach().clone()
                      for n, p in model.named_parameters()})
        return opt_step(*a, **kw)

    state.opt.step = capture
    before = [p.detach().clone() for p in model.parameters()]
    loss = make_dialogue_train_step(model, compute_dtype="float32")(
        state, batch, torch.Generator().manual_seed(DRAW_SEED))
    names = [n for n, _ in model.named_parameters()]
    return (float(loss), [grads[n] for n in names],
            [p.detach() - b for p, b in zip(model.parameters(), before)])


def _ref_step(tree, ref, batch, prec="fp32"):
    """The same from the reference: step_grads, then check_train's clip and
    AdamW at the schedule's rate."""
    ref.prec = Precision(prec)
    ref.train()
    params = [p for _, p in ref.named_parameters()]
    before = [p.detach().clone() for p in params]
    loss, grads = rd.step_grads(ref, batch, params, Draws(
        torch.Generator().manual_seed(DRAW_SEED), "cpu"))
    o = tree["optim"]
    factor, warm = check_train.schedule(10000, o["warm_up"])
    moments = [[torch.zeros_like(p) for p in params] for _ in range(2)]
    check_train.adamw_(params, check_train.clipped(grads, o["clip"]),
                       *moments, 1, o["trg_lr"] * factor(warm), o,
                       o["weight_decay"])
    return loss, grads, [p.detach() - b for p, b in zip(params, before)]


def test_eval_logits_match_the_reference_under_dia_mask(pair):
    _, ref, model, batch = pair
    keep = batch["dia_mask"].bool()
    got, want = _port_logits(model, batch), _ref_logits(ref, batch)
    assert got.shape == (B, D, 7)
    assert _gap(got[keep], want[keep]) < REL


def test_train_step_and_update_match_the_reference(pair):
    tree, ref, _, batch = pair
    # fresh copies: the step moves both models' weights
    ref = copy.deepcopy(ref)
    model = DialogueMultiModalTransformer(cfgmod.program_config(tree))
    model.float().load_state_dict(ref.state_dict(), strict=True)
    assert [n for n, _ in model.named_parameters()] == \
        [n for n, _ in ref.named_parameters()]
    loss, grads, moved = _port_step(tree, model, batch)
    rloss, rgrads, rmoved = _ref_step(tree, ref, batch)
    # the mean over 8 valid utterances, float32 sums in another order
    assert abs(loss - rloss) < 1e-5 * abs(rloss)
    assert max(_leaf_gaps(grads, rgrads)) < REL
    # clip by the global norm, then AdamW's first step: the same relative
    # measure on each leaf's change
    assert max(_leaf_gaps(moved, rmoved)) < REL


def test_the_reference_keeps_every_draw_of_the_step(pair):
    """The reference consumes exactly the masks the step draws: the
    generator ends where the program's does."""
    tree, ref, model, batch = pair
    g = torch.Generator().manual_seed(DRAW_SEED)
    masks = rd.draw_masks(tree, Draws(g, "cpu"), B, D, LA, LV, L)
    e, t, cm = tree["encoder"], tree["text"], tree["crossmodal_ta"]
    layers = (tree["audio_utt_transformer_num"]
              + tree["vision_utt_transformer_num"])
    assert len(masks) == 3 * layers + 1 + 3 * t["num_layers"] \
        + 2 * cm["layers"] + 2 * tree["crossmodal_ta_v"]["layers"] + 1
    assert e["hidden_dropout_prob"] > 0 and cm["attn_dropout"] > 0
    mg = torch.Generator().manual_seed(DRAW_SEED)
    model.train()
    with torch.no_grad():
        model(*(batch[k] for k in (
            "dia_input_ids", "dia_input_mask", "dia_sep_mask",
            "audio_inputs", "audio_mask", "vision_inputs", "vision_mask",
            "dia_mask")), generator=mg)
    assert torch.equal(g.get_state(), mg.get_state())


def test_a_bf16_forward_fails_the_tolerances(pair):
    tree, ref, model, batch = pair
    keep = batch["dia_mask"].bool()
    got = _port_logits(model, batch)
    assert _gap(got[keep], _ref_logits(ref, batch, "bf16")[keep]) > 10 * REL
    _, grads, _ = _ref_step(tree, copy.deepcopy(ref), batch)
    _, low, _ = _ref_step(tree, copy.deepcopy(ref), batch, "bf16")
    assert max(_leaf_gaps(low, grads)) > 10 * REL


def test_the_cell_configuration_is_the_published_tower():
    """The cell's file resolves to chinese-roberta-wwm-ext-large's BERT
    widths and the appendix's fusion; the program's and the reference's
    modules, built on the meta device, hold the same leaves."""
    tree = cfgmod.config_file(CONFIG)["config"]
    cfg = cfgmod.program_config(tree)
    t = resolve_text_config(cfg)
    assert (t.model_type, t.num_layers, t.hidden_size, t.num_heads,
            t.intermediate_size, t.vocab_size, t.max_position_embeddings,
            t.type_vocab_size, t.pad_token_id, t.layer_norm_eps) == (
        "bert", 24, 1024, 16, 4096, 21128, 512, 2, 0, 1e-12)
    assert (cfg.granularity, cfg.choice_modality, cfg.modality_fuse,
            cfg.hidden_size) == ("dia", "T+A+V", "crossmodal", 768)
    with torch.device("meta"):
        model = DialogueMultiModalTransformer(cfg)
        ref = rd.Dialogue(tree)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert shapes == {n: tuple(p.shape) for n, p in ref.named_parameters()}
    assert shapes["roberta.embeddings.word_embeddings.weight"] == (21128,
                                                                   1024)
    assert 380e6 < sum(p.numel() for p in model.parameters()) < 420e6


@pytest.fixture
def recorder():
    obs.clear()
    yield obs
    obs.disable()
    obs.clear()


def test_spans_and_the_slot_counter_are_recorded(pair, recorder):
    tree, _, model, _ = pair
    ds = M3edDialogueDataset.from_arrays("train", *_arrays().values())
    recorder.enable()
    batch = {k: torch.from_numpy(v) for k, v in ds.get_batch([1, 0]).items()}
    cfg = cfgmod.program_config(tree)
    model = copy.deepcopy(model)
    make_dialogue_train_step(model, compute_dtype="float32")(
        SingleTaskState.create(model, cfg.optim, 10), batch,
        torch.Generator().manual_seed(DRAW_SEED))
    rows = recorder.rows()
    names = [r.name for r in rows]
    for name in ("fmmt.data.fetch", "fmmt.train.forward",
                 "fmmt.train.backward", "fmmt.train.optimizer"):
        assert names.count(name) == 1, name
    for name in ("fmmt.model.encoders", "fmmt.model.text",
                 "fmmt.model.crossmodal", "fmmt.model.head"):
        row = next(r for r in rows if r.name == name)
        assert row.parent == "fmmt.train.forward" and row.end_ns > \
            row.start_ns
    counter = [r for r in rows if r.name == "fmmt.data.slots"]
    assert len(counter) == 1 and counter[0].start_ns == counter[0].end_ns
    assert counter[0].value == (sum(UTTS), B * D)


def test_with_the_recorder_off_a_span_reads_no_clock(pair, recorder,
                                                     monkeypatch):
    """Off, each span and the counter cost one flag check: no clock read,
    no row."""
    _, _, model, _ = pair
    ds = M3edDialogueDataset.from_arrays("train", *_arrays().values())

    def clock():
        raise AssertionError("a clock was read with the recorder off")

    monkeypatch.setattr(obs.time, "time_ns", clock)
    assert obs.trace_span("fmmt.model.text") is obs.trace_span(
        "fmmt.data.fetch")
    batch = {k: torch.from_numpy(v) for k, v in ds.get_batch([0, 1]).items()}
    _port_logits(model, batch)
    assert recorder.rows() == []


def test_from_arrays_gives_the_pickle_constructors_batches(tmp_path):
    from tests.fixtures import write_m3ed_multimodal_fixture

    root = str(tmp_path)
    write_m3ed_multimodal_fixture(root, "train", num_dia=3, utts_per_dia=3)
    rng = np.random.default_rng(1)
    text = [rng.integers(0, 9, (3, 16)).astype(np.int32) for _ in range(3)]
    files = M3edDialogueDataset(root, "train", *text)

    def load(kind):
        with open(os.path.join(root, f"m3ed_train_{kind}_dia.pkl"),
                  "rb") as f:
            return pickle.load(f)["train"]

    a, v = load("audio"), load("vision")
    arrays = M3edDialogueDataset.from_arrays(
        "train", *text, a["audio"], a["audio_utt_mask"], v["vision"],
        v["vision_utt_mask"], v["vision_dia_mask"], a["labels"])
    assert len(arrays) == len(files) == 3
    assert arrays.num_utt_in_dia == files.num_utt_in_dia
    for idx in ([2, 0], [1, 1, 2]):
        want, got = files.get_batch(idx), arrays.get_batch(idx)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k])
