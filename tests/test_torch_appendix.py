"""The port's appendix modules and steps (CCAC2023/M3ED) against the JAX
package on the CPU, at tiny() widths.

The same numpy-made inputs, and JAX weights drawn from a numpy seed and
carried over by checkpoint/from_jax.py (loaded with strict=True), go through
both packages: the sep scatter (exact), the utterance-level model's modality
subsets and concat fusion and the dialogue-level model (fp32 XLA against
fp32 PyTorch, atol 1e-4 / rtol 1e-4), the M3ED text preparation and the
four appendix datasets on tests/fixtures.py's files (array for array,
exact), one text and one dialogue train step from the same weights with
every dropout off (loss 1e-5 absolute, every updated parameter 1e-4 of its
leaf's max, floored at 1e-2 of the largest, as tests/test_torch_train.py),
and the submission CSV and 'pred true' dump writers (byte for byte).
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from facialmmt_tpu.config import FacialMMTConfig
from facialmmt_tpu_torch.checkpoint import from_jax
from tests.fixtures import (WhitespaceTokenizer, write_m3ed_multimodal_fixture,
                            write_meld_fixture)
from tests.test_torch_ops import TOL, T, random_params
from tests.test_torch_train import OPT, nodrop_config
from tests.torch_bridge import port_config

MAX_SEQ = 64
AUDIO_LEN, VISION_LEN, AUDIO_DIM, VISION_DIM = 10, 7, 20, 12
LOSS_TOL, LEAF_TOL = 1e-5, 1e-4
TOTAL_STEPS = 100


def m3ed_config(base=None, **kw):
    """tiny() (or `base`) at the M3ED fixture's feature shapes."""
    cfg = base or FacialMMTConfig.tiny()
    return cfg.replace(data=dataclasses.replace(
        cfg.data, audio_utt_max_len=AUDIO_LEN, vision_utt_max_len=VISION_LEN,
        audio_feat_dim=AUDIO_DIM, vision_feat_dim=VISION_DIM,
        max_seq_length=MAX_SEQ), **kw)


def m3ed_text(path, max_seq=MAX_SEQ, package="port"):
    """(ids, mask, sep, labels) of an M3ED text JSON from either package's
    M3edTextPreprocessor and the fixtures' whitespace tokenizer."""
    if package == "port":
        from facialmmt_tpu_torch.data.text_prep import M3edTextPreprocessor
    else:
        from facialmmt_tpu.data.text_prep import M3edTextPreprocessor
    prep = M3edTextPreprocessor(WhitespaceTokenizer(False), max_seq)
    return M3edTextPreprocessor.to_arrays(prep.preprocess_split(path))


@pytest.fixture(scope="module")
def m3ed_files(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("m3ed"))
    info = write_m3ed_multimodal_fixture(
        root, "train", num_dia=3, utts_per_dia=3, audio_len=AUDIO_LEN,
        vision_len=VISION_LEN, audio_dim=AUDIO_DIM, vision_dim=VISION_DIM,
        seed=4)
    info["arrays"] = m3ed_text(info["text"]["path"])
    return info


def _load(module, sd):
    module.load_state_dict({k: torch.tensor(np.asarray(v))
                            for k, v in sd.items()}, strict=True)
    return module.eval()


def _utt_batch(files, idx=(0, 4, 5, 8)):
    from facialmmt_tpu_torch.data.m3ed import M3edMultimodalDataset

    ids, mask, sep, _ = files["arrays"]
    return M3edMultimodalDataset(files["root"], "train", ids, mask,
                                 sep).get_batch(list(idx))


def _dia_batch(files, idx=(0, 2)):
    """Two dialogues; the second's last utterance is padding (dia_mask 0,
    its sep gone), so the scatter leaves its slot empty."""
    from facialmmt_tpu_torch.data.m3ed import M3edDialogueDataset

    ids, mask, sep, _ = files["arrays"]
    batch = M3edDialogueDataset(files["root"], "train", ids, mask,
                                sep).get_batch(list(idx))
    batch = {k: v.copy() for k, v in batch.items()}
    batch["dia_mask"][1, -1] = 0
    last = np.nonzero(batch["dia_sep_mask"][1])[0][-1]
    batch["dia_sep_mask"][1, last] = 0
    return batch


def _text_args(batch):
    args = [batch[k] for k in ("dia_input_ids", "dia_input_mask",
                               "dia_sep_mask")]
    kw = {k: batch[k] for k in ("utt_in_dia_idx", "dia_idx", "audio_inputs",
                                "audio_mask", "vision_inputs", "vision_mask")}
    return args, kw


def _dia_args(batch):
    return [batch[k] for k in ("dia_input_ids", "dia_input_mask",
                               "dia_sep_mask", "audio_inputs", "audio_mask",
                               "vision_inputs", "vision_mask", "dia_mask")]


# ------------------------------------------------------------------ models --

def test_scatter_sep_features_matches_jax(rng):
    """Slot u holds the feature at the u-th sep, seps past max_dia_len drop
    out, slots without a sep stay zero: equal to JAX exactly."""
    from facialmmt_tpu.models.dialogue import scatter_sep_features as J
    from facialmmt_tpu_torch.models.dialogue import scatter_sep_features as P

    feats = rng.normal(size=(3, 12, 5)).astype(np.float32)
    sep = np.zeros((3, 12), np.int32)
    sep[0, [2, 5, 9]] = 1
    sep[1, [1, 3, 4, 7, 10, 11]] = 1          # more seps than slots
    sep[2, 6] = 1
    got = P(T(feats), T(sep), 4).numpy()
    want = np.asarray(J(jax.numpy.asarray(feats), jax.numpy.asarray(sep), 4))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0, 1], feats[0, 5])
    np.testing.assert_array_equal(got[1, 3], feats[1, 7])
    np.testing.assert_array_equal(got[2, 1:], 0.0)
    feats_t = T(feats).requires_grad_()
    P(feats_t, T(sep), 4).sum().backward()
    np.testing.assert_array_equal(feats_t.grad.numpy()[..., 0],
                                  (sep * (np.cumsum(sep, 1) <= 4)))


@pytest.mark.parametrize("modality,fuse", [
    ("T", "crossmodal"), ("T+A", "crossmodal"), ("T+V", "crossmodal"),
    ("T+A+V", "concat"), ("T+A", "concat")])
def test_multimodal_subsets_match_jax(m3ed_files, rng, modality, fuse):
    """The utterance-level model of each subset and fusion on an M3ED batch
    (raw vision features, the width flax infers): only the towers that the
    configuration uses are built, the bridged weights load strictly."""
    from facialmmt_tpu.models.multimodal import \
        MultiModalTransformerForClassification as J
    from facialmmt_tpu_torch.models.multimodal import \
        MultiModalTransformerForClassification as P

    cfg = m3ed_config(choice_modality=modality, modality_fuse=fuse)
    args, kw = _text_args(_utt_batch(m3ed_files))
    jm = J(cfg)
    v = random_params(jm, rng, *args, **kw)
    tm = _load(P(port_config(cfg), vision_in_dim=VISION_DIM),
               from_jax.multimodal_state_dict(v))
    stacks = {n for n in from_jax.CROSSMODAL_STACKS if hasattr(tm, n)}
    assert stacks == set(v["params"]) & set(from_jax.CROSSMODAL_STACKS)
    assert hasattr(tm, "multimodal_linear") == (fuse == "concat"
                                               and modality != "T")
    with torch.no_grad():
        got = tm(*[T(a) for a in args],
                 **{k: T(a) for k, a in kw.items()}).numpy()
    want = np.asarray(jax.jit(jm.apply)(v, *args, **kw))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("fuse", ["crossmodal", "concat"])
def test_dialogue_model_matches_jax(m3ed_files, rng, fuse):
    from facialmmt_tpu.models.dialogue import DialogueMultiModalTransformer as J
    from facialmmt_tpu_torch.models.dialogue import \
        DialogueMultiModalTransformer as P

    cfg = m3ed_config(modality_fuse=fuse)
    args = _dia_args(_dia_batch(m3ed_files))
    jm = J(cfg)
    v = random_params(jm, rng, *args)
    tm = _load(P(port_config(cfg)), from_jax.dialogue_state_dict(v))
    with torch.no_grad():
        got = tm(*[T(a) for a in args]).numpy()
    want = np.asarray(jax.jit(jm.apply)(v, *args))
    assert got.shape == (2, 3, cfg.num_labels)
    np.testing.assert_allclose(got, want, **TOL)


# -------------------------------------------------------------------- data --

@pytest.mark.parametrize("max_seq", [MAX_SEQ, 14])
def test_m3ed_text_prep_matches_jax(m3ed_files, max_seq):
    """M3edTextPreprocessor's arrays, the label channel included, equal the
    JAX package's; at 14 tokens the dialogues truncate (budget
    max_seq - utterances - 1)."""
    path = m3ed_files["text"]["path"]
    got = m3ed_text(path, max_seq)
    want = m3ed_text(path, max_seq, package="jax")
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    ids, mask, sep, labels = got
    assert ids.shape == (3, max_seq) and (sep.sum(1) == 3).all()
    assert (labels[sep == 0] == 0).all()
    if max_seq == 14:
        assert mask.sum(1).max() == 14         # truncated to the budget
    from facialmmt_tpu.data.text_prep import M3edTextPreprocessor as J
    from facialmmt_tpu_torch.data.text_prep import M3edTextPreprocessor as P

    dialogues = [["a b c", "d e"], ["f"]]
    for labels_in in ([[1, 2], [3]], None):
        got = P.to_arrays(P(WhitespaceTokenizer(False), 8)
                          .preprocess_dialogues(dialogues, labels_in))
        want = J.to_arrays(J(WhitespaceTokenizer(False), 8)
                           .preprocess_dialogues(dialogues, labels_in))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def _same_batches(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_m3ed_datasets_match_jax(m3ed_files):
    """The three M3ED datasets on the same files and text arrays: lengths,
    shape properties and batches (deduplicated dialogues, dia_idx) array for
    array; a train split without labels raises, a test split gets zeros."""
    import pickle

    import facialmmt_tpu.data.m3ed as J
    import facialmmt_tpu_torch.data.m3ed as P

    root = m3ed_files["root"]
    ids, mask, sep, labels = m3ed_files["arrays"]
    for name, args, indices in (
            ("M3edTextDataset", (ids, mask, sep, labels),
             ([0, 1, 4, 8], [2, 2, 7])),
            ("M3edMultimodalDataset", (root, "train", ids, mask, sep),
             ([0, 1, 4, 8], [3, 5, 5])),
            ("M3edDialogueDataset", (root, "train", ids, mask, sep),
             ([0, 2], [1, 1, 0]))):
        pd, jd = getattr(P, name)(*args), getattr(J, name)(*args)
        assert len(pd) == len(jd)
        for prop in ("audio_max_utt_len", "vision_max_utt_len",
                     "audio_feat_dim", "vision_feat_dim", "max_dia_len"):
            if hasattr(jd, prop):
                assert getattr(pd, prop) == getattr(jd, prop), (name, prop)
        for idx in indices:
            _same_batches(pd.get_batch(idx), jd.get_batch(idx))

    data = {"train": {"audio": np.zeros((2, 3, 4), np.float32),
                      "audio_utt_mask": np.ones((2, 3), np.int32)}}
    with pytest.raises(KeyError, match="labels"):
        P._labels_or_raise(data["train"], "train", 2)
    np.testing.assert_array_equal(P._labels_or_raise(data["train"], "test", 2),
                                  J._labels_or_raise(data["train"], "test", 2))
    assert pickle.dumps(P._labels_or_raise(data["train"], "test", (2, 3))) \
        == pickle.dumps(J._labels_or_raise(data["train"], "test", (2, 3)))


def test_meld_dialogue_dataset_matches_jax(tmp_path):
    """MeldDialogueDataset groups a MELD split's utterance arrays by
    utt_profile into (B, D, L, feat) batches with the pickle's raw vision,
    as the JAX package does."""
    from facialmmt_tpu.data.meld import MeldDialogueDataset as JD
    from facialmmt_tpu.data.meld import MeldMultimodalDataset as JM
    from facialmmt_tpu.data.meld import MeldTextArrays as JT
    from facialmmt_tpu_torch.data.meld import MeldDialogueDataset as PD
    from facialmmt_tpu_torch.data.meld import MeldMultimodalDataset as PM
    from facialmmt_tpu_torch.data.meld import MeldTextArrays as PT
    from facialmmt_tpu_torch.data.text_prep import MeldTextPreprocessor

    write_meld_fixture(str(tmp_path), "val", num_dia=3, utts_per_dia=4,
                       seed=5)
    prep = MeldTextPreprocessor(WhitespaceTokenizer(), True, MAX_SEQ)
    arrays = MeldTextPreprocessor.to_arrays(prep.preprocess_split(
        str(tmp_path / "val_sent_emo.csv"), str(tmp_path / "val_text.json")))
    pd = PD(PM(str(tmp_path), "val", PT(*arrays), cache=False))
    jd = JD(JM(str(tmp_path), "val", JT(*arrays), cache=False))
    assert len(pd) == len(jd) == 3 and pd.max_dia_len == jd.max_dia_len == 4
    assert pd.dia_rows == jd.dia_rows and pd.dialogues == jd.dialogues
    for idx in ([0, 1], [2, 0, 2]):
        _same_batches(pd.get_batch(idx), jd.get_batch(idx))
    short = PD(pd.base, max_dia_len=2)
    _same_batches(short.get_batch([1]), JD(jd.base, 2).get_batch([1]))


# ------------------------------------------------------------------- steps --

def _hold_state_dict(got_model, want_sd, what):
    got = {k: v.detach().numpy() for k, v in got_model.state_dict().items()}
    assert sorted(got) == sorted(want_sd), what
    floor = 1e-2 * max(np.abs(w).max() for w in want_sd.values())
    for k, w in want_sd.items():
        scale = max(np.abs(w).max(), floor)
        assert np.abs(got[k] - w).max() <= LEAF_TOL * scale, \
            (what, k, np.abs(got[k] - w).max(), scale)


def _steps_match(rng, jmodel, batch, init_args, init_kw, to_state_dict,
                 port_model, make_jax_step, make_port_step):
    """Two train steps from the same weights on both sides: losses and
    every updated parameter."""
    from facialmmt_tpu.train.optim import SingleTaskState as JState
    from facialmmt_tpu.train.optim import make_optimizer
    from facialmmt_tpu_torch.train.optim import SingleTaskState

    params = random_params(jmodel, rng, *init_args, **init_kw)["params"]
    _load(port_model, to_state_dict({"params": params}))
    tx = make_optimizer(OPT, OPT.trg_lr, TOTAL_STEPS, OPT.weight_decay)
    jstate = JState.create(params, tx)
    jstep = jax.jit(make_jax_step(jmodel, tx))
    pstate = SingleTaskState.create(port_model, port_config(OPT),
                                    TOTAL_STEPS)
    pstep = make_port_step(port_model, compute_dtype="float32")
    jbatch = {k: jax.numpy.asarray(v) for k, v in batch.items()}
    for i in range(2):
        jstate, jloss = jstep(jstate, jbatch, jax.random.PRNGKey(i))
        ploss = pstep(pstate, {k: T(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(ploss), float(jloss), atol=LOSS_TOL)
        _hold_state_dict(port_model, to_state_dict(
            {"params": jax.device_get(jstate.params)}), f"step {i}")
    assert pstate.step == int(jstate.step) == 2


def test_text_step_matches_jax(m3ed_files, rng):
    """make_text_train_step on the T+V crossmodal model (CrossModalTrans_TV,
    raw vision) against JAX's, dropout off."""
    from facialmmt_tpu.models.multimodal import \
        MultiModalTransformerForClassification as J
    from facialmmt_tpu.train import steps as jsteps
    from facialmmt_tpu_torch.models.multimodal import \
        MultiModalTransformerForClassification as P
    from facialmmt_tpu_torch.train import steps as psteps

    cfg = m3ed_config(nodrop_config(), choice_modality="T+V")
    batch = _utt_batch(m3ed_files)
    args, kw = _text_args(batch)
    _steps_match(rng, J(cfg), batch, args, kw, from_jax.multimodal_state_dict,
                 P(port_config(cfg), vision_in_dim=VISION_DIM),
                 jsteps.make_text_train_step, psteps.make_text_train_step)


def test_dialogue_step_matches_jax(m3ed_files, rng):
    """make_dialogue_train_step (masked cross-entropy over dia_mask) on the
    crossmodal dialogue model against JAX's, dropout off."""
    from facialmmt_tpu.models.dialogue import DialogueMultiModalTransformer as J
    from facialmmt_tpu.train import steps as jsteps
    from facialmmt_tpu_torch.models.dialogue import \
        DialogueMultiModalTransformer as P
    from facialmmt_tpu_torch.train import steps as psteps

    cfg = m3ed_config(nodrop_config())
    batch = _dia_batch(m3ed_files)
    _steps_match(rng, J(cfg), batch, _dia_args(batch), {},
                 from_jax.dialogue_state_dict, P(port_config(cfg)),
                 jsteps.make_dialogue_train_step,
                 psteps.make_dialogue_train_step)


def test_masked_cross_entropy_matches_jax(rng):
    from facialmmt_tpu.train.steps import masked_cross_entropy as J
    from facialmmt_tpu_torch.train.steps import masked_cross_entropy as P

    logits = rng.normal(size=(2, 4, 7)).astype(np.float32)
    labels = rng.integers(0, 7, (2, 4)).astype(np.int32)
    for mask in (np.array([[1, 1, 0, 0], [1, 0, 0, 0]], np.int32),
                 np.zeros((2, 4), np.int32)):
        np.testing.assert_allclose(float(P(T(logits), T(labels), T(mask))),
                                   float(J(logits, labels, mask)),
                                   atol=LOSS_TOL)


# -------------------------------------------------------------- submission --

def test_submission_and_dump_match_jax(tmp_path, rng):
    """The CSV and the dump byte for byte against JAX's writers, with more
    predictions than template rows and fewer."""
    from facialmmt_tpu.utils import submission as J
    from facialmmt_tpu_torch.utils import submission as P

    assert P.M3ED_EMOTIONS == J.M3ED_EMOTIONS
    template = tmp_path / "template.csv"
    template.write_text("ID,Emotion\n" + "".join(f"dia{i // 3}_utt{i % 3},\n"
                                                 for i in range(6)))
    for n in (6, 4, 9):
        logits = rng.normal(size=(n, 7))
        P.write_submission_csv(logits, str(template), str(tmp_path / "p.csv"))
        J.write_submission_csv(logits, str(template), str(tmp_path / "j.csv"))
        assert (tmp_path / "p.csv").read_bytes() == \
            (tmp_path / "j.csv").read_bytes()
        preds, truths = logits.argmax(-1), rng.integers(0, 7, n)
        got = P.write_pred_true_dump(preds, truths,
                                     str(tmp_path / "d" / "p.txt"))
        want = J.write_pred_true_dump(preds, truths,
                                      str(tmp_path / "d" / "j.txt"))
        assert got == want
        assert (tmp_path / "d" / "p.txt").read_bytes() == \
            (tmp_path / "d" / "j.txt").read_bytes()
    assert os.path.getsize(tmp_path / "p.csv") > 0
