"""The port's command line on the appendix's paths (facialmmt_tpu_torch/
main.py), on the CPU at tiny() widths, on tests/fixtures.py's files.

No JAX command line or trainer runs here: each --doEval command evaluates
weights that the JAX package's module made (drawn from a numpy seed, carried
over by checkpoint/from_jax.py into the port's best file), and its
per-utterance logits are held against the JAX module's forward on the JAX
package's dataset of the same files (fp32 on both sides, atol 1e-4); its
macro-F1 equals the port's API call on the same files exactly, a second run
gives the same bits and a byte-identical submission CSV, whose rows follow
the test split's order.  Each training command runs one epoch and must give
finite losses, the best and resume files and an F1 in [0, 1]; the T run
preempted after its first step and resumed equals the uninterrupted run bit
for bit.  Also here: MELD's token length against the JAX preprocessor, and
the startup check of an explicit --submission_template.
"""

import csv
import os

import jax
import numpy as np
import pytest
import torch

import facialmmt_tpu.main as jax_main
import facialmmt_tpu_torch.main as port_main
import facialmmt_tpu_torch.train.trainer as port_trainer
from facialmmt_tpu_torch.checkpoint import from_jax
from facialmmt_tpu_torch.checkpoint.io import CheckpointManager
from facialmmt_tpu_torch.utils import preemption
from facialmmt_tpu_torch.utils.submission import M3ED_EMOTIONS
from tests.fixtures import (WhitespaceTokenizer, write_affwild_fixture,
                            write_m3ed_multimodal_fixture, write_meld_fixture)
from tests.test_torch_appendix import (AUDIO_DIM, AUDIO_LEN, VISION_DIM,
                                       VISION_LEN, m3ed_text)
from tests.test_torch_cli import (EVAL, MAX_SEQ, SMALL,  # noqa: F401
                                  small_swin)            # (a fixture)
from tests.test_torch_ops import random_params
from tests.test_torch_resume import _leaves

SPLIT_SEEDS = {"train": 1, "val": 2, "test": 3}
LOGIT_TOL = 1e-4


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """M3ED splits (3 dialogues of 3 utterances) with their text caches at
    MAX_SEQ tokens, a 9-row submission template, and MELD T+V splits with
    their text caches and an Aff-Wild2 tree."""
    from facialmmt_tpu_torch.data.text_prep import MeldTextPreprocessor

    root = tmp_path_factory.mktemp("appendix")
    m3ed, data = root / "m3ed", root / "data"
    os.makedirs(data / "T")
    meld_prep = MeldTextPreprocessor(WhitespaceTokenizer(), True, MAX_SEQ)
    for split, seed in SPLIT_SEEDS.items():
        info = write_m3ed_multimodal_fixture(
            str(m3ed), split, num_dia=3, utts_per_dia=3, audio_len=AUDIO_LEN,
            vision_len=VISION_LEN, audio_dim=AUDIO_DIM, vision_dim=VISION_DIM,
            seed=seed)
        ids, mask, sep, labels = m3ed_text(info["text"]["path"])
        np.savez(data / "T" / f"text_{split}_roberta-large_m3ed.npz", ids=ids,
                 mask=mask, sep=sep, labels=labels)
        write_meld_fixture(str(root / "meld"), split, num_dia=2,
                           utts_per_dia=3, seed=seed, modality="T+V")
        arrays = MeldTextPreprocessor.to_arrays(meld_prep.preprocess_split(
            str(root / "meld" / f"{split}_sent_emo.csv"),
            str(root / "meld" / f"{split}_text.json")))
        np.savez(root / "meld" / "T+V" / f"text_{split}_roberta-large.npz",
                 **dict(zip(("ids", "mask", "sep"), arrays)))
    with open(root / "template.csv", "w") as f:
        f.write("ID,Emotion\n")
        f.writelines(f"dia{i // 3}_utt{i % 3},\n" for i in range(9))
    write_affwild_fixture(str(root / "aux"), num_videos=2, frames=5)
    return root


def _argv(root, save, *extra):
    return ["--device", "cpu", "--data_load_path", str(root / "data"),
            "--m3ed_project_path", str(root / "m3ed"),
            "--save_Model_path", str(save),
            "--metrics_path", str(save / "metrics.jsonl"), *SMALL, *EVAL,
            *extra]


def _jax_argv(argv):
    return [a for a in argv if a not in ("--device", "cpu")]


def _record(monkeypatch, cls, into):
    """Keep the logits of every prediction pass of `cls`."""
    real = cls._predict

    def recording(self, eval_step, ds, bsz):
        out = real(self, eval_step, ds, bsz)
        into.append(out[0])
        return out

    monkeypatch.setattr(cls, "_predict", recording)


def _jax_setup(root, argv, dia):
    """The JAX config, model and dataset of the test split for `argv`."""
    from facialmmt_tpu.data.m3ed import (M3edDialogueDataset,
                                         M3edMultimodalDataset,
                                         M3edTextDataset)
    from facialmmt_tpu.models.dialogue import DialogueMultiModalTransformer
    from facialmmt_tpu.models.multimodal import \
        MultiModalTransformerForClassification

    cfg = jax_main.config_from_args(
        jax_main.build_argparser().parse_args(_jax_argv(argv)))
    with np.load(root / "data" / "T" / "text_test_roberta-large_m3ed.npz") \
            as z:
        ids, mask, sep, labels = (z[k] for k in ("ids", "mask", "sep",
                                                 "labels"))
    if cfg.choice_modality == "T":
        return (cfg, MultiModalTransformerForClassification(cfg),
                M3edTextDataset(ids, mask, sep, labels))
    cls = M3edDialogueDataset if dia else M3edMultimodalDataset
    ds = cls(str(root / "m3ed"), "test", ids, mask, sep)
    cfg = jax_main._adapt_static_shapes(cfg, ds)
    model = (DialogueMultiModalTransformer(cfg) if dia
             else MultiModalTransformerForClassification(cfg))
    return cfg, model, ds


def _jax_logits(model, ds, rng, dia, save):
    """Weights for `model` from `rng`, written to `save` as the port's best
    file; the JAX logits of the whole split in dataset order (mask-selected
    for dialogues) and the labels."""
    batch = ds.get_batch(list(range(len(ds))))
    if dia:
        args = [batch[k] for k in ("dia_input_ids", "dia_input_mask",
                                   "dia_sep_mask", "audio_inputs",
                                   "audio_mask", "vision_inputs",
                                   "vision_mask", "dia_mask")]
        kw = {}
    else:
        args = [batch[k] for k in ("dia_input_ids", "dia_input_mask",
                                   "dia_sep_mask")]
        kw = {k: batch[k] for k in ("utt_in_dia_idx", "dia_idx",
                                    "audio_inputs", "audio_mask",
                                    "vision_inputs", "vision_mask")
              if k in batch}
    v = random_params(model, rng, *args, **kw)
    sd = (from_jax.dialogue_state_dict if dia
          else from_jax.multimodal_state_dict)(v)
    CheckpointManager(str(save)).save_best(
        {k: torch.tensor(np.asarray(a)) for k, a in sd.items()}, 1)
    logits = np.asarray(jax.jit(model.apply)(v, *args, **kw))
    labels = batch["labels"]
    if dia:
        keep = batch["dia_mask"].astype(bool)
        logits, labels = logits[keep], labels[keep]
    return logits, labels


def _read_csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def _doeval_equals_jax(root, tmp_path, monkeypatch, rng, extra, dia):
    """The --doEval command on JAX-made weights: logits against the JAX
    module, macro-F1 against the API call, a second run bit for bit with a
    byte-identical CSV in test order, the dump."""
    from facialmmt_tpu_torch.train.trainer import DialogueTrainer, TextTrainer

    save = tmp_path / "saved"
    os.makedirs(save)
    argv = _argv(root, save, "--doEval", "1", *extra,
                 "--submission_template", str(root / "template.csv"),
                 "--pred_dump_path", str(tmp_path / "dump.txt"))
    _, jmodel, jds = _jax_setup(root, argv, dia)
    want, labels = _jax_logits(jmodel, jds, rng, dia, save)
    cls = DialogueTrainer if dia else TextTrainer
    got = []
    _record(monkeypatch, cls, got)
    f1 = port_main.run(argv)
    f1_again = port_main.run(argv + ["--submission_out",
                                     str(tmp_path / "again.csv")])
    assert len(got) == 2 and got[0].shape == want.shape == (9, 7)
    np.testing.assert_allclose(got[0], want, atol=LOGIT_TOL, rtol=0)
    np.testing.assert_array_equal(got[1], got[0])
    assert f1_again == f1 and 0.0 <= f1 <= 1.0
    first = (save / "nustm_submission.csv").read_bytes()
    assert (tmp_path / "again.csv").read_bytes() == first
    rows = _read_csv(save / "nustm_submission.csv")
    assert rows[0] == ["ID", "Emotion"]
    assert [r[0] for r in rows[1:]] == [f"dia{i // 3}_utt{i % 3}"
                                        for i in range(9)]
    assert [r[1] for r in rows[1:]] == [M3ED_EMOTIONS[i]
                                        for i in got[0].argmax(-1)]
    dump = (tmp_path / "dump.txt").read_text().split()
    np.testing.assert_array_equal(np.asarray(dump[1::2], int), labels)
    np.testing.assert_array_equal(np.asarray(dump[0::2], int),
                                  got[0].argmax(-1))
    return argv, f1


def _train_once(root, save, *extra, seen=None):
    """One epoch from scratch: the test F1 and the files written; the losses
    of the steps must be finite.  `seen`, when given, receives the model's
    state_dict before the first step ('start')."""
    os.makedirs(save, exist_ok=True)
    losses = []
    real = port_trainer._SingleModelTrainer._run

    def run(self, *args, **kwargs):
        def on_event(name, **info):
            if name == "trg_step":
                losses.append(info["loss"])
            elif name == "start" and seen is not None:
                seen.update({k: v.clone() for k, v in
                             self.state.model.state_dict().items()})

        kwargs["on_event"] = on_event
        return real(self, *args, **kwargs)

    port_trainer._SingleModelTrainer._run = run
    try:
        f1 = port_main.run(_argv(root, save, "--doEval", "0", "--num_epochs",
                                 "1", "--trg_lr", "1e-3", *extra))
    finally:
        port_trainer._SingleModelTrainer._run = real
        if preemption._guard is not None:
            preemption._guard.uninstall()
    assert 0.0 <= f1 <= 1.0 and losses and np.isfinite(losses).all()
    files = sorted(os.listdir(save))
    assert "best_1" in files and "step_1" in files, files
    return f1, files


# --------------------------------------------------------------- T (text) --

def test_cli_t_doeval_equals_jax_and_api(root, tmp_path, monkeypatch, rng):
    from facialmmt_tpu_torch.data.m3ed import M3edTextDataset
    from facialmmt_tpu_torch.train.trainer import TextTrainer

    argv, f1 = _doeval_equals_jax(root, tmp_path, monkeypatch, rng,
                                  ["--choice_modality", "T"], dia=False)
    cfg = port_main.config_from_args(port_main.build_argparser()
                                     .parse_args(argv))
    arrays = port_main.m3ed_text_arrays(cfg, "", "test")
    api = TextTrainer(cfg, device="cpu").eval_text_only(
        M3edTextDataset(*arrays), ckpt_dir=str(tmp_path / "saved"))
    assert api == f1


def test_cli_t_trains_then_evaluates_its_best_file(root, tmp_path):
    """T from an HF-layout text directory: before the first step the tower
    is the directory's tensors; the --doEval of the best file gives the
    training run's test F1."""
    from facialmmt_tpu_torch.checkpoint.torch_load import save_hf_text_tower
    from facialmmt_tpu_torch.models.multimodal import \
        MultiModalTransformerForClassification
    from tests.test_torch_cli import seeded_state_dict

    cfg = port_main.config_from_args(port_main.build_argparser().parse_args(
        _argv(root, tmp_path, "--choice_modality", "T")))
    src = seeded_state_dict(MultiModalTransformerForClassification(cfg),
                            np.random.default_rng(5))
    save_hf_text_tower(src, cfg.text, "roberta", str(tmp_path / "plm"))
    seen = {}
    f1, _ = _train_once(root, tmp_path / "saved", "--choice_modality", "T",
                        "--trg_batch_size", "2", "--trg_accumulation_steps",
                        "2", "--pretrainedtextmodel_path",
                        str(tmp_path / "plm"), seen=seen)
    tower = [k for k in src if k.startswith("roberta.")]
    assert len(tower) > 20
    for k in tower:
        assert torch.equal(seen[k], src[k]), k
    again = port_main.run(_argv(root, tmp_path / "saved", "--doEval", "1",
                                "--choice_modality", "T", "--trg_batch_size",
                                "2", "--trg_accumulation_steps", "2"))
    assert again == f1


def test_cli_t_preempted_then_resumed_equals_uninterrupted(root, tmp_path,
                                                           monkeypatch):
    """Two epochs with dropout: a run stopped by the preemption guard after
    its first step and resumed with --resume 1 ends with the uninterrupted
    run's test F1 and epoch-2 resume file, bit for bit."""
    import facialmmt_tpu_torch.train.steps as psteps

    extra = ["--choice_modality", "T", "--doEval", "0", "--num_epochs", "2",
             "--trg_lr", "1e-3", "--trg_batch_size", "2",
             "--trg_accumulation_steps", "1", "--hidden_dropout_prob", "0.1"]
    os.makedirs(tmp_path / "a")
    os.makedirs(tmp_path / "b")
    try:
        f1_a = port_main.run(_argv(root, tmp_path / "a", *extra))
        real = psteps.make_text_train_step

        def stop_after_first(model, **kw):
            step = real(model, **kw)

            def wrapped(*args, **kwargs):
                loss = step(*args, **kwargs)
                preemption._guard.trigger()
                return loss

            return wrapped

        monkeypatch.setattr(psteps, "make_text_train_step", stop_after_first)
        with pytest.raises(preemption.Preempted):
            port_main.run(_argv(root, tmp_path / "b", *extra))
        assert os.listdir(tmp_path / "b").count("step_0") == 1
        monkeypatch.setattr(psteps, "make_text_train_step", real)
        f1_b = port_main.run(_argv(root, tmp_path / "b", *extra,
                                   "--resume", "1"))
    finally:
        if preemption._guard is not None:
            preemption._guard.uninstall()
    assert f1_a == f1_b
    la = _leaves(CheckpointManager(str(tmp_path / "a")).restore("step_2"))
    lb = _leaves(CheckpointManager(str(tmp_path / "b")).restore("step_2"))
    assert sorted(la) == sorted(lb) and "/generator" in la
    for k, v in la.items():
        assert (torch.equal(v, lb[k]) if torch.is_tensor(v)
                else v == lb[k]), k


# ---------------------------------------------------------------- M3ED utt --

@pytest.mark.parametrize("modality", ["T+A", "T+V", "T+A+V"])
def test_cli_m3ed_utt_equals_jax_and_trains(root, tmp_path, monkeypatch, rng,
                                            modality):
    _doeval_equals_jax(root, tmp_path, monkeypatch, rng,
                       ["--choice_modality", modality], dia=False)
    _train_once(root, tmp_path / "trained", "--choice_modality", modality)


# ---------------------------------------------------------------- M3ED dia --

@pytest.mark.parametrize("fuse", ["crossmodal", "concat"])
def test_cli_m3ed_dia_equals_jax_and_trains(root, tmp_path, monkeypatch, rng,
                                            fuse):
    from facialmmt_tpu_torch.data.m3ed import M3edDialogueDataset
    from facialmmt_tpu_torch.train.trainer import DialogueTrainer

    extra = ["--uttORdia", "dia", "--modalityFuse", fuse]
    argv, f1 = _doeval_equals_jax(root, tmp_path, monkeypatch, rng, extra,
                                  dia=True)
    cfg = port_main.config_from_args(port_main.build_argparser()
                                     .parse_args(argv))
    ids, mask, sep, _ = port_main.m3ed_text_arrays(cfg, "", "test")
    ds = M3edDialogueDataset(str(root / "m3ed"), "test", ids, mask, sep)
    api = DialogueTrainer(port_main._adapt_static_shapes(cfg, ds),
                          device="cpu").eval_dialogue_only(
        ds, ckpt_dir=str(tmp_path / "saved"))
    assert api == f1
    _train_once(root, tmp_path / "trained", *extra, "--trg_batch_size", "2")


# -------------------------------------------------------------------- MELD --

def test_cli_meld_tv_and_dialogue_train(root, tmp_path, small_swin):  # noqa: F811
    """MELD --choice_modality T+V through the FER pipeline (CrossModalTrans_TV
    on the 512 + 7 wide vision) and --uttORdia dia (the dialogue model on the
    pickle's raw vision), one epoch each."""
    aux = ["--data_folder", str(root / "aux" / "cropped_aligned"),
           "--anno_folder", str(root / "aux" / "annos"),
           "--data_list_train", str(tmp_path / "aux_list.txt"),
           "--aux_batch_size", "4", "--trg_batch_size", "2",
           "--trg_accumulation_steps", "1"]
    meld = ["--data_load_path", str(root / "meld"), "--m3ed_project_path", "",
            "--choice_modality", "T+V"]
    save = tmp_path / "tv"
    os.makedirs(save)
    f1 = port_main.run(_argv(root, save, "--doEval", "0", "--num_epochs", "1",
                             *aux, *meld))
    if preemption._guard is not None:
        preemption._guard.uninstall()
    assert 0.0 <= f1 <= 1.0
    _, best = CheckpointManager(str(save)).restore_best()
    assert any(k.startswith("multimodal.CrossModalTrans_TV.") for k in best)
    assert not any(k.startswith(("multimodal.audio", "multimodal.CrossModal"
                                 "Trans_TA")) for k in best)
    assert best["multimodal.vision_linear.weight"].shape[1] == 16 + 7
    _, files = _train_once(root, tmp_path / "dia", *meld, "--uttORdia", "dia",
                           "--trg_batch_size", "2")
    _, best = CheckpointManager(str(tmp_path / "dia")).restore_best()
    assert best["vision_linear.weight"].shape[1] == 16
    assert "attention_pooling.query_vector" in best


# -------------------------------------------------------- flags and caches --

def test_explicit_template_raises_before_data(tmp_path, monkeypatch):
    """A mistyped --submission_template raises FileNotFoundError before any
    data loads (the data path is empty); the default name, absent, is
    skipped."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError, match="submission_template"):
        port_main.run(["--data_load_path", str(tmp_path / "none"),
                       "--device", "cpu", "--choice_modality", "T",
                       "--doEval", "1", "--submission_template",
                       str(tmp_path / "typo.csv")])
    assert port_main.resolve_submission_template(
        port_main.DEFAULT_TEMPLATE) == ""
    (tmp_path / port_main.DEFAULT_TEMPLATE).write_text("ID,Emotion\n")
    assert port_main.resolve_submission_template(
        port_main.DEFAULT_TEMPLATE) == port_main.DEFAULT_TEMPLATE


def test_text_caches_follow_jax_token_lengths(tmp_path, monkeypatch):
    """With no cache, the MELD dialogues are 512 tokens whatever
    --max_seq_length says and equal JAX's MeldTextPreprocessor(tok,
    is_roberta) array for array; the M3ED dialogues take --max_seq_length
    and equal JAX's M3edTextPreprocessor.  Both caches read back the same."""
    import transformers

    from facialmmt_tpu.data.text_prep import (M3edTextPreprocessor,
                                              MeldTextPreprocessor)

    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        staticmethod(lambda name: WhitespaceTokenizer()))
    write_meld_fixture(str(tmp_path), "test", num_dia=2, utts_per_dia=3,
                       seed=6)
    write_m3ed_multimodal_fixture(str(tmp_path / "m3ed"), "test", seed=6)
    cfg = port_main.config_from_args(port_main.build_argparser().parse_args(
        ["--data_load_path", str(tmp_path), "--max_seq_length", "128",
         "--load_anno_csv_path", str(tmp_path),
         "--meld_text_path", str(tmp_path)]))
    got = port_main.text_arrays(cfg, "test")
    want = MeldTextPreprocessor.to_arrays(
        MeldTextPreprocessor(WhitespaceTokenizer(), True).preprocess_split(
            str(tmp_path / "test_sent_emo.csv"),
            str(tmp_path / "test_text.json")))
    cached = port_main.text_arrays(cfg, "test")
    for g, w, c in zip((got.input_ids, got.input_mask, got.sep_mask), want,
                       (cached.input_ids, cached.input_mask,
                        cached.sep_mask)):
        assert g.shape == (2, 512)
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(c, w)
    got = port_main.m3ed_text_arrays(cfg, str(tmp_path / "m3ed"), "test")
    want = M3edTextPreprocessor.to_arrays(
        M3edTextPreprocessor(WhitespaceTokenizer(), 128).preprocess_split(
            str(tmp_path / "m3ed" / "test_utt_text_noEmo.json")))
    cached = port_main.m3ed_text_arrays(cfg, "", "test")
    for g, w, c in zip(got, want, cached):
        assert g.shape == (3, 128)
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(c, w)
