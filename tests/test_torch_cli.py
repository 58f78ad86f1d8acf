"""The port's command line (facialmmt_tpu_torch/main.py) against the JAX
package's on the CPU, on the seed-made files of tests/fixtures.py.

Both packages' `config_from_args` parse the same argv; the small Swin that no
flag selects (`DataConfig.swin_img_size` has none) comes from a monkeypatch of
both, and the JAX converter, which sizes a released text tower from the
checkpoint's plm (roberta-large), is handed the tiny tower the config holds.
Evaluation runs in fp32 with deterministic gumbel and the weights are drawn
from a numpy seed, so both CLIs must print the same W-F1 (atol 1e-6) and
their per-utterance logits agree to 1e-4 (fp32 XLA against fp32 PyTorch,
differing in summation order).  The flag decisions, the config mapping, the
V-only model and its steps, and the training command line (in process and as
`python -m facialmmt_tpu_torch.main`, preempted and resumed) are here too.
"""

import dataclasses
import os
import signal
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import facialmmt_tpu.checkpoint.torch_convert as jax_convert
import facialmmt_tpu.main as jax_main
import facialmmt_tpu.train.trainer as jax_trainer
import facialmmt_tpu_torch.main as port_main
import facialmmt_tpu_torch.train.trainer as port_trainer
from facialmmt_tpu.config import FacialMMTConfig as JaxConfig
from facialmmt_tpu.config import resolve_text_config as jax_text_config
from facialmmt_tpu_torch.checkpoint.torch_load import (save_hf_text_tower,
                                                       save_released)
from facialmmt_tpu_torch.config import FacialMMTConfig as PortConfig
from facialmmt_tpu_torch.data.meld import MeldMultimodalDataset
from facialmmt_tpu_torch.models.pipeline import FacialMMTPipeline
from facialmmt_tpu_torch.models.unimodal import MeldUttTransformer
from facialmmt_tpu_torch.utils import preemption
from tests.fixtures import (WhitespaceTokenizer, write_affwild_fixture,
                            write_meld_fixture)
from tests.torch_bridge import port_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLIT_SEEDS = {"train": 1, "val": 2, "test": 3}
MAX_SEQ = 64
SMALL = ["--hidden_size", "64", "--num_attention_heads", "4",
         "--intermediate_size", "128", "--crossmodal_num_heads_TA", "4",
         "--crossmodal_num_heads_TA_V", "4", "--audio_utt_Transformernum", "2",
         "--vision_utt_Transformernum", "1", "--text_preset", "tiny",
         "--max_seq_length", str(MAX_SEQ), "--dp", "1"]
EVAL = ["--compute_dtype", "float32", "--deterministic_gumbel", "1"]
LOGIT_TOL = 1e-4


def _write_text_caches(root, splits):
    """The CLI's tokenized-text npz cache, so no HF tokenizer is needed."""
    from facialmmt_tpu_torch.data.text_prep import MeldTextPreprocessor

    prep = MeldTextPreprocessor(WhitespaceTokenizer(), True, MAX_SEQ)
    for split in splits:
        feats = prep.preprocess_split(
            os.path.join(root, f"{split}_sent_emo.csv"),
            os.path.join(root, f"{split}_text.json"))
        ids, mask, sep = MeldTextPreprocessor.to_arrays(feats)
        np.savez(os.path.join(root, "T+A+V",
                              f"text_{split}_roberta-large.npz"),
                 ids=ids, mask=mask, sep=sep)


@pytest.fixture(scope="module")
def meld_root(tmp_path_factory):
    """train / val / test splits in the reference's layout, their text
    caches, and an Aff-Wild2 tree."""
    root = tmp_path_factory.mktemp("meld")
    for split, seed in SPLIT_SEEDS.items():
        write_meld_fixture(str(root), split=split, num_dia=3, utts_per_dia=3,
                           seed=seed, faces_per_utt=3)
    _write_text_caches(str(root), SPLIT_SEEDS)
    write_affwild_fixture(str(root / "aux"), num_videos=2, frames=5)
    return root


def _small_swin(cfg, tiny):
    """cfg with tiny()'s Swin (its implementation fields kept) and image
    size."""
    swin = dataclasses.replace(
        tiny.swin, attention_impl=cfg.swin.attention_impl,
        mlp_impl=cfg.swin.mlp_impl, merge_impl=cfg.swin.merge_impl,
        remat=cfg.swin.remat)
    return cfg.replace(swin=swin, data=dataclasses.replace(
        cfg.data, swin_img_size=tiny.data.swin_img_size))


@pytest.fixture
def small_swin(monkeypatch):
    """Both packages' config_from_args give the tiny Swin; the JAX converter
    sizes the released text tower from the config."""
    jax_cfa, port_cfa = jax_main.config_from_args, port_main.config_from_args
    monkeypatch.setattr(jax_main, "config_from_args",
                        lambda args: _small_swin(jax_cfa(args),
                                                 JaxConfig.tiny()))
    monkeypatch.setattr(port_main, "config_from_args",
                        lambda args: _small_swin(port_cfa(args),
                                                 PortConfig.tiny()))
    convert = jax_convert.convert_multimodal
    monkeypatch.setattr(
        jax_convert, "convert_multimodal",
        lambda sd, cfg, text_cfg=None: convert(sd, cfg, jax_text_config(cfg)))


@pytest.fixture
def no_guard():
    """A training run installs the SIGTERM guard; take it out afterwards."""
    yield
    if preemption._guard is not None:
        preemption._guard.uninstall()


def seeded_state_dict(model, rng):
    """A state_dict of `model` drawn from `rng`: matrices ~ N(0, 1/fan_in),
    norm scales ~ 1 + N(0, 0.1), other vectors ~ N(0, 0.1), running
    variances ~ U(0.5, 1.5); geometry and integer buffers as built."""
    out = {}
    for name, t in model.state_dict().items():
        leaf = name.rsplit(".", 1)[-1]
        if not t.is_floating_point() or name.endswith("attn_mask"):
            out[name] = t.clone()
        elif leaf == "running_var":
            out[name] = torch.tensor(rng.uniform(0.5, 1.5, t.shape),
                                     dtype=t.dtype)
        elif t.dim() >= 2:
            fan_in = int(np.prod(t.shape[1:]))
            out[name] = torch.tensor(rng.normal(size=t.shape)
                                     / np.sqrt(fan_in), dtype=t.dtype)
        else:
            base = 1.0 if leaf == "weight" and "norm" in name.lower() else 0.0
            out[name] = torch.tensor(base + 0.1 * rng.normal(size=t.shape),
                                     dtype=t.dtype)
    return out


def _argv(root, *extra):
    return ["--data_load_path", str(root), "--device", "cpu",
            "--pretrained_model_dir", str(root / "pretrained_model"),
            "--save_Model_path", str(root / "saved_model"),
            "--metrics_path", str(root / "metrics.jsonl"), *SMALL, *extra]


def _port_cfg(argv, ds):
    args = port_main.build_argparser().parse_args(argv)
    return port_main._adapt_static_shapes(port_main.config_from_args(args), ds)


def _record_logits(monkeypatch, module, into):
    """Keep the logits each trainer hands to eval_meld."""
    orig = module.eval_meld

    def recording(logits, labels, test=False):
        into.append(np.asarray(logits, np.float64))
        return orig(logits, labels, test=test)

    monkeypatch.setattr(module, "eval_meld", recording)


# ------------------------------------------------------------ the headline --

def test_cli_doeval_tav_equals_jax(meld_root, small_swin, monkeypatch):
    """`--choice_modality T+A+V --doEval 1` from a released pair that the
    port writes with save_released: the same W-F1 as the JAX CLI, the same
    per-utterance logits, and the same as Trainer.eval_multimodal_only on
    the same files."""
    from facialmmt_tpu_torch.checkpoint.torch_load import released_state_dict
    from facialmmt_tpu_torch.main import text_arrays
    from facialmmt_tpu_torch.train.trainer import Trainer

    argv = _argv(meld_root, "--choice_modality", "T+A+V", "--doEval", "1",
                 *EVAL)
    probe = port_main.config_from_args(port_main.build_argparser()
                                       .parse_args(argv))
    test_ds = MeldMultimodalDataset(str(meld_root), "test",
                                    text_arrays(probe, "test"))
    cfg = _port_cfg(argv, test_ds)
    sd = seeded_state_dict(FacialMMTPipeline(cfg), np.random.default_rng(7))
    pm = meld_root / "pretrained_model"
    os.makedirs(pm, exist_ok=True)
    save_released(sd, str(pm / "multimodal_model_T+A+V_RoBERTa.pt"),
                  str(pm / "best_swin_RoBERTa.pt"))

    got, want = [], []
    _record_logits(monkeypatch, port_trainer, got)
    _record_logits(monkeypatch, jax_trainer, want)
    f1_port = port_main.run(argv)
    f1_jax = jax_main.run([a for a in argv if a not in ("--device", "cpu")])
    np.testing.assert_allclose(f1_port, f1_jax, atol=1e-6)
    assert len(got) == len(want) == 1 and got[0].shape == (len(test_ds), 7)
    np.testing.assert_allclose(got[0], want[0], atol=LOGIT_TOL, rtol=0)
    assert np.unique(got[0].argmax(-1)).size > 1   # not a constant answer
    api = Trainer(cfg, device="cpu").eval_multimodal_only(
        released_state_dict(str(pm / "multimodal_model_T+A+V_RoBERTa.pt"),
                            str(pm / "best_swin_RoBERTa.pt")), test_ds)
    assert api == f1_port


def test_cli_doeval_v_equals_jax(meld_root, monkeypatch):
    """`--choice_modality V --doEval 1` from a unimodal_model_V.pt."""
    argv = _argv(meld_root, "--choice_modality", "V", "--doEval", "1", *EVAL)
    from facialmmt_tpu_torch.data.meld import MeldVisionDataset

    cfg = _port_cfg(argv, MeldVisionDataset(str(meld_root), "test"))
    pm = meld_root / "pretrained_model"
    os.makedirs(pm, exist_ok=True)
    torch.save(seeded_state_dict(MeldUttTransformer(cfg),
                                 np.random.default_rng(8)),
               pm / "unimodal_model_V.pt")
    got, want = [], []
    _record_logits(monkeypatch, port_trainer, got)
    _record_logits(monkeypatch, jax_trainer, want)
    f1_port = port_main.run(argv)
    f1_jax = jax_main.run([a for a in argv if a not in ("--device", "cpu")])
    np.testing.assert_allclose(f1_port, f1_jax, atol=1e-6)
    np.testing.assert_allclose(got[0], want[0], atol=LOGIT_TOL, rtol=0)


# ----------------------------------------------------------------- config --

@pytest.mark.parametrize("argv", [
    [],
    ["--choice_modality", "V", "--doEval", "0", "--trg_lr", "1e-3",
     "--hidden_size", "64", "--num_attention_heads", "4",
     "--intermediate_size", "128", "--seed", "7", "--patience", "3"],
    ["--plm_name", "bert-large", "--text_preset", "tiny",
     "--compute_dtype", "float32", "--deterministic_gumbel", "1",
     "--fused_text_attention", "auto", "--fused_fusion_attention", "",
     "--eval_face_chunk", "32", "--swin_remat", "0", "--text_remat", "0"],
    ["--swin_attention_impl", "pair", "--swin_mlp_impl", "xla",
     "--swin_merge_impl", "raster", "--dp", "1", "--swin_from_target", "1",
     "--trg_accumulation_steps", "2", "--aux_batch_size", "8",
     "--swin_config_path", os.path.join(REPO, "configs", "swin_conf.yaml")],
])
def test_config_from_args_equals_jax(argv):
    want = port_config(jax_main.config_from_args(
        jax_main.build_argparser().parse_args(argv)))
    got = port_main.config_from_args(
        port_main.build_argparser().parse_args(argv))
    assert got == want


@pytest.mark.parametrize("argv, world, error, match", [
    (["--dp", "2"], None, NotImplementedError, "torchrun"),
    (["--tp", "3"], "4", ValueError, "does not divide"),
])
def test_unported_flags_raise_before_data(argv, world, error, match,
                                          tmp_path, monkeypatch):
    """Raised by run() before anything is read: the data path is empty.
    --dp / --tp beyond one rank need torchrun's environment (WORLD_SIZE),
    and --tp must divide its world."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    if world is not None:
        monkeypatch.setenv("WORLD_SIZE", world)
    with pytest.raises(error, match=match):
        port_main.run(["--data_load_path", str(tmp_path / "none"),
                       "--device", "cpu", *argv])


@pytest.mark.parametrize("argv", [
    ["--profile_dir", "/tmp/trace"],
    ["--debug_nans", "1"],
])
def test_tooling_flags_are_ported(argv):
    """--profile_dir and --debug_nans pass the port's check and map to the
    JAX package's config (tests/test_torch_observability.py runs them)."""
    args = port_main.build_argparser().parse_args(argv)
    port_main.check_ported(args)
    assert port_main.config_from_args(args) == port_config(
        jax_main.config_from_args(jax_main.build_argparser().parse_args(argv)))


def test_build_mesh_defaults_to_the_card(tmp_path):
    """In a one-rank gloo group on the CPU: build_mesh with no device asks
    for the card and raises without one; with "cpu" it builds the plan."""
    import torch.distributed as dist

    from facialmmt_tpu_torch.parallel.mesh import build_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                build_mesh(1, 1)
        plan = build_mesh(1, 1, "cpu")
        assert plan.member and (plan.dp, plan.tp) == (1, 1)
        assert plan.mesh.device_type == "cpu"
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("argv", [
    ["--choice_modality", "T"],
    ["--choice_modality", "T+A"],
    ["--choice_modality", "T+V"],
    ["--modalityFuse", "concat"],
    ["--uttORdia", "dia"],
    ["--m3ed_project_path", "/data/m3ed"],
])
def test_appendix_flags_are_ported(argv):
    """The appendix's flags pass the port's check and map to the JAX
    package's config (tests/test_torch_appendix_cli.py runs them)."""
    args = port_main.build_argparser().parse_args(argv)
    port_main.check_ported(args)
    assert port_main.config_from_args(args) == port_config(
        jax_main.config_from_args(jax_main.build_argparser().parse_args(argv)))


@pytest.mark.parametrize("argv, match", [
    (["--fused_text_attention", "on"], "device decides"),
    (["--fused_fusion_attention", "off"], "device decides"),
    (["--prng_impl", "rbg"], "torch.Generator"),
    (["--prng_impl", "threefry2x32"], "torch.Generator"),
])
def test_jax_implementation_switches_raise(argv, match):
    with pytest.raises(ValueError, match=match):
        port_main.config_from_args(port_main.build_argparser()
                                   .parse_args(argv))


def test_cli_raises_without_a_card(meld_root):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main.run(["--data_load_path", str(meld_root),
                       "--choice_modality", "V"])


# --------------------------------------------------------------- unimodal --

def test_unimodal_forward_and_steps_match_jax():
    """MeldUttTransformer's forward, then three train steps with dropout
    off, against the JAX model and optax from the same weights (loss 1e-5,
    every parameter 1e-4 of its leaf's max, as test_torch_train.py)."""
    import jax.numpy as jnp

    from facialmmt_tpu.checkpoint.torch_export import export_unimodal
    from facialmmt_tpu.models.unimodal import MeldUttTransformer as JaxModel
    from facialmmt_tpu.train import steps as jsteps
    from facialmmt_tpu.train.optim import SingleTaskState as JaxState
    from facialmmt_tpu.train.optim import make_optimizer
    from facialmmt_tpu_torch.train import steps as psteps
    from facialmmt_tpu_torch.train.optim import SingleTaskState
    from tests.test_torch_ops import random_params

    jcfg = JaxConfig.tiny()
    jcfg = jcfg.replace(encoder=dataclasses.replace(
        jcfg.encoder, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0), optim=dataclasses.replace(
        jcfg.optim, warm_up=0.0, trg_lr=2e-3))
    rng = np.random.default_rng(3)
    d = jcfg.data
    feats = rng.normal(size=(5, d.vision_utt_max_len, d.vision_feat_dim)
                       ).astype(np.float32)
    mask = (np.arange(d.vision_utt_max_len)[None]
            < rng.integers(1, d.vision_utt_max_len + 1, (5, 1))
            ).astype(np.int32)
    labels = rng.integers(0, 7, 5).astype(np.int32)
    jmodel = JaxModel(jcfg)
    params = random_params(jmodel, rng, feats, mask)["params"]

    pcfg = port_config(jcfg)
    pmodel = MeldUttTransformer(pcfg)
    pmodel.load_state_dict({k: torch.tensor(v) for k, v in
                            export_unimodal({"params": params}).items()},
                           strict=True)
    pmodel.eval()
    with torch.no_grad():
        got = pmodel(torch.tensor(feats), torch.tensor(mask)).numpy()
    want = np.asarray(jmodel.apply({"params": params}, feats, mask))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)

    tx = make_optimizer(jcfg.optim, jcfg.optim.trg_lr, 100,
                        jcfg.optim.weight_decay)
    jstate = JaxState.create(params, tx)
    jstep = jax.jit(jsteps.make_unimodal_train_step(jmodel, tx))
    pstate = SingleTaskState.create(pmodel, pcfg.optim, 100)
    pstep = psteps.make_unimodal_train_step(pmodel, compute_dtype="float32")
    for _ in range(3):
        jstate, jloss = jstep(jstate, jnp.asarray(feats), jnp.asarray(mask),
                              jnp.asarray(labels), jax.random.PRNGKey(0))
        ploss = pstep(pstate, torch.tensor(feats), torch.tensor(mask),
                      torch.tensor(labels))
        np.testing.assert_allclose(float(ploss), float(jloss), atol=1e-5)
    want_sd = export_unimodal({"params": jax.device_get(jstate.params)})
    for name, t in pmodel.state_dict().items():
        scale = max(float(np.abs(want_sd[name]).max()), 1e-2)
        np.testing.assert_allclose(t.numpy(), want_sd[name],
                                   atol=1e-4 * scale, rtol=0, err_msg=name)
    assert pstate.step == int(jstate.step) == 3


# ---------------------------------------------------------------- training --

def _train_argv(root, save, *extra):
    return _argv(root, "--doEval", "0", "--num_epochs", "1",
                 "--trg_batch_size", "4", "--trg_accumulation_steps", "1",
                 "--aux_batch_size", "4", "--warm_up", "0",
                 "--save_Model_path", str(save), "--trg_log_interval", "1",
                 *EVAL, *extra)


def test_cli_train_v(meld_root, tmp_path, no_guard):
    f1 = port_main.run(_train_argv(meld_root, tmp_path / "saved",
                                   "--choice_modality", "V",
                                   "--num_epochs", "2", "--trg_lr", "1e-3",
                                   "--metrics_path",
                                   str(tmp_path / "m.jsonl")))
    assert 0.0 <= f1 <= 1.0
    saved = os.listdir(tmp_path / "saved")
    assert any(s.startswith("best_") for s in saved)
    assert "step_2" in saved
    tags = [line.split('"tag": "')[1].split('"')[0]
            for line in open(tmp_path / "m.jsonl")]
    assert tags.count("val") == 2 and tags[-1] == "test"
    assert "trg_train" in tags


def test_cli_train_v_profiled_under_nan_debugging(meld_root, tmp_path,
                                                  no_guard, monkeypatch):
    """--profile_dir and --debug_nans run: NaN debugging is on before the
    trainer is built and for the rest of the run (the handle main.run
    leaves in place is removed here), the clean run raises nothing, and
    the trace holds train step 3 of the 3 (ProfilerStep#0) and what ran
    after it until the run closed the capture (#1)."""
    import glob
    import json

    from facialmmt_tpu_torch.utils import observability

    handles = []
    enable = observability.enable_nan_debugging

    def recorded():
        handles.append(enable())
        return handles[-1]

    monkeypatch.setattr(observability, "enable_nan_debugging", recorded)
    init, built = port_trainer.Trainer.__init__, []

    def trainer_init(self, *args, **kwargs):
        built.append(torch.is_anomaly_check_nan_enabled())
        init(self, *args, **kwargs)

    monkeypatch.setattr(port_trainer.Trainer, "__init__", trainer_init)
    trace = tmp_path / "trace"
    try:
        f1 = port_main.run(_train_argv(
            meld_root, tmp_path / "saved", "--choice_modality", "V",
            "--trg_lr", "1e-3", "--profile_dir", str(trace),
            "--debug_nans", "1", "--metrics_path", ""))
    finally:
        for handle in handles:
            handle.remove()
    assert len(handles) == 1 and built == [True]
    assert 0.0 <= f1 <= 1.0
    (path,) = glob.glob(str(trace / "rank0.*.pt.trace.json"))
    with open(path) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation"}
    assert {n for n in names if n.startswith("ProfilerStep#")} == {
        "ProfilerStep#0", "ProfilerStep#1"}


def test_cli_train_tav_grafts_and_resumes(meld_root, tmp_path, small_swin,
                                          no_guard, monkeypatch):
    """`--doEval 0` T+A+V from a `backbone.*` Swin file and an HF-layout text
    directory: before the first step the Swin and the text tower are the
    files' tensors; losses are finite; the best and resume files are
    written; `--resume 1` continues from the resume file."""
    import facialmmt_tpu_torch.train.steps as psteps

    argv = _train_argv(
        meld_root, tmp_path / "saved", "--choice_modality", "T+A+V",
        "--data_folder", str(meld_root / "aux" / "cropped_aligned"),
        "--anno_folder", str(meld_root / "aux" / "annos"),
        "--data_list_train", str(tmp_path / "aux_list.txt"),
        "--pretrained_backbone_path", str(tmp_path / "backbone.pt"),
        "--pretrainedtextmodel_path", str(tmp_path / "roberta-large"),
        "--aux_log_interval", "1")
    cfg = _port_cfg(argv, MeldMultimodalDataset(
        str(meld_root), "test", port_main.text_arrays(
            port_main.config_from_args(port_main.build_argparser()
                                       .parse_args(argv)), "test")))
    src = seeded_state_dict(FacialMMTPipeline(cfg), np.random.default_rng(9))
    torch.save({"backbone." + k[len("swin_model.swin."):]: v
                for k, v in src.items() if k.startswith("swin_model.swin.")}
               | {"head.weight": torch.zeros(3, 2)}, tmp_path / "backbone.pt")
    save_hf_text_tower(src, cfg.text, "multimodal.roberta",
                       str(tmp_path / "roberta-large"))

    seen = {}
    aux = psteps.make_aux_train_step

    def first_step_sees(model, **kw):
        step = aux(model, **kw)

        def wrapped(state, *args, **kwargs):
            if "sd" not in seen:
                seen["sd"] = {k: v.clone() for k, v in
                              state.model.state_dict().items()}
            loss = step(state, *args, **kwargs)
            seen.setdefault("losses", []).append(float(loss))
            return loss

        return wrapped

    monkeypatch.setattr(port_trainer, "make_aux_train_step", first_step_sees)
    f1 = port_main.run(argv)
    assert 0.0 <= f1 <= 1.0
    grafted = [k for k in src if k.startswith(
        ("swin_model.swin.", "multimodal.roberta."))
        and not k.endswith(("attn_mask", "relative_position_index",
                            "num_batches_tracked"))]
    assert len(grafted) > 40
    for k in grafted:
        assert torch.equal(seen["sd"][k], src[k]), k
    assert np.isfinite(seen["losses"]).all()
    saved = sorted(os.listdir(tmp_path / "saved"))
    assert any(s.startswith("best_") for s in saved) and "step_1" in saved

    # the same command again with --resume 1: the resume file says the one
    # epoch is done, so the run goes straight to the test split
    seen.clear()
    f1_resumed = port_main.run(argv + ["--resume", "1"])
    assert "sd" not in seen and f1_resumed == f1


@pytest.mark.parametrize("flag", ["--swin_remat", "--text_remat"])
def test_remat_flags_train_an_epoch(meld_root, tmp_path, small_swin,
                                    no_guard, monkeypatch, flag):
    """--swin_remat 1 / --text_remat 1 (formerly refused) train one T+A+V
    epoch from the fixtures with every Swin block / text layer
    checkpointed."""
    from facialmmt_tpu_torch.ops import layers

    calls = []
    real = layers.checkpointed
    monkeypatch.setattr(
        "facialmmt_tpu_torch.ops.swin.checkpointed"
        if flag == "--swin_remat" else
        "facialmmt_tpu_torch.models.text_encoder.checkpointed",
        lambda *a, **k: calls.append(1) or real(*a, **k))
    f1 = port_main.run(_train_argv(
        meld_root, tmp_path / "saved", "--choice_modality", "T+A+V",
        "--data_folder", str(meld_root / "aux" / "cropped_aligned"),
        "--anno_folder", str(meld_root / "aux" / "annos"),
        "--data_list_train", str(tmp_path / "aux_list.txt"), flag, "1"))
    assert 0.0 <= f1 <= 1.0 and calls
    assert "step_1" in os.listdir(tmp_path / "saved")


def test_cli_module_preempted_then_resumed(meld_root, tmp_path, no_guard):
    """`python -m facialmmt_tpu_torch.main` told to stop by SIGTERM exits 143
    with a resume file; `--resume 1` then finishes the run."""
    argv = _train_argv(meld_root, tmp_path / "saved", "--choice_modality",
                       "V", "--num_epochs", "6", "--trg_batch_size", "1",
                       "--metrics_path", str(tmp_path / "m.jsonl"))
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "facialmmt_tpu_torch.main", *argv],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "PYTHONPATH": REPO})
    try:
        for line in proc.stdout:             # the guard is installed first
            if line.startswith("&&&&"):
                proc.send_signal(signal.SIGTERM)
                break
        out = proc.stdout.read()
        rc = proc.wait(timeout=120)
    finally:
        proc.kill()
    assert rc == 143, out
    assert "Preemption requested" in out
    assert any(s.startswith("step_") for s in os.listdir(tmp_path / "saved"))
    f1 = port_main.run(argv + ["--resume", "1"])
    assert 0.0 <= f1 <= 1.0


# --------------------------------------------------------------- full dims --

@pytest.mark.slow
@pytest.mark.parametrize("plm_name", ["roberta-large", "bert-large"])
def test_cli_full_dims_equals_jax(tmp_path, plm_name):
    """The port's twin of test_wf1_readiness.py::
    test_wf1_readiness_full_dims_cli: the README's evaluation command at
    FacialMMTConfig() dims (RoBERTa- or BERT-large at 512 tokens, Swin-tiny
    at 224 px, the 768-wide fusion stacks) on fixtures at the real feature
    widths, from a released pair the port writes (seeded random weights);
    both CLIs print the same W-F1.  No reference tree is needed: the JAX
    package is the oracle."""
    from facialmmt_tpu_torch.data.text_prep import MeldTextPreprocessor
    from facialmmt_tpu_torch.models.pipeline import build_pipeline

    is_roberta = plm_name == "roberta-large"
    d = PortConfig().data
    write_meld_fixture(str(tmp_path), split="test", num_dia=2, utts_per_dia=3,
                       audio_len=d.audio_utt_max_len,
                       vision_len=d.vision_utt_max_len,
                       audio_dim=d.audio_feat_dim,
                       vision_dim=d.vision_feat_dim, seed=11)
    prep = MeldTextPreprocessor(WhitespaceTokenizer(is_roberta), is_roberta,
                                d.max_seq_length)
    ids, mask, sep = MeldTextPreprocessor.to_arrays(prep.preprocess_split(
        str(tmp_path / "test_sent_emo.csv"), str(tmp_path / "test_text.json")))
    np.savez(tmp_path / "T+A+V" / f"text_test_{plm_name}.npz", ids=ids,
             mask=mask, sep=sep)
    suffix = "RoBERTa" if is_roberta else "BERT"
    argv = ["--choice_modality", "T+A+V", "--plm_name", plm_name,
            "--load_multimodal_path", f"multimodal_T+A+V_{suffix}.pt",
            "--load_swin_path", f"best_swin_{suffix}.pt", "--doEval", "1",
            "--data_load_path", str(tmp_path),
            "--pretrained_model_dir", str(tmp_path / "pretrained_model"),
            "--save_Model_path", str(tmp_path / "saved_model"),
            "--metrics_path", str(tmp_path / "metrics.jsonl"), "--dp", "1",
            *EVAL]
    port_argv = argv + ["--device", "cpu"]
    cfg = _port_cfg(port_argv, MeldMultimodalDataset(
        str(tmp_path), "test", port_main.text_arrays(
            port_main.config_from_args(port_main.build_argparser()
                                       .parse_args(port_argv)), "test")))
    pm = tmp_path / "pretrained_model"
    os.makedirs(pm)
    save_released(build_pipeline(cfg.replace(runtime=dataclasses.replace(
        cfg.runtime, seed=7)), torch.device("cpu")).state_dict(),
        str(pm / f"multimodal_T+A+V_{suffix}.pt"),
        str(pm / f"best_swin_{suffix}.pt"))
    np.testing.assert_allclose(port_main.run(port_argv), jax_main.run(argv),
                               atol=1e-6)
