"""The port's profiler capture and NaN debugging
(facialmmt_tpu_torch/utils/observability.py, `--profile_dir`,
`--debug_nans`) against the JAX package's on the CPU, at tiny() widths.

StepProfiler starts and stops its capture at the calls where JAX's does
(jax.profiler.start_trace / stop_trace and torch.profiler.profile.start /
stop recorded by monkeypatch), and its trace holds one ProfilerStep span per
captured step; Trainer.run_unimodal on tests/fixtures.py's files writes one.
enable_nan_debugging raises FloatingPointError where `jax_debug_nans` does
(a NaN in one input feature), names the module or the backward Function
that made the NaN, and changes no bit of a clean step, MELD's padding
included.  Every test that switches debugging on restores JAX's flag,
anomaly mode and the hook (`nan_debugging`), so no other test of the worker
sees them.
"""

import dataclasses
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import facialmmt_tpu.utils.observability as jax_obs
import facialmmt_tpu_torch.ops.swin as port_swin
import facialmmt_tpu_torch.utils.observability as port_obs
from facialmmt_tpu.config import FacialMMTConfig as JaxConfig
from facialmmt_tpu.models.pipeline import FacialMMTPipeline as JaxPipeline
from facialmmt_tpu.models.unimodal import MeldUttTransformer as JaxUnimodal
from facialmmt_tpu.train import steps as jsteps
from facialmmt_tpu.train.optim import SingleTaskState as JaxSingleState
from facialmmt_tpu.train.optim import make_optimizer
from facialmmt_tpu_torch.checkpoint import from_jax
from facialmmt_tpu_torch.models.pipeline import FacialMMTPipeline
from facialmmt_tpu_torch.models.unimodal import MeldUttTransformer
from facialmmt_tpu_torch.train import steps as psteps
from facialmmt_tpu_torch.train.optim import MultiTaskState, SingleTaskState
from tests.fixtures import write_meld_fixture
from tests.test_models import make_multimodal_batch
from tests.test_torch_ops import random_params
from tests.torch_bridge import port_config


@pytest.fixture
def nan_debugging():
    """Switches NaN debugging on in both packages; afterwards JAX's flag,
    anomaly mode and the global forward hooks are as before."""
    jax_flag = jax.config.jax_debug_nans
    anomaly = (torch.is_anomaly_enabled(),
               torch.is_anomaly_check_nan_enabled())
    hooks = dict(torch.nn.modules.module._global_forward_hooks)
    handles = []

    def enable():
        jax_obs.enable_nan_debugging()
        handles.append(port_obs.enable_nan_debugging())
        return handles[-1]

    yield enable
    for handle in handles:
        handle.remove()
    jax.config.update("jax_debug_nans", jax_flag)
    assert (torch.is_anomaly_enabled(),
            torch.is_anomaly_check_nan_enabled()) == anomaly
    assert dict(torch.nn.modules.module._global_forward_hooks) == hooks


# ---------------------------------------------------------------- profiler --

def _trace_spans(log_dir):
    """{ProfilerStep#n: names of the `call<i>` spans inside it} of the one
    trace file in log_dir."""
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    assert len(files) == 1, files
    with open(files[0]) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    steps = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in events
             if e["name"].startswith("ProfilerStep#")
             and e.get("cat") == "user_annotation"}   # the host's spans
    return {name: sorted(e["name"] for e in events
                         if e["name"].startswith("call")
                         and lo <= e["ts"] <= hi)
            for name, (lo, hi) in steps.items()}


@pytest.mark.parametrize("steps, skip, calls", [
    (5, 1, 10),     # the trainers' defaults
    (3, 0, 10),
    (2, 4, 10),
    (5, 1, 4),      # the run ends first: close() writes the capture
])
def test_step_profiler_captures_the_steps_jax_captures(steps, skip, calls,
                                                       tmp_path, monkeypatch):
    events = {"jax": [], "port": []}
    at = {"call": 0}
    monkeypatch.setattr(jax.profiler, "start_trace",
                        lambda d: events["jax"].append(("start", at["call"])))
    monkeypatch.setattr(jax.profiler, "stop_trace",
                        lambda: events["jax"].append(("stop", at["call"])))
    start, stop = torch.profiler.profile.start, torch.profiler.profile.stop

    def recorded(what, fn):
        def wrapper(self):
            events["port"].append((what, at["call"]))
            return fn(self)
        return wrapper

    monkeypatch.setattr(torch.profiler.profile, "start",
                        recorded("start", start))
    monkeypatch.setattr(torch.profiler.profile, "stop",
                        recorded("stop", stop))

    x = torch.ones(8, 8)
    for name, module in (("jax", jax_obs), ("port", port_obs)):
        prof = module.StepProfiler(str(tmp_path / name), steps, skip)
        for i in range(1, calls + 1):
            with port_obs.trace_span(f"call{i}"):
                x = x @ x / 8
            at["call"] = i
            prof.step()
        at["call"] = "close"
        prof.close()
        at["call"] = 0
    assert events["port"] == events["jax"]
    first = skip + 2                      # the first call traced
    traced = list(range(first, min(calls, skip + steps + 1) + 1))
    spans = _trace_spans(str(tmp_path / "port"))
    want = {f"ProfilerStep#{k}": [f"call{i}"] for k, i in enumerate(traced)}
    if calls < skip + steps + 1:          # close() ended the last span
        want[f"ProfilerStep#{len(traced)}"] = []
    assert spans == want


def test_profile_trace_and_empty_log_dir(tmp_path):
    """profile_trace writes one trace of its region; a StepProfiler with an
    empty log_dir starts no profiler and writes nothing."""
    with port_obs.profile_trace(str(tmp_path / "region")) as prof:
        with port_obs.trace_span("call1"):
            torch.ones(4, 4).sum()
    assert "call1" in {e.key for e in prof.key_averages()}
    assert len(glob.glob(str(tmp_path / "region" / "*.pt.trace.json"))) == 1
    idle = port_obs.StepProfiler("")
    for _ in range(10):
        idle.step()
    idle.close()
    assert idle._prof is None and os.listdir(tmp_path) == ["region"]


def test_profile_dir_traces_run_unimodal(tmp_path):
    """--profile_dir through Trainer.run_unimodal on tests/fixtures.py's
    files (9 training utterances, one a step): train steps 3-7 as
    ProfilerStep#0-4, each holding one backward and one optimizer step;
    the same run without a directory writes no trace (JAX:
    tests/test_resume.py::test_profile_dir_captures_trace)."""
    from facialmmt_tpu_torch.data.meld import MeldVisionDataset
    from facialmmt_tpu_torch.train.trainer import Trainer

    for seed, split in enumerate(("train", "val", "test"), start=1):
        write_meld_fixture(str(tmp_path), split=split, seed=seed)
    train_ds, valid_ds, test_ds = (MeldVisionDataset(str(tmp_path), s)
                                   for s in ("train", "val", "test"))
    base = port_config(JaxConfig.tiny())
    trace = str(tmp_path / "trace")
    for profile_dir in (trace, ""):
        cfg = base.replace(
            data=dataclasses.replace(base.data,
                                     vision_utt_max_len=train_ds.max_utt_len,
                                     vision_feat_dim=train_ds.feat_dim),
            optim=dataclasses.replace(base.optim, num_epochs=1,
                                      trg_batch_size=1,
                                      trg_accumulation_steps=1),
            runtime=dataclasses.replace(
                base.runtime, profile_dir=profile_dir,
                compute_dtype="float32", trg_log_interval=1000,
                save_model_path=str(tmp_path / f"saved{bool(profile_dir)}")))
        assert len(train_ds) == 9
        Trainer(cfg, device="cpu").run_unimodal(train_ds, valid_ds, test_ds)
    files = glob.glob(os.path.join(trace, "rank0.*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    steps = sorted((e for e in events
                    if e["name"].startswith("ProfilerStep#")
                    and e.get("cat") == "user_annotation"),
                   key=lambda e: e["ts"])
    assert [e["name"] for e in steps] == [f"ProfilerStep#{k}"
                                          for k in range(5)]
    for step in steps:                    # one loss backward, one update
        inside = [e["name"] for e in events
                  if step["ts"] <= e["ts"] <= step["ts"] + step["dur"]]
        assert inside.count("autograd::engine::evaluate_function: "
                            "NllLossBackward0") == 1, step["name"]
        assert inside.count("Optimizer.step#AdamW.step") == 1, step["name"]
    names = {os.path.relpath(p, tmp_path) for p in
             glob.glob(str(tmp_path / "**" / "*.pt.trace.json"),
                       recursive=True)}
    assert names == {os.path.relpath(files[0], tmp_path)}


# --------------------------------------------------------------- NaN checks --

def _unimodal_pair(nan: bool):
    """The tiny V-only model on both sides from one numpy draw, its batch
    (one input feature NaN when `nan`) and both train steps."""
    jcfg = JaxConfig.tiny()
    jcfg = jcfg.replace(encoder=dataclasses.replace(
        jcfg.encoder, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0))
    rng = np.random.default_rng(5)
    d = jcfg.data
    feats = rng.normal(size=(4, d.vision_utt_max_len, d.vision_feat_dim)
                       ).astype(np.float32)
    mask = (np.arange(d.vision_utt_max_len)[None]
            < np.array([[d.vision_utt_max_len], [3], [1], [5]])
            ).astype(np.int32)
    labels = np.array([0, 3, 6, 2], np.int32)
    if nan:
        feats[1, 0, 2] = np.nan
    jmodel = JaxUnimodal(jcfg)
    params = random_params(jmodel, rng, feats, mask)["params"]
    tx = make_optimizer(jcfg.optim, jcfg.optim.trg_lr, 10,
                        jcfg.optim.weight_decay)
    jstep = jax.jit(jsteps.make_unimodal_train_step(jmodel, tx))

    from facialmmt_tpu.checkpoint.torch_export import export_unimodal

    sd = {k: torch.tensor(v)
          for k, v in export_unimodal({"params": params}).items()}
    pcfg = port_config(jcfg)

    def port_step():
        model = MeldUttTransformer(pcfg)
        model.load_state_dict(sd, strict=True)
        state = SingleTaskState.create(model, pcfg.optim, 10)
        step = psteps.make_unimodal_train_step(model,
                                               compute_dtype="float32")
        loss = step(state, torch.tensor(feats), torch.tensor(mask),
                    torch.tensor(labels), torch.Generator().manual_seed(0))
        return loss, model

    def jax_step():
        return jstep(JaxSingleState.create(params, tx), jnp.asarray(feats),
                     jnp.asarray(mask), jnp.asarray(labels),
                     jax.random.PRNGKey(0))

    return jax_step, port_step


def test_debug_nans_a_nan_feature_raises_in_both(nan_debugging):
    jax_step, port_step = _unimodal_pair(nan=True)
    nan_debugging()
    with pytest.raises(FloatingPointError):
        jax_step()
    with pytest.raises(FloatingPointError,
                       match=r"NaN in the output of module \w+"):
        port_step()


def test_debug_nans_clean_step_raises_in_neither_and_keeps_its_bits(
        nan_debugging):
    jax_step, port_step = _unimodal_pair(nan=False)
    want_loss, want_model = port_step()
    handle = nan_debugging()
    jax_step()
    loss, model = port_step()
    assert loss.item() == want_loss.item()
    for (name, got), want in zip(model.state_dict().items(),
                                 want_model.state_dict().values()):
        assert torch.equal(got, want), name
    handle.remove()                      # the process as before
    assert not torch.is_anomaly_enabled()
    jax.config.update("jax_debug_nans", False)
    _, port_nan = _unimodal_pair(nan=True)
    port_nan()                           # no check left: no raise


def _padded_meld_batch(cfg):
    """A tiny T+A+V batch with MELD's padding: dialogues of 40 of 64
    tokens, an utterance of 3 audio frames, one utterance without a face
    and empty face slots."""
    rng = np.random.default_rng(9)
    b = {k: np.array(v) for k, v in make_multimodal_batch(rng, cfg, b=3)
         .items()}
    b["dia_input_mask"][:, 40:] = 0
    b["dia_input_ids"][:, 40:] = cfg.text.pad_token_id
    b["audio_mask"][1, 3:] = 0
    b["n_faces"] = np.array([4, 0, 2], np.int32)
    b["face_utt_id"] = np.array([0, 0, 0, 0, 2, 2] + [-1] * 6, np.int32)
    b["face_pos"] = np.array([0, 1, 2, 3, 0, 1] + [0] * 6, np.int32)
    return rng, b


def test_debug_nans_meld_padding_trips_neither(nan_debugging):
    """The text tower's and the fusion stacks' masked softmax, and the
    empty vision sequence of a faceless utterance, make no NaN: JAX's eval
    step under jax_debug_nans and the port's target, auxiliary and eval
    steps under enable_nan_debugging raise nothing, and the port's losses
    and logits are bit for bit those without debugging."""
    cfg = JaxConfig.tiny()
    rng, batch = _padded_meld_batch(cfg)
    jmodel = JaxPipeline(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = random_params(jmodel, rng, jbatch)
    sd = from_jax.pipeline_state_dict(jax.tree.map(np.asarray, variables))
    pcfg = port_config(cfg)

    def port_steps():
        model = FacialMMTPipeline(pcfg)
        model.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})
        state = MultiTaskState.create(model, pcfg.optim, 10, 10)
        tb = {k: torch.tensor(v) for k, v in batch.items()}
        gen = torch.Generator().manual_seed(0)
        trg = psteps.make_multimodal_train_step(model,
                                                compute_dtype="float32")
        aux = psteps.make_aux_train_step(model, compute_dtype="float32")
        ev = psteps.make_multimodal_eval_step(model, compute_dtype="float32")
        return (trg(state, tb, gen).item(),
                aux(state, tb["faces"][:6], torch.arange(6) % 7, gen).item(),
                ev(tb, gen)[0])

    want = port_steps()
    nan_debugging()
    jstep = jax.jit(jsteps.make_multimodal_eval_step(jmodel,
                                                     sample_gumbel=False))
    jstep(variables["params"], variables["batch_stats"], jbatch,
          jax.random.PRNGKey(0))
    got = port_steps()
    assert got[:2] == want[:2]
    assert torch.equal(got[2], want[2])


def test_debug_nans_backward_nan_names_the_kernel_function(
        nan_debugging, monkeypatch):
    """A NaN injected through a tensor hook into the gradient arriving at
    the Swin head (the last block's MLP half, kernel 3's autograd Function)
    raises FloatingPointError from the auxiliary step naming that
    Function's backward, which the card runs as kernel 4."""
    cfg = port_config(JaxConfig.tiny())
    model = FacialMMTPipeline(cfg)
    state = MultiTaskState.create(model, cfg.optim, 10, 10)
    last = sum(cfg.swin.depths)          # the last block's MLP half
    calls = []

    def fused_ln_mlp_residual(*args, **kwargs):
        out = port_swin_mlp(*args, **kwargs)
        calls.append(out)
        if len(calls) == last:
            out.register_hook(lambda g: g * float("nan"))
        return out

    port_swin_mlp = port_swin.fused_ln_mlp_residual
    monkeypatch.setattr(port_swin, "fused_ln_mlp_residual",
                        fused_ln_mlp_residual)
    rng = np.random.default_rng(2)
    px = cfg.data.swin_img_size
    images = torch.tensor(rng.normal(size=(4, px, px, 3)).astype(np.float32))
    step = psteps.make_aux_train_step(model, compute_dtype="float32")
    nan_debugging()
    with pytest.raises(FloatingPointError,
                       match="FusedLnMlpResidualBackward"):
        step(state, images, torch.tensor([0, 1, 2, 3]),
             torch.Generator().manual_seed(0))
