"""The port's checkpoint files, exact resume, preemption and released-weight
loading (CPU).

The CheckpointManager cases are tests/test_resume.py's retention, fallback,
stray-best, cross-resume-best, guard-reinstall and early-stop cases on the
port's torch files.  The resume case preempts run_multimodal in the middle of
a pass and resumes it in a fresh Trainer: everything must equal an
uninterrupted run bit for bit (both sides run the same PyTorch CPU kernels in
the same order).  The released-weights case goes from JAX variables through
the JAX package's torch export to .pt files and into the port's
EmotionServer, held to tests/test_torch_serving.py's tolerance.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facialmmt_tpu.config import FacialMMTConfig, RuntimeConfig
from facialmmt_tpu_torch.checkpoint.io import CheckpointManager
from facialmmt_tpu_torch.checkpoint.torch_load import (load_torch_state_dict,
                                                       released_state_dict,
                                                       save_released)
from facialmmt_tpu_torch.data.meld import (SyntheticFerDataset,
                                           SyntheticMeldDataset)
from facialmmt_tpu_torch.train.trainer import Trainer
from facialmmt_tpu_torch.utils import preemption
from tests.test_models import make_multimodal_batch
from tests.test_torch_ops import random_params
from tests.torch_bridge import port_config


def _w(value):
    return {"w": torch.tensor(float(value))}


def _read(tree):
    return float(tree["w"])


def test_save_step_retention(tmp_path):
    """save_step keeps the newest keep_steps resume files."""
    m = CheckpointManager(str(tmp_path / "ckpt"), keep_steps=2)
    for step in range(1, 5):
        m.save_step(_w(step), step)
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["step_3", "step_4"]
    assert _read(m.restore_latest()) == 4.0

    m_all = CheckpointManager(str(tmp_path / "all"), keep_steps=0)
    for step in range(1, 4):
        m_all.save_step(_w(step), step)
    assert len(os.listdir(tmp_path / "all")) == 3


def test_restore_latest_falls_back_to_older_checkpoint(tmp_path):
    """An unreadable newest resume file falls back to the next-newest; when
    every one is unreadable the error propagates."""
    d = tmp_path / "ckpt"
    m = CheckpointManager(str(d), keep_steps=2)
    m.save_step(_w(1), 1)
    m.save_step(_w(2), 2)
    (d / "step_2").write_bytes(b"not a checkpoint")
    assert _read(m.restore_latest()) == 1.0
    (d / "step_1").write_bytes(b"")
    with pytest.raises(Exception):
        m.restore_latest()
    assert CheckpointManager(str(tmp_path / "empty")).restore_latest() is None


def test_save_best_ignores_stray_best_entries(tmp_path):
    """Only best_<int> files are the manager's: a user file or directory whose
    name starts with best_ is neither deleted nor a crash."""
    d = tmp_path / "ckpt"
    m = CheckpointManager(str(d))
    m.save_best(_w(1), 1)
    (d / "best_model_notes.txt").write_text("keep me")
    (d / "best_7").mkdir()                      # a directory, not a file
    m.save_best(_w(2), 2)
    assert sorted(n for n in os.listdir(d) if n.startswith("best_")) == \
        ["best_2", "best_7", "best_model_notes.txt"]
    assert m.restore_best()[0] == 2


def test_restore_best_across_resume(tmp_path):
    """A fresh manager (a resumed run) supersedes the best of the run before
    it, and restore_best takes the highest step when two are on disk."""
    d = str(tmp_path / "ckpt")
    CheckpointManager(d).save_best(_w(1), 3)
    m2 = CheckpointManager(d)
    m2.save_best(_w(2), 7)
    assert [n for n in os.listdir(d) if n.startswith("best_")] == ["best_7"]
    assert m2.restore_best()[0] == 7 and _read(m2.restore_best()[1]) == 2.0
    m2.save("best_10", _w(10))        # a second best left by a killed run
    assert sorted(os.listdir(d)) == ["best_10", "best_7"]
    step, tree = CheckpointManager(d).restore_best()
    assert step == 10 and _read(tree) == 10.0


def test_save_is_crash_safe(tmp_path, monkeypatch):
    """A write that dies part-way leaves the previous file under the tag
    intact, and the partial file is invisible to the scans."""
    d = tmp_path / "ckpt"
    m = CheckpointManager(str(d))
    m.save_step(_w(1), 1)

    def dying_save(tree, f):
        f.write(b"partial")
        raise OSError("killed during the write")

    monkeypatch.setattr(torch, "save", dying_save)
    with pytest.raises(OSError):
        m.save_step(_w(2), 1)
    monkeypatch.undo()
    assert _read(m.restore_latest()) == 1.0
    assert sorted(os.listdir(d)) == [".tmp_step_1", "step_1"]


def test_preemption_guard_reinstall_clears_stale_request():
    g = preemption.install_preemption_guard()
    try:
        g.trigger()
        assert preemption.preemption_requested()
        g2 = preemption.install_preemption_guard()   # a new run starts clean
        assert g2 is g
        assert not preemption.preemption_requested()
    finally:
        g.uninstall()
    assert not preemption.preemption_requested()


def _config(save_dir, **optim):
    cfg = port_config(FacialMMTConfig.tiny())
    return cfg.replace(
        optim=dataclasses.replace(cfg.optim, **optim),
        runtime=dataclasses.replace(cfg.runtime, save_model_path=str(save_dir),
                                    compute_dtype="float32"))


def test_early_stopping_counters_survive_resume(tmp_path):
    """The {best_val_loss, patience_counter} counters ride the resume file,
    so a resumed run stops at the epoch an uninterrupted one would."""
    cfg = _config(tmp_path)
    t = Trainer(cfg, device="cpu")
    model = t._build_model()
    state = t._init_multitask_state(model, SyntheticMeldDataset(cfg, 4, 2, 2),
                                    4)[0]
    ckpt = CheckpointManager(cfg.runtime.save_model_path)
    es = {"best_val_loss": 0.25, "patience_counter": 2}
    ckpt.save_step(t._ckpt_payload(state, 0.5, 4, {"aux_batch": 3,
                                                   "trg_batch": 0}, es), 4)
    fresh = Trainer(cfg, device="cpu")
    bf, start_epoch, progress, es2 = fresh._restore_latest(
        ckpt, state, {"aux_batch": 0, "trg_batch": 0})
    assert bf == 0.5 and start_epoch == 5
    assert progress == {"aux_batch": 3, "trg_batch": 0}
    assert es2 == es


def _datasets(cfg):
    return (SyntheticFerDataset(12, 24, cfg.num_labels, seed=1),
            SyntheticMeldDataset(cfg, 8, 2, 3, seed=2),
            SyntheticMeldDataset(cfg, 8, 2, 3, seed=3),
            SyntheticMeldDataset(cfg, 6, 2, 3, seed=4))


def _leaves(tree, prefix=""):
    """Every leaf of a nested payload (tensors, numbers, ...), by path."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_leaves(v, f"{prefix}/{k}"))
    return out


OPTIM = dict(num_epochs=2, aux_batch_size=6, trg_batch_size=2,
             trg_accumulation_steps=2, aux_lr=1e-2, trg_lr=1e-2)


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    """Run A, the uninterrupted two-epoch run that every preemption point is
    held against: (save directory, trainer, test F1)."""
    save = tmp_path_factory.mktemp("uninterrupted")
    a = Trainer(_config(save, **OPTIM), device="cpu")
    return save, a, a.run_multimodal(*_datasets(a.cfg))


@pytest.mark.parametrize("at", ["aux_step", "trg_step"])
def test_exact_resume_matches_uninterrupted_run(tmp_path, at, uninterrupted):
    """Two epochs with dropout and sampled gumbel noise.  Run B is preempted
    after the first step of epoch 1's auxiliary or target pass and resumed
    by a fresh Trainer; its epoch-2 resume file (parameters, BatchNorm
    statistics, both AdamW states and schedules, both step counts, the
    generator), its generator at the end and its test F1 equal run A's, bit
    for bit."""
    save_a, a, f1_a = uninterrupted
    cfg_b = _config(tmp_path / "b", **OPTIM)

    guard = preemption.install_preemption_guard()
    fired = []

    def preempt_once(name, **info):
        if name == at and not fired:
            fired.append(info["index"])
            guard.trigger()

    try:
        with pytest.raises(preemption.Preempted) as err:
            Trainer(cfg_b, device="cpu").run_multimodal(
                *_datasets(cfg_b), on_event=preempt_once)
        assert err.value.epoch == 1 and fired == [0]
        assert os.listdir(tmp_path / "b") == ["step_0"]
        progress = CheckpointManager(str(tmp_path / "b")).restore(
            "step_0")["progress"]
        assert progress == ({"aux_batch": 1, "trg_batch": 0} if at == "aux_step"
                            else {"aux_batch": 2, "trg_batch": 1})
        preemption.install_preemption_guard()        # clears the request
        b = Trainer(cfg_b, device="cpu")
        f1_b = b.run_multimodal(*_datasets(cfg_b), resume=True)
    finally:
        guard.uninstall()

    assert f1_a == f1_b
    assert (a.state.swin_step, a.state.mm_step) == \
        (b.state.swin_step, b.state.mm_step) == (4, 4)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert a.best_epoch == b.best_epoch
    ra = CheckpointManager(str(save_a)).restore("step_2")
    rb = CheckpointManager(str(tmp_path / "b")).restore("step_2")
    la, lb = _leaves(ra), _leaves(rb)
    assert sorted(la) == sorted(lb)
    assert any("/exp_avg_sq" in k for k in la) and "/generator" in la
    assert la["/optim/swin_opt/schedule/last_epoch"] == 4
    for k, v in la.items():
        assert (torch.equal(v, lb[k]) if torch.is_tensor(v)
                else v == lb[k]), k


def test_released_weights_load_into_the_port(rng, tmp_path):
    """JAX variables -> the JAX package's torch export (the reference's two
    files) -> load_torch_state_dict + released_state_dict, strict=True ->
    EmotionServer on the CPU: the JAX pipeline's probabilities."""
    from facialmmt_tpu.checkpoint.torch_export import (export_multimodal,
                                                       export_swin_fer,
                                                       save_state_dict_pt)
    from facialmmt_tpu.models.pipeline import FacialMMTPipeline as J
    from facialmmt_tpu.serving import EmotionServer as JaxServer
    from facialmmt_tpu_torch.serving import EmotionServer
    from tests.test_torch_serving import _requests

    cfg = FacialMMTConfig.tiny().replace(
        runtime=RuntimeConfig(deterministic_gumbel=True))
    variables = random_params(J(cfg), rng, make_multimodal_batch(rng, cfg, b=2))
    params, stats = variables["params"], variables["batch_stats"]
    mm_pt, swin_pt = str(tmp_path / "multimodal.pt"), str(tmp_path / "swin.pt")
    mm_sd = export_multimodal({"params": params["multimodal"]})
    # the reference's HF tower carries a pooler the port has no use for
    mm_sd["roberta.pooler.dense.weight"] = np.zeros((4, 4), np.float32)
    save_state_dict_pt(mm_sd, mm_pt)
    save_state_dict_pt(export_swin_fer({"params": params["swin_model"],
                                        "batch_stats": stats["swin_model"]}),
                       swin_pt)
    assert load_torch_state_dict(swin_pt)["swin.output_layer.3.running_var"] \
        .dtype == torch.float32

    sd = released_state_dict(mm_pt, swin_pt)
    kw = dict(max_batch=4, face_capacity=8, transfer_dtype=np.float32)
    port = EmotionServer(port_config(cfg), sd, dtype=torch.float32,
                         device="cpu", **kw)
    ref = JaxServer(cfg, variables, dtype=jnp.float32, **kw)
    reqs = _requests(rng, cfg.data, cfg.text.vocab_size)
    for got, want in zip(port.predict(reqs), ref.predict(reqs)):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)

    # and back: the port's state_dict as the two files, and in again
    save_released(port.model.state_dict(), mm_pt, swin_pt)
    again = released_state_dict(mm_pt, swin_pt)
    assert sorted(again) == sorted(port.model.state_dict())
    for k, v in port.model.state_dict().items():
        assert torch.equal(again[k], v), k
    t = Trainer(port_config(cfg), device="cpu")
    ds = SyntheticMeldDataset(port_config(cfg), 4, 2, 2, seed=9)
    assert np.isfinite(t.eval_multimodal_only(again, ds))
