"""The port's train steps and trainer against the JAX package on the CPU.

One config (FacialMMTConfig.tiny() with every dropout and the drop-path rate
at 0 and deterministic gumbel, so no random draw enters a step), one set of
weights drawn from a numpy seed and carried over by the weight bridge, one
batch: the JAX step and the port's step start from the same state and are
compared for three consecutive steps.  Tolerances: loss 1e-5 absolute, every
gradient and post-step parameter leaf 1e-4 of that leaf's max (both sides are
fp32 XLA / PyTorch CPU, differing only in summation order).  A leaf's scale
is floored at 1e-2 of the tree's largest leaf max: the biases in front of
Swin's batch-statistics BatchNorm have gradients that are zero in exact
arithmetic and hold only rounding noise (1e-8), which has no scale of its own.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from facialmmt_tpu.config import FacialMMTConfig, OptimConfig
from facialmmt_tpu.models.pipeline import FacialMMTPipeline as JaxPipeline
from facialmmt_tpu.train import steps as jsteps
from facialmmt_tpu.train.optim import MultiTaskState as JaxState
from facialmmt_tpu.train.optim import make_optimizer as jax_make_optimizer
from facialmmt_tpu_torch.checkpoint import from_jax
from facialmmt_tpu_torch.checkpoint.io import CheckpointManager
from facialmmt_tpu_torch.data.meld import (FaceCapacityError,
                                           SyntheticFerDataset,
                                           SyntheticMeldDataset)
from facialmmt_tpu_torch.models.pipeline import FacialMMTPipeline
from facialmmt_tpu_torch.train import steps as psteps
from facialmmt_tpu_torch.train.optim import MultiTaskState
from facialmmt_tpu_torch.train.trainer import Trainer
from tests.test_models import make_multimodal_batch
from tests.test_torch_ops import random_params
from tests.torch_bridge import port_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEAF_TOL = 1e-4
OPT = OptimConfig(warm_up=0.0, aux_lr=2e-4, trg_lr=2e-4)
TOTAL_STEPS = 100


def nodrop_config() -> FacialMMTConfig:
    cfg = FacialMMTConfig.tiny()
    rep = dataclasses.replace
    return cfg.replace(
        encoder=rep(cfg.encoder, hidden_dropout_prob=0.0,
                    attention_probs_dropout_prob=0.0),
        crossmodal_ta=rep(cfg.crossmodal_ta, attn_dropout=0.0),
        crossmodal_ta_v=rep(cfg.crossmodal_ta_v, attn_dropout=0.0),
        text=rep(cfg.text, hidden_dropout_prob=0.0,
                 attention_probs_dropout_prob=0.0),
        runtime=rep(cfg.runtime, deterministic_gumbel=True,
                    compute_dtype="float32"))


def _torch_batch(batch):
    return {k: torch.tensor(np.asarray(v)) for k, v in batch.items()}


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def _adam_state(opt_state):
    """(mu, nu, count) of the AdamW inside an optax chain state."""
    found = [s for s in jax.tree.leaves(
        opt_state, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu")]
    assert len(found) == 1
    return _np_tree(found[0].mu), _np_tree(found[0].nu), int(found[0].count)


class Pair:
    """The same model, weights and optimizer state on both sides."""

    def __init__(self, rng, cfg, batch):
        self.cfg = cfg
        self.jmodel = JaxPipeline(cfg)
        variables = random_params(self.jmodel, rng, batch)
        self.swin_tx = jax_make_optimizer(OPT, OPT.aux_lr, TOTAL_STEPS)
        self.mm_tx = jax_make_optimizer(OPT, OPT.trg_lr, TOTAL_STEPS,
                                        OPT.weight_decay)
        self.jstate = JaxState.create(variables["params"],
                                      variables["batch_stats"], self.swin_tx,
                                      self.mm_tx)
        self.pmodel = FacialMMTPipeline(port_config(cfg))
        self.pstate = MultiTaskState.create(self.pmodel, port_config(OPT),
                                            TOTAL_STEPS, TOTAL_STEPS)
        self.carry_over()

    def variables(self):
        return {"params": self.jstate.params,
                "batch_stats": self.jstate.batch_stats}

    def carry_over(self):
        """Put the JAX state (weights, BatchNorm statistics, AdamW moments,
        counts) into the port's."""
        sd = from_jax.pipeline_state_dict(_np_tree(self.variables()))
        self.pmodel.load_state_dict(
            {k: torch.tensor(v) for k, v in sd.items()}, strict=True)
        from_jax.load_multitask_state(
            self.pstate, _adam_state(self.jstate.swin_opt_state),
            _adam_state(self.jstate.mm_opt_state),
            int(self.jstate.swin_step), int(self.jstate.mm_step),
            like=self.variables())

    def hold_state(self, what):
        """Every parameter and running statistic of the port against JAX."""
        want = _np_tree(self.variables())
        got = from_jax.to_jax_tree(
            {k: v.detach().numpy() for k, v in
             self.pmodel.state_dict().items()}, like=want)
        _hold_tree(got, want, what)
        assert (self.pstate.swin_step, self.pstate.mm_step) == \
            (int(self.jstate.swin_step), int(self.jstate.mm_step))


def _hold_tree(got, want, what):
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_got) == len(flat_want), what
    floor = 1e-2 * max(np.abs(w).max() for _, w in flat_want)
    for path, w in flat_want:
        g = flat_got[path]
        scale = max(np.abs(w).max(), floor)
        assert np.abs(g - w).max() <= LEAF_TOL * scale, \
            (what, jax.tree_util.keystr(path), np.abs(g - w).max(), scale)


def _port_grads(model):
    return {k: p.grad.numpy().copy() for k, p in model.named_parameters()
            if p.grad is not None}


def test_aux_step_matches_jax(rng):
    """Three auxiliary steps; the port starts steps 2 and 3 from the JAX
    state after step 1 (non-zero AdamW moments carried across)."""
    cfg = nodrop_config()
    batch = make_multimodal_batch(rng, cfg, b=2)
    pair = Pair(rng, cfg, batch)
    images = np.asarray(batch["faces"][:6])
    labels = rng.integers(0, 7, size=6).astype(np.int32)

    # gradients of the first step, leaf by leaf
    def loss_fn(swin_params):
        params = {"swin_model": swin_params,
                  "multimodal": pair.jstate.params["multimodal"]}
        logits, _ = pair.jmodel.apply(
            {"params": params, "batch_stats": pair.jstate.batch_stats},
            images, deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)},
            method=JaxPipeline.aux_logits, mutable=["batch_stats"])
        return jsteps.cross_entropy(logits, labels)

    want = {"params": {"swin_model": _np_tree(jax.jit(jax.grad(loss_fn))(
        pair.jstate.params["swin_model"]))}}
    pair.pmodel.train()
    stats = {k: v.clone() for k, v in pair.pmodel.state_dict().items()}
    logits = pair.pmodel.aux_logits(torch.tensor(images))
    psteps.cross_entropy(logits, torch.tensor(labels)).backward()
    got = from_jax.to_jax_tree(_port_grads(pair.pmodel), like=pair.variables())
    _hold_tree(got, want, "aux gradients")
    pair.pmodel.zero_grad(set_to_none=True)
    pair.pmodel.load_state_dict(stats)      # undo the BatchNorm update

    jstep = jax.jit(jsteps.make_aux_train_step(pair.jmodel, pair.swin_tx))
    pstep = psteps.make_aux_train_step(pair.pmodel, compute_dtype="float32")
    for i in range(3):
        pair.jstate, jloss = jstep(pair.jstate, images, labels,
                                   jax.random.PRNGKey(i))
        if i == 0:
            pair.carry_over()
            continue
        ploss = pstep(pair.pstate, torch.tensor(images), torch.tensor(labels))
        assert abs(float(ploss) - float(jloss)) <= 1e-5, i
        pair.hold_state(f"aux step {i + 1}")


def test_target_gradients_match_jax(rng):
    """Joint training's gradients into both branches, leaf by leaf."""
    cfg = nodrop_config()
    batch = make_multimodal_batch(rng, cfg, b=2)
    pair = Pair(rng, cfg, batch)

    def loss_fn(params):
        logits, _ = pair.jmodel.apply(
            {"params": params, "batch_stats": pair.jstate.batch_stats}, batch,
            deterministic=False, stop_swin_gradient=False,
            rngs={"gumbel": jax.random.PRNGKey(0),
                  "dropout": jax.random.PRNGKey(1)}, mutable=["batch_stats"])
        return jsteps.cross_entropy(logits, batch["labels"])

    want = {"params": _np_tree(jax.jit(jax.grad(loss_fn))(pair.jstate.params))}
    pair.pmodel.train()
    tb = _torch_batch(batch)
    psteps.cross_entropy(pair.pmodel(tb), tb["labels"]).backward()
    got = from_jax.to_jax_tree(_port_grads(pair.pmodel), like=pair.variables())
    _hold_tree(got, want, "joint gradients")


def test_eval_step_matches_jax_and_chunks(rng):
    cfg = nodrop_config()
    batch = make_multimodal_batch(rng, cfg, b=3)
    pair = Pair(rng, cfg, batch)
    jstep = jax.jit(jsteps.make_multimodal_eval_step(pair.jmodel,
                                                     sample_gumbel=False))
    want_logits, want_loss = jstep(pair.jstate.params, pair.jstate.batch_stats,
                                   batch, jax.random.PRNGKey(0))
    for chunk in (0, 5):
        pstep = psteps.make_multimodal_eval_step(pair.pmodel, face_chunk=chunk,
                                                 compute_dtype="float32")
        logits, loss = pstep(_torch_batch(batch))
        np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                                   rtol=1e-4, atol=1e-4)
        assert abs(float(loss) - float(want_loss)) <= 1e-5
    assert not pair.pmodel.training


# ----------------------------------------------------------------- trainer --

def _trainer_config(save_dir=None, **optim):
    """The tiny config with `optim` overrides; checkpoints go to `save_dir`
    (a test's tmp_path) in every test that trains."""
    cfg = port_config(FacialMMTConfig.tiny())
    cfg = cfg.replace(optim=dataclasses.replace(cfg.optim, **optim))
    if save_dir is not None:
        cfg = cfg.replace(runtime=dataclasses.replace(
            cfg.runtime, save_model_path=str(save_dir)))
    return cfg


def _datasets(cfg, faces=3):
    return (SyntheticFerDataset(12, 24, cfg.num_labels, seed=1),
            SyntheticMeldDataset(cfg, 8, 2, faces, seed=2),
            SyntheticMeldDataset(cfg, 8, 2, faces, seed=3),
            SyntheticMeldDataset(cfg, 6, 2, faces, seed=4))


def test_trainer_runs_and_selects_the_best_epoch(capsys, tmp_path):
    cfg = _trainer_config(tmp_path, num_epochs=2, aux_batch_size=6,
                          trg_batch_size=2, trg_accumulation_steps=2,
                          aux_lr=1e-2, trg_lr=1e-2)
    trainer = Trainer(cfg, device="cpu")
    events = []
    f1 = trainer.run_multimodal(*_datasets(cfg),
                                on_event=lambda name, **kw: events.append(name))
    assert np.isfinite(f1) and 0.0 <= f1 <= 1.0
    assert [h["epoch"] for h in trainer.history] == [1, 2]
    f1s = [h["val_f1"] for h in trainer.history]
    # the first epoch to reach the best validation F1 is kept
    assert trainer.best_epoch == 1 + int(np.argmax(f1s))
    # ... written to its file, and what the test split was evaluated from
    assert sorted(os.listdir(tmp_path)) == [f"best_{trainer.best_epoch}",
                                            "step_1", "step_2"]
    step, best = CheckpointManager(str(tmp_path)).restore_best()
    final = trainer.state.model.state_dict()
    assert step == trainer.best_epoch and best.keys() == final.keys()
    assert all(torch.equal(final[k], v) for k, v in best.items())
    assert (trainer.state.swin_step, trainer.state.mm_step) == (4, 4)
    assert events == ["start"] + (["aux_step"] * 2 + ["aux_pass"]
                                  + ["trg_step"] * 2 + ["trg_pass", "valid"]) * 2
    out = capsys.readouterr().out
    assert "**SRC** | Epoch  2" in out and "val_wg_av_f1" in out
    assert "**TEST** | wg_av_f1" in out


def test_trainer_joint_training_steps_swin_from_the_target_pass(tmp_path):
    cfg = _trainer_config(tmp_path, num_epochs=1, aux_batch_size=6,
                          trg_batch_size=2, trg_accumulation_steps=2).replace(
                              swin_from_target=True)
    trainer = Trainer(cfg, device="cpu")
    f1 = trainer.run_multimodal(*_datasets(cfg))
    assert np.isfinite(f1)
    # 2 auxiliary steps + 2 joint target steps
    assert (trainer.state.swin_step, trainer.state.mm_step) == (4, 2)


def test_trainer_escalates_the_face_bucket(capsys):
    """20 faces per utterance at an 8-utterance eval batch need 160 slots: the
    base bucket (128) overflows and the loader moves to the ceiling (192)."""
    cfg = _trainer_config()
    cfg = cfg.replace(data=dataclasses.replace(cfg.data,
                                               vision_utt_max_len=20))
    trainer = Trainer(cfg, device="cpu")
    assert trainer._face_buckets(8) == [128, 192]
    ds = SyntheticMeldDataset(cfg, 8, 2, faces_per_utt=20, seed=5)
    with pytest.raises(FaceCapacityError) as err:
        ds.get_batch(range(8), face_capacity=128)
    assert err.value.required == 160
    model = trainer._build_model()
    step = psteps.make_multimodal_eval_step(model, compute_dtype="float32")
    logits, labels = trainer._eval_multimodal(step, ds, batch_size=8)
    assert "escalating to bucket 192" in capsys.readouterr().out
    assert logits.shape == (8, cfg.num_labels) and np.isfinite(logits).all()
    np.testing.assert_array_equal(labels, ds.labels)
    with pytest.raises(FaceCapacityError):      # the ceiling bucket re-raises
        trainer._batch_with_escalation(
            lambda cap: ds.get_batch(range(8), face_capacity=cap), [32, 64])


def test_trainer_eval_only_and_resume(tmp_path):
    cfg = _trainer_config(tmp_path, num_epochs=1, aux_batch_size=6,
                          trg_batch_size=2, trg_accumulation_steps=1)
    cfg = cfg.replace(runtime=dataclasses.replace(cfg.runtime,
                                                  deterministic_gumbel=True))
    trainer = Trainer(cfg, device="cpu")
    sd = trainer._build_model().state_dict()
    ds = SyntheticMeldDataset(cfg, 6, 2, 3, seed=6)
    a = trainer.eval_multimodal_only(sd, ds)
    b = Trainer(cfg, device="cpu").eval_multimodal_only(sd, ds, batch_size=4)
    assert a == b                               # batch size does not matter
    # one epoch, then a run of two that resumes from its epoch checkpoint
    # and takes only the second epoch
    trainer.run_multimodal(*_datasets(cfg))
    assert (trainer.state.swin_step, trainer.state.mm_step) == (2, 4)
    cfg2 = cfg.replace(optim=dataclasses.replace(cfg.optim, num_epochs=2))
    resumed = Trainer(cfg2, device="cpu")
    f1 = resumed.run_multimodal(*_datasets(cfg2), resume=True)
    assert np.isfinite(f1)
    assert [h["epoch"] for h in resumed.history] == [2]
    assert (resumed.state.swin_step, resumed.state.mm_step) == (4, 8)
    assert {"step_1", "step_2"} <= set(os.listdir(tmp_path))


def test_entry_points_default_to_the_card():
    """No CUDA device here: the default device raises, it does not move to
    the CPU."""
    from facialmmt_tpu_torch.serving import EmotionServer

    assert not torch.cuda.is_available()
    cfg = _trainer_config()
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        EmotionServer(cfg, max_batch=2, face_capacity=4)


def test_training_imports_no_jax(tmp_path):
    """One auxiliary and one target step in a fresh interpreter: neither JAX
    nor the JAX package is imported."""
    code = (
        "import sys, dataclasses, torch\n"
        "from facialmmt_tpu_torch.config import FacialMMTConfig\n"
        "from facialmmt_tpu_torch.data.meld import (SyntheticFerDataset,\n"
        "                                           SyntheticMeldDataset)\n"
        "from facialmmt_tpu_torch.train.trainer import Trainer\n"
        "cfg = FacialMMTConfig.tiny()\n"
        "cfg = cfg.replace(optim=dataclasses.replace(cfg.optim,\n"
        "    aux_batch_size=4, trg_batch_size=2, trg_accumulation_steps=1))\n"
        "aux = SyntheticFerDataset(4, 24, seed=1)\n"
        "ds = SyntheticMeldDataset(cfg, 2, 1, 2, seed=2)\n"
        "cfg = cfg.replace(runtime=dataclasses.replace(cfg.runtime,\n"
        "    save_model_path=sys.argv[1]))\n"
        "t = Trainer(cfg, device='cpu')\n"
        "t.run_multimodal(aux, ds, ds, ds)\n"
        "assert (t.state.swin_step, t.state.mm_step) == (1, 1)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'optax', 'facialmmt_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         env=env, cwd="/", capture_output=True, text=True)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("clean")
