"""The port's multi-device runs on the CPU, against the JAX package's mesh.

Two worlds of ranks (2 and 4 processes, gloo, one thread each) are spawned
once for the module; each rank runs tests/torch_dist_worker.py, which
imports torch and the port only, and the cases below assert on what they
wrote.  The JAX oracle is the step on build_mesh(dp, tp) over the
conftest's virtual CPU devices (sharding is layout there, so it is also
the one-device step).  The comparisons:
  * one joint target step (Swin learns from the target loss: face shards,
    the gathered FER distributions, the global BatchNorm statistics, TP
    text tower / fusion towers / crossmodal stacks) at dp=2, tp=2 and
    dp=2 x tp=2 (with every Swin block and text layer checkpointed) against
    JAX: loss at rtol 1e-5, parameters, running
    statistics and AdamW moments leaf by leaf (tests/test_torch_train.py's
    tolerance); ZeRO-1 against the replicated moments at rtol 1e-6, and
    each rank's moment slice against JAX's shard of that moment;
  * the auxiliary step after it, against the port on one process;
  * the dialogue-level step over dialogues with uneven valid counts
    (the loss is the mean over the GLOBAL valid utterances);
  * run_unimodal and DialogueTrainer at dp=2 against one process;
  * a run_multimodal resume file written at dp=2 (ZeRO-1 on), resumed
    at dp=1, and files written at dp=1 and dp=2 resumed at dp=2;
  * the mesh EmotionServer at dp=2 x tp=2 against one rank (JAX's
    tolerances, tests/test_appendix.py) and its divisibility assertion;
  * the serving front (AsyncBatchServer, its router, ServingApp and
    benchmark_load) over mesh servers at dp=2 and dp=2 x tp=2, every rank
    constructing it and rank 0 submitting: the answers against JAX's front
    over JAX's mesh server and the one-process port, the same packs on
    every rank, the follower's refusals, the keepalive and close();
  * the TP and ZeRO-1 plans at FacialMMTConfig()'s production dims on the
    meta device (the counterpart of tests/test_sharding_audit.py).
"""

import base64
import dataclasses
import os
import shutil
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from facialmmt_tpu import serving as jax_serving
from facialmmt_tpu.config import FacialMMTConfig, RuntimeConfig
from facialmmt_tpu.models.pipeline import FacialMMTPipeline as JaxPipeline
from facialmmt_tpu.parallel.mesh import (build_mesh, opt_state_shardings,
                                         param_shardings, shard_batch)
from facialmmt_tpu.train import steps as jsteps
from facialmmt_tpu.train.optim import MultiTaskState as JaxState
from facialmmt_tpu.train.optim import make_optimizer as jax_make_optimizer
from facialmmt_tpu_torch.checkpoint import from_jax
from facialmmt_tpu_torch.checkpoint.io import CheckpointManager
from facialmmt_tpu_torch.data.meld import (SyntheticFerDataset,
                                           SyntheticMeldDataset)
from facialmmt_tpu_torch.models.dialogue import DialogueMultiModalTransformer
from facialmmt_tpu_torch.models.pipeline import (FacialMMTPipeline,
                                                 init_random_)
from facialmmt_tpu_torch.parallel.mesh import (MeshPlan, TP_RULES,
                                               param_plan, zero1_partition)
from facialmmt_tpu_torch.train import steps as psteps
from facialmmt_tpu_torch.train.optim import MultiTaskState, SingleTaskState
from facialmmt_tpu_torch.train.trainer import DialogueTrainer, Trainer
from tests.test_models import make_multimodal_batch
from tests.test_torch_ops import random_params
from tests.test_torch_train import (OPT, TOTAL_STEPS, _hold_tree, _np_tree,
                                    nodrop_config)
from tests.torch_bridge import port_config
from tests.torch_dist_worker import synthetic_datasets

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYOUTS = [(2, 1), (1, 2), (2, 2)]
SCENARIO = {(2, 1): ("dp2", 2), (1, 2): ("tp2", 2), (2, 2): ("dp2tp2", 4)}
SCENARIOS = {2: ["dp2", "dp2_replicated", "tp2", "dialogue_dp2",
                 "trainers_dp2", "resume_dp2", "resume_at_dp2", "front_dp2"],
             4: ["dp2tp2", "server_dp2tp2", "front_dp2tp2", "shrink_dp"]}
FRONT = {2: "front_dp2", 4: "front_dp2tp2"}
# the fronts' config: answers that do not depend on the pack they rode in
FRONT_CFG = FacialMMTConfig.tiny().replace(
    runtime=RuntimeConfig(deterministic_gumbel=True))
WORLD_TIMEOUT = 240


def _asdict(cfg):
    return dataclasses.asdict(cfg)


def _step_config():
    """tests/test_torch_train.py's no-dropout tiny config with one layer
    in each stack: every TP rule still fires, and JAX's mesh step compiles
    in about half the time."""
    cfg = nodrop_config()
    rep = dataclasses.replace
    return cfg.replace(
        text=rep(cfg.text, num_layers=1), audio_utt_transformer_num=1,
        crossmodal_ta=rep(cfg.crossmodal_ta, layers=1),
        crossmodal_ta_v=rep(cfg.crossmodal_ta_v, layers=1))


def _spawn(world, case_dir):
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    return [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "torch_dist_worker.py"),
         str(r), str(world), case_dir], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(world)]


def _collect(procs, world, case_dir):
    deadline = time.time() + WORLD_TIMEOUT
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=max(deadline - time.time(), 1))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(out.decode(errors="replace"))
    if any(p.returncode for p in procs):
        raise AssertionError("\n".join(f"rank {r} rc {p.returncode}:\n"
                                       f"{log[-3000:]}" for r, (p, log)
                                       in enumerate(zip(procs, logs))))
    return [torch.load(os.path.join(case_dir, f"out_{world}_{r}.pt"),
                       weights_only=False) for r in range(world)]


def _meld_files(root):
    """MELD fixture files for the trainers and the dialogue text caches."""
    from facialmmt_tpu_torch.data.text_prep import MeldTextPreprocessor
    from tests.fixtures import WhitespaceTokenizer, write_meld_fixture

    prep = MeldTextPreprocessor(WhitespaceTokenizer(), True, 64)
    for seed, split in enumerate(("train", "val", "test")):
        write_meld_fixture(root, split=split, num_dia=4, utts_per_dia=4,
                           seed=seed)
        feats = prep.preprocess_split(
            os.path.join(root, f"{split}_sent_emo.csv"),
            os.path.join(root, f"{split}_text.json"))
        ids, mask, sep = MeldTextPreprocessor.to_arrays(feats)
        np.savez(os.path.join(root, f"text_{split}.npz"), ids=ids, mask=mask,
                 sep=sep)


def _trainer_cfgs(root, save, dp):
    from facialmmt_tpu_torch.config import (OptimConfig, ParallelConfig,
                                            RuntimeConfig)
    from facialmmt_tpu_torch.data.meld import MeldVisionDataset

    base = port_config(FacialMMTConfig.tiny())
    rt = RuntimeConfig(compute_dtype="float32", metrics_path="",
                       trg_log_interval=1000)
    ds = MeldVisionDataset(root, "train")
    uni = base.replace(
        parallel=ParallelConfig(dp=dp), data=dataclasses.replace(
            base.data, vision_utt_max_len=ds.max_utt_len,
            vision_feat_dim=ds.feat_dim),
        optim=OptimConfig(num_epochs=1, trg_batch_size=8,
                          trg_accumulation_steps=1, trg_lr=1e-3,
                          warm_up=0.0),
        runtime=dataclasses.replace(rt, save_model_path=save + "/uni"))
    dia = base.replace(
        parallel=ParallelConfig(dp=dp),
        data=dataclasses.replace(base.data, max_seq_length=64),
        optim=OptimConfig(num_epochs=1, trg_batch_size=4, trg_lr=1e-3,
                          warm_up=0.0),
        runtime=dataclasses.replace(rt, save_model_path=save + "/dia"))
    return uni, dia


def _shrink_cfg(root):
    uni, _ = _trainer_cfgs(root, root + "/shrink", -1)
    return uni.replace(optim=dataclasses.replace(uni.optim,
                                                 trg_batch_size=2))


def _resume_cfg(save, dp, epochs):
    from facialmmt_tpu_torch.config import ParallelConfig

    cfg = port_config(FacialMMTConfig.tiny())
    return cfg.replace(
        parallel=ParallelConfig(dp=dp),
        optim=dataclasses.replace(cfg.optim, num_epochs=epochs,
                                  aux_batch_size=6, trg_batch_size=4,
                                  trg_accumulation_steps=1),
        runtime=dataclasses.replace(cfg.runtime, save_model_path=save))


def _dialogue_case(rng, cfg):
    d = cfg.data
    b, n = 4, 3
    sep = np.zeros((b, d.max_seq_length), np.int32)
    sep[:, [9, 21, 33]] = 1
    dia_mask = np.array([[1, 1, 1], [1, 0, 0], [1, 1, 0], [1, 0, 0]],
                        np.int32)          # rank 0: 4 valid, rank 1: 3
    batch = {
        "dia_input_ids": rng.integers(2, cfg.text.vocab_size,
                                      (b, d.max_seq_length)).astype(np.int32),
        "dia_input_mask": np.ones((b, d.max_seq_length), np.int32),
        "dia_sep_mask": sep,
        "audio_inputs": rng.normal(size=(b, n, d.audio_utt_max_len,
                                         d.audio_feat_dim)).astype(np.float32),
        "audio_mask": np.ones((b, n, d.audio_utt_max_len), np.int32),
        "vision_inputs": rng.normal(size=(b, n, d.vision_utt_max_len,
                                          d.vision_feat_dim)).astype(
                                              np.float32),
        "vision_mask": np.ones((b, n, d.vision_utt_max_len), np.int32),
        "dia_mask": dia_mask,
        "labels": rng.integers(0, 7, (b, n)).astype(np.int32)}
    model = DialogueMultiModalTransformer(cfg)
    init_random_(model, torch.Generator().manual_seed(3))
    return batch, {k: v.numpy() for k, v in model.state_dict().items()}


def _requests(rng, cfg):
    d = cfg.data
    return [{"audio": rng.normal(size=(5, d.audio_feat_dim)),
             "vision": rng.normal(size=(3, d.vision_feat_dim)),
             "faces": rng.integers(0, 255, (3, 160, 160, 3), dtype=np.uint8),
             "input_ids": rng.integers(2, cfg.text.vocab_size, size=(20,)),
             "sep_mask": np.eye(20)[7]},
            {"audio": rng.normal(size=(4, d.audio_feat_dim))},
            {"faces": rng.integers(0, 255, (2, 160, 160, 3),
                                   dtype=np.uint8)}]


def _front_requests(rng, cfg):
    """Requests of 0-3 faces, 3-12 audio and 2-6 vision frames, 10-40
    tokens; a light one (audio only) and a heavy one (6 faces)."""
    d = cfg.data

    def full(faces):
        n = int(rng.integers(10, 41))
        return {"audio": rng.normal(size=(int(rng.integers(3, 13)),
                                          d.audio_feat_dim)),
                "vision": rng.normal(size=(int(rng.integers(2, 7)),
                                           d.vision_feat_dim)),
                "faces": rng.integers(0, 255, (faces, 160, 160, 3),
                                      dtype=np.uint8),
                "input_ids": rng.integers(2, cfg.text.vocab_size, size=(n,)),
                "sep_mask": np.eye(n)[int(rng.integers(0, n))],
                "utt_in_dia_idx": 0}

    reqs = [full(int(rng.integers(0, 4))) for _ in range(8)]
    light = {"audio": rng.normal(size=(5, d.audio_feat_dim))}
    heavy = full(6)
    return reqs, light, heavy


def _payload(req):
    """serve_http's JSON body of a request."""
    faces = req["faces"]
    return {"audio": req["audio"].tolist(), "vision": req["vision"].tolist(),
            "faces": base64.b64encode(faces.tobytes()).decode(),
            "faces_shape": list(faces.shape),
            "input_ids": req["input_ids"].tolist(),
            "sep_mask": req["sep_mask"].tolist(), "utt_in_dia_idx": 0}


def _jax_front(variables, requests):
    """JAX's AsyncBatchServer over JAX's EmotionServer on a 2 x 2 mesh
    (fp32, the (4, 8) bucket): every request submitted at once."""
    server = jax_serving.EmotionServer(
        FRONT_CFG, variables, max_batch=4, face_capacity=8,
        dtype=jax.numpy.float32, transfer_dtype=np.float32,
        mesh_plan=build_mesh(dp=2, tp=2, devices=jax.devices()[:4]))
    front = jax_serving.AsyncBatchServer(server, batch_deadline_ms=50.0)
    try:
        futures = [front.submit(r) for r in requests]
        return np.stack([f.result(timeout=120) for f in futures])
    finally:
        front.close()


def _jax_mesh_step(jmodel, jstate, batch, swin_tx, mm_tx, dp, tp):
    plan = build_mesh(dp=dp, tp=tp, devices=jax.devices()[:dp * tp])
    rep = jax.sharding.NamedSharding(plan.mesh, jax.sharding.PartitionSpec())
    placed = JaxState(
        params=jax.device_put(jstate.params,
                              param_shardings(plan, jstate.params)),
        batch_stats=jax.device_put(jstate.batch_stats, jax.tree.map(
            lambda _: rep, jstate.batch_stats)),
        swin_opt_state=jax.device_put(jstate.swin_opt_state, opt_state_shardings(
            plan, jstate.swin_opt_state, min_size=64)),
        mm_opt_state=jax.device_put(jstate.mm_opt_state, opt_state_shardings(
            plan, jstate.mm_opt_state, min_size=64)),
        swin_step=jax.device_put(jstate.swin_step, rep),
        mm_step=jax.device_put(jstate.mm_step, rep))
    step = jax.jit(jsteps.make_multimodal_train_step(
        jmodel, swin_tx, mm_tx, swin_from_target=True))
    return step(placed, shard_batch(plan, batch), jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """Writes the case, starts both worlds, computes the references while
    they run, and returns (references, outputs by world)."""
    rng = np.random.default_rng(21)
    root = str(tmp_path_factory.mktemp("parallel"))
    jcfg = _step_config()
    batch = {k: np.asarray(v) for k, v in
             make_multimodal_batch(rng, jcfg, b=4).items()}
    # faces in an order unrelated to the utterances: a rank's faces belong
    # to the other rank's utterances too
    perm = rng.permutation(batch["faces"].shape[0])
    for k in ("faces", "face_utt_id", "face_pos"):
        batch[k] = batch[k][perm]
    jmodel = JaxPipeline(jcfg)
    variables = random_params(jmodel, rng, batch)
    sd = from_jax.pipeline_state_dict(_np_tree(variables))
    images = batch["faces"][:8].copy()
    image_labels = rng.integers(0, 7, size=8).astype(np.int32)
    pcfg = port_config(jcfg)
    dia_batch, dia_sd = _dialogue_case(rng, pcfg)
    _meld_files(root)
    uni, dia = _trainer_cfgs(root, root + "/dp2", 2)
    server_cfg = port_config(FacialMMTConfig.tiny())
    server_vars = random_params(JaxPipeline(FacialMMTConfig.tiny()), rng,
                                batch)
    server_sd = from_jax.pipeline_state_dict(_np_tree(server_vars))
    requests = _requests(rng, server_cfg)
    front_reqs, light, heavy = _front_requests(rng, server_cfg)
    torch.save({
        "scenarios": SCENARIOS, "nodrop_cfg": _asdict(pcfg),
        "opt": _asdict(port_config(OPT)), "state_dict": sd, "batch": batch,
        "images": images, "image_labels": image_labels,
        "dialogue_cfg": _asdict(pcfg), "dialogue_sd": dia_sd,
        "dialogue_batch": dia_batch, "meld_root": root,
        "unimodal_cfg": _asdict(uni), "dia_trainer_cfg": _asdict(dia),
        "resume_cfg": _asdict(_resume_cfg(root + "/resume_dp2", 2, 2)),
        "resume_dp1_cfg": _asdict(_resume_cfg(root + "/resume_w_dp1", 1, 2)),
        "shrink_cfg": _asdict(_shrink_cfg(root)),
        "server_cfg": _asdict(server_cfg), "server_sd": server_sd,
        "requests": requests, "front_cfg": _asdict(port_config(FRONT_CFG)),
        "front_requests": front_reqs, "front_light": light,
        "front_heavy": heavy,
        "front_payloads": [_payload(r) for r in front_reqs[:3]]},
        os.path.join(root, "case.pt"))
    procs = {w: _spawn(w, root) for w in SCENARIOS}
    ref = {"front_jax": _jax_front(server_vars, front_reqs)}

    # the references, while the ranks run (JAX's mesh steps when a case
    # first asks for one: jax_step)
    swin_tx = jax_make_optimizer(OPT, OPT.aux_lr, TOTAL_STEPS)
    mm_tx = jax_make_optimizer(OPT, OPT.trg_lr, TOTAL_STEPS, OPT.weight_decay)
    jstate = JaxState.create(variables["params"], variables["batch_stats"],
                             swin_tx, mm_tx)
    ref.update({"variables": variables, "jax": {},
                "jax_args": (jmodel, jstate, batch, swin_tx, mm_tx)})
    # the port on one process: joint step then auxiliary step
    model = FacialMMTPipeline(pcfg)
    model.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})
    state = MultiTaskState.create(model, port_config(OPT), 100, 100)
    psteps.make_multimodal_train_step(model, swin_from_target=True,
                                      compute_dtype="float32")(
        state, {k: torch.tensor(v) for k, v in batch.items()})
    ref["aux_loss"] = float(psteps.make_aux_train_step(
        model, compute_dtype="float32")(state, torch.tensor(images),
                                        torch.tensor(image_labels)))
    ref["after_aux"] = {k: v.numpy().copy()
                        for k, v in model.state_dict().items()}
    dmodel = DialogueMultiModalTransformer(pcfg)
    dmodel.load_state_dict({k: torch.tensor(v) for k, v in dia_sd.items()})
    dstate = SingleTaskState.create(dmodel, pcfg.optim, 10)
    ref["dia_loss"] = float(psteps.make_dialogue_train_step(
        dmodel, compute_dtype="float32")(
            dstate, {k: torch.tensor(v) for k, v in dia_batch.items()}))
    ref["dia_state"] = {k: v.numpy().copy()
                        for k, v in dmodel.state_dict().items()}
    ref["trainers"] = _one_rank_trainers(root)
    outs = {w: _collect(p, w, root) for w, p in procs.items()}
    ref["resume"] = _one_rank_resume(root)
    ref["meld_root"] = root
    return ref, outs


def _one_rank_trainers(root):
    from facialmmt_tpu_torch.data.meld import (MeldDialogueDataset,
                                               MeldMultimodalDataset,
                                               MeldTextArrays,
                                               MeldVisionDataset)

    uni, dia = _trainer_cfgs(root, root + "/one", 1)
    out = {"uni_f1": Trainer(uni, device="cpu").run_unimodal(
        *(MeldVisionDataset(root, s) for s in ("train", "val", "test")))}
    out["uni_best"] = CheckpointManager(
        uni.runtime.save_model_path).restore_best()[1]

    def ds(split):
        text = np.load(os.path.join(root, f"text_{split}.npz"))
        return MeldDialogueDataset(MeldMultimodalDataset(
            root, split, MeldTextArrays(text["ids"], text["mask"],
                                        text["sep"])))

    out["dia_f1"] = DialogueTrainer(dia, device="cpu").run_dialogue(
        ds("train"), ds("val"), ds("test"))
    out["dia_best"] = CheckpointManager(
        dia.runtime.save_model_path).restore_best()[1]
    return out


def _one_rank_resume(root):
    """Epoch 2 at dp=1 from the resume file of the dp=2 run's epoch 1, and
    two epochs uninterrupted at dp=1."""
    resumed = root + "/resume_dp1"
    shutil.copytree(root + "/resume_dp2", resumed)
    out = {}
    for name, path, resume in (("resumed", resumed, True),
                               ("straight", root + "/straight_dp1", False)):
        cfg = _resume_cfg(path, 1, 2)
        t = Trainer(cfg, device="cpu")
        t.run_multimodal(*synthetic_datasets(cfg, SyntheticFerDataset,
                                             SyntheticMeldDataset),
                         resume=resume)
        m = CheckpointManager(path)
        out[name] = {"step_1": m.restore("step_1") if not resume else None,
                     "step_2": m.restore("step_2")}
    out["dp2_step_1"] = CheckpointManager(root + "/resume_dp2").restore(
        "step_1")
    return out


def jax_step(ref, dp, tp):
    """(loss, new state) of JAX's joint step on build_mesh(dp, tp)."""
    if (dp, tp) not in ref["jax"]:
        new, loss = _jax_mesh_step(*ref["jax_args"], dp, tp)
        ref["jax"][dp, tp] = (float(loss), new)
    return ref["jax"][dp, tp]


def _hold_sd(got, want, what, variables):
    _hold_tree(from_jax.to_jax_tree(got, like=variables),
               from_jax.to_jax_tree(want, like=variables), what)


# ----------------------------------------------------------- mesh steps --

@pytest.mark.parametrize("dp,tp", LAYOUTS)
def test_joint_step_matches_jax_mesh(case, dp, tp):
    ref, outs = case
    name, world = SCENARIO[dp, tp]
    got = outs[world][0][name]
    want_loss, new = jax_step(ref, dp, tp)
    np.testing.assert_allclose(got["loss"], want_loss, rtol=1e-5)
    want = _np_tree({"params": new.params, "batch_stats": new.batch_stats})
    _hold_tree(from_jax.to_jax_tree(got["state"], like=want), want,
               f"params and statistics at dp={dp} tp={tp}")
    # every rank holds the same whole state
    for r in range(1, world):
        for k, v in outs[world][r][name]["state"].items():
            np.testing.assert_array_equal(v, got["state"][k], err_msg=k)
    if tp > 1:     # the TP rules split the text tower, towers and stacks
        split = got["tp_split"]
        for part in ("roberta.encoder", "utt_transformer",
                     "CrossModalTrans_TA."):
            assert any(part in n for n in split), part


def _adam(opt_state):
    """optax's AdamW state inside a chain state (the arrays as placed)."""
    return next(s for s in jax.tree.leaves(
        opt_state, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu"))


@pytest.mark.parametrize("dp,tp", LAYOUTS)
def test_moments_match_jax_mesh(case, dp, tp):
    ref, outs = case
    name, world = SCENARIO[dp, tp]
    got = outs[world][0][name]
    _, new = jax_step(ref, dp, tp)
    for branch, sub, opt_state in (("mm", "multimodal", new.mm_opt_state),
                                   ("swin", "swin_model",
                                    new.swin_opt_state)):
        adam = _adam(opt_state)
        for which, want in ((0, adam.mu), (1, adam.nu)):
            named = {f"{sub}.{k}": v[which]
                     for k, v in got[branch + "_moments"].items()}
            tree = from_jax.to_jax_tree(named, like=ref["variables"])
            _hold_tree(tree["params"][sub], _np_tree(want),
                       f"{branch} moment {which} at dp={dp} tp={tp}")


def test_zero1_equals_replicated_and_slices_are_jax_shards(case):
    ref, outs = case
    for r in range(2):
        z, rep = outs[2][r]["dp2"], outs[2][r]["dp2_replicated"]
        np.testing.assert_allclose(z["loss"], rep["loss"], rtol=1e-6)
        for k, v in rep["state"].items():
            np.testing.assert_allclose(z["state"][k], v, rtol=1e-6,
                                       atol=1e-7, err_msg=k)
        for branch in ("mm_moments", "swin_moments"):
            for k, (m, v) in rep[branch].items():
                np.testing.assert_allclose(z[branch][k][0], m, rtol=1e-6,
                                           atol=1e-7, err_msg=k)
                np.testing.assert_allclose(z[branch][k][1], v, rtol=1e-6,
                                           atol=1e-7, err_msg=k)
        assert not rep["slices"]
    # each rank's moment slice is its device's shard of JAX's moment
    _, new = jax_step(ref, 2, 1)
    mu = _adam(new.mm_opt_state).mu
    rules = {name: (path, layout) for path, name, layout in
             from_jax._pipeline_rules(ref["variables"], "roberta-large")}
    checked = 0
    for r in range(2):
        for name, (axis, local) in outs[2][r]["dp2"]["slices"].items():
            path, layout = rules["multimodal." + name]
            leaf = mu
            for key in path[2:]:
                leaf = leaf[key]
            shard = next(s for s in leaf.addressable_shards
                         if s.device == jax.devices()[r])
            np.testing.assert_allclose(
                from_jax._TO_TORCH[layout](np.asarray(shard.data)), local,
                rtol=1e-4, atol=1e-7, err_msg=name)
            checked += 1
    assert checked > 10


def test_aux_step_after_matches_one_process(case):
    ref, outs = case
    for r in range(2):
        got = outs[2][r]["dp2"]
        np.testing.assert_allclose(got["aux_loss"], ref["aux_loss"],
                                   rtol=1e-5)
        _hold_sd(got["after_aux"], ref["after_aux"], "after aux",
                 ref["variables"])


def test_dialogue_loss_is_the_global_masked_mean(case):
    ref, outs = case
    for r in range(2):
        got = outs[2][r]["dialogue_dp2"]
        np.testing.assert_allclose(got["loss"], ref["dia_loss"], rtol=1e-5)
        for k, v in ref["dia_state"].items():
            np.testing.assert_allclose(got["state"][k], v, rtol=1e-4,
                                       atol=2e-6, err_msg=k)


@pytest.mark.parametrize("kind", ["uni", "dia"])
def test_trainers_at_dp2_match_one_process(case, kind):
    ref, outs = case
    for r in range(2):
        got = outs[2][r]["trainers_dp2"]
        assert got[kind + "_plan"] == (2, 1)
        assert got[kind + "_f1"] == ref["trainers"][kind + "_f1"]
        for k, v in ref["trainers"][kind + "_best"].items():
            np.testing.assert_allclose(got[kind + "_best"][k], v.numpy(),
                                       rtol=1e-4, atol=2e-6, err_msg=k)


def test_sigterm_on_one_rank_stops_every_rank(case):
    """A preemption request on rank 1 alone: both ranks agree at the step
    boundary, the resume file is written (by rank 0) and both raise
    Preempted in the first epoch."""
    _, outs = case
    for r in range(2):
        got = outs[2][r]["trainers_dp2"]
        assert got["preempted"] == (1, "step_0"), got["preempted"]
        assert got["preempt_files"] == ["step_0"]


def test_dp_minus_one_shrinks_and_idle_ranks_leave(case):
    """dp = -1 over 4 ranks with an effective batch of 2 builds a 2 x 1
    mesh (JAX's shrink rule); ranks 2 and 3 leave the run."""
    _, outs = case
    for r in range(4):
        got = outs[4][r]["shrink_dp"]
        assert got["plan"] == (2, 1, r < 2)
        assert (got["f1"] is None) == (r >= 2)
    assert outs[4][0]["shrink_dp"]["f1"] == outs[4][1]["shrink_dp"]["f1"]


def test_torchrun_trains_v_only_at_dp2(case, tmp_path):
    """`torchrun --nproc_per_node 2 -m facialmmt_tpu_torch.main --dp 2`:
    V-only training from the fixtures on two CPU ranks; rank 0 alone
    prints and writes the files."""
    ref, _ = case
    root = ref["meld_root"]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    env.pop("WORLD_SIZE", None)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "facialmmt_tpu_torch.main",
         "--device", "cpu", "--choice_modality", "V", "--doEval", "0",
         "--data_load_path", root, "--save_Model_path",
         str(tmp_path / "saved"), "--metrics_path", "",
         "--hidden_size", "64", "--num_attention_heads", "4",
         "--intermediate_size", "128", "--vision_utt_Transformernum", "1",
         "--trg_batch_size", "4", "--trg_accumulation_steps", "1",
         "--trg_lr", "1e-3", "--warm_up", "0", "--dp", "2"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert proc.stdout.count("**TEST** | wg_av_f1") == 1   # rank 0 alone
    saved = os.listdir(tmp_path / "saved")
    assert "step_1" in saved and any(s.startswith("best_") for s in saved)


def test_resume_file_from_dp2_restores_at_dp1(case):
    """The dp=2 file is the single-device layout (same keys, shapes and
    generator state as a one-process run's) and a one-process run resumes
    from it to where an uninterrupted one-process run gets."""
    ref, outs = case
    res = ref["resume"]
    dp2, one = res["dp2_step_1"], res["straight"]["step_1"]
    assert dp2.keys() == one.keys()
    assert torch.equal(dp2["generator"], one["generator"])
    # every rank's generator is at the same state
    assert np.array_equal(outs[2][0]["resume_dp2"]["generator"],
                          outs[2][1]["resume_dp2"]["generator"])
    for k, v in one["model"].items():
        assert dp2["model"][k].shape == v.shape, k
        torch.testing.assert_close(dp2["model"][k], v, rtol=1e-4, atol=2e-6)
    for opt in ("swin_opt", "mm_opt"):
        a = dp2["optim"][opt]["adamw"]["state"]
        b = one["optim"][opt]["adamw"]["state"]
        assert a.keys() == b.keys()
        for i in b:
            for m in ("exp_avg", "exp_avg_sq"):
                torch.testing.assert_close(a[i][m], b[i][m], rtol=1e-3,
                                           atol=1e-9)
    got, want = res["resumed"]["step_2"], res["straight"]["step_2"]
    for k, v in want["model"].items():
        torch.testing.assert_close(got["model"][k], v, rtol=1e-4, atol=2e-6)


@pytest.mark.parametrize("written", ["resume_w_dp1", "resume_dp2"])
def test_resume_at_dp2_matches_uninterrupted_run(case, written):
    """A dp=2 run with ZeRO-1 on resumes from the epoch-1 file of a dp=1
    run and of a dp=2 run to where an uninterrupted one-process run gets:
    each rank's moment slices and the parameters they update are the
    resumed ones."""
    ref, _ = case
    got = CheckpointManager(os.path.join(
        ref["meld_root"], written + "_at_dp2")).restore("step_2")
    want = ref["resume"]["straight"]["step_2"]
    assert torch.equal(got["generator"], want["generator"])
    for k, v in want["model"].items():
        torch.testing.assert_close(got["model"][k], v, rtol=1e-4, atol=2e-6)
    for opt in ("swin_opt", "mm_opt"):
        a = got["optim"][opt]["adamw"]["state"]
        b = want["optim"][opt]["adamw"]["state"]
        assert a.keys() == b.keys()
        for i in b:
            for m in ("exp_avg", "exp_avg_sq"):
                torch.testing.assert_close(a[i][m], b[i][m], rtol=1e-3,
                                           atol=1e-9)


def test_ranks_load_no_jax(case):
    """The rank processes ran on torch and the port alone."""
    _, outs = case
    for world, ranks in outs.items():
        for r, out in enumerate(ranks):
            assert out["jax_modules"] == [], (world, r, out["jax_modules"])


# -------------------------------------------------------------- serving --

@pytest.mark.parametrize("dtype,rtol,atol", [("fp32", 5e-4, 1e-5),
                                             ("bf16", 1e-2, 1e-3)])
def test_mesh_server_matches_one_rank(case, dtype, rtol, atol):
    _, outs = case
    one = outs[4][0]["server_dp2tp2"][dtype + "_one"]
    assert one.shape == (3, 7)
    for r in range(4):
        got = outs[4][r]["server_dp2tp2"][dtype]
        np.testing.assert_allclose(got, one, rtol=rtol, atol=atol)


def test_mesh_server_needs_dp_dividing_its_shapes(case):
    _, outs = case
    assert all(outs[4][r]["server_dp2tp2"]["indivisible_raises"]
               for r in range(4))


@pytest.mark.parametrize("shape", [(24, 5), (24,)], ids=["weight", "bias"])
def test_packed_in_proj_split_takes_rows_of_each_block(monkeypatch, shape):
    """The crossmodal in_proj (3E, E) and its bias: rank r holds rows
    [r E/tp, (r+1) E/tp) of EACH of the q, k and v blocks (a contiguous
    third of the rows would be q and part of k), and the parts gathered in
    rank order give the whole tensor back."""
    from facialmmt_tpu_torch.parallel import mesh

    tp, e = 2, shape[0] // 3
    full = torch.arange(np.prod(shape), dtype=torch.float32).reshape(shape)
    blocks = full.chunk(3)
    parts = [mesh.shard_tensor(full, mesh.PACKED, tp, r) for r in range(tp)]
    for r, part in enumerate(parts):
        want = torch.cat([b[r * e // tp:(r + 1) * e // tp] for b in blocks])
        assert torch.equal(part, want)
    assert not torch.equal(parts[0], full[:3 * e // tp])
    monkeypatch.setattr(mesh.dist, "get_world_size", lambda group: tp)
    monkeypatch.setattr(mesh, "all_gather_cat",
                        lambda t, group, dim: torch.cat(parts, dim))
    assert torch.equal(mesh.unshard_tensor(parts[0], mesh.PACKED, None), full)


# ------------------------------------------------ the front over a mesh --

def _front(outs, world, rank=0):
    return outs[world][rank][FRONT[world]]


@pytest.mark.parametrize("world", [2, 4])
def test_mesh_front_matches_jax_mesh_front(case, world):
    """(i) fp32 answers of requests submitted at once on rank 0 against
    JAX's AsyncBatchServer over JAX's EmotionServer on a 2 x 2 mesh; (vii)
    ServingApp(front).predict on rank 0 gives the same answers."""
    ref, outs = case
    got = _front(outs, world)
    assert got["fp32"].shape == (8, 7)
    np.testing.assert_allclose(got["fp32"], ref["front_jax"], rtol=5e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got["app"], got["fp32"][:3], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("world", [2, 4])
def test_mesh_front_bf16_matches_one_process(case, world):
    _, outs = case
    got = _front(outs, world)
    np.testing.assert_allclose(got["bf16"], got["bf16_one"], rtol=1e-2,
                               atol=1e-3)


@pytest.mark.parametrize("world", [2, 4])
def test_mesh_router_runs_the_same_packs_on_every_rank(case, world):
    """(ii) A two-bucket router: a light request on the small bucket, a
    6-face one on the large; every rank ran the same packs on the same
    buckets, and the answers are the one-process router's."""
    _, outs = case
    main = _front(outs, world)
    lists = main["router_lists"]
    assert lists["buckets"][:2] == [(2, 4), (4, 8)]
    assert sum(lists["packs"]) == 10 and lists["broadcasts"] == len(
        lists["packs"])
    for r in range(1, world):
        theirs = _front(outs, world, r)["router_lists"]
        assert (theirs["packs"], theirs["buckets"]) == (lists["packs"],
                                                        lists["buckets"])
    np.testing.assert_allclose(main["router"], main["router_one"],
                               rtol=5e-4, atol=1e-5)


@pytest.mark.parametrize("world", [2, 4])
def test_mesh_front_refusals_and_failures(case, world):
    """(iii) submit on a follower fails its future naming the main rank; a
    direct predict while the front is open raises on every rank and works
    once it is closed; a request too large for the only bucket fails on
    the main alone, which sends it nowhere, and the next one is answered."""
    _, outs = case
    main = _front(outs, world)
    assert "too_large" in main and "FaceCapacityError" in main["too_large"]
    for r in range(world):
        got = _front(outs, world, r)
        assert "AsyncBatchServer over this mesh server is open" in got["direct"]
        np.testing.assert_allclose(got["direct_after"], main["fp32"][0],
                                   rtol=1e-5, atol=1e-6)
        if r:
            assert "main rank 0" in got["submit"]
            # the follower ran the main's packs less the one that failed
            assert got["small"]["packs"] == main["small"]["packs"][1:]
            assert got["small"]["buckets"] == main["small"]["buckets"]
    assert main["small"]["packs"] == [1, 1]
    np.testing.assert_allclose(main["after_too_large"], main["fp32"][1],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("world", [2, 4])
def test_mesh_front_keepalive_and_close(case, world):
    """(iv) With KEEPALIVE_S at 0.2 s, a 1 s idle gap sends IDLE headers
    that every follower receives, and the next request is answered; (v)
    close() on the main ends every follower's thread (the ranks exit 0:
    the world finished)."""
    _, outs = case
    main = _front(outs, world)
    np.testing.assert_allclose(main["after_idle"], main["fp32"][0],
                               rtol=1e-5, atol=1e-6)
    sent = main["single"]["keepalives"]
    assert sent >= 3
    for r in range(world):
        got = _front(outs, world, r)
        assert got["single"]["keepalives"] == sent
        for key in ("single", "small", "router_lists"):
            assert not got[key]["alive"]
        assert (got["single"]["packs"], got["single"]["buckets"]) == (
            main["single"]["packs"], main["single"]["buckets"])


@pytest.mark.parametrize("world", [2, 4])
def test_mesh_benchmark_load_same_on_every_rank(case, world):
    """(vi) Every rank calls benchmark_load; each returns the main's
    stats."""
    _, outs = case
    stats = _front(outs, world)["load"]
    assert stats["n_requests"] >= 1 and stats["bucket_counts"]
    for r in range(1, world):
        assert _front(outs, world, r)["load"] == stats


@pytest.mark.parametrize("world", [2, 4])
def test_mesh_front_generators_agree(case, world):
    """(viii) Under the random gumbel every rank's generator has advanced
    by the same packs to the same state."""
    _, outs = case
    before, after = _front(outs, world)["generator"]
    assert not np.array_equal(before, after)
    for r in range(1, world):
        b, a = _front(outs, world, r)["generator"]
        assert np.array_equal(b, before) and np.array_equal(a, after)
        assert _front(outs, world, r)["rnd_packs"] == _front(
            outs, world)["rnd_packs"]


# ------------------------------------------------- production-dims audit --

@pytest.fixture(scope="module")
def production_model():
    cfg = port_config(FacialMMTConfig())
    with torch.device("meta"):
        model = FacialMMTPipeline(cfg)
    return cfg, model


@pytest.mark.parametrize("dp,tp", [(1, 8), (2, 4), (4, 2), (8, 1)])
def test_plans_divide_production_dims(production_model, dp, tp):
    cfg, model = production_model
    plan = MeshPlan.abstract(dp, tp)
    specs = param_plan(plan, model)
    params = dict(model.named_parameters())
    for name, spec in specs.items():
        size = params[name].shape[spec.dim]
        assert size % (3 * tp if spec.packed else tp) == 0, name
    text = [n for n in specs if ".roberta.encoder." in n]
    if tp > 1:
        # every text layer splits its six ruled leaves' weights
        assert len(text) >= 6 * cfg.text.num_layers
        # 12-head towers and stacks split where tp divides 12
        fusion = [n for n in specs if "roberta" not in n]
        assert bool(fusion) == (12 % tp == 0)
    else:
        assert not specs
    ruled = [n for n in params if any(
        __import__("re").match(p, n) for p, _ in TP_RULES)]
    assert set(specs) <= set(ruled)
    for branch in (model.swin_model, model.multimodal):
        leaves = list(branch.parameters())
        axes = zero1_partition(plan, leaves)
        assert any(ax is not None for ax in axes) == (dp > 1)
        for p, ax in zip(leaves, axes):
            if ax is not None:
                assert p.shape[ax] % dp == 0 and p.numel() >= 65536
