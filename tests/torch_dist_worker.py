"""One rank of the port's multi-process tests (tests/test_torch_parallel.py).

    python tests/torch_dist_worker.py RANK WORLD CASE_DIR

joins a gloo process group through a file under CASE_DIR, reads
CASE_DIR/case.pt (weights, batches and configs the test wrote), runs the
scenarios listed there for its world size and writes what it saw to
CASE_DIR/out_<WORLD>_<RANK>.pt.  It imports torch and the port only: the
test modules import JAX, which a rank must not load.  The ranks run on the
case's "device" (the CPU unless it says "cuda:0": then every rank shares
the one card, over gloo).
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import sys
import time
import typing
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist

from facialmmt_tpu_torch import config as port_config
from facialmmt_tpu_torch.parallel.mesh import (build_mesh, full_state_dict,
                                               init_distributed, shard_model_)


def config(values: dict, cls=port_config.FacialMMTConfig):
    """A port config from dataclasses.asdict() of one."""
    hints = typing.get_type_hints(cls)
    kw = {}
    for f in dataclasses.fields(cls):
        v = values[f.name]
        if dataclasses.is_dataclass(hints[f.name]):
            v = config(v, hints[f.name])
        elif isinstance(v, list):
            v = tuple(v)
        kw[f.name] = v
    return cls(**kw)


def _np(sd):
    return {k: v.detach().cpu().numpy().copy() for k, v in sd.items()}


def _moments(opt, named):
    """{name: (exp_avg, exp_avg_sq)} of a ClippedAdamW's whole state."""
    state = opt.state_dict()["adamw"]["state"]
    return {name: (state[i]["exp_avg"].numpy().copy(),
                   state[i]["exp_avg_sq"].numpy().copy())
            for i, (name, _) in enumerate(named)}


def joint_step(case, rank, dp, tp, zero1=True, remat=False):
    """One joint target step (Swin learns from it) then one auxiliary step
    of the pipeline on the (dp, tp) mesh; `remat` checkpoints every Swin
    block and text layer (their recompute runs the layers' collectives
    again inside the backward)."""
    from facialmmt_tpu_torch.models.pipeline import FacialMMTPipeline
    from facialmmt_tpu_torch.train.optim import MultiTaskState
    from facialmmt_tpu_torch.train.steps import (make_aux_train_step,
                                                 make_multimodal_train_step)

    cfg = config(case["nodrop_cfg"])
    if remat:
        cfg = cfg.replace(swin=dataclasses.replace(cfg.swin, remat=True),
                          text=dataclasses.replace(cfg.text, remat=True))
    plan = build_mesh(dp, tp, "cpu")
    model = FacialMMTPipeline(cfg)
    model.load_state_dict({k: torch.tensor(v)
                           for k, v in case["state_dict"].items()})
    shard_model_(model, plan)
    opt = config(case["opt"], port_config.OptimConfig)
    state = MultiTaskState.create(model, opt, 100, 100, plan=plan,
                                  zero1=zero1, min_size=64)
    step = make_multimodal_train_step(model, swin_from_target=True,
                                      compute_dtype="float32", plan=plan)
    batch = {k: torch.tensor(v) for k, v in case["batch"].items()}
    out = {"loss": float(step(state, batch))}
    mm_named = [n for n, _ in model.multimodal.named_parameters()]
    out["state"] = _np(full_state_dict(model, plan))
    out["mm_moments"] = _moments(state.mm_opt, [(n, None) for n in mm_named])
    out["swin_moments"] = _moments(
        state.swin_opt, list(model.swin_model.named_parameters()))
    # this rank's ZeRO-1 slices: (axis, exp_avg slice)
    out["slices"] = {
        n: (ax, state.mm_opt.adamw.state[q]["exp_avg"].numpy().copy())
        for n, q, ax in zip(mm_named, state.mm_opt.opt_params,
                            state.mm_opt.zero_axes) if ax is not None}
    aux = make_aux_train_step(model, compute_dtype="float32", plan=plan)
    out["aux_loss"] = float(aux(state, torch.tensor(case["images"]),
                                torch.tensor(case["image_labels"])))
    out["after_aux"] = _np(full_state_dict(model, plan))
    out["tp_split"] = sorted(getattr(model, "_tp_specs", {}))
    return out


def dialogue_step(case, rank, dp, tp):
    """One dialogue-level step at dp ranks over dialogues whose valid
    utterance counts differ."""
    from facialmmt_tpu_torch.models.dialogue import \
        DialogueMultiModalTransformer
    from facialmmt_tpu_torch.train.optim import SingleTaskState
    from facialmmt_tpu_torch.train.steps import make_dialogue_train_step

    cfg = config(case["dialogue_cfg"])
    plan = build_mesh(dp, tp, "cpu")
    model = DialogueMultiModalTransformer(cfg)
    model.load_state_dict({k: torch.tensor(v)
                           for k, v in case["dialogue_sd"].items()})
    shard_model_(model, plan)
    state = SingleTaskState.create(model, cfg.optim, 10, plan=plan)
    step = make_dialogue_train_step(model, compute_dtype="float32",
                                    plan=plan)
    loss = step(state, {k: torch.tensor(v)
                        for k, v in case["dialogue_batch"].items()})
    return {"loss": float(loss), "state": _np(full_state_dict(model, plan))}


def trainers(case, rank):
    """run_unimodal and DialogueTrainer.run_dialogue at dp=2 on the test's
    files; the best files they select."""
    from facialmmt_tpu_torch.checkpoint.io import CheckpointManager
    from facialmmt_tpu_torch.data.meld import (MeldDialogueDataset,
                                               MeldMultimodalDataset,
                                               MeldTextArrays,
                                               MeldVisionDataset)
    from facialmmt_tpu_torch.train.trainer import DialogueTrainer, Trainer

    out = {}
    cfg = config(case["unimodal_cfg"])
    root = case["meld_root"]
    t = Trainer(cfg, device="cpu")
    out["uni_plan"] = (t.plan.dp, t.plan.tp)
    out["uni_f1"] = t.run_unimodal(*(MeldVisionDataset(root, s)
                                     for s in ("train", "val", "test")))
    out["uni_best"] = _np(CheckpointManager(
        cfg.runtime.save_model_path).restore_best()[1])

    def dia(split):
        text = np.load(os.path.join(root, f"text_{split}.npz"))
        return MeldDialogueDataset(MeldMultimodalDataset(
            root, split, MeldTextArrays(text["ids"], text["mask"],
                                        text["sep"])))

    cfg = config(case["dia_trainer_cfg"])
    t = DialogueTrainer(cfg, device="cpu")
    out["dia_plan"] = (t.plan.dp, t.plan.tp)
    out["dia_f1"] = t.run_dialogue(dia("train"), dia("val"), dia("test"))
    out["dia_best"] = _np(CheckpointManager(
        cfg.runtime.save_model_path).restore_best()[1])

    # SIGTERM reaches rank 1 only (after its first step): both ranks agree
    # at that step boundary, rank 0 writes the resume file, both stop
    from facialmmt_tpu_torch.utils.preemption import (Preempted,
                                                      install_preemption_guard)

    guard = install_preemption_guard()

    def sigterm(name, **info):
        if name == "trg_step" and rank == 1:
            guard.trigger()

    cfg = cfg.replace(runtime=dataclasses.replace(
        cfg.runtime, save_model_path=cfg.runtime.save_model_path + "_pre"))
    try:
        DialogueTrainer(cfg, device="cpu").run_dialogue(
            dia("train"), dia("val"), dia("test"), on_event=sigterm)
        out["preempted"] = None
    except Preempted as e:
        out["preempted"] = (e.epoch, os.path.basename(e.path))
    out["preempt_files"] = sorted(os.listdir(cfg.runtime.save_model_path))
    guard.uninstall()
    return out


def shrink(case, rank):
    """dp = -1 over 4 ranks with an effective batch of 2: dp shrinks to 2,
    ranks 2 and 3 leave the run."""
    from facialmmt_tpu_torch.data.meld import MeldVisionDataset
    from facialmmt_tpu_torch.train.trainer import Trainer

    cfg = config(case["shrink_cfg"])
    t = Trainer(cfg, device="cpu")
    f1 = t.run_unimodal(*(MeldVisionDataset(case["meld_root"], s)
                          for s in ("train", "val", "test")))
    return {"plan": (t.plan.dp, t.plan.tp, t.plan.member), "f1": f1}


class _Stop(Exception):
    pass


def _zero1_small_leaves():
    """Trainers from here on split the moments of every leaf of 64
    elements or more over the data ranks (tiny() has no leaf of the
    default 65,536, so ZeRO-1 would split nothing)."""
    from facialmmt_tpu_torch.train.trainer import Trainer

    Trainer._layout = lambda self: dict(
        plan=self.plan, zero1=self.cfg.parallel.zero1, min_size=64)


def resume_file(case, rank):
    """run_multimodal at dp=2, ZeRO-1 on, stopped after its first epoch's
    resume file (at the first step of the second epoch)."""
    from facialmmt_tpu_torch.data.meld import (SyntheticFerDataset,
                                               SyntheticMeldDataset)
    from facialmmt_tpu_torch.train.trainer import Trainer

    def stop(name, epoch=0, **info):
        if name == "aux_step" and epoch == 2:
            raise _Stop

    _zero1_small_leaves()
    cfg = config(case["resume_cfg"])
    t = Trainer(cfg, device="cpu")
    try:
        t.run_multimodal(*synthetic_datasets(cfg, SyntheticFerDataset,
                                             SyntheticMeldDataset),
                         on_event=stop)
    except _Stop:
        pass
    return {"generator": t.generator.get_state().numpy().copy()}


def resume_at_dp2(case, rank):
    """Epoch 2 at dp=2 resumed from epoch 1's resume file of a run at dp=1
    (rank 0 alone: a dp=1 plan leaves rank 1 out of the run) and from that
    of the dp=2 run (resume_file), each copied to '<dir>_at_dp2'; the test
    reads their step_2 files."""
    from facialmmt_tpu_torch.data.meld import (SyntheticFerDataset,
                                               SyntheticMeldDataset)
    from facialmmt_tpu_torch.train.trainer import Trainer

    def stop(name, epoch=0, **info):
        if name == "aux_step" and epoch == 2:
            raise _Stop

    _zero1_small_leaves()
    one, two = config(case["resume_dp1_cfg"]), config(case["resume_cfg"])
    def data():
        return synthetic_datasets(two, SyntheticFerDataset,
                                  SyntheticMeldDataset)

    try:
        Trainer(one, device="cpu").run_multimodal(*data(), on_event=stop)
    except _Stop:
        pass
    for src in (one.runtime.save_model_path, two.runtime.save_model_path):
        dist.barrier()
        if rank == 0:
            shutil.copytree(src, src + "_at_dp2")
        dist.barrier()
        Trainer(two.replace(runtime=dataclasses.replace(
            two.runtime, save_model_path=src + "_at_dp2")),
            device="cpu").run_multimodal(*data(), resume=True)
    return {}


def synthetic_datasets(cfg, fer_cls, meld_cls):
    """The in-memory datasets of the resume scenario (aux, train, val,
    test); the test builds the same ones."""
    return (fer_cls(12, 24, cfg.num_labels, seed=1),
            meld_cls(cfg, 8, 2, 3, seed=2), meld_cls(cfg, 8, 2, 3, seed=3),
            meld_cls(cfg, 8, 2, 3, seed=4))


def server(case, rank, dp, tp):
    """The mesh EmotionServer at fp32 and bf16 (rank 0 also answers
    without a mesh), and its divisibility check."""
    from facialmmt_tpu_torch.serving import EmotionServer

    cfg = config(case["server_cfg"])
    sd = {k: torch.tensor(v) for k, v in case["server_sd"].items()}
    plan = build_mesh(dp, tp, "cpu")
    out = {}
    for name, kw in (("fp32", dict(dtype=torch.float32,
                                   transfer_dtype=np.float32)),
                     ("bf16", {})):
        srv = EmotionServer(cfg, sd, max_batch=4, face_capacity=8,
                            device="cpu", mesh_plan=plan, **kw)
        out[name] = np.stack(srv.predict(case["requests"]))
        if rank == 0:
            one = EmotionServer(cfg, sd, max_batch=4, face_capacity=8,
                                device="cpu", **kw)
            out[name + "_one"] = np.stack(one.predict(case["requests"]))
    try:
        EmotionServer(cfg, sd, max_batch=3, face_capacity=8, device="cpu",
                      mesh_plan=plan)
        out["indivisible_raises"] = False
    except AssertionError:
        out["indivisible_raises"] = True
    return out


def text_tp(case, rank, dp, tp):
    """The text tower at eval on the card under tensor parallelism: the
    heads each rank's attention (kernel 1) sees, its launches, the
    output."""
    from facialmmt_tpu_torch.models import text_encoder
    from facialmmt_tpu_torch.ops import kernels

    dev = torch.device(case["device"])
    cfg = config(case["text_cfg"], port_config.TextEncoderConfig)
    plan = build_mesh(dp, tp, dev)
    holder = torch.nn.Module()
    holder.roberta = text_encoder.TextEncoder(cfg)
    holder.roberta.load_state_dict({k: torch.tensor(v) for k, v in
                                    case["text_sd"].items()})
    holder.to(dev).eval()
    shard_model_(holder, plan)
    heads = []
    real = text_encoder.fused_attention

    def seen(q, k, v, bias):
        heads.append(q.shape[1])
        return real(q, k, v, bias)

    text_encoder.fused_attention = seen
    kernels.reset_launch_counts()
    try:
        with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
            out = holder.roberta(torch.tensor(case["ids"], device=dev),
                                 torch.tensor(case["mask"], device=dev))
    finally:
        text_encoder.fused_attention = real
    return {"out": out.float().cpu().numpy(), "heads": heads,
            "launches": kernels.launch_counts()["fused_attention"]}


FRONT_BUCKETS = ((2, 4), (4, 8))        # (max_batch, face_capacity)


def _burst(front, requests):
    """Every request submitted at once from four threads; the answers."""
    with ThreadPoolExecutor(4) as pool:
        futures = list(pool.map(front.submit, requests))
    return np.stack([f.result(timeout=120) for f in futures])


def _lists(front):
    return {"packs": list(front.pack_sizes),
            "buckets": list(front.bucket_choices),
            "keepalives": front.keepalives, "alive": front._thread.is_alive(),
            "broadcasts": len(front.broadcast_ms)}


def front(case, rank, dp, tp):
    """The serving front over mesh servers of dp x tp ranks: every rank
    constructs each front over the same servers, rank 0 submits.  A burst
    at fp32 and bf16 plus ServingApp, a direct call and an idle gap longer
    than the keepalive; a bucket too small for a request; the router; the
    generator after a burst under the random gumbel; benchmark_load.  Rank
    0 also answers on one process."""
    from facialmmt_tpu_torch import serving
    from facialmmt_tpu_torch.serve_http import ServingApp

    cfg = config(case["front_cfg"])
    sd = {k: torch.tensor(v) for k, v in case["server_sd"].items()}
    reqs, main = case["front_requests"], rank == 0
    plan = build_mesh(dp, tp, "cpu")
    fp32 = dict(dtype=torch.float32, transfer_dtype=np.float32)

    def servers(plan, cfg=cfg, buckets=FRONT_BUCKETS, **kw):
        return [serving.EmotionServer(cfg, sd, max_batch=mb, face_capacity=cap,
                                      device="cpu", mesh_plan=plan, **kw)
                for mb, cap in buckets]

    def refused(call):
        try:
            call()
        except RuntimeError as e:
            return str(e)
        return None

    small, big = servers(plan, **fp32)
    out = {}
    # (i), (iii), (iv), (vii): one bucket
    f = serving.AsyncBatchServer(big, batch_deadline_ms=50.0)
    out["direct"] = refused(lambda: big.predict(reqs[:1]))
    if main:
        out["fp32"] = _burst(f, reqs)
        app = ServingApp(f)
        out["app"] = np.stack([app.predict(p)["probs"]
                               for p in case["front_payloads"]])
        keepalive, serving.KEEPALIVE_S = serving.KEEPALIVE_S, 0.2
        time.sleep(1.0)
        serving.KEEPALIVE_S = keepalive
        out["after_idle"] = f.submit(reqs[0]).result(timeout=60)
    else:
        out["submit"] = repr(f.submit(reqs[0]).exception(timeout=5))
    f.close()
    out["single"] = _lists(f)
    out["direct_after"] = big.predict(reqs[:1])[0]
    # (iii) a request whose faces exceed the only bucket
    f = serving.AsyncBatchServer(small, batch_deadline_ms=20.0)
    if main:
        out["too_large"] = repr(f.submit(case["front_heavy"]).exception(
            timeout=60))
        out["after_too_large"] = f.submit(reqs[1]).result(timeout=60)
    f.close()
    out["small"] = _lists(f)
    # (ii) the router, its servers given largest first
    f = serving.AsyncBatchServer([big, small], batch_deadline_ms=50.0)
    if main:
        out["router"] = np.stack(
            [f.submit(case["front_light"]).result(timeout=60),
             f.submit(case["front_heavy"]).result(timeout=60)]
            + list(_burst(f, reqs)))
    f.close()
    out["router_lists"] = _lists(f)
    # bf16
    (bf16,) = servers(plan, buckets=FRONT_BUCKETS[1:])
    f = serving.AsyncBatchServer(bf16, batch_deadline_ms=50.0)
    if main:
        out["bf16"] = _burst(f, reqs)
    f.close()
    # (viii) the random gumbel: every rank's generator after the burst
    (rnd,) = servers(plan, cfg=config(case["server_cfg"]),
                     buckets=FRONT_BUCKETS[1:])
    before = rnd.generator.get_state().clone()
    f = serving.AsyncBatchServer(rnd, batch_deadline_ms=50.0)
    if main:
        _burst(f, reqs)
    f.close()
    out["generator"] = (before.numpy(), rnd.generator.get_state().numpy())
    out["rnd_packs"] = len(f.pack_sizes)
    # (vi) every rank calls benchmark_load
    out["load"] = serving.benchmark_load([small, big], rate_utt_per_s=20.0,
                                         duration_s=0.5, batch_deadline_ms=10.0)
    if main:        # one process: the router and bf16 on the same requests
        small1, big1 = servers(None, **fp32)
        f = serving.AsyncBatchServer([big1, small1], batch_deadline_ms=50.0)
        out["router_one"] = np.stack(
            [f.submit(case["front_light"]).result(timeout=60),
             f.submit(case["front_heavy"]).result(timeout=60)]
            + list(_burst(f, reqs)))
        f.close()
        (one,) = servers(None, buckets=FRONT_BUCKETS[1:])
        out["bf16_one"] = np.stack([one.predict([r])[0] for r in reqs])
    return out


SCENARIOS = {
    "dp2": lambda c, r: joint_step(c, r, 2, 1),
    "dp2_replicated": lambda c, r: joint_step(c, r, 2, 1, zero1=False),
    "tp2": lambda c, r: joint_step(c, r, 1, 2),
    "dialogue_dp2": lambda c, r: dialogue_step(c, r, 2, 1),
    "trainers_dp2": trainers,
    "resume_dp2": resume_file,
    "resume_at_dp2": resume_at_dp2,
    "dp2tp2": lambda c, r: joint_step(c, r, 2, 2, remat=True),
    "server_dp2tp2": lambda c, r: server(c, r, 2, 2),
    "front_dp2": lambda c, r: front(c, r, 2, 1),
    "front_dp2tp2": lambda c, r: front(c, r, 2, 2),
    "text_tp2": lambda c, r: text_tp(c, r, 1, 2),
    "shrink_dp": shrink,
}


def main(rank: int, world: int, case_dir: str) -> None:
    torch.set_num_threads(1)
    case = torch.load(os.path.join(case_dir, "case.pt"), weights_only=False)
    init_distributed(case.get("device", "cpu"), backend="gloo",
                     init_method="file://" + os.path.join(
                         case_dir, f"init_{world}"),
                     rank=rank, world_size=world)
    out = {name: SCENARIOS[name](case, rank)
           for name in case["scenarios"][world]}
    out["jax_modules"] = sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                               "facialmmt_tpu"))
    torch.save(out, os.path.join(case_dir, f"out_{world}_{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
