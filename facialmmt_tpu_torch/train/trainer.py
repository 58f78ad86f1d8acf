"""The epoch loops of the multi-task T+A+V run, the V-only model and the
appendix's text-feature and dialogue-level models (counterpart of
facialmmt_tpu/train/trainer.py; reference train.py:245-435 and
(Appendix)CCAC2023/train.py:100-194).

Per epoch: one auxiliary FER pass over Aff-Wild2-style image batches, one
target pass over MELD utterance batches, validation, best-val-F1 model
selection; the test split is evaluated from the best model.  Choices carried
over from the JAX package:
  * gradient accumulation is one larger device batch (trg_batch_size *
    trg_accumulation_steps utterances per step), the same mean gradient as the
    reference's accumulation of small batches, with the scheduler's total-step
    arithmetic preserved (reference train.py:309); joint training
    (swin_from_target) at accumulation > 1 runs the microbatch step instead,
    so only one microbatch's Swin activations are live;
  * face preprocessing and augmentation run batched on the device
    (data/image_pipeline.py) between loader and step;
  * eval keeps the reference's SAMPLED gumbel noise behind a seeded generator
    unless runtime.deterministic_gumbel.

Checkpoints go to runtime.save_model_path (checkpoint/io.py): `best_<epoch>`,
the pipeline's state_dict, whenever validation F1 improves (the test split is
evaluated from that file), and `step_<epoch>`, the resume checkpoint, at every
epoch end.  With a preemption guard installed (utils/preemption.py) a SIGTERM
makes the loop save the mid-epoch state at the next batch boundary and raise
`Preempted`; `run_multimodal(..., resume=True)` then continues exactly where
the interrupted run stopped (same batches, same random stream).

Training from scratch starts from pretrained towers as the reference does:
`run_multimodal(..., pretrained_swin=...)` grafts the Ms-Celeb-1M Swin
backbone and a non-empty `pretrained_text_model_path` the HF text tower
(`graft_subtree`, checkpoint/torch_load.py's loaders).  Progress lines and
the JSON-lines records of `--metrics_path` go through a MetricWriter
(utils/observability.py).  A non-empty runtime.profile_dir (`--profile_dir`)
traces train steps 3-7 of the run into that directory (StepProfiler: one
`ProfilerStep#n` span a step; a run that ends or is preempted before step 7
writes what it captured).

TextTrainer and DialogueTrainer (the appendix) train one model with one
optimizer over data/m3ed.py's datasets (or MeldDialogueDataset), select the
best epoch by macro-F1, stop early on validation loss and, in their eval_*_only
calls, write the competition CSV and the 'pred true' dump.

Multi-device runs (cfg.parallel; parallel/mesh.py): when dp or tp asks
for more than one rank, the trainer joins torchrun's process group and
builds the (data, model) mesh (_build_plan: dp = -1 takes every rank / tp,
and dp shrinks, as in JAX, to the largest count that divides the effective
batch; a rank left outside prints so and its run_* returns None).  Every
rank builds the same model from the same seed, splits its tensor-parallel
layers (shard_model_) and the same global batches; the steps split them
over the data ranks (train/steps.py), the optimizer sums the gradients and
holds ZeRO-1 moments (train/optim.py), and eval gathers the logits, so
every rank computes the same F1.  All random draws come from the one
generator every rank holds, at the global batch's shape (parallel/
context.py), so the ranks' generators stay equal and a dp run draws what
one process draws.  Only rank 0 prints, writes metrics and writes
checkpoints, between barriers; files hold whole tensors in the
single-device layout, so a run resumes at any layout.  A preemption request
is agreed over the ranks at each step boundary before anyone saves.

Datasets are any objects with the protocol of data/meld.py; the V-only loop
takes MeldVisionDataset's.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from facialmmt_tpu_torch.checkpoint.io import CheckpointManager
from facialmmt_tpu_torch.config import FacialMMTConfig, resolve_text_config
from facialmmt_tpu_torch.data.image_pipeline import (affwild2_train_augment,
                                                     meld_face_eval_transform,
                                                     meld_face_train_augment)
from facialmmt_tpu_torch.data.loader import PrefetchLoader
from facialmmt_tpu_torch.data.meld import FaceCapacityError
from facialmmt_tpu_torch.models.multimodal import text_prefix
from facialmmt_tpu_torch.models.pipeline import (FacialMMTPipeline,
                                                 build_pipeline, init_random_)
from facialmmt_tpu_torch.models.unimodal import MeldUttTransformer
from facialmmt_tpu_torch.ops.kernels import resolve_device
from facialmmt_tpu_torch.parallel.mesh import (full_state_dict,
                                               load_full_state_dict,
                                               shard_model_)
from facialmmt_tpu_torch.train.metrics import eval_meld
from facialmmt_tpu_torch.train.optim import MultiTaskState, SingleTaskState
from facialmmt_tpu_torch.train.steps import (make_aux_train_step,
                                             make_multimodal_eval_step,
                                             make_multimodal_train_step,
                                             make_multimodal_train_step_accum,
                                             make_unimodal_eval_step,
                                             make_unimodal_train_step)
from facialmmt_tpu_torch.utils.observability import (MetricWriter,
                                                     StepProfiler)
from facialmmt_tpu_torch.utils.preemption import (Preempted,
                                                  preemption_requested)

# buffers the model builds from its config (Swin's window index and shift
# mask) and BatchNorm's update counter: a graft leaves the model's own
_GEOMETRY = ("relative_position_index", "attn_mask", "num_batches_tracked")


def graft_subtree(model, src: Mapping[str, torch.Tensor],
                  prefix: str, what: str) -> None:
    """Copy the pretrained tensors `src` (names relative to `prefix`) into
    the parameters and running statistics of `model` (a module, or a
    state_dict of whole tensors) under `prefix`, after checking that both
    hold the same names with the same shapes: a wrong-dims checkpoint fails
    here, with the first six mismatches listed, before anything is copied.
    The model keeps its dtypes (counterpart of the JAX package's
    graft_subtree)."""
    def own(name):
        return not name.endswith(_GEOMETRY)

    sd = model if isinstance(model, Mapping) else model.state_dict()
    dst = {k[len(prefix):]: v for k, v in sd.items()
           if k.startswith(prefix) and own(k)}
    src = {k: v for k, v in src.items() if own(k)}
    problems = []
    for k in sorted(set(dst) | set(src)):
        if k not in src:
            problems.append(f"{k}: missing from pretrained tree")
        elif k not in dst:
            problems.append(f"{k}: unexpected in pretrained tree")
        elif tuple(dst[k].shape) != tuple(src[k].shape):
            problems.append(f"{k}: shape {tuple(src[k].shape)} vs model "
                            f"{tuple(dst[k].shape)}")
    if problems:
        raise ValueError(
            f"pretrained {what} tree does not match the model "
            f"({len(problems)} mismatch(es): {'; '.join(problems[:6])})")
    with torch.no_grad():
        for k, t in dst.items():
            t.copy_(src[k].to(device=t.device, dtype=t.dtype))


class StepTimer:
    """Interval timing with the reference's reset-on-log behaviour."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.start = time.time()
        self.total_loss = 0.0
        self.total_size = 0

    def update(self, loss: float, batch_size: int):
        self.total_loss += loss * batch_size
        self.total_size += batch_size

    def interval_stats(self, log_interval: int):
        elapsed = time.time() - self.start
        avg_loss = self.total_loss / max(self.total_size, 1)
        return elapsed * 1000 / max(log_interval, 1), avg_loss


class _QuietWriter(MetricWriter):
    """The writer of a rank other than 0: records nothing, prints nothing."""

    def write(self, tag: str, step: int, **metrics: Any):
        return None

    def log_train(self, *a, **k):
        pass

    def log_eval(self, *a, **k):
        pass

    def log_test(self, *a, **k):
        pass


class Trainer:
    def __init__(self, cfg: FacialMMTConfig, device="cuda",
                 writer: Optional[MetricWriter] = None):
        """`device` defaults to the card; without a CUDA device the
        constructor raises (pass "cpu" to train on the CPU).  `writer`
        receives the progress records; by default they are printed only.
        cfg.parallel asking for more than one rank joins torchrun's process
        group (parallel/mesh.py::init_distributed) and builds the mesh."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.writer = writer or MetricWriter()
        # --profile_dir: a trace of a few train steps (no-op when unset)
        self.profiler = StepProfiler(cfg.runtime.profile_dir)
        self.plan = self._build_plan(self._effective_batch())
        if self.plan is not None and not self.plan.is_main:
            self.writer = _QuietWriter()
        self.generator = torch.Generator(self.device).manual_seed(
            cfg.runtime.seed)
        self.history: list = []       # per epoch: val_f1, val_loss
        self.best_epoch = 0
        self.state: Optional[MultiTaskState] = None

    # ------------------------------------------------------------- layout --

    def _effective_batch(self) -> int:
        """The batch axis the data ranks must divide: the microbatch under
        joint training with accumulation, else the accumulated batch."""
        opt = self.cfg.optim
        if self.cfg.swin_from_target and opt.trg_accumulation_steps > 1:
            return max(opt.trg_batch_size, 1)
        return max(opt.trg_batch_size * opt.trg_accumulation_steps, 1)

    def _build_plan(self, batch: int):
        """The mesh of cfg.parallel (counterpart of the JAX trainer's
        _build_plan), or None for a one-process run."""
        import torch.distributed as dist

        from facialmmt_tpu_torch.parallel.mesh import (build_mesh,
                                                       init_distributed)

        dp, tp = self.cfg.parallel.dp, self.cfg.parallel.tp
        world = (dist.get_world_size() if dist.is_initialized()
                 else int(os.environ.get("WORLD_SIZE", "1")))
        if dp in (-1, 1) and tp == 1 and world == 1 \
                and not dist.is_initialized():
            return None
        self.device = init_distributed(self.device)
        world = dist.get_world_size()
        if world % tp:
            raise ValueError(f"--tp {tp} does not divide the {world} ranks")
        # batches split on their leading axis, so dp must divide the
        # effective batch; shrink to the largest count that does
        want = world // tp if dp == -1 else dp
        asked = want
        while want > 1 and (batch % want or (world // tp) % want):
            want -= 1
        if want < asked and dist.get_rank() == 0:
            print(f"parallel plan: dp shrunk {asked} -> {want} "
                  f"(effective batch {batch} must divide dp; "
                  f"{world} ranks, tp={tp}) — "
                  f"{(asked - want) * tp} rank(s) idle")
        plan = build_mesh(want, tp, self.device)
        if not plan.member:
            print(f"rank {plan.rank}: outside the {want} x {tp} mesh, "
                  f"leaving the run")
        return plan

    def _idle(self) -> bool:
        """A rank outside the mesh takes no part in the run."""
        return self.plan is not None and not self.plan.member

    def _say(self, *args) -> None:
        if self.plan is None or self.plan.is_main:
            print(*args)

    def _shard(self, model):
        """Split the model's tensor-parallel layers (a no-op at tp = 1)."""
        if self.plan is not None:
            shard_model_(model, self.plan)
        return model

    def _layout(self) -> dict:
        """The optimizer's layout arguments (train/optim.py)."""
        return dict(plan=self.plan, zero1=self.cfg.parallel.zero1)

    def _write(self, save, *args):
        """save(*args) on rank 0 only, between barriers; the path."""
        if self.plan is None:
            return save(*args)
        self.plan.barrier()
        path = save(*args) if self.plan.is_main else None
        self.plan.barrier()
        return path

    def _eval_meld(self, logits, labels, test: bool) -> float:
        """eval_meld, whose per-class line only rank 0 prints."""
        if self.plan is None or self.plan.is_main:
            return eval_meld(logits, labels, test=test)
        with open(os.devnull, "w") as sink, \
                contextlib.redirect_stdout(sink):
            return eval_meld(logits, labels, test=test)

    def _log_pass(self, task: str, epoch: int, hours: float):
        self._say("-" * 50)
        self._say(f"**{task}** | Epoch {epoch:2d} | Time {hours:5.4f} hour")
        self._say("-" * 50)

    # ----------------------------------------------------------- multimodal --

    def _to_device(self, array) -> torch.Tensor:
        return torch.from_numpy(np.asarray(array)).to(self.device)

    def _prepare_faces(self, batch: Dict[str, Any], train: bool):
        """Device-side face pipeline: uint8 (N, 160, 160, 3) -> normalised
        swin_img_size.  Also takes the microbatch layout (M, N, 160, 160, 3),
        flattening the microbatch axis through the augment."""
        faces = self._to_device(batch["faces_raw"]).float()
        micro = faces.dim() == 5
        if micro:
            m, n = faces.shape[:2]
            faces = faces.reshape((m * n,) + tuple(faces.shape[2:]))
        size = self.cfg.data.swin_img_size
        if train:
            out = meld_face_train_augment(self.generator, faces, img_size=size)
        else:
            out = meld_face_eval_transform(faces, img_size=size)
        if micro:
            out = out.reshape((m, n) + tuple(out.shape[1:]))
        device_batch = {k: self._to_device(v) for k, v in batch.items()
                        if k != "faces_raw"}
        device_batch["faces"] = out
        return device_batch

    def _build_model(self, state_dict=None) -> FacialMMTPipeline:
        """The pipeline on the device with fp32 parameters: `state_dict` or
        random weights from runtime.seed (models/pipeline.py), split over
        the model ranks."""
        return self._shard(build_pipeline(self.cfg, self.device,
                                          state_dict).float())

    def _pretrained_text_tower(self) -> Optional[Dict[str, torch.Tensor]]:
        """The HF text tower for training from scratch, as state_dict
        entries under the multimodal model's `roberta.` / `bert.`, or None.
        The reference always starts its text tower from pretrained PLM
        weights (reference src/models.py:72-77, resolved from
        <project>/pretrained_model/<plm_name> at reference main.py:118); a
        random roberta-large cannot approach its W-F1.  An empty path keeps
        the random tower (tests, ablations; the command line warns, in
        main.resolve_pretrained_text_dir, where the JAX trainer warns on
        every run); a path that is not a directory raises."""
        path = self.cfg.pretrained_text_model_path
        if not path:
            return None
        if not os.path.isdir(path):
            raise FileNotFoundError(
                f"--pretrainedtextmodel_path {path} is not a directory "
                f"(expected a local HF pretrained model dir)")
        from facialmmt_tpu_torch.checkpoint.torch_load import \
            load_hf_text_tower

        return load_hf_text_tower(path, resolve_text_config(self.cfg),
                                  text_prefix(self.cfg))

    def _graft_pretrained(self, model: FacialMMTPipeline, pretrained_swin):
        """Graft the pretrained towers into a freshly built pipeline, where
        the JAX package grafts them (at init, before the optimizers):
        `pretrained_swin`, the backbone's state_dict
        (checkpoint/torch_load.py::load_pretrained_swin_backbone), into
        swin_model.swin; the HF text tower into the multimodal model."""
        text = self._pretrained_text_tower()
        if pretrained_swin is None and text is None:
            return
        whole = full_state_dict(model, self.plan)
        if pretrained_swin is not None:
            graft_subtree(whole, pretrained_swin, "swin_model.swin.",
                          "pretrained Swin backbone")
        if text is not None:
            tower = text_prefix(self.cfg) + "."
            graft_subtree(whole, {k[len(tower):]: v for k, v in text.items()},
                          "multimodal." + tower, "text tower")
        if self.plan is not None:
            load_full_state_dict(model, whole, self.plan)

    def _init_multitask_state(self, model, train_ds, aux_len: int):
        cfg, opt = self.cfg, self.cfg.optim
        trg_bsz = opt.trg_batch_size * opt.trg_accumulation_steps
        steps_per_epoch = (len(train_ds) + trg_bsz - 1) // trg_bsz
        mm_total = opt.num_epochs * steps_per_epoch
        # aux accumulation is one larger device batch (same mean gradient;
        # reference train.py:26-34), so each loader batch is one update
        aux_bsz = opt.aux_batch_size * max(opt.aux_accumulation_steps, 1)
        aux_steps = max((aux_len + aux_bsz - 1) // aux_bsz, 1)
        aux_total = opt.num_epochs * aux_steps
        if cfg.swin_from_target:  # joint training also steps Swin per trg step
            aux_total += mm_total
        state = MultiTaskState.create(model, opt, aux_total, mm_total,
                                      **self._layout())
        return state, steps_per_epoch, trg_bsz

    def _face_capacity(self, batch_size: int) -> int:
        """Static face-buffer capacity: about 8 faces per utterance, rounded
        up to 64."""
        cap = batch_size * min(self.cfg.data.vision_utt_max_len, 12)
        return max(64, (cap + 63) // 64 * 64)

    def _face_buckets(self, batch_size: int):
        """Ascending face-capacity buckets (base, 2x, ceiling).  A face-heavy
        batch that overflows the base bucket escalates instead of dropping
        faces; the ceiling batch * vision_utt_max_len can never overflow
        because per-utterance face lists truncate to that cap (reference
        utils/dataset.py:278-279)."""
        base = self._face_capacity(batch_size)
        ceiling = max(64, (batch_size * self.cfg.data.vision_utt_max_len
                           + 63) // 64 * 64)
        buckets = [min(base, ceiling)]
        if base * 2 < ceiling:
            buckets.append(base * 2)
        if buckets[-1] < ceiling:
            buckets.append(ceiling)
        return buckets

    def _batch_with_escalation(self, fetch, buckets):
        """fetch(capacity) under each bucket until one fits."""
        for i, cap in enumerate(buckets):
            try:
                batch = fetch(cap)
            except FaceCapacityError as e:
                if i == len(buckets) - 1:
                    raise  # ceiling bucket: a real data/config inconsistency
                self._say(f"face capacity {cap} overflowed (need "
                          f"{e.required}); escalating to bucket "
                          f"{buckets[i + 1]}")
                continue
            return batch

    def _make_steps(self, model):
        cfg, opt = self.cfg, self.cfg.optim
        dtype = cfg.runtime.compute_dtype
        accum = max(opt.trg_accumulation_steps, 1)
        use_micro = cfg.swin_from_target and accum > 1
        plan = self.plan
        aux_step = make_aux_train_step(model, compute_dtype=dtype, plan=plan)
        if use_micro:
            trg_step = make_multimodal_train_step_accum(
                model, swin_from_target=True, compute_dtype=dtype, plan=plan)
        else:
            trg_step = make_multimodal_train_step(
                model, swin_from_target=cfg.swin_from_target,
                compute_dtype=dtype, plan=plan)
        eval_step = make_multimodal_eval_step(
            model, face_chunk=cfg.runtime.eval_face_chunk, compute_dtype=dtype,
            plan=plan)
        return aux_step, trg_step, eval_step, use_micro

    def _target_loader(self, train_ds, trg_bsz: int, use_micro: bool):
        opt = self.cfg.optim
        if use_micro:
            accum = max(opt.trg_accumulation_steps, 1)
            micro_bsz = opt.trg_batch_size
            buckets_m = self._face_buckets(micro_bsz)

            def make_trg_batch(idx):
                chunks = [idx[i * micro_bsz:(i + 1) * micro_bsz]
                          for i in range(accum)]

                # all microbatches share one capacity (np.stack), so an
                # overflow in ANY chunk escalates the whole fetch
                def fetch(cap):
                    subs = [train_ds.get_batch(c, face_capacity=cap)
                            for c in chunks]
                    return {k: np.stack([s[k] for s in subs])
                            for k in subs[0]}

                return self._batch_with_escalation(fetch, buckets_m)
        else:
            buckets = self._face_buckets(trg_bsz)

            def make_trg_batch(idx):
                return self._batch_with_escalation(
                    lambda cap: train_ds.get_batch(idx, face_capacity=cap),
                    buckets)
        return PrefetchLoader(make_trg_batch, len(train_ds), trg_bsz,
                              shuffle=True, seed=self.cfg.runtime.seed)

    # --------------------------------------------------------- checkpoints --

    def _ckpt_payload(self, state, best_f1: float, epoch: int,
                      progress: Dict[str, int], early_stop: Dict[str, float]):
        """Resume checkpoint contents of `state`, a MultiTaskState or a
        SingleTaskState (train/optim.py).  `epoch` counts COMPLETED epochs;
        `progress` counts the batches already applied in epoch + 1 (all zero
        at an epoch boundary).  The generator behind augmentation, dropout,
        drop-path and the gumbel noise rides along, so a resumed run
        continues the same random stream, and the early-stopping counters, so
        it stops at the epoch an uninterrupted run would.  Under a plan the
        tensors are made whole (every rank calls this) and the generator's
        state is every rank's: all of them draw the same stream."""
        return {"model": full_state_dict(state.model, self.plan),
                "optim": state.state_dict(),
                "best_f1": float(best_f1), "epoch": int(epoch),
                "progress": {k: int(v) for k, v in progress.items()},
                "early_stop": {
                    "best_val_loss": float(early_stop["best_val_loss"]),
                    "patience_counter": int(early_stop["patience_counter"])},
                "generator": self.generator.get_state()}

    def _restore_latest(self, ckpt: CheckpointManager, state,
                        progress_zero: Dict[str, int]):
        """Load the newest resume checkpoint into `state` and the generator.
        Returns (best_f1 or None, first epoch to run, progress, early_stop);
        without a checkpoint, a fresh start."""
        latest = ckpt.restore_latest()
        if latest is None:
            return (None, 1, dict(progress_zero),
                    {"best_val_loss": float("inf"), "patience_counter": 0})
        load_full_state_dict(state.model, latest["model"], self.plan)
        state.load_state_dict(latest["optim"])
        self.generator.set_state(latest["generator"])
        es = latest["early_stop"]
        return (float(latest["best_f1"]), int(latest["epoch"]) + 1,
                {k: int(latest["progress"][k]) for k in progress_zero},
                {"best_val_loss": float(es["best_val_loss"]),
                 "patience_counter": int(es["patience_counter"])})

    def _maybe_preempt(self, ckpt: CheckpointManager, state,
                       best_f1: float, epoch: int, progress: Dict[str, int],
                       early_stop: Dict[str, float]) -> None:
        """Poll the preemption guard at a batch boundary.  On a request, save
        the mid-epoch state as the resume checkpoint of the epochs before
        (crash-safe: the previous file under that name stays until the new
        one is complete) and raise Preempted.  Under a plan the ranks agree
        first (a SIGTERM reaches them at different steps): any rank's
        request stops every rank at this boundary."""
        requested = preemption_requested()
        if self.plan is not None:
            from facialmmt_tpu_torch.parallel.comm import all_reduce_

            flag = torch.tensor([float(requested)], device=self.device)
            requested = bool(all_reduce_(flag, self.plan.group).item() > 0)
        if not requested:
            return
        self.profiler.close()  # write a capture still running
        self._write(ckpt.save_step, self._ckpt_payload(
            state, best_f1, epoch - 1, progress, early_stop), epoch - 1)
        path = os.path.join(ckpt.directory, f"step_{epoch - 1}")
        self._say(f"Preemption requested: resume checkpoint saved to "
                  f"{path}; run again with resume=True to continue epoch "
                  f"{epoch}.")
        raise Preempted(epoch, path)

    # ----------------------------------------------------------- multimodal --

    def run_multimodal(self, aux_ds, train_ds, valid_ds, test_ds,
                       state_dict=None, resume: bool = False,
                       on_event=None, pretrained_swin=None) -> float:
        """T+A+V multi-task training (reference train.py:297-421); returns the
        test weighted F1 of the best-validation model.  `state_dict` holds the
        starting weights (None: random from runtime.seed), onto which the
        pretrained towers are grafted (`pretrained_swin`, the Ms-Celeb-1M
        backbone's state_dict, and runtime's text tower, see
        _graft_pretrained).  resume=True
        continues from the newest resume checkpoint in
        runtime.save_model_path (a fresh start when there is none).
        `on_event(name, **info)`, when given, is called after every step
        ('aux_step', 'trg_step': epoch, index, loss), after every pass
        ('aux_pass', 'trg_pass', 'valid': epoch) and once before the first
        ('start'), for measurement and inspection; self.state holds the
        model by then."""
        if self._idle():
            return None
        notify = on_event or (lambda name, **info: None)
        cfg, opt = self.cfg, self.cfg.optim
        model = self._build_model(state_dict)
        self._graft_pretrained(model, pretrained_swin)
        state, steps_per_epoch, trg_bsz = self._init_multitask_state(
            model, train_ds, len(aux_ds))
        self.state = state
        aux_step, trg_step, eval_step, use_micro = self._make_steps(model)
        trg_loader = self._target_loader(train_ds, trg_bsz, use_micro)
        aux_bsz = opt.aux_batch_size * max(opt.aux_accumulation_steps, 1)
        aux_loader = PrefetchLoader(aux_ds.get_batch, len(aux_ds), aux_bsz,
                                    shuffle=True, seed=cfg.runtime.seed + 1)

        ckpt = CheckpointManager(cfg.runtime.save_model_path)
        best_f1 = -1.0
        # early stopping (appendix train.py:114-152)
        early = {"best_val_loss": float("inf"), "patience_counter": 0}
        start_epoch = 1
        resume_prog = {"aux_batch": 0, "trg_batch": 0}
        if resume:
            bf, start_epoch, resume_prog, early = self._restore_latest(
                ckpt, state, resume_prog)
            if bf is not None:
                best_f1 = bf
        notify("start")
        self.history = []
        for epoch in range(start_epoch, opt.num_epochs + 1):
            first = epoch == start_epoch
            aux_sb = resume_prog["aux_batch"] if first else 0
            trg_sb = resume_prog["trg_batch"] if first else 0
            if first and trg_sb > 0:   # preempted in the target pass
                aux_sb = len(aux_loader)
            # ---- auxiliary FER pass (reference train.py:356-363) ----
            start = time.time()
            timer = StepTimer()
            for i, ((images, labels), n_valid) in enumerate(
                    aux_loader.epoch(epoch, start_batch=aux_sb),
                    start=aux_sb):
                images = affwild2_train_augment(
                    self.generator, self._to_device(images).float(),
                    img_size=cfg.data.swin_img_size)
                loss = aux_step(state, images, self._to_device(labels),
                                self.generator)
                timer.update(float(loss), n_valid)
                self.profiler.step()
                notify("aux_step", epoch=epoch, index=i, loss=float(loss))
                self._maybe_preempt(ckpt, state, best_f1, epoch,
                                    {"aux_batch": i + 1, "trg_batch": 0},
                                    early)
                if i % cfg.runtime.aux_log_interval == 0 and i > 0:
                    ms, avg = timer.interval_stats(cfg.runtime.aux_log_interval)
                    self.writer.log_train("SRC", epoch, i, len(aux_loader),
                                          ms, avg)
                    timer.reset()
            self._log_pass("SRC", epoch, (time.time() - start) / 3600)
            notify("aux_pass", epoch=epoch)

            # ---- target multimodal pass (reference train.py:364-374) ----
            start = time.time()
            timer = StepTimer()
            for i, (batch, n_valid) in enumerate(
                    trg_loader.epoch(epoch, start_batch=trg_sb),
                    start=trg_sb):
                device_batch = self._prepare_faces(batch, train=True)
                loss = trg_step(state, device_batch, self.generator)
                timer.update(float(loss), n_valid)
                self.profiler.step()
                notify("trg_step", epoch=epoch, index=i, loss=float(loss))
                self._maybe_preempt(ckpt, state, best_f1, epoch,
                                    {"aux_batch": len(aux_loader),
                                     "trg_batch": i + 1}, early)
                if i % cfg.runtime.trg_log_interval == 0 and i > 0:
                    ms, avg = timer.interval_stats(cfg.runtime.trg_log_interval)
                    self.writer.log_train("TRG", epoch, i, steps_per_epoch,
                                          ms, avg)
                    timer.reset()
            notify("trg_pass", epoch=epoch)
            logits, labels, val_loss = self._eval_multimodal(
                eval_step, valid_ds, return_loss=True)
            val_f1 = self._eval_meld(logits, labels, test=False)
            self.writer.log_eval(epoch, (time.time() - start) / 3600, val_f1)
            self.history.append({"epoch": epoch, "val_f1": val_f1,
                                 "val_loss": val_loss})
            notify("valid", epoch=epoch)
            if val_f1 > best_f1:
                best_f1 = val_f1
                self._write(ckpt.save_best,
                            full_state_dict(model, self.plan), epoch)
            # the early-stopping counters move BEFORE the epoch's resume
            # checkpoint, so a resumed run carries them
            if opt.patience > 0:  # appendix early stopping on val loss
                if val_loss < early["best_val_loss"]:
                    early["best_val_loss"] = val_loss
                    early["patience_counter"] = 0
                else:
                    early["patience_counter"] += 1
            self._write(ckpt.save_step, self._ckpt_payload(
                state, best_f1, epoch, {"aux_batch": 0, "trg_batch": 0},
                early), epoch)
            if opt.patience > 0 and early["patience_counter"] >= opt.patience:
                self._say(f"Validation loss has not descended for "
                          f"{opt.patience} epochs. Stopping training.")
                break

        self.profiler.close()
        self.best_epoch, best = ckpt.restore_best()
        load_full_state_dict(model, best, self.plan)
        logits, labels = self._eval_multimodal(eval_step, test_ds)
        test_f1 = self._eval_meld(logits, labels, test=True)
        self.writer.log_test(test_f1)
        return test_f1

    def eval_multimodal_only(self, state_dict, test_ds,
                             batch_size: int = 16) -> float:
        """Direct-eval path from a state_dict (reference train.py:424-434)."""
        if self._idle():
            return None
        cfg = self.cfg
        model = self._build_model(state_dict)
        eval_step = make_multimodal_eval_step(
            model, face_chunk=cfg.runtime.eval_face_chunk,
            compute_dtype=cfg.runtime.compute_dtype, plan=self.plan)
        logits, labels = self._eval_multimodal(eval_step, test_ds, batch_size)
        test_f1 = self._eval_meld(logits, labels, test=True)
        self.writer.log_test(test_f1)
        return test_f1

    def _eval_multimodal(self, eval_step, ds, batch_size: int = 16,
                         return_loss: bool = False):
        buckets = self._face_buckets(batch_size)
        loader = PrefetchLoader(
            lambda idx: self._batch_with_escalation(
                lambda cap: ds.get_batch(idx, face_capacity=cap), buckets),
            len(ds), batch_size, shuffle=False)
        logits_all, labels_all = [], []
        loss_sum, n_sum = 0.0, 0
        for batch, n_valid in loader.epoch(0):
            device_batch = self._prepare_faces(batch, train=False)
            logits, loss = eval_step(device_batch, self.generator)
            loss_sum += float(loss) * n_valid
            n_sum += n_valid
            logits_all.append(logits.float().cpu().numpy()[:n_valid])
            labels_all.append(np.asarray(batch["labels"])[:n_valid])
        logits_cat = np.concatenate(logits_all)
        labels_cat = np.concatenate(labels_all)
        if return_loss:
            return logits_cat, labels_cat, loss_sum / max(n_sum, 1)
        return logits_cat, labels_cat

    # ------------------------------------------------------------- unimodal --

    def _build_unimodal(self, state_dict=None) -> MeldUttTransformer:
        """The V-only model on the device: `state_dict` (a released
        unimodal_model_V.pt, strict) or random weights from runtime.seed."""
        with torch.device(self.device):
            model = MeldUttTransformer(self.cfg)
        if state_dict is None:
            init_random_(model, torch.Generator(self.device)
                         .manual_seed(self.cfg.runtime.seed))
        else:
            model.load_state_dict(state_dict, strict=True)
        return self._shard(model)

    def run_unimodal(self, train_ds, valid_ds, test_ds,
                     resume: bool = False) -> float:
        """V-only training (reference train.py:245-292, 342-349, 390-409);
        returns the test weighted F1 of the best-validation model.
        Checkpoints, preemption and resume=True as in run_multimodal, with
        the batch count of the interrupted epoch as its progress."""
        if self._idle():
            return None
        cfg, opt = self.cfg, self.cfg.optim
        model = self._build_unimodal()
        bsz = opt.trg_batch_size * opt.trg_accumulation_steps
        loader = PrefetchLoader(train_ds.get_batch, len(train_ds), bsz,
                                shuffle=True, seed=cfg.runtime.seed)
        steps_per_epoch = len(loader)
        state = SingleTaskState.create(model, opt,
                                       opt.num_epochs * steps_per_epoch,
                                       **self._layout())
        self.state = state
        dtype = cfg.runtime.compute_dtype
        train_step = make_unimodal_train_step(model, compute_dtype=dtype,
                                              plan=self.plan)
        eval_step = make_unimodal_eval_step(model, compute_dtype=dtype,
                                            plan=self.plan)

        ckpt = CheckpointManager(cfg.runtime.save_model_path)
        # the reference starts best at 0 with a strict '>' (train.py:352) and
        # has no best model when val F1 never exceeds 0; -1 saves epoch 1
        best_f1 = -1.0
        no_early_stop = {"best_val_loss": float("inf"), "patience_counter": 0}
        start_epoch, resume_batch = 1, 0
        if resume:
            bf, start_epoch, prog, _ = self._restore_latest(
                ckpt, state, {"batch": 0})
            if bf is not None:
                best_f1 = bf
            resume_batch = prog["batch"]
        for epoch in range(start_epoch, opt.num_epochs + 1):
            timer = StepTimer()
            start = time.time()
            sb = resume_batch if epoch == start_epoch else 0
            for i, (batch, n_valid) in enumerate(
                    loader.epoch(epoch, start_batch=sb), start=sb):
                loss = train_step(state, self._to_device(batch["feats"]),
                                  self._to_device(batch["mask"]),
                                  self._to_device(batch["labels"]),
                                  self.generator)
                timer.update(float(loss), n_valid)
                self.profiler.step()
                self._maybe_preempt(ckpt, state, best_f1, epoch,
                                    {"batch": i + 1}, no_early_stop)
                if i % cfg.runtime.trg_log_interval == 0 and i > 0:
                    ms, avg = timer.interval_stats(cfg.runtime.trg_log_interval)
                    self.writer.log_train("TRG", epoch, i, steps_per_epoch,
                                          ms, avg)
                    timer.reset()
            logits, labels = self._eval_unimodal(eval_step, valid_ds)
            val_f1 = self._eval_meld(logits, labels, test=False)
            self.writer.log_eval(epoch, (time.time() - start) / 3600, val_f1)
            if val_f1 > best_f1:
                best_f1 = val_f1
                self._write(ckpt.save_best,
                            full_state_dict(model, self.plan), epoch)
            self._write(ckpt.save_step, self._ckpt_payload(
                state, best_f1, epoch, {"batch": 0}, no_early_stop), epoch)

        self.profiler.close()
        self.best_epoch, best = ckpt.restore_best()
        load_full_state_dict(model, best, self.plan)
        logits, labels = self._eval_unimodal(eval_step, test_ds)
        test_f1 = self._eval_meld(logits, labels, test=True)
        self.writer.log_test(test_f1)
        return test_f1

    def eval_unimodal_only(self, state_dict, test_ds) -> float:
        """Direct-eval path from a released unimodal state_dict (reference
        train.py:431-434)."""
        if self._idle():
            return None
        model = self._build_unimodal(state_dict)
        eval_step = make_unimodal_eval_step(
            model, compute_dtype=self.cfg.runtime.compute_dtype,
            plan=self.plan)
        logits, labels = self._eval_unimodal(eval_step, test_ds)
        test_f1 = self._eval_meld(logits, labels, test=True)
        self.writer.log_test(test_f1)
        return test_f1

    def _eval_unimodal(self, eval_step, ds, batch_size: int = 64):
        loader = PrefetchLoader(ds.get_batch, len(ds), batch_size,
                                shuffle=False)
        logits_all, labels_all = [], []
        for batch, n_valid in loader.epoch(0):
            logits, _ = eval_step(self._to_device(batch["feats"]),
                                  self._to_device(batch["mask"]),
                                  self._to_device(batch["labels"]))
            logits_all.append(logits.float().cpu().numpy()[:n_valid])
            labels_all.append(np.asarray(batch["labels"])[:n_valid])
        return np.concatenate(logits_all), np.concatenate(labels_all)


# ------------------------------------------------------------- appendix --

class _SingleModelTrainer(Trainer):
    """The loop the appendix's two trainers share (counterpart of the JAX
    package's TextTrainer and DialogueTrainer, reference
    (Appendix)CCAC2023/train.py:100-194): one model and one optimizer
    (trg_lr, weight decay) over target batches, validation, the best model
    by validation F1 (macro by default), early stopping on validation loss
    (its counters written before the epoch's resume file), resume=True, and
    a direct eval that restores the best file, predicts the test split in
    dataset order and writes the submission CSV and the 'pred true' dump.
    A subclass gives the model (_new_model), its steps (_steps) and its
    predictions (_predict)."""

    def _new_model(self) -> torch.nn.Module:
        raise NotImplementedError

    def _steps(self, model):
        raise NotImplementedError

    def _predict(self, eval_step, ds, bsz: int):
        raise NotImplementedError

    def _build_single(self, state_dict=None, pretrained: bool = False):
        """The model on the device with fp32 parameters: `state_dict`
        (strict), or random weights from runtime.seed with, when
        `pretrained`, the HF text tower of pretrained_text_model_path grafted
        in."""
        with torch.device(self.device):
            model = self._new_model()
        model.to(self.device).float()   # buffers made from numpy
        if state_dict is not None:
            model.load_state_dict(state_dict, strict=True)
            return self._shard(model)
        init_random_(model, torch.Generator(self.device).manual_seed(
            self.cfg.runtime.seed))
        text = self._pretrained_text_tower() if pretrained else None
        if text is not None:
            tower = text_prefix(self.cfg) + "."
            graft_subtree(model, {k[len(tower):]: v for k, v in text.items()},
                          tower, "text tower")
        return self._shard(model)

    def _batch_to_device(self, batch):
        return {k: self._to_device(v) for k, v in batch.items()}

    def _run(self, train_ds, valid_ds, test_ds, use_macro_f1: bool = True,
             resume: bool = False, on_event=None) -> float:
        """Train from scratch (or resume=True from the newest resume file in
        runtime.save_model_path), return the test F1 of the best-validation
        model.  `on_event(name, **info)` as in run_multimodal: 'start',
        'trg_step' (epoch, index, loss) and 'valid' (epoch)."""
        from facialmmt_tpu_torch.train.metrics import macro_f1, weighted_f1

        if self._idle():
            return None
        notify = on_event or (lambda name, **info: None)
        cfg, opt = self.cfg, self.cfg.optim
        model = self._build_single(pretrained=True)
        bsz = self._effective_batch()
        loader = PrefetchLoader(train_ds.get_batch, len(train_ds), bsz,
                                shuffle=True, seed=cfg.runtime.seed)
        state = SingleTaskState.create(model, opt,
                                       opt.num_epochs * len(loader),
                                       **self._layout())
        self.state = state
        train_step, eval_step = self._steps(model)
        metric = macro_f1 if use_macro_f1 else weighted_f1
        ckpt = CheckpointManager(cfg.runtime.save_model_path)
        best_f1 = -1.0
        early = {"best_val_loss": float("inf"), "patience_counter": 0}
        start_epoch, resume_batch = 1, 0
        if resume:
            bf, start_epoch, prog, early = self._restore_latest(
                ckpt, state, {"batch": 0})
            if bf is not None:
                best_f1 = bf
            resume_batch = prog["batch"]
        notify("start")
        self.history = []
        for epoch in range(start_epoch, opt.num_epochs + 1):
            start = time.time()
            timer = StepTimer()
            sb = resume_batch if epoch == start_epoch else 0
            for i, (batch, n_valid) in enumerate(
                    loader.epoch(epoch, start_batch=sb), start=sb):
                loss = train_step(state, self._batch_to_device(batch),
                                  self.generator)
                timer.update(float(loss), n_valid)
                self.profiler.step()
                notify("trg_step", epoch=epoch, index=i, loss=float(loss))
                self._maybe_preempt(ckpt, state, best_f1, epoch,
                                    {"batch": i + 1}, early)
                if i % cfg.runtime.trg_log_interval == 0 and i > 0:
                    ms, avg = timer.interval_stats(cfg.runtime.trg_log_interval)
                    self.writer.log_train("TRG", epoch, i, len(loader), ms,
                                          avg)
                    timer.reset()
            logits, labels, val_loss = self._predict(eval_step, valid_ds, bsz)
            val_f1 = metric(labels, logits.argmax(-1))
            self.writer.log_eval(epoch, (time.time() - start) / 3600, val_f1)
            self.history.append({"epoch": epoch, "val_f1": val_f1,
                                 "val_loss": val_loss})
            notify("valid", epoch=epoch)
            if val_f1 > best_f1:
                best_f1 = val_f1
                self._write(ckpt.save_best,
                            full_state_dict(model, self.plan), epoch)
            # the counters move BEFORE the epoch's resume file (exact resume)
            if opt.patience > 0:
                if val_loss < early["best_val_loss"]:
                    early["best_val_loss"] = val_loss
                    early["patience_counter"] = 0
                else:
                    early["patience_counter"] += 1
            self._write(ckpt.save_step, self._ckpt_payload(
                state, best_f1, epoch, {"batch": 0}, early), epoch)
            if opt.patience > 0 and early["patience_counter"] >= opt.patience:
                self._say(f"Validation loss has not descended for "
                          f"{opt.patience} epochs. Stopping training.")
                break

        self.profiler.close()
        self.best_epoch, best = ckpt.restore_best()
        load_full_state_dict(model, best, self.plan)
        logits, labels, _ = self._predict(eval_step, test_ds, bsz)
        test_f1 = metric(labels, logits.argmax(-1))
        self.writer.log_test(test_f1)
        return test_f1

    def _eval_only(self, test_ds, ckpt_dir: Optional[str] = None,
                   submission_template: str = "", submission_out: str = "",
                   pred_dump_path: str = "",
                   use_macro_f1: bool = True) -> float:
        """Restore the best file of `ckpt_dir` (default
        runtime.save_model_path), predict the test split in dataset order,
        fill `submission_template` (argmax -> emotion names) into
        `submission_out` (default <save_model_path>/nustm_submission.csv)
        and write the 'pred true' dump to `pred_dump_path`, each when given
        (reference (Appendix)CCAC2023/train.py:156-194, utils/
        eval_metrics.py:22-35).  A template that does not exist raises
        before anything is loaded."""
        from facialmmt_tpu_torch.train.metrics import macro_f1, weighted_f1
        from facialmmt_tpu_torch.utils.submission import (write_pred_true_dump,
                                                          write_submission_csv)

        if submission_template and not os.path.exists(submission_template):
            raise FileNotFoundError(
                f"--submission_template not found: {submission_template}")
        if self._idle():
            return None
        cfg = self.cfg
        _, best = CheckpointManager(
            ckpt_dir or cfg.runtime.save_model_path).restore_best()
        model = self._build_single(best)
        _, eval_step = self._steps(model)
        logits, labels, _ = self._predict(eval_step, test_ds,
                                          self._effective_batch())
        preds = logits.argmax(-1)
        if self.plan is not None and not self.plan.is_main:
            submission_template = pred_dump_path = ""   # rank 0 writes them
        if submission_template:
            out = submission_out or os.path.join(cfg.runtime.save_model_path,
                                                 "nustm_submission.csv")
            write_submission_csv(logits, submission_template, out)
            print(f"submission written: {out}")
        else:
            self._say("no submission template: no submission CSV written")
        if pred_dump_path:
            correct = write_pred_true_dump(preds, labels, pred_dump_path)
            print(f"pred/true dump: {pred_dump_path} "
                  f"({correct}/{len(preds)} correct)")
        metric = macro_f1 if use_macro_f1 else weighted_f1
        test_f1 = metric(labels, preds)
        self.writer.log_test(test_f1)
        return test_f1


class TextTrainer(_SingleModelTrainer):
    """The feature-modality experiments: choice_modality 'T' (the appendix's
    text-only model, reference (Appendix)CCAC2023/utils/dataset.py:112-147)
    and 'T+A' / 'T+V' / 'T+A+V' on precomputed features (vision is the
    extractor's raw features: no faces, no FER branch; reference :165-302),
    over data/m3ed.py's utterance datasets."""

    def _new_model(self):
        from facialmmt_tpu_torch.models.multimodal import \
            MultiModalTransformerForClassification

        cfg = self.cfg
        modality = (cfg.choice_modality if cfg.choice_modality in
                    ("T", "T+A", "T+V", "T+A+V") else "T")
        return MultiModalTransformerForClassification(
            cfg.replace(choice_modality=modality),
            vision_in_dim=cfg.data.vision_feat_dim)

    def _steps(self, model):
        from facialmmt_tpu_torch.train.steps import (make_text_eval_step,
                                                     make_text_train_step)

        dtype = self.cfg.runtime.compute_dtype
        return (make_text_train_step(model, compute_dtype=dtype,
                                     plan=self.plan),
                make_text_eval_step(model, compute_dtype=dtype,
                                    plan=self.plan))

    def _predict(self, eval_step, ds, bsz: int):
        """(logits (N, C), labels (N,), mean loss) over `ds` in order."""
        loader = PrefetchLoader(ds.get_batch, len(ds), bsz, shuffle=False)
        logits_all, labels_all = [], []
        loss_sum, n_sum = 0.0, 0
        for batch, n_valid in loader.epoch(0):
            logits, loss = eval_step(self._batch_to_device(batch))
            logits_all.append(logits.float().cpu().numpy()[:n_valid])
            labels_all.append(np.asarray(batch["labels"])[:n_valid])
            loss_sum += float(loss) * n_valid
            n_sum += n_valid
        return (np.concatenate(logits_all), np.concatenate(labels_all),
                loss_sum / max(n_sum, 1))

    def run_text(self, train_ds, valid_ds, test_ds, use_macro_f1: bool = True,
                 resume: bool = False, on_event=None) -> float:
        """Train (see _SingleModelTrainer._run); returns the test F1."""
        return self._run(train_ds, valid_ds, test_ds,
                         use_macro_f1=use_macro_f1, resume=resume,
                         on_event=on_event)

    def eval_text_only(self, test_ds, ckpt_dir: Optional[str] = None,
                       submission_template: str = "",
                       submission_out: str = "", pred_dump_path: str = "",
                       use_macro_f1: bool = True) -> float:
        """doEval of the utterance-level models, with the submission CSV and
        the dump as the reference writes them for the utt granularity too
        (reference (Appendix)CCAC2023/train.py:166-196)."""
        return self._eval_only(test_ds, ckpt_dir, submission_template,
                               submission_out, pred_dump_path, use_macro_f1)


class DialogueTrainer(_SingleModelTrainer):
    """The dialogue-level experiments (--uttORdia dia, reference
    (Appendix)CCAC2023/train.py:100-194) over M3edDialogueDataset or
    MeldDialogueDataset.  One sample is one dialogue: the batch is
    trg_batch_size dialogues, without accumulation."""

    def _effective_batch(self) -> int:
        return max(self.cfg.optim.trg_batch_size, 1)

    def _new_model(self):
        from facialmmt_tpu_torch.models.dialogue import \
            DialogueMultiModalTransformer

        return DialogueMultiModalTransformer(self.cfg)

    def _steps(self, model):
        from facialmmt_tpu_torch.train.steps import (make_dialogue_eval_step,
                                                     make_dialogue_train_step)

        dtype = self.cfg.runtime.compute_dtype
        return (make_dialogue_train_step(model, compute_dtype=dtype,
                                         plan=self.plan),
                make_dialogue_eval_step(model, compute_dtype=dtype,
                                        plan=self.plan))

    def _predict(self, eval_step, ds, bsz: int):
        """(logits (U, C), labels (U,), mean loss) over the valid utterances
        of `ds`, selected by dia_mask in dataset order: the order the
        submission CSV expects (reference (Appendix)CCAC2023/
        train.py:162-186)."""
        loader = PrefetchLoader(ds.get_batch, len(ds), bsz, shuffle=False)
        logits_all, labels_all = [], []
        loss_sum, n_sum = 0.0, 0
        for batch, n_valid in loader.epoch(0):
            logits, loss = eval_step(self._batch_to_device(batch))
            logits = logits.float().cpu().numpy()[:n_valid]
            mask = np.asarray(batch["dia_mask"])[:n_valid].astype(bool)
            logits_all.append(logits[mask])
            labels_all.append(np.asarray(batch["labels"])[:n_valid][mask])
            loss_sum += float(loss) * n_valid
            n_sum += n_valid
        return (np.concatenate(logits_all), np.concatenate(labels_all),
                loss_sum / max(n_sum, 1))

    def run_dialogue(self, train_ds, valid_ds, test_ds,
                     use_macro_f1: bool = True, resume: bool = False,
                     on_event=None) -> float:
        """Train (see _SingleModelTrainer._run); returns the test F1."""
        return self._run(train_ds, valid_ds, test_ds,
                         use_macro_f1=use_macro_f1, resume=resume,
                         on_event=on_event)

    def eval_dialogue_only(self, test_ds, ckpt_dir: Optional[str] = None,
                           submission_template: str = "",
                           submission_out: str = "",
                           pred_dump_path: str = "",
                           use_macro_f1: bool = True) -> float:
        """doEval of the dialogue-level model (reference
        (Appendix)CCAC2023/train.py:156-194)."""
        return self._eval_only(test_ds, ckpt_dir, submission_template,
                               submission_out, pred_dump_path, use_macro_f1)
