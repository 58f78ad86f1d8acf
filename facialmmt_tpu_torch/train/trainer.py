"""The epoch loops of the multi-task T+A+V run and of the V-only model
(counterpart of facialmmt_tpu/train/trainer.py; reference train.py:245-435).

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
(utils/observability.py).

Not ported yet: multi-device placement.  Datasets are any objects with the
protocol of data/meld.py; the V-only loop takes MeldVisionDataset's.
"""

from __future__ import annotations

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
from facialmmt_tpu_torch.train.metrics import eval_meld
from facialmmt_tpu_torch.train.optim import MultiTaskState, SingleTaskState
from facialmmt_tpu_torch.train.steps import (make_aux_train_step,
                                             make_multimodal_eval_step,
                                             make_multimodal_train_step,
                                             make_multimodal_train_step_accum,
                                             make_unimodal_eval_step,
                                             make_unimodal_train_step)
from facialmmt_tpu_torch.utils.observability import MetricWriter
from facialmmt_tpu_torch.utils.preemption import (Preempted,
                                                  preemption_requested)

# buffers the model builds from its config (Swin's window index and shift
# mask) and BatchNorm's update counter: a graft leaves the model's own
_GEOMETRY = ("relative_position_index", "attn_mask", "num_batches_tracked")


def graft_subtree(model: torch.nn.Module, src: Mapping[str, torch.Tensor],
                  prefix: str, what: str) -> None:
    """Copy the pretrained tensors `src` (names relative to `prefix`) into
    the parameters and running statistics of `model` under `prefix`, after
    checking that both hold the same names with the same shapes: a
    wrong-dims checkpoint fails here, with the first six mismatches listed,
    before anything is copied.  The model keeps its dtypes (counterpart of
    the JAX package's graft_subtree)."""
    def own(name):
        return not name.endswith(_GEOMETRY)

    dst = {k[len(prefix):]: v for k, v in model.state_dict().items()
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


def _log_pass(task: str, epoch: int, hours: float):
    print("-" * 50)
    print(f"**{task}** | Epoch {epoch:2d} | Time {hours:5.4f} hour")
    print("-" * 50)


class Trainer:
    def __init__(self, cfg: FacialMMTConfig, device="cuda",
                 writer: Optional[MetricWriter] = None):
        """`device` defaults to the card; without a CUDA device the
        constructor raises (pass "cpu" to train on the CPU).  `writer`
        receives the progress records; by default they are printed only."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.writer = writer or MetricWriter()
        self.generator = torch.Generator(self.device).manual_seed(
            cfg.runtime.seed)
        self.history: list = []       # per epoch: val_f1, val_loss
        self.best_epoch = 0
        self.state: Optional[MultiTaskState] = None

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
        random weights from runtime.seed (models/pipeline.py)."""
        return build_pipeline(self.cfg, self.device, state_dict).float()

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
        if pretrained_swin is not None:
            graft_subtree(model, pretrained_swin, "swin_model.swin.",
                          "pretrained Swin backbone")
        text = self._pretrained_text_tower()
        if text is not None:
            tower = text_prefix(self.cfg) + "."
            graft_subtree(model, {k[len(tower):]: v for k, v in text.items()},
                          "multimodal." + tower, "text tower")

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
        state = MultiTaskState.create(model, opt, aux_total, mm_total)
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

    @staticmethod
    def _batch_with_escalation(fetch, buckets):
        """fetch(capacity) under each bucket until one fits."""
        for i, cap in enumerate(buckets):
            try:
                batch = fetch(cap)
            except FaceCapacityError as e:
                if i == len(buckets) - 1:
                    raise  # ceiling bucket: a real data/config inconsistency
                print(f"face capacity {cap} overflowed (need {e.required}); "
                      f"escalating to bucket {buckets[i + 1]}")
                continue
            return batch

    def _make_steps(self, model):
        cfg, opt = self.cfg, self.cfg.optim
        dtype = cfg.runtime.compute_dtype
        accum = max(opt.trg_accumulation_steps, 1)
        use_micro = cfg.swin_from_target and accum > 1
        aux_step = make_aux_train_step(model, compute_dtype=dtype)
        if use_micro:
            trg_step = make_multimodal_train_step_accum(
                model, swin_from_target=True, compute_dtype=dtype)
        else:
            trg_step = make_multimodal_train_step(
                model, swin_from_target=cfg.swin_from_target,
                compute_dtype=dtype)
        eval_step = make_multimodal_eval_step(
            model, face_chunk=cfg.runtime.eval_face_chunk, compute_dtype=dtype)
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
        it stops at the epoch an uninterrupted run would."""
        return {"model": state.model.state_dict(),
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
        state.model.load_state_dict(latest["model"], strict=True)
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
        one is complete) and raise Preempted."""
        if not preemption_requested():
            return
        path = ckpt.save_step(
            self._ckpt_payload(state, best_f1, epoch - 1, progress,
                               early_stop), epoch - 1)
        print(f"Preemption requested: resume checkpoint saved to {path}; "
              f"run again with resume=True to continue epoch {epoch}.")
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
                notify("aux_step", epoch=epoch, index=i, loss=float(loss))
                self._maybe_preempt(ckpt, state, best_f1, epoch,
                                    {"aux_batch": i + 1, "trg_batch": 0},
                                    early)
                if i % cfg.runtime.aux_log_interval == 0 and i > 0:
                    ms, avg = timer.interval_stats(cfg.runtime.aux_log_interval)
                    self.writer.log_train("SRC", epoch, i, len(aux_loader),
                                          ms, avg)
                    timer.reset()
            _log_pass("SRC", epoch, (time.time() - start) / 3600)
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
            val_f1 = eval_meld(logits, labels, test=False)
            self.writer.log_eval(epoch, (time.time() - start) / 3600, val_f1)
            self.history.append({"epoch": epoch, "val_f1": val_f1,
                                 "val_loss": val_loss})
            notify("valid", epoch=epoch)
            if val_f1 > best_f1:
                best_f1 = val_f1
                ckpt.save_best(model.state_dict(), epoch)
            # the early-stopping counters move BEFORE the epoch's resume
            # checkpoint, so a resumed run carries them
            if opt.patience > 0:  # appendix early stopping on val loss
                if val_loss < early["best_val_loss"]:
                    early["best_val_loss"] = val_loss
                    early["patience_counter"] = 0
                else:
                    early["patience_counter"] += 1
            ckpt.save_step(self._ckpt_payload(
                state, best_f1, epoch, {"aux_batch": 0, "trg_batch": 0},
                early), epoch)
            if opt.patience > 0 and early["patience_counter"] >= opt.patience:
                print(f"Validation loss has not descended for "
                      f"{opt.patience} epochs. Stopping training.")
                break

        self.best_epoch, best = ckpt.restore_best()
        model.load_state_dict(best, strict=True)
        logits, labels = self._eval_multimodal(eval_step, test_ds)
        test_f1 = eval_meld(logits, labels, test=True)
        self.writer.log_test(test_f1)
        return test_f1

    def eval_multimodal_only(self, state_dict, test_ds,
                             batch_size: int = 16) -> float:
        """Direct-eval path from a state_dict (reference train.py:424-434)."""
        cfg = self.cfg
        model = self._build_model(state_dict)
        eval_step = make_multimodal_eval_step(
            model, face_chunk=cfg.runtime.eval_face_chunk,
            compute_dtype=cfg.runtime.compute_dtype)
        logits, labels = self._eval_multimodal(eval_step, test_ds, batch_size)
        test_f1 = eval_meld(logits, labels, test=True)
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
            return init_random_(model, torch.Generator(self.device)
                                .manual_seed(self.cfg.runtime.seed))
        model.load_state_dict(state_dict, strict=True)
        return model

    def run_unimodal(self, train_ds, valid_ds, test_ds,
                     resume: bool = False) -> float:
        """V-only training (reference train.py:245-292, 342-349, 390-409);
        returns the test weighted F1 of the best-validation model.
        Checkpoints, preemption and resume=True as in run_multimodal, with
        the batch count of the interrupted epoch as its progress."""
        cfg, opt = self.cfg, self.cfg.optim
        model = self._build_unimodal()
        bsz = opt.trg_batch_size * opt.trg_accumulation_steps
        loader = PrefetchLoader(train_ds.get_batch, len(train_ds), bsz,
                                shuffle=True, seed=cfg.runtime.seed)
        steps_per_epoch = len(loader)
        state = SingleTaskState.create(model, opt,
                                       opt.num_epochs * steps_per_epoch)
        self.state = state
        dtype = cfg.runtime.compute_dtype
        train_step = make_unimodal_train_step(model, compute_dtype=dtype)
        eval_step = make_unimodal_eval_step(model, compute_dtype=dtype)

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
                self._maybe_preempt(ckpt, state, best_f1, epoch,
                                    {"batch": i + 1}, no_early_stop)
                if i % cfg.runtime.trg_log_interval == 0 and i > 0:
                    ms, avg = timer.interval_stats(cfg.runtime.trg_log_interval)
                    self.writer.log_train("TRG", epoch, i, steps_per_epoch,
                                          ms, avg)
                    timer.reset()
            logits, labels = self._eval_unimodal(eval_step, valid_ds)
            val_f1 = eval_meld(logits, labels, test=False)
            self.writer.log_eval(epoch, (time.time() - start) / 3600, val_f1)
            if val_f1 > best_f1:
                best_f1 = val_f1
                ckpt.save_best(model.state_dict(), epoch)
            ckpt.save_step(self._ckpt_payload(
                state, best_f1, epoch, {"batch": 0}, no_early_stop), epoch)

        self.best_epoch, best = ckpt.restore_best()
        model.load_state_dict(best, strict=True)
        logits, labels = self._eval_unimodal(eval_step, test_ds)
        test_f1 = eval_meld(logits, labels, test=True)
        self.writer.log_test(test_f1)
        return test_f1

    def eval_unimodal_only(self, state_dict, test_ds) -> float:
        """Direct-eval path from a released unimodal state_dict (reference
        train.py:431-434)."""
        model = self._build_unimodal(state_dict)
        eval_step = make_unimodal_eval_step(
            model, compute_dtype=self.cfg.runtime.compute_dtype)
        logits, labels = self._eval_unimodal(eval_step, test_ds)
        test_f1 = eval_meld(logits, labels, test=True)
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
