"""The epoch loop of the multi-task T+A+V run (counterpart of
facialmmt_tpu/train/trainer.py; reference train.py:297-435).

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

Not ported yet: checkpoint files, resume and preemption (the best model is
kept as a host copy of the state_dict in memory), the pretrained-tower grafts,
multi-device placement.  Datasets are any objects with the protocol of
data/meld.py.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from facialmmt_tpu_torch.config import FacialMMTConfig
from facialmmt_tpu_torch.data.image_pipeline import (affwild2_train_augment,
                                                     meld_face_eval_transform,
                                                     meld_face_train_augment)
from facialmmt_tpu_torch.data.loader import PrefetchLoader
from facialmmt_tpu_torch.data.meld import FaceCapacityError
from facialmmt_tpu_torch.models.pipeline import (FacialMMTPipeline,
                                                 build_pipeline)
from facialmmt_tpu_torch.ops.kernels import resolve_device
from facialmmt_tpu_torch.train.metrics import eval_meld
from facialmmt_tpu_torch.train.optim import MultiTaskState
from facialmmt_tpu_torch.train.steps import (make_aux_train_step,
                                             make_multimodal_eval_step,
                                             make_multimodal_train_step,
                                             make_multimodal_train_step_accum)


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


def _log_train(task: str, epoch: int, batch: int, num_batches: int,
               ms_per_batch: float, loss: float):
    """Reference-format train line (reference train.py:39-40, 149-150)."""
    print(f"**{task}** | Epoch {epoch:2d} | Batch {batch:3d}/"
          f"{num_batches:3d} | Time/Batch(ms) {ms_per_batch:5.2f} | "
          f"Train Loss {loss:5.4f}")


def _log_pass(task: str, epoch: int, hours: float, tail: str = ""):
    print("-" * 50)
    print(f"**{task}** | Epoch {epoch:2d} | Time {hours:5.4f} hour{tail}")
    print("-" * 50)


def _host_state_dict(model) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", copy=True)
            for k, v in model.state_dict().items()}


class Trainer:
    def __init__(self, cfg: FacialMMTConfig, device="cuda"):
        """`device` defaults to the card; without a CUDA device the
        constructor raises (pass "cpu" to train on the CPU)."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.generator = torch.Generator(self.device).manual_seed(
            cfg.runtime.seed)
        self.history: list = []       # per epoch: val_f1, val_loss
        self.best_epoch = 0
        self.best_state: Optional[Dict[str, torch.Tensor]] = None
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

    def run_multimodal(self, aux_ds, train_ds, valid_ds, test_ds,
                       state_dict=None, resume: bool = False,
                       on_event=None) -> float:
        """T+A+V multi-task training (reference train.py:297-421); returns the
        test weighted F1 of the best-validation model.  `state_dict` holds the
        starting weights (None: random from runtime.seed).  `on_event(name,
        **info)`, when given, is called after every step ('aux_step',
        'trg_step': epoch, index, loss), after every pass ('aux_pass',
        'trg_pass', 'valid': epoch) and once before the first ('start'), for
        measurement and inspection; self.state holds the model by then."""
        notify = on_event or (lambda name, **info: None)
        if resume:
            raise NotImplementedError(
                "resume needs the checkpoint files, which are not ported yet")
        cfg, opt = self.cfg, self.cfg.optim
        model = self._build_model(state_dict)
        state, steps_per_epoch, trg_bsz = self._init_multitask_state(
            model, train_ds, len(aux_ds))
        self.state = state
        aux_step, trg_step, eval_step, use_micro = self._make_steps(model)
        trg_loader = self._target_loader(train_ds, trg_bsz, use_micro)
        aux_bsz = opt.aux_batch_size * max(opt.aux_accumulation_steps, 1)
        aux_loader = PrefetchLoader(aux_ds.get_batch, len(aux_ds), aux_bsz,
                                    shuffle=True, seed=cfg.runtime.seed + 1)

        notify("start")
        best_f1 = -1.0
        best_val_loss = float("inf")  # early stopping (appendix train.py:114-152)
        patience_counter = 0
        self.history = []
        for epoch in range(1, opt.num_epochs + 1):
            # ---- auxiliary FER pass (reference train.py:356-363) ----
            start = time.time()
            timer = StepTimer()
            for i, ((images, labels), n_valid) in enumerate(
                    aux_loader.epoch(epoch)):
                images = affwild2_train_augment(
                    self.generator, self._to_device(images).float(),
                    img_size=cfg.data.swin_img_size)
                loss = aux_step(state, images, self._to_device(labels),
                                self.generator)
                timer.update(float(loss), n_valid)
                notify("aux_step", epoch=epoch, index=i, loss=float(loss))
                if i % cfg.runtime.aux_log_interval == 0 and i > 0:
                    ms, avg = timer.interval_stats(cfg.runtime.aux_log_interval)
                    _log_train("SRC", epoch, i, len(aux_loader), ms, avg)
                    timer.reset()
            _log_pass("SRC", epoch, (time.time() - start) / 3600)
            notify("aux_pass", epoch=epoch)

            # ---- target multimodal pass (reference train.py:364-374) ----
            start = time.time()
            timer = StepTimer()
            for i, (batch, n_valid) in enumerate(trg_loader.epoch(epoch)):
                device_batch = self._prepare_faces(batch, train=True)
                loss = trg_step(state, device_batch, self.generator)
                timer.update(float(loss), n_valid)
                notify("trg_step", epoch=epoch, index=i, loss=float(loss))
                if i % cfg.runtime.trg_log_interval == 0 and i > 0:
                    ms, avg = timer.interval_stats(cfg.runtime.trg_log_interval)
                    _log_train("TRG", epoch, i, steps_per_epoch, ms, avg)
                    timer.reset()
            notify("trg_pass", epoch=epoch)
            logits, labels, val_loss = self._eval_multimodal(
                eval_step, valid_ds, return_loss=True)
            val_f1 = eval_meld(logits, labels, test=False)
            _log_pass("TRG", epoch, (time.time() - start) / 3600,
                      f" | val_wg_av_f1 {val_f1:5.4f} ")
            self.history.append({"epoch": epoch, "val_f1": val_f1,
                                 "val_loss": val_loss})
            notify("valid", epoch=epoch)
            if val_f1 > best_f1:
                best_f1 = val_f1
                self.best_epoch = epoch
                self.best_state = _host_state_dict(model)
            if opt.patience > 0:  # appendix early stopping on val loss
                if val_loss < best_val_loss:
                    best_val_loss = val_loss
                    patience_counter = 0
                else:
                    patience_counter += 1
                if patience_counter >= opt.patience:
                    print(f"Validation loss has not descended for "
                          f"{opt.patience} epochs. Stopping training.")
                    break

        if self.best_state is not None:
            model.load_state_dict(self.best_state, strict=True)
        logits, labels = self._eval_multimodal(eval_step, test_ds)
        test_f1 = eval_meld(logits, labels, test=True)
        print(f"**TEST** | wg_av_f1 {test_f1:5.4f} ")
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
        print(f"**TEST** | wg_av_f1 {test_f1:5.4f} ")
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
