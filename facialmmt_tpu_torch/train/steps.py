"""Train and eval steps of the multi-task T+A+V run, the V-only model and the
appendix's text-feature and dialogue-level models (counterpart of
facialmmt_tpu/train/steps.py).

Each make_* returns a step function over a MultiTaskState or, for the
single-model tasks, a SingleTaskState (train/optim.py), which is updated in
place.  Reference semantics preserved:
  * the target-task step leaves Swin's weights alone (two-optimizer coupling,
    reference train.py:305-340) unless joint training is enabled; without
    joint training the Swin pass runs without a graph;
  * Swin's BatchNorm running statistics DO update during the target task
    (reference multimodal_train calls shareSwin_model.train(), train.py:47);
  * loss is mean cross-entropy (torch nn.CrossEntropyLoss default); the
    dialogue-level model's is the mean over the utterances its dia_mask
    keeps.
On a CUDA device the forward runs under bf16 autocast (fp32 parameters,
BatchNorm statistics and AdamW moments); on the CPU everything is fp32.

Every make_* takes an optional mesh `plan` (parallel/mesh.py).  A step is
given the GLOBAL batch, the same on every rank.  When dp > 1 divides every
leading axis, each rank runs its rows under the plan's data shard
(parallel/context.py) and a loss is this rank's share of the global mean
(its sum over the global count), so the gradients summed over the data
ranks are those of the global batch, as JAX's mean over a sharded batch;
the optimizer sums them (train/optim.py).  Otherwise the pass runs whole on
every rank, its gradients are not summed, and a line says so once per
step function (JAX's _place_batch_best_effort).  Returned losses are the
global ones on every rank; eval steps return the global logits.
"""

from __future__ import annotations

from contextlib import nullcontext

import torch
import torch.nn.functional as F

from facialmmt_tpu_torch.models.pipeline import FacialMMTPipeline
from facialmmt_tpu_torch.models.unimodal import MeldUttTransformer
from facialmmt_tpu_torch.train.optim import MultiTaskState, SingleTaskState
from facialmmt_tpu_torch.utils.observability import trace_span


def backward(loss) -> None:
    """loss.backward().  Under NaN debugging (utils/observability.py::
    enable_nan_debugging) anomaly mode reports a backward Function that
    returned a NaN as a RuntimeError; it is raised as FloatingPointError, as
    `jax_debug_nans` raises, naming the Function.  The span
    `fmmt.train.backward`."""
    try:
        with trace_span("fmmt.train.backward"):
            loss.backward()
    except RuntimeError as e:
        if "returned nan values" not in str(e):
            raise
        raise FloatingPointError(str(e)) from e


def cross_entropy(logits, labels):
    return F.cross_entropy(logits.float(), labels.long())


class _Split:
    """Whether a step's pass splits over the data ranks of `plan`."""

    def __init__(self, plan, what: str):
        self.plan = plan if plan is not None and plan.dp > 1 else None
        self.what = what
        self.warned = False

    def __call__(self, tree, axis: int = 0) -> bool:
        if self.plan is None:
            return False
        leaves = tree.values() if isinstance(tree, dict) else tree
        sizes = {t.shape[axis] for t in leaves}
        if all(n % self.plan.dp == 0 for n in sizes):
            return True
        if not self.warned:
            self.warned = True
            if self.plan.is_main:
                print(f"parallel plan: batch axis {sorted(sizes)} not "
                      f"divisible by dp={self.plan.dp}; the {self.what} "
                      f"pass runs whole on every rank (size the batch to a "
                      f"dp multiple for data parallelism)")
        return False

    def shard(self, tree, split: bool, axis: int = 0):
        if not split:
            return tree
        from facialmmt_tpu_torch.parallel.mesh import shard_batch

        return shard_batch(self.plan, tree, axis)

    def context(self, split: bool):
        return self.plan.data_shard() if split else nullcontext()

    def mean(self, total, count, split: bool):
        """total / count; split: both are this rank's part of a global sum
        (the count is summed over the data ranks, the total is not)."""
        count = torch.as_tensor(count, dtype=torch.float32,
                                device=total.device)
        if split:
            from facialmmt_tpu_torch.parallel.comm import all_reduce_

            count = all_reduce_(count.clone(), self.plan.data_group)
        return total / torch.clamp(count, min=1.0)

    def report(self, loss, split: bool):
        """The global loss from this rank's share."""
        if not split:
            return loss.detach()
        from facialmmt_tpu_torch.parallel.comm import all_reduce_

        return all_reduce_(loss.detach().clone(), self.plan.data_group)

    def gather(self, logits, split: bool):
        if not split:
            return logits
        from facialmmt_tpu_torch.parallel.comm import all_gather_cat

        return all_gather_cat(logits, self.plan.data_group)


def _ce_sum(logits, labels):
    return F.cross_entropy(logits.float(), labels.long(), reduction="sum")


def _ce(split: _Split, logits, labels, on: bool):
    """Mean cross-entropy; under a split, this rank's share of the global
    mean."""
    if not on:
        return cross_entropy(logits, labels)
    return split.mean(_ce_sum(logits, labels), labels.shape[0], True)


def compute_context(device: torch.device, compute_dtype: str = "bfloat16"):
    """Autocast to `compute_dtype` on a CUDA device; fp32 on the CPU."""
    enabled = device.type == "cuda" and compute_dtype == "bfloat16"
    return torch.autocast(device_type=device.type, dtype=torch.bfloat16,
                          enabled=enabled)


def _device(model) -> torch.device:
    return next(model.parameters()).device


# ------------------------------------------------------------- target task --

def make_multimodal_train_step(model: FacialMMTPipeline, *,
                               swin_from_target: bool = False,
                               compute_dtype: str = "bfloat16", plan=None):
    """Returns step(state, batch, generator) -> loss.  batch carries the
    packed-face layout (models/pipeline.py) plus 'labels'.  Spans: the
    forward and loss `fmmt.train.forward`, then backward(), then the
    optimizer's (train/optim.py)."""
    split = _Split(plan, "target")

    def step(state: MultiTaskState, batch, generator=None):
        model.train()
        on = split(batch)
        with trace_span("fmmt.train.forward"):
            local = split.shard(batch, on)
            with split.context(on), compute_context(_device(model),
                                                    compute_dtype):
                logits = model(local, generator=generator,
                               stop_swin_gradient=not swin_from_target)
            loss = _ce(split, logits, local["labels"], on)
        backward(loss)
        _apply_target_updates(state, swin_from_target, on)
        return split.report(loss, on)

    return step


def make_multimodal_train_step_accum(model: FacialMMTPipeline, *,
                                     swin_from_target: bool = True,
                                     compute_dtype: str = "bfloat16",
                                     plan=None):
    """Microbatch gradient-accumulation variant of the target step (the
    reference's trg_accumulation_steps, main.py:60 + train.py:137-145): the
    batch arrives with a leading microbatch axis M, the microbatches run one
    after another and their gradients are averaged, so only one microbatch's
    activations are live.  This is what lets joint training
    (swin_from_target=True: a Swin backward over every face) fit device
    memory at the full effective batch.  BatchNorm statistics update
    sequentially per microbatch.  Spans: a forward and a backward a
    microbatch, as make_multimodal_train_step's."""

    split = _Split(plan, "target")

    def step(state: MultiTaskState, batches, generator=None):
        model.train()
        m = next(iter(batches.values())).shape[0]
        on = split(batches, axis=1)
        total = 0.0
        for i in range(m):
            with trace_span("fmmt.train.forward"):
                micro = split.shard({k: v[i] for k, v in batches.items()},
                                    on)
                with split.context(on), compute_context(_device(model),
                                                        compute_dtype):
                    logits = model(micro, generator=generator,
                                   stop_swin_gradient=not swin_from_target)
                loss = _ce(split, logits, micro["labels"], on) / m
            backward(loss)                     # .grad accumulates the mean
            total = total + split.report(loss, on)
        _apply_target_updates(state, swin_from_target, on)
        return total

    return step


def _apply_target_updates(state: MultiTaskState, swin_from_target: bool,
                          sync: bool = True):
    state.mm_opt.step(sync)
    state.mm_step += 1
    if swin_from_target:
        state.swin_opt.step(sync)
        state.swin_step += 1
    else:
        # target-task gradients never reach Swin (its pass ran without a
        # graph); make sure none linger from elsewhere
        state.swin_opt.adamw.zero_grad(set_to_none=True)


@torch.no_grad()
def chunked_fer_probs(model: FacialMMTPipeline, faces, generator,
                      face_chunk: int):
    """Run Swin FER over the packed-face axis in tiles of `face_chunk`, so
    only one tile's activations are live.  Returns (N, num_labels) FER
    distributions, or None when chunking does not apply (N <= chunk)."""
    n = faces.shape[0]
    if not face_chunk or n <= face_chunk:
        return None
    return torch.cat([model.fer_probs(faces[i:i + face_chunk],
                                      generator=generator)
                      for i in range(0, n, face_chunk)])


def make_multimodal_eval_step(model: FacialMMTPipeline, *, face_chunk: int = 0,
                              compute_dtype: str = "bfloat16", plan=None):
    """Returns step(batch, generator) -> (logits, loss).  The reference
    SAMPLES gumbel noise at eval (src/models.py:31-32 under torch.no_grad)
    unless runtime.deterministic_gumbel.  face_chunk > 0 runs Swin in tiles
    and feeds the model the precomputed 'face_probs'."""
    split = _Split(plan, "eval")

    @torch.no_grad()
    def step(batch, generator=None):
        model.eval()
        on = split(batch)
        local = split.shard(batch, on)
        with split.context(on), compute_context(_device(model),
                                                compute_dtype):
            probs = chunked_fer_probs(model, local["faces"], generator,
                                      face_chunk)
            if probs is not None:
                local = dict(local, face_probs=probs)
            logits = split.gather(model(local, generator=generator), on)
        return logits, cross_entropy(logits, batch["labels"])

    return step


# ---------------------------------------------------------- auxiliary task --

def make_aux_train_step(model: FacialMMTPipeline, *,
                        compute_dtype: str = "bfloat16", plan=None):
    """FER auxiliary step over Aff-Wild2 image batches (reference
    train.py:15-42): returns step(state, images, labels, generator) -> loss.
    Only the Swin branch is updated.  `keeps` (the drop-path multipliers of
    ops/swin.py, drawn for the whole batch) override the draw.  Spans as
    make_multimodal_train_step's."""
    split = _Split(plan, "auxiliary")

    def step(state: MultiTaskState, images, labels, generator=None, keeps=None):
        model.train()
        on = split([images, labels])
        with trace_span("fmmt.train.forward"):
            images, labels = split.shard([images, labels], on)
            if keeps is not None and on:
                keeps = [tuple(None if k is None else split.shard(k, True)
                               for k in pair) for pair in keeps]
            with split.context(on), compute_context(_device(model),
                                                    compute_dtype):
                logits = model.aux_logits(images, generator=generator,
                                          keeps=keeps)
            loss = _ce(split, logits, labels, on)
        backward(loss)
        state.swin_opt.step(on)
        state.swin_step += 1
        return split.report(loss, on)

    return step


# ------------------------------------------------------------ unimodal task --

def make_unimodal_train_step(model: MeldUttTransformer, *,
                             compute_dtype: str = "bfloat16", plan=None):
    """V-only step (reference train.py:245-270): returns
    step(state, feats, mask, labels, generator) -> loss."""
    split = _Split(plan, "target")

    def step(state: SingleTaskState, feats, mask, labels, generator=None):
        model.train()
        on = split([feats, mask, labels])
        feats, mask, labels = split.shard([feats, mask, labels], on)
        with split.context(on), compute_context(_device(model),
                                                compute_dtype):
            logits = model(feats, mask, generator)
        loss = _ce(split, logits, labels, on)
        backward(loss)
        state.opt.step(on)
        state.step += 1
        return split.report(loss, on)

    return step


def make_unimodal_eval_step(model: MeldUttTransformer, *,
                            compute_dtype: str = "bfloat16", plan=None):
    """Returns step(feats, mask, labels) -> (logits, loss)."""
    split = _Split(plan, "eval")

    @torch.no_grad()
    def step(feats, mask, labels):
        model.eval()
        on = split([feats, mask, labels])
        f, m = split.shard([feats, mask], on)
        with split.context(on), compute_context(_device(model),
                                                compute_dtype):
            logits = split.gather(model(f, m), on)
        return logits, cross_entropy(logits, labels)

    return step


# ------------------------------------------------------- dialogue-level task --

def _masked_ce_parts(logits, labels, mask):
    """(sum of the valid utterances' cross-entropy, their count)."""
    ce = F.cross_entropy(logits.float().flatten(0, -2),
                         labels.long().flatten(), reduction="none")
    m = mask.float().flatten()
    return (ce * m).sum(), m.sum()


def masked_cross_entropy(logits, labels, mask):
    """Mean cross-entropy over the valid utterances only, the reference's
    masked_select then CE over (num_valid_utt, C) ((Appendix)CCAC2023 train
    loop)."""
    total, count = _masked_ce_parts(logits, labels, mask)
    return total / torch.clamp(count, min=1.0)


def _dialogue_logits(model, batch, generator=None):
    return model(batch["dia_input_ids"], batch["dia_input_mask"],
                 batch["dia_sep_mask"], batch["audio_inputs"],
                 batch["audio_mask"], batch["vision_inputs"],
                 batch["vision_mask"], batch["dia_mask"], generator=generator)


def make_dialogue_train_step(model, *, compute_dtype: str = "bfloat16",
                             plan=None):
    """Step of DialogueMultiModalTransformer (models/dialogue.py): returns
    step(state, batch, generator) -> loss over a SingleTaskState.  Under a
    split the mean is over the valid utterances of the GLOBAL batch (the
    ranks hold different numbers of them).  Spans as
    make_multimodal_train_step's."""
    split = _Split(plan, "target")

    def step(state: SingleTaskState, batch, generator=None):
        model.train()
        on = split(batch)
        with trace_span("fmmt.train.forward"):
            local = split.shard(batch, on)
            with split.context(on), compute_context(_device(model),
                                                    compute_dtype):
                logits = _dialogue_logits(model, local, generator)
            if on:
                total, count = _masked_ce_parts(logits, local["labels"],
                                                local["dia_mask"])
                loss = split.mean(total, count, True)
            else:
                loss = masked_cross_entropy(logits, local["labels"],
                                            local["dia_mask"])
        backward(loss)
        state.opt.step(on)
        state.step += 1
        return split.report(loss, on)

    return step


def make_dialogue_eval_step(model, *, compute_dtype: str = "bfloat16",
                            plan=None):
    """Returns step(batch) -> (logits (B, D, C), masked mean loss)."""
    split = _Split(plan, "eval")

    @torch.no_grad()
    def step(batch):
        model.eval()
        on = split(batch)
        with split.context(on), compute_context(_device(model),
                                                compute_dtype):
            logits = split.gather(
                _dialogue_logits(model, split.shard(batch, on)), on)
        return logits, masked_cross_entropy(logits, batch["labels"],
                                            batch["dia_mask"])

    return step


# ------------------------------------- feature-modality task (T, T+A, T+V) --

def _feature_kwargs(batch):
    """The precomputed-feature streams a batch carries (M3ED-style: vision is
    the raw extractor features, no faces or FER branch; reference
    (Appendix)CCAC2023/utils/dataset.py:165-302)."""
    return {k: batch[k] for k in ("audio_inputs", "audio_mask",
                                  "vision_inputs", "vision_mask")
            if k in batch}


def _text_logits(model, batch, generator=None):
    return model(batch["dia_input_ids"], batch["dia_input_mask"],
                 batch["dia_sep_mask"], utt_in_dia_idx=batch["utt_in_dia_idx"],
                 dia_idx=batch.get("dia_idx"), generator=generator,
                 **_feature_kwargs(batch))


def make_text_train_step(model, *, compute_dtype: str = "bfloat16",
                         plan=None):
    """Step of the feature-modality paths (choice_modality 'T', and 'T+A' /
    'T+V' / 'T+A+V' on precomputed features: the unused towers are not
    built, models/multimodal.py): returns step(state, batch, generator) ->
    loss over a SingleTaskState."""
    split = _Split(plan, "target")

    def step(state: SingleTaskState, batch, generator=None):
        model.train()
        on = split(batch)
        local = split.shard(batch, on)
        with split.context(on), compute_context(_device(model),
                                                compute_dtype):
            logits = _text_logits(model, local, generator)
        loss = _ce(split, logits, local["labels"], on)
        backward(loss)
        state.opt.step(on)
        state.step += 1
        return split.report(loss, on)

    return step


def make_text_eval_step(model, *, compute_dtype: str = "bfloat16",
                        plan=None):
    """Returns step(batch) -> (logits, loss)."""
    split = _Split(plan, "eval")

    @torch.no_grad()
    def step(batch):
        model.eval()
        on = split(batch)
        with split.context(on), compute_context(_device(model),
                                                compute_dtype):
            logits = split.gather(_text_logits(model, split.shard(batch, on)),
                                  on)
        return logits, cross_entropy(logits, batch["labels"])

    return step
