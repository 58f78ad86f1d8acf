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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from facialmmt_tpu_torch.models.pipeline import FacialMMTPipeline
from facialmmt_tpu_torch.models.unimodal import MeldUttTransformer
from facialmmt_tpu_torch.train.optim import MultiTaskState, SingleTaskState


def cross_entropy(logits, labels):
    return F.cross_entropy(logits.float(), labels.long())


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
                               compute_dtype: str = "bfloat16"):
    """Returns step(state, batch, generator) -> loss.  batch carries the
    packed-face layout (models/pipeline.py) plus 'labels'."""

    def step(state: MultiTaskState, batch, generator=None):
        model.train()
        with compute_context(_device(model), compute_dtype):
            logits = model(batch, generator=generator,
                           stop_swin_gradient=not swin_from_target)
        loss = cross_entropy(logits, batch["labels"])
        loss.backward()
        _apply_target_updates(state, swin_from_target)
        return loss.detach()

    return step


def make_multimodal_train_step_accum(model: FacialMMTPipeline, *,
                                     swin_from_target: bool = True,
                                     compute_dtype: str = "bfloat16"):
    """Microbatch gradient-accumulation variant of the target step (the
    reference's trg_accumulation_steps, main.py:60 + train.py:137-145): the
    batch arrives with a leading microbatch axis M, the microbatches run one
    after another and their gradients are averaged, so only one microbatch's
    activations are live.  This is what lets joint training
    (swin_from_target=True: a Swin backward over every face) fit device
    memory at the full effective batch.  BatchNorm statistics update
    sequentially per microbatch."""

    def step(state: MultiTaskState, batches, generator=None):
        model.train()
        m = next(iter(batches.values())).shape[0]
        total = 0.0
        for i in range(m):
            micro = {k: v[i] for k, v in batches.items()}
            with compute_context(_device(model), compute_dtype):
                logits = model(micro, generator=generator,
                               stop_swin_gradient=not swin_from_target)
            loss = cross_entropy(logits, micro["labels"]) / m
            loss.backward()                    # .grad accumulates the mean
            total = total + loss.detach()
        _apply_target_updates(state, swin_from_target)
        return total

    return step


def _apply_target_updates(state: MultiTaskState, swin_from_target: bool):
    state.mm_opt.step()
    state.mm_step += 1
    if swin_from_target:
        state.swin_opt.step()
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
                              compute_dtype: str = "bfloat16"):
    """Returns step(batch, generator) -> (logits, loss).  The reference
    SAMPLES gumbel noise at eval (src/models.py:31-32 under torch.no_grad)
    unless runtime.deterministic_gumbel.  face_chunk > 0 runs Swin in tiles
    and feeds the model the precomputed 'face_probs'."""

    @torch.no_grad()
    def step(batch, generator=None):
        model.eval()
        with compute_context(_device(model), compute_dtype):
            probs = chunked_fer_probs(model, batch["faces"], generator,
                                      face_chunk)
            if probs is not None:
                batch = dict(batch, face_probs=probs)
            logits = model(batch, generator=generator)
        return logits, cross_entropy(logits, batch["labels"])

    return step


# ---------------------------------------------------------- auxiliary task --

def make_aux_train_step(model: FacialMMTPipeline, *,
                        compute_dtype: str = "bfloat16"):
    """FER auxiliary step over Aff-Wild2 image batches (reference
    train.py:15-42): returns step(state, images, labels, generator) -> loss.
    Only the Swin branch is updated."""

    def step(state: MultiTaskState, images, labels, generator=None, keeps=None):
        model.train()
        with compute_context(_device(model), compute_dtype):
            logits = model.aux_logits(images, generator=generator, keeps=keeps)
        loss = cross_entropy(logits, labels)
        loss.backward()
        state.swin_opt.step()
        state.swin_step += 1
        return loss.detach()

    return step


# ------------------------------------------------------------ unimodal task --

def make_unimodal_train_step(model: MeldUttTransformer, *,
                             compute_dtype: str = "bfloat16"):
    """V-only step (reference train.py:245-270): returns
    step(state, feats, mask, labels, generator) -> loss."""

    def step(state: SingleTaskState, feats, mask, labels, generator=None):
        model.train()
        with compute_context(_device(model), compute_dtype):
            logits = model(feats, mask, generator)
        loss = cross_entropy(logits, labels)
        loss.backward()
        state.opt.step()
        state.step += 1
        return loss.detach()

    return step


def make_unimodal_eval_step(model: MeldUttTransformer, *,
                            compute_dtype: str = "bfloat16"):
    """Returns step(feats, mask, labels) -> (logits, loss)."""

    @torch.no_grad()
    def step(feats, mask, labels):
        model.eval()
        with compute_context(_device(model), compute_dtype):
            logits = model(feats, mask)
        return logits, cross_entropy(logits, labels)

    return step


# ------------------------------------------------------- dialogue-level task --

def masked_cross_entropy(logits, labels, mask):
    """Mean cross-entropy over the valid utterances only, the reference's
    masked_select then CE over (num_valid_utt, C) ((Appendix)CCAC2023 train
    loop)."""
    ce = F.cross_entropy(logits.float().flatten(0, -2),
                         labels.long().flatten(), reduction="none")
    m = mask.float().flatten()
    return (ce * m).sum() / torch.clamp(m.sum(), min=1.0)


def _dialogue_logits(model, batch, generator=None):
    return model(batch["dia_input_ids"], batch["dia_input_mask"],
                 batch["dia_sep_mask"], batch["audio_inputs"],
                 batch["audio_mask"], batch["vision_inputs"],
                 batch["vision_mask"], batch["dia_mask"], generator=generator)


def make_dialogue_train_step(model, *, compute_dtype: str = "bfloat16"):
    """Step of DialogueMultiModalTransformer (models/dialogue.py): returns
    step(state, batch, generator) -> loss over a SingleTaskState."""

    def step(state: SingleTaskState, batch, generator=None):
        model.train()
        with compute_context(_device(model), compute_dtype):
            logits = _dialogue_logits(model, batch, generator)
        loss = masked_cross_entropy(logits, batch["labels"], batch["dia_mask"])
        loss.backward()
        state.opt.step()
        state.step += 1
        return loss.detach()

    return step


def make_dialogue_eval_step(model, *, compute_dtype: str = "bfloat16"):
    """Returns step(batch) -> (logits (B, D, C), masked mean loss)."""

    @torch.no_grad()
    def step(batch):
        model.eval()
        with compute_context(_device(model), compute_dtype):
            logits = _dialogue_logits(model, batch)
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


def make_text_train_step(model, *, compute_dtype: str = "bfloat16"):
    """Step of the feature-modality paths (choice_modality 'T', and 'T+A' /
    'T+V' / 'T+A+V' on precomputed features: the unused towers are not
    built, models/multimodal.py): returns step(state, batch, generator) ->
    loss over a SingleTaskState."""

    def step(state: SingleTaskState, batch, generator=None):
        model.train()
        with compute_context(_device(model), compute_dtype):
            logits = _text_logits(model, batch, generator)
        loss = cross_entropy(logits, batch["labels"])
        loss.backward()
        state.opt.step()
        state.step += 1
        return loss.detach()

    return step


def make_text_eval_step(model, *, compute_dtype: str = "bfloat16"):
    """Returns step(batch) -> (logits, loss)."""

    @torch.no_grad()
    def step(batch):
        model.eval()
        with compute_context(_device(model), compute_dtype):
            logits = _text_logits(model, batch)
        return logits, cross_entropy(logits, batch["labels"])

    return step
