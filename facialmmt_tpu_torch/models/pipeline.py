"""End-to-end FacialMMT forward (counterpart of
facialmmt_tpu/models/pipeline.py): Swin FER over the packed faces,
gumbel-softmax, scatter to per-utterance slots, the frame-importance filter,
then the fusion model (T+A+V, or the appendix's T+A and T+V, whose FER
branch runs all the same, as in JAX).  The module's train / eval mode
selects dropout, stochastic depth and BatchNorm batch statistics.

Faces arrive packed contiguously in a static-capacity buffer `faces`
(N, H, W, 3) with `face_utt_id` / `face_pos` slot maps (-1 = pad slot).

Under a data shard (parallel/context.py) every leading axis holds this
rank's rows: its utterances, dialogue slots and faces, each shard of the
global batch taken apart, as JAX shards them; a rank's faces need not
belong to its utterances.  Swin runs over the rank's faces, the FER
distributions and slot maps of all ranks are gathered (the gather's backward
sums over the data ranks), and the scatter keeps the rank's utterances.
"""

from __future__ import annotations

from contextlib import nullcontext

import numpy as np
import torch
from torch import nn

from facialmmt_tpu_torch.config import FacialMMTConfig
from facialmmt_tpu_torch.models.multimodal import \
    MultiModalTransformerForClassification
from facialmmt_tpu_torch.models.swin_fer import SwinForAffwildClassification
from facialmmt_tpu_torch.ops.frame_filter import (frame_importance_filter,
                                                  scatter_face_probs)
from facialmmt_tpu_torch.parallel import context
from facialmmt_tpu_torch.utils.observability import trace_span


class FacialMMTPipeline(nn.Module):
    """Two branches, `swin_model` and `multimodal`, as in the JAX package and
    the reference's two released checkpoints."""

    def __init__(self, cfg: FacialMMTConfig):
        super().__init__()
        self.cfg = cfg
        self.swin_model = SwinForAffwildClassification(cfg)
        self.multimodal = MultiModalTransformerForClassification(cfg)

    def fer_probs(self, faces, *, generator: torch.Generator | None = None,
                  noise: torch.Tensor | None = None,
                  attention_impl: str | None = None):
        """Frame-level FER distributions (N, num_labels) for packed faces.
        `attention_impl` overrides swin.attention_impl for this call.  (The
        JAX pipeline resolves 'auto' to a grad-bearing variant per call; the
        port's 'auto' route is one autograd Function for both, so nothing is
        resolved here.)"""
        with trace_span("fmmt.model.swin"):
            return self.swin_model(faces, is_trg_task=True,
                                   generator=generator, noise=noise,
                                   attention_impl=attention_impl)

    def aux_logits(self, images, *, generator: torch.Generator | None = None,
                   keeps=None, attention_impl: str | None = None):
        """Auxiliary FER logits (N, num_labels) for an image batch."""
        with trace_span("fmmt.model.swin"):
            return self.swin_model(images, is_trg_task=False,
                                   generator=generator, keeps=keeps,
                                   attention_impl=attention_impl)

    def forward(self, batch, *, generator: torch.Generator | None = None,
                noise: torch.Tensor | None = None,
                stop_swin_gradient: bool = False):
        """batch: dict of tensors (the packed-face layout).  `generator` or
        `noise` feed the sampled gumbel draw, `generator` also dropout and
        stochastic depth in train mode.  A precomputed 'face_probs' entry
        (N, num_labels) skips the Swin pass.  stop_swin_gradient runs the Swin
        pass without a graph: the reference computes the target task's gradients
        into Swin and then discards them (two-optimizer coupling, reference
        train.py:305-340), so cutting them here gives the same updates
        without the Swin backward.  Returns logits (B, num_labels)."""
        cfg = self.cfg
        b = batch["vision_feats"].shape[0]
        f = cfg.data.vision_utt_max_len
        probs_flat = batch.get("face_probs")
        if probs_flat is None:
            with torch.no_grad() if stop_swin_gradient else nullcontext():
                probs_flat = self.fer_probs(batch["faces"],
                                            generator=generator, noise=noise)
        with trace_span("fmmt.model.filter"):
            vision_concat, vision_mask = self._filter(batch, probs_flat, b, f)
        return self.multimodal(
            batch["dia_input_ids"], batch["dia_input_mask"],
            batch["dia_sep_mask"], batch["audio_inputs"], batch["audio_mask"],
            vision_concat, vision_mask,
            batch["utt_in_dia_idx"], batch.get("dia_idx"),
            generator=generator)

    def _filter(self, batch, probs_flat, b: int, f: int):
        """The FER distributions scattered to each utterance's face slots,
        then the frame-importance filter of its vision features, in their
        dtype: (features, mask)."""
        utt_id, pos = batch["face_utt_id"], batch["face_pos"]
        shard = context.current()
        if shard is None:
            probs = scatter_face_probs(probs_flat.float(), utt_id, pos, b, f)
        else:
            from facialmmt_tpu_torch.parallel.comm import gather_rows

            probs = scatter_face_probs(
                gather_rows(probs_flat.float(), shard.group),
                gather_rows(utt_id, shard.group),
                gather_rows(pos, shard.group), b * shard.parts, f
            ).narrow(0, shard.index * b, b)
        n_faces = batch["n_faces"]
        face_mask = (torch.arange(f, device=n_faces.device)[None, :]
                     < n_faces[:, None])
        feats, mask = frame_importance_filter(
            batch["vision_feats"], probs, face_mask,
            self.cfg.facial_emo_impor_threshold)
        return feats.to(batch["vision_feats"].dtype), mask


@torch.no_grad()
def init_random_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter and float buffer from `generator`, in place, for
    runs without a checkpoint: matrices ~ N(0, 0.02^2), vectors and biases 0,
    norm weights 1, the pooling query ~ N(0, 1), BatchNorm running stats
    (0, 1).  Index and mask buffers are geometry and stay as built."""
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if name.endswith("query_vector"):
            p.normal_(0.0, 1.0, generator=generator)
        elif p.dim() >= 2:
            p.normal_(0.0, 0.02, generator=generator)
        elif leaf == "weight":          # LayerNorm / BatchNorm scale
            p.fill_(1.0)
        else:
            p.zero_()
    for name, buf in model.named_buffers():
        if name.endswith("running_mean"):
            buf.zero_()
        elif name.endswith("running_var"):
            buf.fill_(1.0)
    return model


def build_pipeline(cfg: FacialMMTConfig, device: torch.device,
                   state_dict=None) -> FacialMMTPipeline:
    """The pipeline on `device`: `state_dict` holds its weights under the
    reference names (checkpoint/from_jax.py builds one from JAX variables;
    tensors or numpy arrays), None draws random weights from runtime.seed."""
    with torch.device(device):      # build the weights on the device
        model = FacialMMTPipeline(cfg)
    model.to(device)                # buffers made from numpy start on the host
    if state_dict is None:
        return init_random_(model, torch.Generator(device).manual_seed(
            cfg.runtime.seed))
    model.load_state_dict(
        {k: v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
         for k, v in state_dict.items()}, strict=True)
    return model
