"""Optimizers, schedules and the multi-task train state (counterpart of
facialmmt_tpu/train/optim.py).

Reference recipe (train.py:305-349):
  * AdamW with decoupled weight decay applied to ALL params, incl. norms and
    biases (the reference never builds no-decay groups), eps 1e-6;
  * linear warmup (10% of total steps) then linear decay to zero;
  * global-norm clip 0.8 BEFORE the optimizer step, per optimizer;
  * TWO optimizers over disjoint parameter sets: the multimodal model (trg_lr,
    weight decay) and the shared Swin (aux_lr, no weight decay).  Swin learns
    only from the aux FER loss unless `swin_from_target` asks for joint
    training.

torch.optim.AdamW computes what optax.adamw does (p - lr * (m_hat / (sqrt(v_hat)
+ eps) + wd * p)).  Two things are written by hand because PyTorch's
utilities differ from optax:
  * the clip scales by clip / max(norm, clip), where
    torch.nn.utils.clip_grad_norm_ uses clip / (norm + 1e-6);
  * the schedule is read at the update count BEFORE the step (so the first
    step under warm-up runs at lr 0): LambdaLR set up at count 0 and stepped
    after the optimizer keeps that phase.
"""

from __future__ import annotations

from typing import Iterable

import torch

from facialmmt_tpu_torch.config import OptimConfig


def make_schedule(base_lr: float, total_steps: int, warm_up: float):
    """step -> lr: linear warmup then linear decay to zero
    (transformers.get_linear_schedule_with_warmup)."""
    warmup_steps = int(total_steps * warm_up)

    def schedule(step: int) -> float:
        if step < warmup_steps:
            factor = step / max(warmup_steps, 1)
        else:
            factor = (total_steps - step) / max(total_steps - warmup_steps, 1)
        return base_lr * min(max(factor, 0.0), 1.0)

    return schedule


def clip_by_global_norm_(grads: Iterable[torch.Tensor], clip: float):
    """Scale `grads` in place by clip / max(norm, clip) (optax's
    clip_by_global_norm); returns the norm before clipping."""
    grads = list(grads)
    norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
    scale = clip / torch.clamp(norm, min=clip)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return norm


class ClippedAdamW:
    """clip-by-global-norm -> AdamW under the warmup/decay schedule, over one
    parameter set, with the reference's hyperparameters."""

    def __init__(self, params, cfg: OptimConfig, base_lr: float,
                 total_steps: int, weight_decay: float = 0.0):
        self.params = list(params)
        self.clip = cfg.clip
        schedule = make_schedule(1.0, total_steps, cfg.warm_up)
        self.adamw = torch.optim.AdamW(
            self.params, lr=base_lr, betas=(cfg.adam_b1, cfg.adam_b2),
            eps=cfg.adam_eps, weight_decay=weight_decay)
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(self.adamw, schedule)

    def step(self):
        """One update from the parameters' .grad (a parameter without one
        counts as a zero gradient: it still decays), then the schedule moves
        on and the gradients are dropped."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        clip_by_global_norm_((p.grad for p in self.params), self.clip)
        self.adamw.step()
        self.scheduler.step()
        self.adamw.zero_grad(set_to_none=True)

    @property
    def lr(self) -> float:
        return self.adamw.param_groups[0]["lr"]

    def state_dict(self) -> dict:
        """AdamW's moments and step counts, and the schedule's position
        (LambdaLR's last_epoch: the update count the next step reads)."""
        return {"adamw": self.adamw.state_dict(),
                "schedule": self.scheduler.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.scheduler.load_state_dict(state["schedule"])

    def set_count(self, count: int) -> None:
        """Put the schedule at update count `count` (the moments' own step
        counts live in the AdamW state)."""
        self.scheduler.last_epoch = count
        for group, base, fn in zip(self.adamw.param_groups,
                                   self.scheduler.base_lrs,
                                   self.scheduler.lr_lambdas):
            group["lr"] = base * fn(count)


def make_optimizer(params, cfg: OptimConfig, base_lr: float, total_steps: int,
                   weight_decay: float = 0.0) -> ClippedAdamW:
    return ClippedAdamW(params, cfg, base_lr, total_steps, weight_decay)


class MultiTaskState:
    """Train state of the shared-Swin multi-task setup: the pipeline (its
    `swin_model` and `multimodal` branches hold the parameters and Swin's
    BatchNorm running statistics), one optimizer per branch, and how many
    updates each has taken."""

    def __init__(self, model, swin_opt: ClippedAdamW, mm_opt: ClippedAdamW):
        self.model = model
        self.swin_opt = swin_opt
        self.mm_opt = mm_opt
        self.swin_step = 0
        self.mm_step = 0

    @staticmethod
    def create(model, cfg: OptimConfig, swin_total_steps: int,
               mm_total_steps: int) -> "MultiTaskState":
        return MultiTaskState(
            model,
            make_optimizer(model.swin_model.parameters(), cfg, cfg.aux_lr,
                           max(swin_total_steps, 1)),
            make_optimizer(model.multimodal.parameters(), cfg, cfg.trg_lr,
                           max(mm_total_steps, 1), cfg.weight_decay))

    def state_dict(self) -> dict:
        """Both optimizers and both update counts; the model's parameters and
        running statistics travel in its own state_dict."""
        return {"swin_opt": self.swin_opt.state_dict(),
                "mm_opt": self.mm_opt.state_dict(),
                "swin_step": self.swin_step, "mm_step": self.mm_step}

    def load_state_dict(self, state: dict) -> None:
        self.swin_opt.load_state_dict(state["swin_opt"])
        self.mm_opt.load_state_dict(state["mm_opt"])
        self.swin_step = int(state["swin_step"])
        self.mm_step = int(state["mm_step"])


class SingleTaskState:
    """Train state of the V-only model: the model, one optimizer over all of
    its parameters (trg_lr, weight decay; reference train.py:245-292) and
    its update count."""

    def __init__(self, model, opt: ClippedAdamW):
        self.model = model
        self.opt = opt
        self.step = 0

    @staticmethod
    def create(model, cfg: OptimConfig, total_steps: int) -> "SingleTaskState":
        return SingleTaskState(model, make_optimizer(
            model.parameters(), cfg, cfg.trg_lr, max(total_steps, 1),
            cfg.weight_decay))

    def state_dict(self) -> dict:
        return {"opt": self.opt.state_dict(), "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        self.opt.load_state_dict(state["opt"])
        self.step = int(state["step"])
