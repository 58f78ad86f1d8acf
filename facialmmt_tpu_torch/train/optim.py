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

Under a mesh plan (parallel/mesh.py) a step first sums the gradients over
the data ranks (one all_reduce per bucket of about 2**24 elements), unless
the pass ran whole on every rank; the clip's norm is global (the squares of
tensor-parallel leaves summed over the model group, every other leaf counted
once); and with ZeRO-1 each data rank keeps AdamW moments only for its slice
of each large leaf (zero1_partition), takes that slice of the parameter at
every step (a resume may have set it), updates it and all-gathers the
parameter back.  AdamW is elementwise, so ZeRO-1 changes no value.  The
state_dict is the single-device one whatever the layout: whole moments.
"""

from __future__ import annotations

from typing import Iterable

import torch

from facialmmt_tpu_torch.config import OptimConfig
from facialmmt_tpu_torch.utils.observability import trace_span

BUCKET = 1 << 24        # elements per gradient all_reduce


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


def clip_by_global_norm_(grads: Iterable[torch.Tensor], clip: float,
                         split=None, model_group=None):
    """Scale `grads` in place by clip / max(norm, clip) (optax's
    clip_by_global_norm); returns the norm before clipping.  `split` marks
    the grads of tensor-parallel leaves: their squares are summed over
    `model_group` before they join the rest."""
    grads = list(grads)
    if split is None or not any(split):
        norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
    else:
        from facialmmt_tpu_torch.parallel.comm import all_reduce_

        whole = sum(g.float().square().sum()
                    for g, s in zip(grads, split) if not s)
        part = all_reduce_(torch.stack([g.float().square().sum() for g, s in
                                        zip(grads, split) if s]).sum(),
                           model_group)
        norm = torch.sqrt(whole + part)
    scale = clip / torch.clamp(norm, min=clip)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return norm


class ClippedAdamW:
    """clip-by-global-norm -> AdamW under the warmup/decay schedule, over one
    parameter set, with the reference's hyperparameters; `plan` and
    `zero1` as in the module docstring (min_size: the smallest leaf whose
    moments ZeRO-1 splits)."""

    def __init__(self, params, cfg: OptimConfig, base_lr: float,
                 total_steps: int, weight_decay: float = 0.0, plan=None,
                 zero1: bool = False, min_size: int = 65536):
        self.params = list(params)
        self.clip = cfg.clip
        self.plan = plan if plan is not None and plan.dp * plan.tp > 1 \
            else None
        self.split = [getattr(p, "tp_spec", None) for p in self.params]
        # the axis each leaf's moments split on over the data ranks
        self.zero_axes = [None] * len(self.params)
        if self.plan is not None and zero1:
            from facialmmt_tpu_torch.parallel.mesh import zero1_partition

            self.zero_axes = zero1_partition(self.plan, self.params, min_size)
        self.opt_params = [p if ax is None else torch.nn.Parameter(
            self._slice(p.detach(), ax).clone())
            for p, ax in zip(self.params, self.zero_axes)]
        schedule = make_schedule(1.0, total_steps, cfg.warm_up)
        self.adamw = torch.optim.AdamW(
            self.opt_params, lr=base_lr, betas=(cfg.adam_b1, cfg.adam_b2),
            eps=cfg.adam_eps, weight_decay=weight_decay)
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(self.adamw, schedule)

    def _slice(self, t, axis):
        """This data rank's ZeRO-1 slice of `t` on `axis`."""
        return t.chunk(self.plan.dp, axis)[self.plan.dp_rank]

    def step(self, sync: bool = True):
        """One update from the parameters' .grad (a parameter without one
        counts as a zero gradient: it still decays), then the schedule moves
        on and the gradients are dropped.  sync=False: the gradients are
        already the same on every data rank (a pass every rank ran whole)
        and are not summed.  The span `fmmt.train.optimizer`."""
        with trace_span("fmmt.train.optimizer"):
            for p in self.params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            plan = self.plan
            if plan is not None and plan.dp > 1 and sync:
                self._sum_over_data([p.grad for p in self.params])
            clip_by_global_norm_(
                (p.grad for p in self.params), self.clip,
                [s is not None for s in self.split],
                plan.model_group if plan is not None else None)
            for p, q, ax in zip(self.params, self.opt_params, self.zero_axes):
                if ax is not None:
                    with torch.no_grad():
                        q.copy_(self._slice(p, ax))
                    q.grad = self._slice(p.grad, ax).contiguous()
            self.adamw.step()
            if any(ax is not None for ax in self.zero_axes):
                from facialmmt_tpu_torch.parallel.comm import all_gather_cat

                with torch.no_grad():
                    for p, q, ax in zip(self.params, self.opt_params,
                                        self.zero_axes):
                        if ax is not None:
                            p.copy_(all_gather_cat(q.detach(),
                                                   plan.data_group, ax))
            self.scheduler.step()
            self.adamw.zero_grad(set_to_none=True)
            for p in self.params:
                p.grad = None

    def _sum_over_data(self, grads):
        """Sum `grads` over the data ranks in place, a bucket of about
        BUCKET elements of one dtype per all_reduce, in a fixed order."""
        from facialmmt_tpu_torch.parallel.comm import all_reduce_

        bucket, size = [], 0

        def flush():
            if bucket:
                flat = all_reduce_(torch.cat([g.reshape(-1) for g in bucket]),
                                   self.plan.data_group)
                for g, part in zip(bucket, flat.split(
                        [g.numel() for g in bucket])):
                    g.copy_(part.view_as(g))
            bucket.clear()

        for g in grads:
            if bucket and (g.dtype != bucket[0].dtype
                           or size + g.numel() > BUCKET):
                flush()
                size = 0
            bucket.append(g)
            size += g.numel()
        flush()

    @property
    def lr(self) -> float:
        return self.adamw.param_groups[0]["lr"]

    def state_dict(self) -> dict:
        """AdamW's moments and step counts, and the schedule's position
        (LambdaLR's last_epoch: the update count the next step reads).
        Under a plan the moments are made whole (a collective: every rank
        calls it), so the layout is the single-device one."""
        sd = self.adamw.state_dict()
        if self.plan is not None:
            sd = dict(sd, state={i: self._whole(i, st) for i, st in
                                 sd["state"].items()})
        return {"adamw": sd, "schedule": self.scheduler.state_dict()}

    def moments(self, i: int):
        """(exp_avg, exp_avg_sq) of parameter i, whole (a collective under
        a plan: every rank calls it)."""
        st = self.adamw.state[self.opt_params[i]]
        if self.plan is not None:
            st = self._whole(i, st)
        return st["exp_avg"], st["exp_avg_sq"]

    @staticmethod
    def _map_moments(st, fn):
        return {k: (fn(v) if k in ("exp_avg", "exp_avg_sq") else v)
                for k, v in st.items()}

    def _whole(self, i, st):
        from facialmmt_tpu_torch.parallel.comm import all_gather_cat
        from facialmmt_tpu_torch.parallel.mesh import unshard_tensor

        ax, spec = self.zero_axes[i], self.split[i]

        def whole(v):
            if ax is not None:
                v = all_gather_cat(v, self.plan.data_group, ax)
            if spec is not None:
                v = unshard_tensor(v, spec, self.plan.model_group)
            return v

        return self._map_moments(st, whole)

    def _local(self, i, st):
        from facialmmt_tpu_torch.parallel.mesh import shard_tensor

        ax, spec = self.zero_axes[i], self.split[i]
        plan = self.plan

        def local(v):
            if spec is not None:
                v = shard_tensor(v, spec, plan.tp, plan.tp_rank)
            if ax is not None:
                v = self._slice(v, ax)
            return v.contiguous().clone()

        return self._map_moments(st, local)

    def load_state_dict(self, state: dict) -> None:
        """Load a state_dict of any layout's state_dict() (whole moments),
        keeping this rank's part."""
        sd = state["adamw"]
        if self.plan is not None:
            sd = dict(sd, state={int(i): self._local(int(i), st)
                                 for i, st in sd["state"].items()})
        self.adamw.load_state_dict(sd)
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
                   weight_decay: float = 0.0, plan=None, zero1: bool = False,
                   min_size: int = 65536) -> ClippedAdamW:
    return ClippedAdamW(params, cfg, base_lr, total_steps, weight_decay,
                        plan, zero1, min_size)


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
               mm_total_steps: int, **layout) -> "MultiTaskState":
        """`layout`: plan, zero1, min_size of make_optimizer."""
        return MultiTaskState(
            model,
            make_optimizer(model.swin_model.parameters(), cfg, cfg.aux_lr,
                           max(swin_total_steps, 1), **layout),
            make_optimizer(model.multimodal.parameters(), cfg, cfg.trg_lr,
                           max(mm_total_steps, 1), cfg.weight_decay,
                           **layout))

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
    def create(model, cfg: OptimConfig, total_steps: int,
               **layout) -> "SingleTaskState":
        return SingleTaskState(model, make_optimizer(
            model.parameters(), cfg, cfg.trg_lr, max(total_steps, 1),
            cfg.weight_decay, **layout))

    def state_dict(self) -> dict:
        return {"opt": self.opt.state_dict(), "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        self.opt.load_state_dict(state["opt"])
        self.step = int(state["step"])
