"""The check of a training cell: the plain reference follows the program's
first steps from the same weights, the same rows, the same augmentation and
drop-path draws, in float32, and three numbers are compared:

  loss_gap    the widest gap between the program's and the reference's loss
              over the steps, over the reference's loss;
  grad_gap    per leaf, the gap between the norms of the first step's
              gradient as the optimizer got it (from its first moment after
              one step: m / (1 - b1)) and the reference's clipped gradient,
              over the larger of the reference leaf's norm and the median
              leaf's; the worst leaf;
  update_gap  the same for the norm of each leaf's change over the steps,
              leaving out leaves whose reference gradient is under a
              thousandth of the median leaf's (they move by round-off
              alone under Adam);
  loss1_gap, update1_gap  the same after the first step alone.
A cell's file holds the numbers it compares, each with its limit; the rest
are printed.

The reference's optimizer is written out here: the clip scales by
clip / max(norm, clip), then AdamW (decoupled decay, bias-corrected
moments) at the schedule's rate for the update count."""

from __future__ import annotations

import numpy as np

from perfbench.lib import weights
from perfbench.reference import augment
from perfbench.reference import facialmmt as ref_model


class ProgramReadings:
    """What the program's first steps show, read as they run."""

    def __init__(self, torch, module, opt):
        self.torch = torch
        self.names = [n for n, _ in module.named_parameters()]
        self.params = [p for _, p in module.named_parameters()]
        self.opt = opt
        if [id(p) for p in opt.params] != [id(p) for p in self.params]:
            raise ValueError("the optimizer's leaves are not the module's")
        self.losses = []
        self.start = None
        self.grad_norms = None
        self.first_change_norms = None
        self.change_norms = None

    def before_step(self, k):
        if k == 0:
            self.start = [p.detach().clone() for p in self.params]

    def loss(self, value):
        self.losses.append(float(value))

    def after_step(self, k):
        if k == 0:
            b1 = self.opt.adamw.param_groups[0]["betas"][0]
            state = self.opt.adamw.state
            # a leaf the optimizer never stepped holds no moment: read 0
            self.grad_norms = [
                float(state[q]["exp_avg"].double().norm() / (1.0 - b1))
                if "exp_avg" in state.get(q, {}) else 0.0
                for q in self.opt.opt_params]
            self.first_change_norms = self._changes()

    def _changes(self):
        return [float((p.detach() - s).double().norm())
                for p, s in zip(self.params, self.start)]

    def done(self):
        self.change_norms = self._changes()
        self.start = None

    def host(self):
        return {"names": self.names, "losses": self.losses,
                "grad_norms": self.grad_norms,
                "first_change_norms": self.first_change_norms,
                "change_norms": self.change_norms}


def changes(params, start):
    return [float((p.detach() - s).double().norm())
            for p, s in zip(params, start)]


def schedule(total, warm_up):
    warm = int(total * warm_up)

    def factor(count):
        if count < warm:
            return count / max(warm, 1)
        return min(max((total - count) / max(total - warm, 1), 0.0), 1.0)

    return factor, warm


def aux_reference(ctx, tree, spec, precision="fp32"):
    """The reference's readings of the auxiliary step's first steps."""
    import torch
    import torch.nn.functional as F

    from perfbench.runners.train_aux import (batch_rows, draw_keeps, frames,
                                             step_generator)

    dev = ctx.device
    ref_model.strict_fp32()
    model = ref_model.SwinFER(tree["swin"], tree["num_labels"]).to(dev)
    weights.draw_(model, ctx.seed)
    model.train()
    prec = ref_model.Precision(precision)
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    start = [p.detach().clone() for p in params]
    o = tree["optim"]
    clip, lr0 = o["clip"], o["aux_lr"]
    factor, warm = schedule(spec["schedule_steps"], o["warm_up"])
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    images, labels = frames(spec, tree, ctx.seed)
    size = tree["data"]["swin_img_size"]
    losses, grad_norms = [], None
    for k in range(spec["check"]["steps"]):
        g = step_generator(torch, ctx.seed, k, dev)
        rows = batch_rows(spec, ctx.seed, k)
        x = augment.affwild2_train_augment(
            g, torch.from_numpy(images[rows]).to(dev).float(), img_size=size)
        y = torch.from_numpy(labels[rows]).to(dev).long()
        keeps = draw_keeps(torch, tree["swin"], len(rows), g, dev)
        loss = F.cross_entropy(model(prec, x, keeps, batch_stats=True), y)
        grads = torch.autograd.grad(loss, params)
        grads = clipped(grads, clip)
        if k == 0:
            grad_norms = [float(gr.double().norm()) for gr in grads]
        adamw_(params, grads, m, v, k + 1, lr0 * factor(warm + k), o, 0.0)
        losses.append(float(loss.detach()))
        if k == 0:
            first = changes(params, start)
    return {"names": names, "losses": losses, "grad_norms": grad_norms,
            "first_change_norms": first,
            "change_norms": changes(params, start)}


def adamw_(params, grads, m, v, t, lr, o, decay):
    """One AdamW update in place (decoupled decay first)."""
    import torch

    b1, b2, eps = o["adam_b1"], o["adam_b2"], o["adam_eps"]
    with torch.no_grad():
        for p, gr, mk, vk in zip(params, grads, m, v):
            if decay:
                p.mul_(1 - lr * decay)
            mk.mul_(b1).add_(gr, alpha=1 - b1)
            vk.mul_(b2).addcmul_(gr, gr, value=1 - b2)
            denom = (vk.sqrt() / (1 - b2 ** t) ** 0.5).add_(eps)
            p.addcdiv_(mk, denom, value=-lr / (1 - b1 ** t))


def clipped(grads, clip):
    import torch

    norm = torch.sqrt(sum(gr.double().square().sum() for gr in grads))
    scale = clip / max(float(norm), clip)
    return [gr * scale for gr in grads]


def target_reference(ctx, tree, spec, fed, precision="fp32"):
    """The reference's readings of the target step's first steps, on the
    rows and face capacities `fed` the program took."""
    import torch
    import torch.nn.functional as F

    from perfbench.reference import target as ref_target
    from perfbench.runners.train_target import pool_faces, step_generator

    dev = ctx.device
    model = reference_model(ctx, tree, precision)
    model.train()
    p = model.prec
    params = [q for _, q in model.multimodal.named_parameters()]
    names = [n for n, _ in model.multimodal.named_parameters()]
    start = [q.detach().clone() for q in params]
    o = tree["optim"]
    factor, warm = schedule(spec["schedule_steps"], o["warm_up"])
    m = [torch.zeros_like(q) for q in params]
    v = [torch.zeros_like(q) for q in params]
    arrays = ref_target.meld_arrays(tree, spec["pool_utts"],
                                    spec["pool_dialogues"],
                                    pool_faces(spec, tree, ctx.seed),
                                    ctx.seed)
    draws = ref_target.Draws(step_generator(torch, ctx.seed, dev), dev)
    size = tree["data"]["swin_img_size"]
    losses, grad_norms = [], None
    for k, (idx, cap) in enumerate(fed):
        b = ref_target.meld_batch(arrays, idx, cap, spec["face_px"])
        on = {key: torch.from_numpy(np.asarray(val)).to(dev)
              for key, val in b.items()}
        faces = augment.meld_face_train_augment(draws.g, on["faces_raw"]
                                                .float(), size)
        logits = ref_target.target_logits(model, on, faces, draws)
        loss = F.cross_entropy(logits, on["labels"].long())
        grads = clipped(torch.autograd.grad(loss, params, allow_unused=True,
                                            materialize_grads=True),
                        o["clip"])
        if k == 0:
            grad_norms = [float(gr.double().norm()) for gr in grads]
        adamw_(params, grads, m, v, k + 1,
               o["trg_lr"] * factor(warm + k), o, o["weight_decay"])
        losses.append(float(loss.detach()))
        if k == 0:
            first = changes(params, start)
    return {"names": names, "losses": losses, "grad_norms": grad_norms,
            "first_change_norms": first,
            "change_norms": changes(params, start)}


def target_plan(ctx, tree, spec):
    """The rows and face capacities of the target step's first steps, as
    the program's loader takes them."""
    from perfbench.reference import target as ref_target
    from perfbench.runners.train_target import (face_buckets, pool_faces,
                                                step_rows)

    arrays = ref_target.meld_arrays(tree, spec["pool_utts"],
                                    spec["pool_dialogues"],
                                    pool_faces(spec, tree, ctx.seed),
                                    ctx.seed)
    rows, fed = step_rows(spec, ctx.seed), []
    for _ in range(spec["check"]["steps"]):
        idx = rows()
        cap = next(c for c in face_buckets(spec, tree)
                   if arrays["n_faces"][idx].sum() <= c)
        fed.append((idx, cap))
    return fed


def reference_model(ctx, tree, precision):
    from perfbench.lib import check

    return check.reference_model(ctx, tree, precision)


def target(ctx, tree, spec, program, fed):
    return held(ctx, spec, compare(
        program, target_reference(ctx, tree, spec, fed)))


def compare(got, want):
    """The numbers of readings `got` against `want` (module docstring):
    loss_gap, grad_gap, update_gap over the steps, and the first step's
    loss1_gap and update1_gap; beside them the losses and the worst
    leaves."""
    if got["names"] != want["names"]:
        raise ValueError("the program's leaves differ from the reference's")
    lw, lg = np.asarray(want["losses"]), np.asarray(got["losses"])
    gw, gg = np.asarray(want["grad_norms"]), np.asarray(got["grad_norms"])
    gmed = float(np.median(gw))
    moved = gw >= 1e-3 * gmed
    grad = np.abs(gg - gw) / np.maximum(gw, gmed)

    def update(key):
        cw, cg = np.asarray(want[key]), np.asarray(got[key])
        cmed = float(np.median(cw[moved]))
        return np.where(moved, np.abs(cg - cw) / np.maximum(cw, cmed), 0.0)

    upd, upd1 = update("change_norms"), update("first_change_norms")
    names = want["names"]
    loss = np.abs(lg - lw) / np.abs(lw)
    return {
        "losses": " ".join(f"{a:.6f}/{b:.6f}" for a, b in zip(lg, lw)),
        "loss_gap": float(np.max(loss)), "loss1_gap": float(loss[0]),
        "grad_gap": float(np.max(grad)),
        "update_gap": float(np.max(upd)), "update1_gap": float(np.max(upd1)),
        "worst_grad_leaf": names[int(np.argmax(grad))],
        "worst_update_leaf": names[int(np.argmax(upd))]}


def held(ctx, spec, numbers):
    """The checks of the numbers the cell's file gives a limit; the rest
    are printed."""
    limits = spec["check"]["limits"]
    ctx.say("readings: " + ", ".join(
        f"{k} {v:.6g}" if isinstance(v, float) else f"{k} {v}"
        for k, v in numbers.items()))
    checks = {k: [numbers[k], v] for k, v in limits.items()}
    return checks, all(v <= lim for v, lim in checks.values())


def aux(ctx, tree, spec, program):
    return held(ctx, spec, compare(program, aux_reference(ctx, tree, spec)))
