"""The check of the dialogue cell, in lib/check_train.py's terms: the plain
reference (reference/dialogue.py) follows the program's first steps from
the same weights, on the same pool rows, with the same dropout masks, in
float32, and check_train.compare reads loss1_gap, grad_gap, update1_gap
and the rest; the cell's file holds the limits.  The reference's optimizer
is check_train's: the clip, then AdamW at the schedule's rate."""

from __future__ import annotations

import numpy as np

from perfbench.lib import check_train, weights
from perfbench.reference import dialogue as ref_dialogue
from perfbench.reference import facialmmt as ref_model
from perfbench.reference.target import Draws


def reference_model(ctx, tree, precision="fp32"):
    ref_model.strict_fp32()
    model = ref_dialogue.Dialogue(tree).to(ctx.device)
    weights.draw_(model, ctx.seed)
    model.prec = ref_model.Precision(precision)
    return model.train()


def reference_readings(ctx, tree, spec, pool, fed, precision="fp32"):
    """The reference's readings over the rows `fed` of `pool`, one list of
    dialogue rows a step, as the program took them."""
    import torch

    from perfbench.runners.train_dialogue import BATCH_KEYS, step_generator

    dev = ctx.device
    model = reference_model(ctx, tree, precision)
    names = [n for n, _ in model.named_parameters()]
    params = [q for _, q in model.named_parameters()]
    start = [q.detach().clone() for q in params]
    o = tree["optim"]
    factor, warm = check_train.schedule(spec["schedule_steps"], o["warm_up"])
    m = [torch.zeros_like(q) for q in params]
    v = [torch.zeros_like(q) for q in params]
    draws = Draws(step_generator(torch, ctx.seed, dev), dev)
    losses, grad_norms, first = [], None, None
    for k, idx in enumerate(fed):
        batch = {key: torch.from_numpy(np.asarray(pool[key][idx])).to(dev)
                 for key in BATCH_KEYS}
        loss, grads = ref_dialogue.step_grads(model, batch, params, draws)
        grads = check_train.clipped(grads, o["clip"])
        if k == 0:
            grad_norms = [float(gr.double().norm()) for gr in grads]
        check_train.adamw_(params, grads, m, v, k + 1,
                           o["trg_lr"] * factor(warm + k), o,
                           o["weight_decay"])
        losses.append(loss)
        if k == 0:
            first = check_train.changes(params, start)
    return {"names": names, "losses": losses, "grad_norms": grad_norms,
            "first_change_norms": first,
            "change_norms": check_train.changes(params, start)}


def check(ctx, tree, spec, program, pool, fed):
    return check_train.held(ctx, spec, check_train.compare(
        program, reference_readings(ctx, tree, spec, pool, fed)))
