"""The auxiliary FER training cell: the program's `make_aux_train_step` as
`Trainer.run_multimodal` drives it, on Aff-Wild2-shaped uint8 frames held in
the program's in-memory dataset (data/meld.py::SyntheticFerDataset).

One step: fetch the batch's rows, copy them to the card, the device augment
(data/image_pipeline.py::affwild2_train_augment), then the step (Swin forward
and backward through kernels 2-6, clip, AdamW), and the loss read back, as
the trainer reads it.  The augment and the drop-path multipliers (passed as
the step's `keeps`) draw from the benchmark's generator for that step, so
the check can repeat them.  Set-up builds one train state, drives it through
the first `check.steps` steps (the check's readings), and hands it to the
window."""

from __future__ import annotations

import gc
import time

import numpy as np

from perfbench.lib import check_train, harness
from perfbench.lib.flops import aux_step_macs
from perfbench.lib.spans import Spans
from perfbench.lib.tracer import Tracer
from perfbench.reference import facialmmt as ref_model


def frames(spec, tree, seed):
    """(uint8 images, int32 labels) of the dataset, drawn from the seed."""
    rng = np.random.default_rng([seed % (2 ** 63), 3])
    px = spec["frame_px"]
    images = rng.integers(0, 256, size=(spec["frames"], px, px, 3),
                          dtype=np.uint8)
    labels = rng.integers(0, tree["num_labels"], size=spec["frames"],
                          dtype=np.int32)
    return images, labels


def batch_rows(spec, seed, step):
    """The dataset rows of step `step`: a permutation of the frames drawn
    from the seed, in batches, so that the first steps' rows all differ."""
    per_epoch = spec["frames"] // spec["batch"]
    epoch, at = divmod(step, per_epoch)
    order = np.random.default_rng([seed % (2 ** 63), 5, epoch]).permutation(
        spec["frames"])
    return order[at * spec["batch"]:(at + 1) * spec["batch"]]


def step_generator(torch, seed, step, device):
    return torch.Generator(device).manual_seed(
        (seed * 1000003 + step * 7919 + 1) % (2 ** 63))


def draw_keeps(torch, s, batch, generator, device):
    """Per block (keep_attn, keep_mlp), timm DropPath multipliers drawn from
    the step's generator; None for a block whose rate is 0."""
    rates = np.linspace(0, s["drop_path_rate"], sum(s["depths"]))
    keeps = []
    for r in rates:
        if r <= 0:
            keeps.append((None, None))
            continue
        pair = tuple((torch.rand((batch,), generator=generator, device=device)
                      < 1.0 - r).float() / (1.0 - r) for _ in range(2))
        keeps.append(pair)
    return keeps


def run(ctx):
    import torch
    from facialmmt_tpu_torch.data.image_pipeline import affwild2_train_augment
    from facialmmt_tpu_torch.data.meld import SyntheticFerDataset
    from facialmmt_tpu_torch.models.pipeline import build_pipeline
    from facialmmt_tpu_torch.train.optim import MultiTaskState
    from facialmmt_tpu_torch.train.steps import make_aux_train_step

    from perfbench.lib import config as cfgmod
    from perfbench.lib import weights

    dev, spec, tree = ctx.device, ctx.traffic, ctx.tree
    cfg = cfgmod.program_config(tree)
    ref_model.strict_fp32()
    # the program's pipeline; its Swin branch takes the seed's weights
    model = build_pipeline(cfg, dev).float()
    fer = ref_model.SwinFER(tree["swin"], tree["num_labels"]).to(dev)
    weights.draw_(fer, ctx.seed)
    model.swin_model.load_state_dict(fer.state_dict(), strict=True)
    del fer
    opt = cfg.optim
    total = spec["schedule_steps"]
    state = MultiTaskState.create(model, opt, total, total)
    state.swin_opt.set_count(int(total * opt.warm_up))
    step_fn = make_aux_train_step(model,
                                  compute_dtype=cfg.runtime.compute_dtype)
    images, labels = frames(spec, tree, ctx.seed)
    ds = SyntheticFerDataset(0)
    ds.images, ds.labels = images, labels
    size = tree["data"]["swin_img_size"]
    spans = Spans()
    opt_step = state.swin_opt.step

    def timed_opt_step(*a, **kw):
        with spans.span("perfbench.optimizer"):
            return opt_step(*a, **kw)

    state.swin_opt.step = timed_opt_step

    def one_step(k):
        """The window's step k; returns the loss as the trainer reads it."""
        g = step_generator(torch, ctx.seed, k, dev)
        with spans.span("perfbench.input"):
            imgs, labs = ds.get_batch(batch_rows(spec, ctx.seed, k))
            x = affwild2_train_augment(
                g, torch.from_numpy(np.asarray(imgs)).to(dev).float(),
                img_size=size)
            y = torch.from_numpy(np.asarray(labs)).to(dev)
        keeps = draw_keeps(torch, tree["swin"], len(labs), g, dev)
        with spans.span("perfbench.step"):
            loss = step_fn(state, x, y, g, keeps=keeps)
        return float(loss)

    readings = check_train.ProgramReadings(torch, model.swin_model,
                                           state.swin_opt)
    for k in range(spec["check"]["steps"]):
        readings.before_step(k)
        readings.loss(one_step(k))
        readings.after_step(k)
    readings.done()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    spans.rows.clear()

    tracer = Tracer(torch, ctx, {}, spans) if ctx.trace else None
    if tracer:
        tracer.arm()
    tr = spec["trace"]
    setup_s = ctx.elapsed()
    t0 = time.perf_counter()
    if tracer:
        tracer.t0 = t0
    k = spec["check"]["steps"]
    ends = []
    traced = []
    while True:
        j = k - spec["check"]["steps"]
        if tracer and j == tr["first_step"] - 1:
            tracer.record()
        if tracer and j == tr["first_step"]:
            tracer.begin()
            counts = harness.launch_counts()
        one_step(k)
        now = time.perf_counter() - t0
        ends.append(now)
        if tracer and tr["first_step"] <= j < tr["first_step"] + tr["steps"]:
            traced.append({"kind": "aux", "images": spec["batch"]})
            if j == tr["first_step"] + tr["steps"] - 1:
                tracer.end()
                counts = {name: n - counts[name]
                          for name, n in harness.launch_counts().items()}
        k += 1
        if now >= ctx.seconds:
            break
    done_steps, spent = harness.steps_in_window(ends, ctx.seconds)
    if tracer:
        tracer.finish()
    ctx.say(f"steps in the window {done_steps} of {len(ends)} run, "
            f"{spec['batch']} images each")
    device = harness.device_info(torch, dev, 1,
                                 tracer.trace if tracer else None)
    metrics = {"train_img_per_s": done_steps * spec["batch"] / spent,
               "setup_s": setup_s}
    out_readings = {}
    if ctx.trace:
        lo = tracer.t_on - t0
        hi = tracer.t_off - t0
        out_readings = {
            "tree": tree, "trace": tracer.trace,
            "kernels": harness.kernel_models(ctx.root),
            "launched": counts,
            "traced_steps": traced,
            "input_s": [e - s for n, s, e in spans.rows
                        if n == "perfbench.input"
                        and not lo <= s - t0 <= hi],
            "macs": done_steps * aux_step_macs(tree, spec["batch"]),
            "macs_window_s": spent}
    program = readings.host()
    del state, model, step_fn, readings
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks, correct = check_train.aux(ctx, tree, spec, program)
    return {"metrics": metrics, "readings": out_readings, "device": device,
            "attempted": len(ends), "failed": 0, "checks": checks,
            "correct": correct,
            "breakdown": tracer.breakdown() if tracer else None}
