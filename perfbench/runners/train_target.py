"""The target-task training step (`make_multimodal_train_step`, the step
`Trainer.run_multimodal` runs without joint training) at `utts` utterances a
step, `dialogues` dialogues of `utts / dialogues`, on the program's in-memory
MELD dataset (data/meld.py::SyntheticMeldDataset) with MELD-shaped face
counts, face buffers bucketed as the trainer buckets them, the faces'
colour jitter on the card and the Swin forward without a graph.

The step draws the faces' jitter, drop-path multipliers, Gumbel noise and
dropout masks inside the program from the generator it is handed; the
benchmark hands it its own, seeded from the run, and the reference
(reference/target.py) draws the same values from a generator in the same
state, in the same order.  Set-up runs the first `check.steps` steps for
the check's readings (lib/check_train.py) and hands the state on."""

from __future__ import annotations

import gc
import time

import numpy as np

from perfbench.lib import check_train, harness
from perfbench.lib.flops import target_step_macs
from perfbench.lib.spans import Spans
from perfbench.lib.tracer import Tracer
from perfbench.lib.traffic import Traffic


def run(ctx):
    import torch
    from facialmmt_tpu_torch.data.image_pipeline import \
        meld_face_train_augment
    from facialmmt_tpu_torch.data.meld import (FaceCapacityError,
                                               SyntheticMeldDataset)
    from facialmmt_tpu_torch.models.pipeline import build_pipeline
    from facialmmt_tpu_torch.train.optim import MultiTaskState
    from facialmmt_tpu_torch.train.steps import make_multimodal_train_step

    from perfbench.lib import config as cfgmod
    from perfbench.lib import weights
    from perfbench.reference import facialmmt as ref_model
    from perfbench.reference.target import meld_arrays

    dev, spec, tree = ctx.device, ctx.traffic, ctx.tree
    cfg = cfgmod.program_config(tree)
    ref = ref_model.FacialMMT(tree).to(dev)
    weights.draw_(ref, ctx.seed)
    model = build_pipeline(cfg, dev, ref.state_dict()).float()
    del ref
    total = spec["schedule_steps"]
    state = MultiTaskState.create(model, cfg.optim, total, total)
    state.mm_opt.set_count(int(total * cfg.optim.warm_up))
    step_fn = make_multimodal_train_step(
        model, swin_from_target=False,
        compute_dtype=cfg.runtime.compute_dtype)
    n_utts, n_dia = spec["pool_utts"], spec["pool_dialogues"]
    faces = pool_faces(spec, tree, ctx.seed)
    ds = SyntheticMeldDataset.__new__(SyntheticMeldDataset)
    ds.__dict__.update(meld_arrays(tree, n_utts, n_dia, faces, ctx.seed))
    per = spec["utts"] // spec["dialogues"]
    buckets = face_buckets(spec, tree)
    size = tree["data"]["swin_img_size"]
    g = step_generator(torch, ctx.seed, dev)
    rows = step_rows(spec, ctx.seed)
    spans = Spans()
    opt_step = state.mm_opt.step

    def timed_opt_step(*a, **kw):
        with spans.span("perfbench.optimizer"):
            return opt_step(*a, **kw)

    state.mm_opt.step = timed_opt_step

    works, fed = [], []

    def one_step():
        idx = rows()
        with spans.span("perfbench.input"):
            for cap in buckets:
                try:
                    batch = ds.get_batch(idx, face_capacity=cap)
                    break
                except FaceCapacityError:
                    continue
            fed.append((idx, cap))
            raw = torch.from_numpy(batch["faces_raw"]).to(dev).float()
            dev_batch = {k: torch.from_numpy(np.asarray(v)).to(dev)
                         for k, v in batch.items() if k != "faces_raw"}
            dev_batch["faces"] = meld_face_train_augment(g, raw, size)
        d = tree["data"]
        span = min((d["max_seq_length"] - 2) // per, d["text_utt_max_len"])
        works.append([{"faces": int(faces[i]), "tokens": d["max_seq_length"],
                       "audio": d["audio_utt_max_len"], "span": span}
                      for i in idx])
        return float(step_fn(state, dev_batch, g))

    readings = check_train.ProgramReadings(torch, model.multimodal,
                                           state.mm_opt)
    for k in range(spec["check"]["steps"]):
        readings.before_step(k)
        readings.loss(one_step())
        readings.after_step(k)
    readings.done()
    checked = list(fed)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    spans.rows.clear()
    works.clear()
    tracer = Tracer(torch, ctx, {}, spans) if ctx.trace else None
    if tracer:
        tracer.arm()
    tr = spec["trace"]
    setup_s = ctx.elapsed()
    t0 = time.perf_counter()
    if tracer:
        tracer.t0 = t0
    ends, j = [], 0
    while True:
        if tracer and j == tr["first_step"] - 1:
            tracer.record()
        if tracer and j == tr["first_step"]:
            tracer.begin()
            counts = harness.launch_counts()
        one_step()
        ends.append(time.perf_counter() - t0)
        if tracer and j == tr["first_step"] + tr["steps"] - 1:
            tracer.end()
            counts = {name: n - counts[name]
                      for name, n in harness.launch_counts().items()}
        j += 1
        if ends[-1] >= ctx.seconds:
            break
    done, spent = harness.steps_in_window(ends, ctx.seconds)
    if tracer:
        tracer.finish()
    device = harness.device_info(torch, dev, 1,
                                 tracer.trace if tracer else None)
    ctx.say(f"steps in the window {done} of {len(ends)}, "
            f"{spec['utts']} utterances each")
    readings_out = {}
    if ctx.trace:
        lo, hi = tracer.t_on - t0, tracer.t_off - t0
        readings_out = {
            "tree": tree, "trace": tracer.trace,
            "kernels": harness.kernel_models(ctx.root),
            "launched": counts,
            "traced_steps": [{"kind": "target", "faces": cap} for _, cap in
                             fed[len(checked) + tr["first_step"]:
                                 len(checked) + tr["first_step"]
                                 + tr["steps"]]],
            "input_s": [e - s for n, s, e in spans.rows
                        if n == "perfbench.input" and not lo <= s - t0 <= hi],
            "macs": sum(target_step_macs(tree, w, spec["dialogues"])
                        for w in works[:done]),
            "macs_window_s": spent}
    program = readings.host()
    del state, model, step_fn, readings
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks, correct = check_train.target(ctx, tree, spec, program, checked)
    return {"metrics": {"train_utt_per_s": done * spec["utts"] / spent,
                        "setup_s": setup_s},
            "readings": readings_out, "device": device, "attempted": len(ends),
            "failed": 0, "checks": checks, "correct": correct,
            "breakdown": tracer.breakdown() if tracer else None}


def face_buckets(spec, tree):
    """The trainer's face-buffer capacities for a batch (base, 2 x, the
    ceiling; train/trainer.py::_face_buckets)."""
    lv = tree["data"]["vision_utt_max_len"]
    base = spec["utts"] * min(lv, 12)
    buckets = [max(64, (base + 63) // 64 * 64)]
    ceiling = max(64, (spec["utts"] * lv + 63) // 64 * 64)
    if buckets[0] * 2 < ceiling:
        buckets.append(buckets[0] * 2)
    if buckets[-1] < ceiling:
        buckets.append(ceiling)
    return buckets


def step_rows(spec, seed):
    """Each step's dataset rows: `dialogues` distinct dialogues drawn from
    the seed, all of their `utts / dialogues` utterances."""
    rng = np.random.default_rng([seed % (2 ** 63), 9])
    per = spec["utts"] // spec["dialogues"]
    n_dia = spec["pool_dialogues"]

    def rows():
        dias = rng.choice(n_dia, size=spec["dialogues"], replace=False)
        return np.concatenate([d + n_dia * np.arange(per) for d in dias])

    return rows


def pool_faces(spec, tree, seed):
    """Faces per utterance of the dataset: MELD-shaped counts from the
    traffic generator's sizes."""
    sizes = Traffic(spec["requests"], tree, seed, spec["pool_utts"])
    return np.asarray([sizes.work(i)["faces"]
                       for i in range(spec["pool_utts"])])


def step_generator(torch, seed, device):
    """The generator the target steps draw from, as the trainer's one."""
    return torch.Generator(device).manual_seed(
        (seed * 1000033 + 5) % (2 ** 63))
