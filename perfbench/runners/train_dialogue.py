"""The dialogue-level training step (`make_dialogue_train_step` on
`DialogueMultiModalTransformer`, what DialogueTrainer runs for --uttORdia
dia) at `dialogues` dialogues a step, each padded to `slots` utterance
slots, from a pool of `pool_dialogues` held in M3edDialogueDataset's dense
4-D arrays and fed through the trainer's PrefetchLoader, each batch copied
to the card as the trainer copies it.  An epoch is `epoch_dialogues`
indices, as many as the train split has dialogues, each on a pool row
(pool_rows): the loader restarts its worker once an epoch, as in training,
not once per pass over the pool.

Sizes come from the cell's `sizes`, each drawn once from `shape_seed` on a
stream of its own: utterances a dialogue (stratified over the pool, so that
the pool's mean is the distribution's), then tokens an utterance, audio
frames and vision rows for every slot.  The run seed draws the token ids,
the labels and the features.  A dialogue's text is [CLS] u1 [SEP] u2 [SEP]
... cut longest-first to the token budget as M3edTextPreprocessor cuts it.

The step draws its dropout masks inside the program from the generator it
is handed; the benchmark hands it its own, seeded from the run, and the
reference (reference/dialogue.py) draws the same masks from a generator in
the same state.  Set-up runs the first `check.steps` steps for the check's
readings (lib/check_dialogue.py) and hands the state on.  The program's
span recorder is on from the end of set-up; its rows feed the per-layer
readings (lib/readers_dialogue.py)."""

from __future__ import annotations

import bisect
import gc
import statistics
import time

import numpy as np

from perfbench.lib import check_dialogue, check_train, harness, program_spans
from perfbench.lib.flops_dialogue import forward_macs, train_macs
from perfbench.lib.spans import Spans
from perfbench.lib.tracer import Tracer
from perfbench.lib.traffic import _count

CLS, SEP, PAD = 101, 102, 0
FIRST_ID = 104          # past [PAD], [unused*], [UNK], [CLS], [SEP], [MASK]
BATCH_KEYS = ("dia_input_ids", "dia_input_mask", "dia_sep_mask",
              "audio_inputs", "audio_mask", "vision_inputs", "vision_mask",
              "dia_mask", "labels")


def run(ctx):
    import torch
    from facialmmt_tpu_torch.data.loader import PrefetchLoader
    from facialmmt_tpu_torch.data.m3ed import M3edDialogueDataset
    from facialmmt_tpu_torch.models.dialogue import \
        DialogueMultiModalTransformer
    from facialmmt_tpu_torch.train.optim import SingleTaskState
    from facialmmt_tpu_torch.train.steps import make_dialogue_train_step
    from facialmmt_tpu_torch.utils import observability as obs

    from perfbench.lib import config as cfgmod
    from perfbench.lib import weights
    from perfbench.reference import dialogue as ref_dialogue

    dev, spec, tree = ctx.device, ctx.traffic, ctx.tree
    cfg = cfgmod.program_config(tree)
    pool = dialogue_pool(torch, spec, tree, ctx.seed, dev)
    ds = M3edDialogueDataset.from_arrays(
        "train", *(pool[k] for k in BATCH_KEYS))
    ref = ref_dialogue.Dialogue(tree).to(dev)
    weights.draw_(ref, ctx.seed)
    with torch.device(dev):
        model = DialogueMultiModalTransformer(cfg)
    model.to(dev).float()
    model.load_state_dict(ref.state_dict(), strict=True)
    del ref
    total = spec["schedule_steps"]
    state = SingleTaskState.create(model, cfg.optim, total)
    state.opt.set_count(int(total * cfg.optim.warm_up))
    step_fn = make_dialogue_train_step(
        model, compute_dtype=cfg.runtime.compute_dtype)
    fed = []

    def fetch(idx):
        fed.append(pool_rows(spec, idx))
        return ds.get_batch(fed[-1])

    loader = PrefetchLoader(fetch, spec["epoch_dialogues"], spec["dialogues"],
                            shuffle=True, seed=loader_seed(ctx.seed))

    def epochs():
        e = 0
        while True:
            yield from loader.epoch(e)
            e += 1

    batches = epochs()
    g = step_generator(torch, ctx.seed, dev)
    per_dialogue = np.asarray([train_macs(forward_macs(tree, **w))
                               for w in dialogue_work(pool)])
    spans = Spans()
    valid, kept = [], []

    def one_step():
        with spans.span("perfbench.wait"):
            batch, n_valid = next(batches)
        with spans.span("perfbench.copy"):
            on = {k: torch.from_numpy(np.asarray(v)).to(dev)
                  for k, v in batch.items()}
        kept.append(n_valid)
        valid.append(valid_utterances(batch, n_valid))
        return float(step_fn(state, on, g))

    steps = spec["check"]["steps"]
    readings = check_train.ProgramReadings(torch, model, state.opt)
    for k in range(steps):
        readings.before_step(k)
        readings.loss(one_step())
        readings.after_step(k)
    readings.done()
    checked = fed[:steps]
    if checked != plan(spec, ctx.seed)[:steps]:
        raise RuntimeError("the loader's first batches are not its plan's")
    if dev.type == "cuda":
        torch.cuda.synchronize()
    spans.rows.clear()
    del valid[:], kept[:]
    obs.clear()
    obs.enable()
    tracer = Tracer(torch, ctx, {}, spans) if ctx.trace else None
    if tracer:
        tracer.arm()
    tr = spec["trace"]
    marks = {}
    setup_s = ctx.elapsed()
    t0 = time.perf_counter()
    marks["window"] = time.time_ns()
    if tracer:
        tracer.t0 = t0
    ends, j = [], 0
    while True:
        if tracer and j == tr["first_step"] - 1:
            marks["recording"] = time.time_ns()
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
    obs.disable()
    batches.close()
    done, spent = harness.steps_in_window(ends, ctx.seconds)
    if tracer:
        tracer.finish()
    device = harness.device_info(torch, dev, 1,
                                 tracer.trace if tracer else None)
    window_fed = fed[steps:steps + done]
    ctx.say(f"steps in the window {done} of {len(ends)}, "
            f"{sum(valid[:done])} valid utterances in "
            f"{done * spec['dialogues'] * spec['slots']} slots")
    readings_out = {}
    if ctx.trace:
        ctx.say(f"kernel launches in the traced steps: "
                f"{ {k: v for k, v in counts.items() if v} or 'none'}")
        rec = marks["recording"]
        rows = obs.rows()
        untraced = tr["first_step"] - 1
        before = [0.0] * untraced
        for n, s, e in spans.rows:
            k = bisect.bisect_right(ends, s - t0)
            if n in ("perfbench.wait", "perfbench.copy") and k < untraced:
                before[k] += e - s
        fetch = program_spans.host_ms(rows, "fmmt.data.fetch",
                                      (marks["window"], rec))
        ctx.say(f"host ms a step before the profiler records: fetch "
                f"{fetch} (the loader's thread, overlapped), wait and "
                f"copy {1e3 * statistics.fmean(before):.2f}")
        readings_out = {
            "trace": tracer.trace, "rows": rows, "launched": counts,
            "input_s": before, "traced_steps": tr["steps"],
            "untraced_step_s": np.diff([0.0] + ends[:untraced]).tolist(),
            "macs": int(sum(per_dialogue[np.asarray(rows_)[:n]].sum()
                            for rows_, n in zip(window_fed, kept))),
            "macs_window_s": spent}
    program = readings.host()
    del state, model, step_fn, readings, ds, loader
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks, correct = check_dialogue.check(ctx, tree, spec, program, pool,
                                           checked)
    return {"metrics": {"train_utt_per_s": sum(valid[:done]) / spent,
                        "setup_s": setup_s},
            "readings": readings_out, "device": device, "attempted": len(ends),
            "failed": 0, "checks": checks, "correct": correct,
            "breakdown": tracer.breakdown() if tracer else None}


def valid_utterances(batch, n_valid):
    """The labelled utterances of a batch's first `n_valid` dialogues: the
    loader fills an epoch's last batch by repeating its last index, and
    those rows are not counted."""
    return int(batch["dia_mask"][:n_valid].sum())


def loader_seed(seed):
    return seed % (2 ** 32)


def pool_rows(spec, idx):
    """The pool's rows of a batch of the epoch's indices: an epoch runs over
    `epoch_dialogues` indices (a train split's dialogues), index i on the
    pool's row i mod `pool_dialogues`."""
    return [int(i) % spec["pool_dialogues"] for i in idx]


def plan(spec, seed):
    """The pool rows of the loader's first epoch (the trainer's plan)."""
    from facialmmt_tpu_torch.data.loader import epoch_batches

    return [pool_rows(spec, idx) for idx, _ in epoch_batches(
        spec["epoch_dialogues"], spec["dialogues"], shuffle=True,
        seed=loader_seed(seed), epoch=0)]


def step_generator(torch, seed, device):
    """The generator the dialogue steps draw their dropout masks from."""
    return torch.Generator(device).manual_seed(
        (seed * 1000033 + 11) % (2 ** 63))


def _stratified(rng, d, n):
    """n counts of `exponential` d whose uniforms are stratified: one in
    each n-th of [0, 1), in an order drawn from rng."""
    u = (rng.permutation(n) + rng.random(n)) / n
    x = d["min"] + np.floor(-d["scale"] * np.log1p(-u))
    return np.minimum(x, d["max"]).astype(np.int64)


def sizes(spec):
    """Utterances a dialogue (n,), and tokens, frames and rows for every
    slot (n, slots), from the cell's shape seed."""
    s, n, slots = spec["sizes"], spec["pool_dialogues"], spec["slots"]
    stream = lambda k: np.random.default_rng([s["shape_seed"], k])
    utts = np.minimum(_stratified(stream(0), s["utts_per_dialogue"], n),
                      slots)
    return {"utts": utts,
            "tokens": _count(stream(1), s["tokens_per_utt"], (n, slots)),
            "frames": _count(stream(2), s["audio_frames"], (n, slots)),
            "rows": _count(stream(3), s["vision_rows"], (n, slots))}


def truncate_longest_first(lengths, budget):
    """Token counts cut one at a time from the longest (the first of equal
    ones) until they fit `budget` (data/text_prep.py::truncate_seq_pair)."""
    out = [int(x) for x in lengths]
    while sum(out) > budget:
        i = int(np.argmax(out))
        if out[i] == 0:
            break
        out[i] -= 1
    return out


def dialogue_text(n_utts, counts, ids, max_len):
    """(input_ids, input_mask, sep_mask) of one dialogue: [CLS] u1 [SEP] u2
    [SEP] ..., each utterance cut longest-first to max_len - n - 1 tokens."""
    counts = truncate_longest_first(counts[:n_utts], max_len - n_utts - 1)
    out, sep, at = [CLS], [0], 0
    for k in counts:
        out += list(ids[at:at + k]) + [SEP]
        sep += [0] * k + [1]
        at += k
    row = np.full(max_len, PAD, np.int32)
    row[:len(out)] = out
    mask = np.zeros(max_len, np.int32)
    mask[:len(out)] = 1
    seps = np.zeros(max_len, np.int32)
    seps[:len(sep)] = sep
    return row, mask, seps


def dialogue_pool(torch, spec, tree, seed, device):
    """The pool's arrays under get_batch's keys: text (n, L), audio (n, D,
    La, da) and vision (n, D, Lv, dv) float32 with zeros past each slot's
    frames or rows and in empty slots, their masks, dia_mask and labels
    (n, D).  Features are drawn on `device` in one call each and brought
    to the host."""
    data = tree["data"]
    n, slots = spec["pool_dialogues"], spec["slots"]
    sz = sizes(spec)
    rng = np.random.default_rng([seed % (2 ** 63), 17])
    length = data["max_seq_length"]
    text = [dialogue_text(int(sz["utts"][d]), sz["tokens"][d],
                          rng.integers(FIRST_ID, tree["text"]["vocab_size"],
                                       size=int(sz["tokens"][d].sum())),
                          length) for d in range(n)]
    dia_mask = (np.arange(slots)[None] < sz["utts"][:, None]).astype(np.int32)
    labels = rng.integers(0, tree["num_labels"], size=(n, slots)) * dia_mask
    g = torch.Generator(device).manual_seed((seed * 7919 + 3) % (2 ** 63))
    out = {"dia_input_ids": np.stack([t[0] for t in text]),
           "dia_input_mask": np.stack([t[1] for t in text]),
           "dia_sep_mask": np.stack([t[2] for t in text]),
           "dia_mask": dia_mask, "labels": labels.astype(np.int32)}
    for key, count, cap, dim in (
            ("audio", "frames", data["audio_utt_max_len"],
             data["audio_feat_dim"]),
            ("vision", "rows", data["vision_utt_max_len"],
             data["vision_feat_dim"])):
        real = np.minimum(sz[count], cap) * dia_mask
        mask = (np.arange(cap)[None, None] < real[:, :, None])
        x = torch.randn((n, slots, cap, dim), generator=g, device=device)
        x *= torch.from_numpy(mask).to(device)[..., None]
        out[f"{key}_inputs"] = x.cpu().numpy()
        out[f"{key}_mask"] = mask.astype(np.int32)
        del x
    return out


def dialogue_work(pool):
    """Each pool dialogue's real sizes (flops_dialogue.forward_macs'
    arguments): its tokens, and its valid slots' frames and rows."""
    out = []
    for d in range(len(pool["dia_mask"])):
        keep = pool["dia_mask"][d].astype(bool)
        out.append({"tokens": int(pool["dia_input_mask"][d].sum()),
                    "frames": pool["audio_mask"][d][keep].sum(1).tolist(),
                    "rows": pool["vision_mask"][d][keep].sum(1).tolist()})
    return out
