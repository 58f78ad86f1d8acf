"""Whether what the timed path produced is correct: a comparison with the
plain reference (reference/facialmmt.py) in float32, run once the window
has closed and the program is freed.

Serving.  A sample of the requests answered in the window, drawn from the
seed, always with the one of most faces (then most tokens) in it.  For each,
the reference serves the request alone from the same weights, the same
inputs and the same Gumbel draws, and these numbers are compared:
  answer_gap  the widest gap between the program's and the reference's
              centred log-probabilities of an answer, over the median
              spread of the reference's centred log-probabilities: one
              answer altered (one slot of a pack, one bucket) shows here;
  answer_gap_median  the median of those gaps, over the same spread: a
              small error in every answer shows here;
  fer_gap     the same for each served face's FER distribution (the
              program's, taken where it is produced), over the median spread
              of the reference's FER logits.  The frame filter can hide the
              faces from the answer, so they are judged on their own.
A frame whose confidence lies within `margin` of the filter's threshold
may fall either way under rounding: the answer is held to the nearest of
the reference's answers under both choices.  A request never answered, or
answered with an error, fails the run."""

from __future__ import annotations

import time

import numpy as np

from perfbench.lib import weights
from perfbench.reference import facialmmt as ref_model


def serve_sample(ctx, traffic, record, sids):
    """The requests checked: `sample` of `sids` drawn from the seed, and
    the largest."""
    k = ctx.traffic["check"]["sample"]
    sids = sorted(sids)
    if not sids:
        return []

    def size(sid):
        w = traffic.work(record.rows[sid]["rid"])
        return (w["faces"], w["tokens"], -sid)

    rng = np.random.default_rng([ctx.seed % (2 ** 63), 11])
    pick = rng.choice(len(sids), size=min(k - 1, len(sids)), replace=False)
    return sorted({sids[i] for i in pick} | {max(sids, key=size)})


def request_arrays(torch, tree, req, device):
    """One request padded as the reference takes it."""
    d, t = tree["data"], tree["text"]
    L, la, lv = d["max_seq_length"], d["audio_utt_max_len"], \
        d["vision_utt_max_len"]
    ids = np.full((1, L), t["pad_token_id"], np.int64)
    mask = np.zeros((1, L), np.float32)
    sep = np.zeros((1, L), np.int64)
    n = len(req["input_ids"])
    ids[0, :n], mask[0, :n], sep[0, :n] = req["input_ids"], 1, req["sep_mask"]
    audio = np.zeros((1, la, d["audio_feat_dim"]), np.float32)
    amask = np.zeros((1, la), np.float32)
    a = np.asarray(req["audio"])[:la]
    audio[0, :len(a)], amask[0, :len(a)] = a, 1
    vision = np.zeros((lv, d["vision_feat_dim"]), np.float32)
    faces = np.zeros((0, 1, 1, 3), np.uint8)
    if "faces" in req:
        v = np.asarray(req["vision"])[:lv]
        vision[:len(v)] = v
        faces = np.asarray(req["faces"])[:lv]
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return {"ids": on(ids), "mask": on(mask), "sep": on(sep),
            "utt": int(req["utt_in_dia_idx"]), "audio": on(audio),
            "amask": on(amask), "vision": on(vision), "faces": on(faces)}


def centred_log(p):
    lp = np.log(np.maximum(np.asarray(p, np.float64), 1e-30))
    return lp - lp.mean(-1, keepdims=True)


def serve_readings(ctx, tree, traffic, rids, noise, answers, fer, model):
    """The gaps of `answers` / `fer` (by position in rids) against `model`:
    the widest (`answer_gap`, `fer_gap`) and the median (`*_median`)."""
    import torch

    margin = ctx.traffic["check"]["threshold_margin"]
    nf = tree["data"]["vision_utt_max_len"]
    gaps, spreads, fgaps, fspreads = [], [], [], []
    for k, rid in enumerate(rids):
        req = traffic.request(rid)
        arrays = request_arrays(torch, tree, req, ctx.device)
        n = arrays["faces"].shape[0]
        rows = noise[rid * nf: rid * nf + n]
        logits, _, variants = ref_model.serve_one(model, arrays, rows, margin)
        want = [centred_log(v.cpu().numpy()) for v in variants]
        got = centred_log(answers[k])
        gaps.append(min(float(np.abs(got - w).max()) for w in want))
        spreads.append(float(want[0].max() - want[0].min()))
        if n:
            lg = logits.double().cpu().numpy()
            ref = (lg + rows.double().cpu().numpy()) / tree["tau"]
            ref -= ref.mean(-1, keepdims=True)
            fgaps.append(float(np.abs(centred_log(fer[k]) - ref).max()))
            fspreads += list(lg.max(-1) - lg.min(-1))
    a, f = float(np.median(spreads)), float(np.median(fspreads or [1.0]))
    return {"answer_gap": max(gaps) / a,
            "fer_gap": max(fgaps) / f if fgaps else 0.0,
            "answer_gap_median": float(np.median(gaps)) / a,
            "fer_gap_median": float(np.median(fgaps)) / f if fgaps else 0.0}


def reference_model(ctx, tree, precision="fp32"):
    import torch

    ref_model.strict_fp32()
    model = ref_model.FacialMMT(tree).to(ctx.device)
    weights.draw_(model, ctx.seed)
    model.prec.set(precision)
    return model.eval()


def serve(ctx, tree, traffic, record, answers, fer_host, missing):
    """The checks of a serving run: {name: [value, limit]} and whether all
    hold."""
    from perfbench.runners.serve import gumbel_table
    import torch

    t = time.perf_counter()
    limits = ctx.traffic["check"]["limits"]
    sids = sorted(answers)
    nf = tree["data"]["vision_utt_max_len"]
    noise = gumbel_table(torch, traffic.count, nf, tree["num_labels"],
                         ctx.seed, ctx.device)
    model = reference_model(ctx, tree)
    rids = [record.rows[s]["rid"] for s in sids]
    with torch.no_grad():
        r = serve_readings(ctx, tree, traffic, rids, noise,
                           [answers[s] for s in sids],
                           [fer_host.get(s) for s in sids], model)
    ctx.say(f"checked {len(sids)} answered requests against the reference "
            f"in {time.perf_counter() - t:.1f} s: "
            + ", ".join(f"{k} {v:.6g}" for k, v in r.items()))
    checks, correct = verdict(limits, r, missing)
    return checks, len(sids) > 0 and correct


def verdict(limits, readings, missing=0):
    """({name: [value, limit]}, whether all hold) for the readings the
    cell's file gives a limit, and the requests never answered (limit 0)."""
    checks = {k: [readings[k], v] for k, v in limits.items()}
    checks["unanswered"] = [float(missing), 0.0]
    return checks, all(v <= lim for v, lim in checks.values())
