"""Serving cells: the program's AsyncBatchServer over one EmotionServer a
bucket, driven in an open loop (Poisson arrivals at a fixed rate) or a
closed loop (a fixed number of clients).

The benchmark wraps three methods of each server instance and two of the
front end's: build_pack (a host span, and the pack's request ids), the
pipeline's forward (the Gumbel draws of the pack's faces, taken from the
benchmark's own table so the reference can repeat them), fer_probs (the
served faces' FER distributions, kept for the check), predict_device
(a span) and the front's _resolve and _next_item (spans)."""

from __future__ import annotations

import collections
import gc
import time

import numpy as np

from perfbench.lib import check, harness, load, weights
from perfbench.lib.flops import request_macs
from perfbench.lib.spans import Spans
from perfbench.lib.tracer import Tracer
from perfbench.lib.traffic import Traffic
from perfbench.reference import facialmmt as ref_model


def gumbel_table(torch, count, faces, labels, seed, device):
    """(count * faces, labels) standard Gumbel draws, row rid * faces + k
    for face k of request rid."""
    g = torch.Generator(device).manual_seed((seed * 7919 + 17) % (2 ** 63))
    u = torch.rand((count * faces, labels), generator=g, device=device)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


class Instrument:
    """The wraps around one server; see the module docstring."""

    def __init__(self, torch, server, table, faces_per_utt, packs, fer,
                 spans):
        from facialmmt_tpu_torch.ops.kernels import to_device_async

        self.packs = packs      # every bucket's packs, in dispatch order
        self.fer = fer          # pack index -> its device FER rows
        model = server.model
        build, forward, fer_probs = (server.build_pack, model.forward,
                                     model.fer_probs)
        predict = server.predict_device
        rf = spans.span
        state = {}

        def wrapped_build(requests):
            t = time.perf_counter()
            with rf("perfbench.build_pack"):
                batch, faces_raw = build(requests)
            dt = time.perf_counter() - t
            utt, pos = batch["face_utt_id"], batch["face_pos"]
            rids = np.asarray([r["rid"] for r in requests] or [0], np.int64)
            idx = np.where(utt >= 0, rids[np.maximum(utt, 0)] * faces_per_utt
                           + pos, 0).astype(np.int64)
            slots, at = [], 0
            for j, r in enumerate(requests):
                take = int(batch["n_faces"][j])
                slots.append((r.get("sid"), at, take))
                at += take
            state["pack"] = len(self.packs)
            state["idx"] = idx
            self.packs.append({"i": state["pack"],
                               "bucket": (server.max_batch,
                                          server.face_capacity),
                               "n": len(requests), "slots": slots,
                               "build_s": dt, "t": time.perf_counter()})
            return batch, faces_raw

        def wrapped_forward(batch, generator=None, noise=None,
                            stop_swin_gradient=False):
            rows = to_device_async(torch.from_numpy(state["idx"]),
                                   batch["face_utt_id"].device)
            return forward(batch, generator=generator,
                           noise=table.index_select(0, rows),
                           stop_swin_gradient=stop_swin_gradient)

        def wrapped_fer(faces, **kw):
            out = fer_probs(faces, **kw)
            self.fer[state["pack"]] = out
            return out

        def wrapped_predict(batch, faces_raw):
            pack = self.packs[state["pack"]]
            before = harness.launch_counts()
            t = time.perf_counter()
            with rf("perfbench.dispatch"):
                out = predict(batch, faces_raw)
            pack["dispatch"] = (t, time.perf_counter())
            after = harness.launch_counts()
            pack["launches"] = {k: after[k] - before[k] for k in after}
            return out

        server.build_pack = wrapped_build
        model.forward = wrapped_forward
        model.fer_probs = wrapped_fer
        server.predict_device = wrapped_predict


def wrap_front(front, spans):
    rf = spans.span
    resolve, next_item = front._resolve, front._next_item

    def wrapped_resolve(pack, readback):
        with rf("perfbench.readback"):
            return resolve(pack, readback)

    def wrapped_next(timeout):
        with rf("perfbench.queue_wait"):
            return next_item(timeout)

    front._resolve = wrapped_resolve
    front._next_item = wrapped_next


def traffic_for(ctx, rate=None, seconds=None):
    """The run's traffic.  Open loop: `rate` x `seconds` requests due in the
    window.  Closed loop: as many as its clients could take at `max_rate`,
    from a set of `cycle` sizes."""
    spec, seconds = ctx.traffic, seconds or ctx.seconds
    if spec["loop"] == "open":
        rate = rate or spec["rate_utt_per_s"]
        n = max(1, int(round(rate * seconds)))
        return Traffic(spec["requests"], ctx.tree, ctx.seed, n, seconds)
    n = int(spec["max_rate_utt_per_s"] * seconds) + spec["clients"]
    return Traffic(spec["requests"], ctx.tree, ctx.seed, n,
                   cycle=spec["requests"]["cycle"])


class Prepared:
    """The set-up of a serving cell: servers with the seed's weights, the
    traffic, the Gumbel table and the wraps, every bucket warmed up, and the
    front end over them."""

    def __init__(self, ctx, rate=None, seconds=None):
        import torch
        from facialmmt_tpu_torch.serving import AsyncBatchServer, EmotionServer

        from perfbench.lib import config as cfgmod

        dev, spec, tree = ctx.device, ctx.traffic, ctx.tree
        cfg = cfgmod.program_config(tree)
        ref_model.strict_fp32()
        # the weights: drawn into the reference module, handed to each bucket
        ref = ref_model.FacialMMT(tree).to(dev)
        weights.draw_(ref, ctx.seed)
        sd = ref.state_dict()
        self.servers = [EmotionServer(cfg, state_dict=sd, max_batch=b,
                                      face_capacity=f, device=dev)
                        for b, f in spec["buckets"]]
        del ref, sd
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        self.traffic = traffic_for(ctx, rate, seconds)
        count = self.count = self.traffic.count
        nf = tree["data"]["vision_utt_max_len"]
        self.noise = gumbel_table(torch, count, nf, tree["num_labels"],
                                  ctx.seed, dev)
        self.packs, self.fer = [], {}
        self.spans = Spans()
        for s in self.servers:
            Instrument(torch, s, self.noise, nf, self.packs, self.fer,
                       self.spans)
        self.sids = 0
        # warm-up: every bucket's shapes on requests of the traffic, twice
        for s in self.servers:
            reqs, faces = [], 0
            for i in range(count):
                r = self.traffic.request(i)
                take = s.face_take(r.get("faces", ()))
                if faces + take <= s.face_capacity:
                    reqs.append(dict(r, sid=-1))
                    faces += take
                if len(reqs) == s.max_batch:
                    break
            for _ in range(2):
                s.predict(reqs)
        self.front = AsyncBatchServer(
            self.servers, batch_deadline_ms=spec["batch_deadline_ms"],
            pipeline_depth=spec["pipeline_depth"],
            boundary_policy=spec["boundary_policy"])
        wrap_front(self.front, self.spans)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        self.reset()

    def reset(self):
        self.spans.rows.clear()
        self.packs.clear()
        self.fer.clear()
        self.front.pack_sizes.clear()
        self.front.bucket_choices.clear()

    def request(self, i):
        req = self.traffic.request(i % self.count)
        req["sid"] = self.sids
        self.sids += 1
        return req

    def drive(self, ctx, closed, seconds, tick=None, tracer=None):
        t0 = time.perf_counter()
        if tracer is not None:
            tracer.t0 = t0
        if closed:
            record, futures = load.closed_loop(
                self.front.submit, self.request, ctx.traffic["clients"],
                seconds, t0, tick)
        else:
            record, futures = load.open_loop(
                self.front.submit, self.request, self.traffic.due, seconds,
                t0, tick)
        return t0, record, futures


def run(ctx):
    import torch

    dev, spec, tree = ctx.device, ctx.traffic, ctx.tree
    closed = spec["loop"] == "closed"
    st = Prepared(ctx)
    traffic, packs = st.traffic, st.packs
    tracer = (Tracer(torch, ctx, spec.get("trace", {}), st.spans)
              if ctx.trace else None)
    if tracer:
        tracer.arm()
    setup_s = ctx.elapsed()
    with load.FullCollections() as full_gc:
        full_gc.t0 = time.perf_counter()
        t0, record, futures = st.drive(ctx, closed, ctx.seconds,
                                       tracer.tick if tracer else None,
                                       tracer)
    if tracer:
        tracer.finish()
    unresolved = load.settle(futures, 60.0 + ctx.seconds)
    front = st.front
    front.close()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    summary = load.latency_summary(record, ctx.seconds)
    done = load.completed_in_window(record, ctx.seconds)
    ctx.say(f"in the window: {full_gc.line(ctx.seconds)}")
    ctx.say(f"generator lateness: max {summary['late_max_ms']:.3f} ms "
            f"(due at {summary['late_max_at_s']:.3f} s), "
            f"p99 {summary['late_p99_ms']:.3f} ms; requests due "
            f"{summary['attempted']}, failed {summary['failed']}, "
            f"unresolved {unresolved}, answered in the window {len(done)}; "
            f"packs {len(front.pack_sizes)}, p50 {summary['p50_ms']:.3f} ms")
    window_packs = [p for p in packs if p["t"] - t0 <= ctx.seconds]
    device = harness.device_info(torch, dev, 1,
                                 tracer.trace if tracer else None)

    metrics, readings = {}, {}
    if closed:
        metrics["serve_utt_per_s"] = len(done) / ctx.seconds
        attempted = len(record.rows)
        failed = sum(1 for r in record.rows.values() if r["ok"] is False)
    else:
        metrics["serve_p95_ms"] = summary["p95_ms"]
        attempted, failed = summary["attempted"], summary["failed"]
    metrics["setup_s"] = setup_s
    if ctx.trace:
        traced = [p for p in packs if "dispatch" in p
                  and tracer.inside(p["dispatch"])]
        readings = {
            "tree": tree, "trace": tracer.trace,
            "kernels": harness.kernel_models(ctx.root),
            "pack_sizes": [p["n"] for p in window_packs],
            "build_pack_s": [p["build_s"] for p in window_packs
                             if not tracer.covers(p["t"] - t0)],
            "traced_steps": [{"kind": "serve", "rows": p["bucket"][0],
                              "faces": p["bucket"][1],
                              "seq": tree["data"]["max_seq_length"]}
                             for p in traced],
            "launched": dict(sum((collections.Counter(p["launches"])
                                  for p in traced), collections.Counter())),
            "macs": sum(request_macs(tree, traffic.work(
                record.rows[s]["rid"])) for s in done),
            "macs_window_s": ctx.seconds}

    # the check: once the window has closed and the program is freed
    sample = check.serve_sample(ctx, traffic, record, done)
    answers = {sid: record.rows[sid]["answer"] for sid in sample}
    fer_host = {}
    for p in packs:
        for sid, start, take in p["slots"]:
            if sid in answers and take:
                fer_host[sid] = (st.fer[p["i"]][start:start + take].float()
                                 .cpu().numpy())
    del front, st
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks, correct = check.serve(ctx, tree, traffic, record, answers,
                                  fer_host, unresolved + summary["failed"])
    return {"metrics": metrics, "readings": readings, "device": device,
            "attempted": attempted, "failed": failed, "checks": checks,
            "correct": correct,
            "breakdown": tracer.breakdown() if tracer else None}
