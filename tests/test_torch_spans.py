"""The port's span recorder (facialmmt_tpu_torch/utils/observability.py)
and the spans the program opens where its work happens, on the CPU.

Off, trace_span reads no clock, opens no record_function region and leaves
no gc hook and no row.  On, spans nest with their parents, thread ids and
keys, the ring keeps only its newest rows, full collections of the garbage
collector are rows, and a profiler's record_function event lies within its
span's time.time_ns() stamps (the two share a clock).  An AsyncBatchServer
over tiny CPU servers gives one `fmmt.serve.queued` row a request and one
fill / build_pack / dispatch / readback row a pack, keyed by the pack's
index in `bucket_choices`; a train step gives its forward, backward and
optimizer spans, the model's module spans nested in the forward.
"""

import collections
import dataclasses
import gc
import sys
import threading
import time

import numpy as np
import pytest
import torch

import facialmmt_tpu_torch.utils.observability as obs
from facialmmt_tpu_torch.config import FacialMMTConfig, RuntimeConfig

CFG = FacialMMTConfig.tiny().replace(
    runtime=RuntimeConfig(deterministic_gumbel=True))
D = CFG.data
MODULES = ["fmmt.model.swin", "fmmt.model.filter", "fmmt.model.text",
           "fmmt.model.encoders", "fmmt.model.crossmodal", "fmmt.model.head"]


@pytest.fixture
def recorder(monkeypatch):
    """A fresh recorder of 4096 rows in place of the process's, enabled;
    afterwards disabled, its gc hook gone."""
    rec = obs.Recorder(capacity=4096)
    monkeypatch.setattr(obs, "RECORDER", rec)
    rec.enable()
    yield rec
    rec.disable()
    assert rec._gc_hook not in gc.callbacks


# ----------------------------------------------------------------- recorder --

def test_off_reads_no_clock_opens_no_region_and_hooks_no_gc(monkeypatch):
    rec = obs.Recorder()
    monkeypatch.setattr(obs, "RECORDER", rec)
    calls = []
    monkeypatch.setattr(obs.time, "time_ns",
                        lambda: calls.append("clock") or 0)
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: calls.append(name))
    hooks = list(gc.callbacks)
    for i in range(3):
        with obs.trace_span("fmmt.a", key=i) as span:
            with obs.keyed(7), obs.trace_span("fmmt.b"):
                pass
        assert span is None                       # the shared empty context
        assert obs.trace_span("fmmt.a") is obs.trace_span("fmmt.b")
        assert obs.stamp() is None
        obs.add_row("fmmt.c", obs.stamp())
    gc.collect()
    assert calls == [] and rec.rows() == [] and list(gc.callbacks) == hooks


def test_nested_spans_keep_parents_threads_and_keys(recorder):
    with obs.trace_span("fmmt.outer", key="p1"):
        with obs.trace_span("fmmt.inner"):
            time.sleep(0.001)
        with obs.trace_span("fmmt.own", key="k2"):
            pass
    with obs.keyed(5):
        with obs.trace_span("fmmt.keyed"):
            obs.add_row("fmmt.n", obs.stamp(), value=2)
    t = obs.stamp()
    obs.add_row("fmmt.row", t, key=9, value=3)

    def other():
        with obs.trace_span("fmmt.thread"):
            pass

    th = threading.Thread(target=other)
    th.start()
    th.join(timeout=10)
    assert not th.is_alive()
    rows = {r.name: r for r in obs.rows()}
    assert set(rows) == {"fmmt.outer", "fmmt.inner", "fmmt.own",
                         "fmmt.keyed", "fmmt.n", "fmmt.row",
                         "fmmt.thread"}
    me = threading.get_ident()
    outer, inner = rows["fmmt.outer"], rows["fmmt.inner"]
    assert (outer.parent, outer.key, outer.thread) == (None, "p1", me)
    assert (inner.parent, inner.key) == ("fmmt.outer", "p1")
    assert (rows["fmmt.own"].parent, rows["fmmt.own"].key) == ("fmmt.outer",
                                                               "k2")
    assert outer.start_ns <= inner.start_ns
    assert inner.end_ns - inner.start_ns >= 1_000_000
    assert inner.end_ns <= outer.end_ns
    # a keyed frame gives its key and is no parent, nor a row
    assert (rows["fmmt.keyed"].parent, rows["fmmt.keyed"].key) == (None, 5)
    n = rows["fmmt.n"]
    assert (n.parent, n.key, n.value) == ("fmmt.keyed", 5, 2)
    assert n.start_ns <= n.end_ns
    assert (rows["fmmt.row"].start_ns, rows["fmmt.row"].key,
            rows["fmmt.row"].value) == (t, 9, 3)
    assert rows["fmmt.row"].end_ns >= t
    th_row = rows["fmmt.thread"]
    assert th_row.thread != me and th_row.parent is None
    obs.clear()
    assert obs.rows() == []


def test_a_span_that_raises_is_recorded_and_closed(recorder):
    with pytest.raises(ValueError):
        with obs.trace_span("fmmt.outer"):
            with obs.trace_span("fmmt.fails"):
                raise ValueError("x")
    with obs.trace_span("fmmt.after"):
        pass
    rows = {r.name: r for r in obs.rows()}
    assert rows["fmmt.fails"].parent == "fmmt.outer"
    assert rows["fmmt.after"].parent is None      # nothing left open


def test_the_ring_keeps_the_newest_rows(monkeypatch):
    rec = obs.Recorder(capacity=8)
    monkeypatch.setattr(obs, "RECORDER", rec)
    rec.enable()
    try:
        for i in range(50):
            with obs.trace_span("fmmt.step", key=i):
                pass
    finally:
        rec.disable()
    assert [r.key for r in obs.rows()] == list(range(42, 50))
    with obs.trace_span("fmmt.step"):             # disabled: no row
        pass
    assert len(obs.rows()) == 8


def test_a_span_open_at_disable_adds_no_row(monkeypatch):
    """The recorder disabled while a span is open (on the packer's thread,
    say): the span closes without a row, as add_row adds none."""
    rec = obs.Recorder()
    monkeypatch.setattr(obs, "RECORDER", rec)
    rec.enable()
    try:
        with obs.trace_span("fmmt.outer"):
            with obs.trace_span("fmmt.closed"):
                pass
            t = obs.stamp()
            rec.disable()
            obs.add_row("fmmt.late", t)
    finally:
        rec.disable()
    assert [r.name for r in rec.rows()] == ["fmmt.closed"]
    rec.enable()                                  # nothing left open
    try:
        with obs.trace_span("fmmt.next"):
            pass
    finally:
        rec.disable()
    assert rec.rows()[-1].parent is None


def test_a_full_collection_is_one_gc_row(recorder):
    was = gc.isenabled()
    gc.disable()                                  # no collection of its own
    try:
        obs.clear()
        with obs.trace_span("fmmt.outer"):
            gc.collect(1)                         # not a full collection
            gc.collect()
    finally:
        if was:
            gc.enable()
    rows = [r for r in obs.rows() if r.name == "fmmt.gc"]
    assert len(rows) == 1
    row = rows[0]
    assert row.parent == "fmmt.outer" and row.thread == threading.get_ident()
    assert row.end_ns >= row.start_ns and row.value >= 0
    assert recorder._gc_hook in gc.callbacks
    recorder.enable()                             # registered once
    assert gc.callbacks.count(recorder._gc_hook) == 1


def test_profiler_regions_lie_within_their_span_stamps(recorder):
    """The program's rows and the profiler's events share one clock: each
    record_function region a span opens starts and ends inside the span's
    time.time_ns() stamps."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(16, 16)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(40):
            with obs.trace_span(f"fmmt.region{i}"):
                x = x @ x / 16
    rows = {r.name: r for r in obs.rows() if r.name.startswith("fmmt.region")}
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("fmmt.region")}
    assert len(events) == 40 and len(rows) == 40
    for name, e in events.items():
        start = e.start_ns()
        assert rows[name].start_ns <= start
        assert start + e.duration_ns() <= rows[name].end_ns


def test_profiler_alone_opens_regions_and_keeps_no_rows(monkeypatch):
    """A torch.profiler capture with the recorder off: the regions carry
    the span names, and no row is kept."""
    from torch.profiler import ProfilerActivity, profile

    rec = obs.Recorder()
    monkeypatch.setattr(obs, "RECORDER", rec)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.trace_span("fmmt.alone"):
            torch.ones(4, 4).sum()
    assert "fmmt.alone" in {e.key for e in prof.key_averages()}
    assert rec.rows() == []


def test_threads_record_every_span_under_fast_switching(recorder):
    """16 threads open nested spans at once with a tiny switch interval:
    no row is lost and each inner span's parent is its own thread's."""
    per, threads = 100, 16
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    together = threading.Barrier(threads, timeout=60)
    try:
        def work(k):
            together.wait()
            for i in range(per):
                with obs.trace_span(f"fmmt.t{k}", key=i):
                    with obs.trace_span("fmmt.inner"):
                        pass
            together.wait()     # every thread alive to the end: its own id

        pool = [threading.Thread(target=work, args=(k,))
                for k in range(threads)]
        for th in pool:
            th.start()
        for th in pool:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in pool)
    finally:
        sys.setswitchinterval(interval)
    rows = obs.rows()
    assert len(rows) == 2 * per * threads
    outer = {r.thread: r.name for r in rows if r.name != "fmmt.inner"}
    assert len(outer) == threads
    for r in rows:
        if r.name == "fmmt.inner":
            assert r.parent == outer[r.thread]


# ------------------------------------------------------------- the program --

@pytest.fixture(scope="module")
def servers():
    """The port's EmotionServers of two buckets, random weights, on the
    CPU."""
    from facialmmt_tpu_torch.serving import EmotionServer

    kw = dict(dtype=torch.float32, transfer_dtype=np.float32, device="cpu")
    return [EmotionServer(CFG, None, max_batch=1, face_capacity=4, **kw),
            EmotionServer(CFG, None, max_batch=4, face_capacity=16, **kw)]


def _request(rng, faces):
    return {"audio": rng.normal(size=(5, D.audio_feat_dim)),
            "vision": rng.normal(size=(3, D.vision_feat_dim)),
            "faces": rng.integers(0, 255, (faces, 160, 160, 3),
                                  dtype=np.uint8),
            "input_ids": rng.integers(2, CFG.text.vocab_size, size=(20,)),
            "sep_mask": np.eye(20)[7]}


def test_the_front_gives_a_row_a_request_and_a_pack(servers, recorder):
    from facialmmt_tpu_torch.serving import AsyncBatchServer

    rng = np.random.default_rng(3)
    front = AsyncBatchServer(servers, batch_deadline_ms=20.0,
                             boundary_policy="greedy")
    try:
        answered = [front.submit(_request(rng, 1)).result(timeout=60)
                    for _ in range(2)]            # alone: the small bucket
        burst = [front.submit(_request(rng, 2)) for _ in range(7)]
        answered += [f.result(timeout=60) for f in burst]
    finally:
        front.close()
    assert len(answered) == 9
    rows = obs.rows()
    by = collections.defaultdict(list)
    for r in rows:
        by[r.name].append(r)
    packs = len(front.bucket_choices)
    assert packs == len(front.pack_sizes) >= 3
    queued = by["fmmt.serve.queued"]
    assert sorted(r.key for r in queued) == list(range(9))
    assert collections.Counter(r.value for r in queued) == dict(
        enumerate(front.pack_sizes))
    for name in ("fmmt.serve.fill", "fmmt.serve.build_pack",
                 "fmmt.serve.dispatch", "fmmt.serve.stage",
                 "fmmt.serve.readback", *MODULES):
        assert sorted(r.key for r in by[name]) == list(range(packs)), name
    fill = {r.key: r for r in by["fmmt.serve.fill"]}
    for pid, (rows_cap, faces_cap) in enumerate(front.bucket_choices):
        assert fill[pid].value == front.pack_sizes[pid] <= rows_cap
        assert 2 * fill[pid].value <= faces_cap   # at most 2 faces each
    assert front.bucket_choices[:2] == [(1, 4), (1, 4)]
    for q in queued:            # from submit() until its pack closed
        assert q.start_ns <= fill[q.value].end_ns == q.end_ns
    packer = {r.thread for r in by["fmmt.serve.dispatch"]}
    assert len(packer) == 1 and packer != {threading.get_ident()}
    parents = {r.name: r.parent for r in rows}
    assert parents["fmmt.serve.stage"] == "fmmt.serve.dispatch"
    assert parents["fmmt.model.swin"] == "fmmt.serve.dispatch"
    assert parents["fmmt.serve.build_pack"] is None
    assert by["fmmt.serve.idle"]


def test_a_failed_request_is_counted_with_its_pack(servers, recorder):
    from facialmmt_tpu_torch.serving import AsyncBatchServer

    rng = np.random.default_rng(4)
    front = AsyncBatchServer(servers[:1])
    try:
        too_many = front.submit(_request(rng, 5))     # over its 4 faces
        with pytest.raises(Exception):
            too_many.result(timeout=60)
        front.submit(_request(rng, 1)).result(timeout=60)
    finally:
        front.close()
    # the failed request waited in the queue and joined no pack: its row
    # has no pack id, and no pack's rows are keyed for it
    rows = obs.rows()
    queued = sorted((r.key, r.value) for r in rows
                    if r.name == "fmmt.serve.queued")
    assert queued == [(0, None), (1, 0)]
    assert front.bucket_choices == [(1, 4)]
    for name in ("fmmt.serve.build_pack", "fmmt.serve.dispatch",
                 "fmmt.serve.readback"):
        assert [r.key for r in rows if r.name == name] == [0], name
    fills = {(r.key, r.value) for r in rows if r.name == "fmmt.serve.fill"}
    assert fills == {(None, 1), (0, 1)}


def test_a_train_step_gives_its_phases_and_modules(recorder):
    """One target step with accumulation over two microbatches: a forward
    (holding the model's six module spans) and a backward each, then one
    optimizer span; an auxiliary step: forward (Swin), backward,
    optimizer; the data's fetch and augment spans around them."""
    from facialmmt_tpu_torch.data.image_pipeline import (
        affwild2_train_augment, meld_face_train_augment)
    from facialmmt_tpu_torch.data.meld import (SyntheticFerDataset,
                                               SyntheticMeldDataset)
    from facialmmt_tpu_torch.models.pipeline import build_pipeline
    from facialmmt_tpu_torch.train import steps
    from facialmmt_tpu_torch.train.optim import MultiTaskState

    cfg = CFG.replace(optim=dataclasses.replace(CFG.optim,
                                                trg_batch_size=2))
    model = build_pipeline(cfg, torch.device("cpu"))
    state = MultiTaskState.create(model, cfg.optim, 10, 10)
    g = torch.Generator().manual_seed(0)
    ds = SyntheticMeldDataset(cfg, 8, 4, faces_per_utt=2, seed=1)
    micro = []
    for idx in ([0, 1], [2, 3]):
        batch = ds.get_batch(idx, face_capacity=64)
        faces = meld_face_train_augment(
            g, torch.from_numpy(batch.pop("faces_raw")).float(),
            D.swin_img_size)
        micro.append(dict({k: torch.from_numpy(np.asarray(v))
                           for k, v in batch.items()}, faces=faces))
    obs.clear()
    step = steps.make_multimodal_train_step_accum(
        model, swin_from_target=False, compute_dtype="float32")
    step(state, {k: torch.stack([m[k] for m in micro]) for k in micro[0]}, g)
    rows = obs.rows()
    top = [r.name for r in rows if r.parent is None]
    assert top == ["fmmt.train.forward", "fmmt.train.backward"] * 2 + [
        "fmmt.train.optimizer"]
    inside = [r.name for r in rows if r.parent == "fmmt.train.forward"]
    assert sorted(inside) == sorted(MODULES * 2)

    fer = SyntheticFerDataset(12, size=16, seed=2)
    obs.clear()
    imgs, labels = fer.get_batch(range(6))
    x = affwild2_train_augment(g, torch.from_numpy(imgs).float(),
                               img_size=D.swin_img_size)
    steps.make_aux_train_step(model, compute_dtype="float32")(
        state, x, torch.from_numpy(labels), g)
    assert [(r.name, r.parent) for r in obs.rows()] == [
        ("fmmt.data.fetch", None), ("fmmt.data.augment", None),
        ("fmmt.model.swin", "fmmt.train.forward"),
        ("fmmt.train.forward", None), ("fmmt.train.backward", None),
        ("fmmt.train.optimizer", None)]
