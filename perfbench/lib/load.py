"""Open and closed loops over the program's front end.

A copy of the program's `serving._drive_load`, with three things fixed:
each request is timed from when it was DUE (so a stall shows on every
request queued behind it), a request that fails counts as a miss instead of
vanishing from the latency list, and the requests are the traffic
generator's, not one all-zero request.  How late the generator itself ran
is returned beside the latencies.

`submit(i, request) -> Future` is the front end's submit; `on_tick(now)`
is called from the driving thread between arrivals (the traced run starts
and stops its profiler there)."""

from __future__ import annotations

import gc
import threading
import time

INF = float("inf")


class Record:
    """Per-submission timing: due, sent and done on the host clock, relative
    to the window's start; `ok` False for a failed request."""

    def __init__(self):
        self.lock = threading.Lock()
        self.rows = {}          # submission index -> dict

    def sent(self, sid, rid, due, sent):
        with self.lock:
            self.rows[sid] = {"rid": rid, "due": due, "sent": sent,
                              "done": None, "ok": None, "answer": None}

    def done(self, sid, t, ok, answer):
        with self.lock:
            r = self.rows[sid]
            r["done"], r["ok"], r["answer"] = t, ok, answer


def _callback(record, sid, t0, after=None):
    def cb(fut):
        t = time.perf_counter() - t0
        exc = fut.exception()
        record.done(sid, t, exc is None, None if exc else fut.result())
        if after is not None:
            after(t)
    return cb


def open_loop(submit, request, due, seconds, t0, on_tick=None):
    """Send request(i) at due[i] (seconds after t0) for every due time
    inside the window.  Returns (record, futures).  The sending thread
    sleeps until the next due time (with `on_tick`, at most 2 ms)."""
    record = Record()
    futures = []
    i = 0
    nap = 0.002 if on_tick is not None else float("inf")
    while i < len(due) and due[i] < seconds:
        now = time.perf_counter() - t0
        if on_tick is not None:
            on_tick(now)
        if now < due[i]:
            time.sleep(min(due[i] - now, nap))
            continue
        req = request(i)
        record.sent(i, req["rid"], float(due[i]),
                    time.perf_counter() - t0)
        fut = submit(req)
        fut.add_done_callback(_callback(record, i, t0))
        futures.append(fut)
        i += 1
    while on_tick is not None and time.perf_counter() - t0 < seconds:
        on_tick(time.perf_counter() - t0)
        time.sleep(0.002)
    return record, futures


def closed_loop(submit, request, clients, seconds, t0, on_tick=None):
    """`clients` callers, each sending its next request as soon as its last
    one is answered, until the window closes.  The next request is sent
    from the completion callback, so no thread per client is needed."""
    record = Record()
    futures = []
    lock = threading.Lock()
    counter = [0]

    def send(_t=None):
        now = time.perf_counter() - t0
        if now >= seconds:
            return
        with lock:
            sid = counter[0]
            counter[0] += 1
        req = request(sid)
        record.sent(sid, req["rid"], now, now)
        fut = submit(req)
        futures.append(fut)
        fut.add_done_callback(_callback(record, sid, t0, send))

    for _ in range(clients):
        send()
    while time.perf_counter() - t0 < seconds:
        now = time.perf_counter() - t0
        if on_tick is None:
            time.sleep(seconds - now)
            continue
        on_tick(now)
        time.sleep(0.002)
    return record, futures


def settle(futures, timeout):
    """Wait for every future, up to `timeout` seconds in all; returns the
    number still unresolved."""
    end = time.perf_counter() + timeout
    left = 0
    for fut in list(futures):
        try:
            fut.exception(timeout=max(0.0, end - time.perf_counter()))
        except TimeoutError:
            left += 1
    return left


def percentile(values, q):
    """The q-th percentile (nearest rank) of values, inf counting as the
    largest."""
    v = sorted(values)
    if not v:
        return INF
    k = max(0, min(len(v) - 1, int(-(-q * len(v) // 100)) - 1))
    return v[k]


def latency_summary(record, seconds):
    """Requests due in the window: their due-time latencies (ms; a failure
    or a request never answered is inf), the generator's lateness."""
    rows = [r for r in record.rows.values() if r["due"] < seconds]
    lat = [INF if not r["ok"] else (r["done"] - r["due"]) * 1e3
           for r in rows]
    late = [(r["sent"] - r["due"]) * 1e3 for r in rows]
    latest = max(rows, key=lambda r: r["sent"] - r["due"], default=None)
    return {"attempted": len(rows), "failed": sum(1 for r in rows
                                                  if not r["ok"]),
            "p50_ms": percentile(lat, 50), "p95_ms": percentile(lat, 95),
            "late_max_ms": max(late) if late else 0.0,
            "late_max_at_s": latest["due"] if latest else 0.0,
            "late_p99_ms": percentile(late, 99) if late else 0.0}


class FullCollections:
    """The full collections of Python's garbage collector while it is
    entered: (start, seconds) on the host clock, relative to `t0`."""

    def __init__(self):
        self.t0 = 0.0
        self.rows = []
        self._at = None

    def _seen(self, phase, info):
        if info["generation"] == 2:
            now = time.perf_counter()
            if phase == "start":
                self._at = now
            elif self._at is not None:
                self.rows.append((self._at - self.t0, now - self._at))

    def __enter__(self):
        gc.callbacks.append(self._seen)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._seen)

    def line(self, until):
        held = [(a, d) for a, d in self.rows if a <= until]
        return (f"{len(held)} full collections of the garbage collector "
                f"(s in, ms): " + ", ".join(f"{a:.3f} {d * 1e3:.1f}"
                                            for a, d in held))


def completed_in_window(record, seconds):
    return [sid for sid, r in record.rows.items()
            if r["ok"] and r["done"] is not None and r["done"] <= seconds]
