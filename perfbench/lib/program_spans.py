"""Readings of the program's own spans: the rows of the span recorder in
facialmmt_tpu_torch/utils/observability.py (`fmmt.*`), beside a traced
run's Trace (lib/trace.py).

The rows carry time.time_ns() stamps, the clock torch.profiler stamps its
events with, so they sit on the trace's timeline as they are, with no
offset.  A device event is charged to a program span when the host call
that launched it (tied by its correlation id) falls inside the span, on
whatever thread: the front's packer and autograd's threads too.  Host
readings are taken over a window given (where no profiler records),
device readings over the traced stretch.  Every function returns None where it
finds nothing to read (a program without the recorder)."""

from __future__ import annotations

import bisect
import statistics

from perfbench.lib.load import percentile

STAGE = ("fmmt.serve.stage",)
SWIN = ("fmmt.model.swin",)
TEXT = ("fmmt.model.text",)
FUSION = ("fmmt.model.filter", "fmmt.model.encoders",
          "fmmt.model.crossmodal", "fmmt.model.head")
BACKWARD = ("fmmt.train.backward",)
OPTIMIZER = ("fmmt.train.optimizer",)
SERVE_MODULES = STAGE + SWIN + TEXT + FUSION
TRAIN_MODULES = SWIN + TEXT + FUSION + BACKWARD + OPTIMIZER
# the program's span beside the benchmark's own around the same call
TWINS = (("fmmt.serve.build_pack", "perfbench.build_pack"),
         ("fmmt.train.optimizer", "perfbench.optimizer"),
         ("fmmt.data.fetch", "perfbench.input"))


def spans(rows, names=None, within=None):
    """The rows that are spans (counters end where they start), of `names`
    if given, lying inside `within` (start_ns, end_ns) if given."""
    out = []
    for r in rows:
        if r.end_ns <= r.start_ns or (names and r.name not in names):
            continue
        if within and not (within[0] <= r.start_ns
                           and r.end_ns <= within[1]):
            continue
        out.append(r)
    return out


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def device_s(trace, rows, names) -> float:
    """Device seconds of the window's launches made inside any row of
    `names` (each launch counted once)."""
    cover = _union((r.start_ns, r.end_ns) for r in spans(rows, names))
    starts = [s for s, _ in cover]
    total = 0
    for s, e, _, at in trace.launched_in_window():
        i = bisect.bisect_right(starts, at) - 1
        if i >= 0 and at <= cover[i][1]:
            total += e - s
    return total / 1e9


def within_units(trace, rows, unit, names):
    """(the `unit` rows inside the traced stretch, the rows of `unit` and
    `names` that share a key with one of them): the rows of each whole
    pack, by its pack id.  A unit the stretch cuts is left out with its
    rows, and so is one without a key."""
    units = [u for u in spans(rows, (unit,), trace.window)
             if u.key is not None]
    keys = {u.key for u in units}
    return units, [r for r in spans(rows, (unit,) + tuple(names))
                   if r.key in keys]


def device_ms_per(trace, rows, names, unit):
    """Device ms launched under `names` per `unit` row (a pack's dispatch,
    a step's optimizer) of the stretch."""
    if trace is None or not rows:
        return None
    units = spans(rows, (unit,), trace.window)
    if not units:
        return None
    return device_s(trace, rows, names) / len(units) * 1e3


def share_pct(trace, rows, names, of=None):
    """The share of the device time launched under `of` (every launch of
    the stretch if None) that was launched under `names`."""
    if trace is None or not rows:
        return None
    whole = (device_s(trace, rows, of) if of else
             sum(e - s for s, e, _, _ in trace.launched_in_window()) / 1e9)
    part = device_s(trace, rows, names)
    return 100.0 * part / whole if whole > 0 else None


def host_ms(rows, name, window):
    """Mean host ms of the `name` spans that start in `window` (ns)."""
    d = [(r.end_ns - r.start_ns) / 1e6 for r in spans(rows, (name,))
         if window[0] <= r.start_ns <= window[1]]
    return statistics.fmean(d) if d else None


def gc_ms_per_s(rows, window):
    """Milliseconds of full collections (`fmmt.gc`) a second of `window`,
    the collections cut to it.  Zero is a reading: the recorder was on."""
    if not rows:
        return None
    lo, hi = window
    held = sum(max(0, min(r.end_ns, hi) - max(r.start_ns, lo))
               for r in rows if r.name == "fmmt.gc")
    return held / 1e6 / ((hi - lo) / 1e9)


def queue_wait_p95_ms(rows, window):
    """95th percentile of `fmmt.serve.queued` (submit() until the request's
    pack closed) over the requests submitted in `window`."""
    d = [(r.end_ns - r.start_ns) / 1e6 for r in rows
         if r.name == "fmmt.serve.queued" and r.value is not None
         and window[0] <= r.start_ns <= window[1]]
    return percentile(d, 95) if d else None


def innermost(trace, rows, t):
    """The name of the innermost span, the benchmark's or the program's,
    open at trace time t; a program span with a parent as `name in
    parent` (a full collection names the work it stopped)."""
    best = None
    for s, e, name, _ in trace.spans:
        if s <= t <= e and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    for r in spans(rows):
        if r.start_ns <= t <= r.end_ns and (
                best is None or r.end_ns - r.start_ns < best[1] - best[0]):
            best = (r.start_ns, r.end_ns, r.name if r.parent is None
                    else f"{r.name} in {r.parent}")
    return best[2] if best else "no span"


def idle_gaps(trace, rows, top=10):
    """The stretch's longest idle gaps of the device, each named by the
    innermost span at its middle: [[name, seconds], ...]."""
    return [[innermost(trace, rows, (s + e) // 2), (e - s) / 1e9]
            for s, e in trace._gaps()[:top]]


def twins_line(trace, rows, window):
    """One line: each program span beside the benchmark's span around the
    same call, host ms a call over `window`; for the optimizer also device
    ms a step over the stretch, the benchmark's divided by its spans of the
    whole measured window (lib/trace.py)."""
    out = []
    for ours, theirs in TWINS:
        mine = host_ms(rows, ours, window)
        twin = [(e - s) / 1e6 for s, e, n, _ in trace.spans
                if n == theirs and window[0] <= s <= window[1]]
        if mine is None or not twin:
            continue
        line = (f"{ours} {mine:.4f} vs {theirs} "
                f"{statistics.fmean(twin):.4f} ms host")
        if ours == "fmmt.train.optimizer":
            dev, n = trace.span_device_s(theirs)
            mine_dev = device_ms_per(trace, rows, (ours,), ours)
            if n and mine_dev is not None:
                line += (f", {mine_dev:.4f} vs {dev / n * 1e3:.4f} ms "
                         f"device a step")
        out.append(line)
    return "; ".join(out) or "no program span beside its twin"
