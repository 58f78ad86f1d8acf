"""The per-layer readers of the dialogue cell (runners/train_dialogue.py),
from the program's span recorder (lib/program_spans.py) beside a traced
run's Trace.  `r` holds `rows` (the recorder's rows over the window),
`trace` and `traced_steps`, and, a value a step before the profiler
records, `input_s` (the benchmark's wait and copy spans) and
`untraced_step_s` (the step's wall time).
Device ms are a traced step's: launched under the span over the traced
`fmmt.train.forward` spans.  Each returns None where it finds nothing to
read (a program without the spans or the counter)."""

from __future__ import annotations

import statistics

from perfbench.lib import program_spans as ps

STEP = "fmmt.train.forward"
SLOTS = "fmmt.data.slots"


def _device_ms(r, names):
    return ps.device_ms_per(r.get("trace"), r.get("rows"), names, STEP)


def encoders_device_ms(r):
    return _device_ms(r, ("fmmt.model.encoders",))


def text_device_ms(r):
    return _device_ms(r, ("fmmt.model.text",))


def fusion_device_ms(r):
    return _device_ms(r, ("fmmt.model.crossmodal", "fmmt.model.head"))


def backward_device_ms(r):
    return _device_ms(r, ps.BACKWARD)


def slot_fill_pct(r):
    """Valid utterances over utterance slots of the batches fetched in the
    window, from the program's `fmmt.data.slots` counter."""
    counts = [row.value for row in r.get("rows") or ()
              if row.name == SLOTS and row.value]
    slots = sum(v[1] for v in counts)
    return 100.0 * sum(v[0] for v in counts) / slots if slots else None


def input_ms(r):
    """Host ms a step that the step's thread spends on its input, before
    the profiler records: waiting for the loader's next batch and the copy
    to the card.  The loader's `fmmt.data.fetch` runs on its own thread,
    overlapped with the step, and is not counted."""
    before = r.get("input_s")
    return 1e3 * statistics.fmean(before) if before else None


def device_idle_pct(r):
    """Share of an untraced step's wall time in which the card is idle:
    the device-busy seconds a traced step (the profiler leaves the card's
    work as it is but slows the host) over the mean wall seconds of a step
    before the profiler records."""
    t, n, wall = r.get("trace"), r.get("traced_steps"), \
        r.get("untraced_step_s")
    if t is None or not n or not wall:
        return None
    return 100.0 * (1.0 - t.busy_s() / n / statistics.fmean(wall))
