"""torch.profiler over a fixed stretch of a window, its events kept in
memory (no trace file is written: a whole window's trace would be large).
A serving window is traced from `start_s` for `length_s` seconds
(`tick`); a training window over a fixed run of steps (`record` one step
before the first, `begin`, `end`).  Recording starts `LEAD_S` (or a step)
before the stretch, whose own span opens after it: turning the recording
on holds the host up for a while, and that stall stays outside."""

from __future__ import annotations

import time

LEAD_S = 0.5


class Tracer:
    """See the module docstring; `spans` are the benchmark's host spans."""

    def __init__(self, torch, ctx, spec, spans):
        self.torch = torch
        self.ctx = ctx
        self.spans = spans
        self.start = float(spec.get("start_s", 1.0))
        self.length = float(spec.get("length_s", 3.0))
        self.stop = self.start + self.length
        self.prof = None
        self.span = None
        self.trace = None
        self.t_on = self.t_off = None
        self.recording = False
        self.t0 = None      # the window's start on the host clock

    def arm(self):
        """Start the profiler at set-up, in its warm-up phase: its first
        start initialises the card's tracing, which takes seconds, and the
        traced stretch then begins and ends with a cheap step."""
        from torch.profiler import ProfilerActivity, profile, schedule
        acts = [ProfilerActivity.CPU]
        if self.torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts, schedule=schedule(
            wait=0, warmup=1, active=1, repeat=1))
        self.prof.start()

    def record(self):
        self.prof.step()
        self.recording = True

    def begin(self):
        if not self.recording:
            self.record()
        self.span = self.torch.profiler.record_function("perfbench.window")
        self.span.__enter__()
        self.t_on = time.perf_counter()

    def end(self):
        self._stop()

    def tick(self, now):
        if not self.recording and now >= self.start - LEAD_S:
            self.record()
        elif self.t_on is None and now >= self.start:
            self.begin()
            self.stop = self.t_on - self.t0 + self.length
        elif (self.t_on is not None and self.t_off is None
              and now >= self.stop):
            self._stop()

    def _stop(self):
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()
        self.span.__exit__(None, None, None)
        self.t_off = time.perf_counter()

    def finish(self):
        from perfbench.lib.trace import Trace
        if self.t_on is None:
            raise RuntimeError("the traced stretch never started: the "
                               "window is shorter than its start")
        if self.t_off is None:
            self._stop()
        self.prof.step()        # the recording ends and is collected here,
        # after the window: collecting takes seconds
        self.trace = Trace(self.prof, self.spans, self.t_on)
        self.prof.stop()
        self.prof = None
        t = self.trace
        self.ctx.say(f"trace: {len(t.device)} device events, "
                     f"{t.uncorrelated} without their launch, "
                     f"{len(t.spans)} benchmark spans, window "
                     f"{t.window_s:.3f} s")
        name, at, length = t.longest_gap()
        self.ctx.say(f"longest idle gap: {length * 1e3:.1f} ms at "
                     f"{self.t_on - self.t0 + at:.3f} s into the window, "
                     f"in {name}")

    def inside(self, interval):
        return self.t_on <= interval[0] and interval[1] <= self.t_off

    def covers(self, t_rel):
        return self.start <= t_rel <= self.stop + 1.0

    def breakdown(self):
        return {"device_ops": self.trace.device_ops(),
                "idle_gaps": self.trace.idle_gaps()}
