"""Host spans the benchmark records around its calls into the program, on
any thread, on the host clock (time.perf_counter).  The profiler records
regions only on threads started after it, and the front end's packer thread
starts at set-up, so the spans are kept here and placed on the trace's clock
by the traced window's own span (trace.Trace)."""

from __future__ import annotations

import contextlib
import threading
import time


class Spans:
    def __init__(self):
        self.rows = []          # (name, start, end) in perf_counter seconds
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name):
        t = time.perf_counter()
        try:
            yield
        finally:
            with self._lock:
                self.rows.append((name, t, time.perf_counter()))
