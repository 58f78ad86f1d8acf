"""Run records, profiler traces and NaN checks (counterpart of
facialmmt_tpu/utils/observability.py).

  * MetricWriter prints the reference's progress lines (reference
    train.py:36-42, 146-152) and appends the same records as JSON lines to
    `--metrics_path`: one object per record with `tag` (`src_train`,
    `trg_train`, `val`, `test`), `step`, `time` (Unix seconds) and the
    record's numbers.  An empty path prints only.
  * trace_span names a region of the program's work: a row of the span
    recorder (Recorder, below) while it is enabled, and a record_function
    region while a torch.profiler captures; next to nothing otherwise.
    profile_trace captures one region; StepProfiler (`--profile_dir`)
    captures a few training steps, each a `ProfilerStep#n` span.  The
    traces are Chrome traces (`*.pt.trace.json`: chrome://tracing,
    Perfetto, TensorBoard's profiler plugin), with the card's kernels when
    a card is present.
  * enable_nan_debugging (`--debug_nans`) raises FloatingPointError at the
    first module whose forward output holds a NaN and at the first backward
    Function that returns one.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import json
import os
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

_get_ident = threading.get_ident


class MetricWriter:
    def __init__(self, path: str = ""):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._f = open(path, "a", buffering=1)
        else:
            self._f = None

    def write(self, tag: str, step: int, **metrics: Any):
        rec: Dict[str, Any] = {"tag": tag, "step": step,
                               "time": time.time(), **metrics}
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
        return rec

    def log_train(self, task: str, epoch: int, batch: int, num_batches: int,
                  ms_per_batch: float, loss: float):
        """Reference-format train line (reference train.py:39-40, 149-150)."""
        print(f"**{task}** | Epoch {epoch:2d} | Batch {batch:3d}/"
              f"{num_batches:3d} | Time/Batch(ms) {ms_per_batch:5.2f} | "
              f"Train Loss {loss:5.4f}")
        self.write(f"{task.lower()}_train", batch, epoch=epoch,
                   ms_per_batch=ms_per_batch, loss=loss)

    def log_eval(self, epoch: int, hours: float, val_f1: float):
        print("-" * 50)
        print(f"**TRG** | Epoch {epoch:2d} | Time {hours:5.4f} hour | "
              f"val_wg_av_f1 {val_f1:5.4f} ")
        print("-" * 50)
        self.write("val", epoch, wf1=val_f1, hours=hours)

    def log_test(self, wf1: float):
        print(f"**TEST** | wg_av_f1 {wf1:5.4f} ")
        self.write("test", 0, wf1=wf1)

    def close(self):
        if self._f:
            self._f.close()
            self._f = None


def _activities():
    """The CPU, and the card's kernels and copies when a card is present."""
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def _rank() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", "0"))


def _write_trace(prof, log_dir: str) -> None:
    """`rank<r>.<ns>.pt.trace.json` in `log_dir`: one file per rank and
    capture."""
    from torch.profiler import tensorboard_trace_handler

    tensorboard_trace_handler(log_dir, worker_name=f"rank{_rank()}")(prof)


class Row(NamedTuple):
    """One row of the span recorder.  Spans: `start_ns` / `end_ns` from
    time.time_ns(), the clock torch.profiler stamps its events with, so a
    row sits on a trace's timeline as it is.  `parent`: the innermost span
    open on the same thread when it began; `key`: a pack or request id
    shared by the rows of one unit of work (given, or the enclosing
    span's).  `value`: what the row's writer counted (add_row); an
    `fmmt.gc` row holds the objects its full collection freed."""
    name: str
    start_ns: int
    end_ns: int
    thread: int
    parent: Optional[str]
    key: Any
    value: Any


class Recorder:
    """The program's spans, kept in memory.

    Disabled, it records nothing and trace_span costs one flag check.
    enable() starts recording into a ring of the newest `capacity` rows and
    registers one gc.callbacks hook that records each full (generation 2)
    collection of Python's garbage collector as an `fmmt.gc` row on the
    thread that triggered it; disable() stops both.  rows() is a copy of
    the ring, clear() empties it; nothing is written anywhere else.  The
    rows live here because torch.profiler drops the record_function regions
    of threads started before it, the serving front's packer among them."""

    def __init__(self, capacity: int = 1 << 16):
        self.on = False
        self.capacity = capacity
        self._rows: collections.deque = collections.deque(maxlen=capacity)
        self._local = threading.local()
        self._gc_start: Optional[int] = None
        self._gc_hook = self._on_gc

    def enable(self) -> None:
        if self._gc_hook not in gc.callbacks:
            gc.callbacks.append(self._gc_hook)
        self.on = True

    def disable(self) -> None:
        self.on = False
        while self._gc_hook in gc.callbacks:
            gc.callbacks.remove(self._gc_hook)

    def rows(self) -> List[Row]:
        return [Row._make(r) for r in list(self._rows)]

    def clear(self) -> None:
        self._rows.clear()

    def _stack(self) -> list:
        """This thread's open spans and keyed frames, innermost last."""
        try:
            return self._local.stack
        except AttributeError:
            stack = self._local.stack = []
            return stack

    def _context(self):
        """(the innermost open span's name, the innermost key) on this
        thread."""
        stack = self._stack()
        if not stack:
            return None, None
        top = stack[-1]
        return (top.name if top.name is not None else top.parent), top.key

    def add(self, name: str, start_ns: int, end_ns: Optional[int] = None,
            key: Any = None, value: Any = None) -> None:
        """A row of `name` from `start_ns` to `end_ns` (now if None)."""
        parent, inherited = self._context()
        self._rows.append((name, start_ns,
                           time.time_ns() if end_ns is None else end_ns,
                           _get_ident(), parent,
                           inherited if key is None else key, value))

    def _on_gc(self, phase: str, info: Dict[str, int]) -> None:
        if info.get("generation") != 2:
            return
        if phase == "start":
            self._gc_start = time.time_ns()
            return
        start, self._gc_start = self._gc_start, None
        if start is not None and self.on:
            self._rows.append(("fmmt.gc", start, time.time_ns(),
                               _get_ident(), self._context()[0], None,
                               info.get("collected")))


class _Span:
    """An open trace_span (or keyed) frame: its own name and key, and the
    enclosing span's name (`parent`); see trace_span."""

    __slots__ = ("rec", "name", "key", "parent", "start", "region", "stack")

    def __init__(self, rec: Recorder, name: Optional[str], key: Any):
        self.rec, self.name, self.key = rec, name, key
        self.region = self.stack = self.parent = None

    def __enter__(self):
        rec = self.rec
        if rec.on:
            stack = self.stack = rec._stack()
            if stack:
                top = stack[-1]
                self.parent = top.name if top.name is not None else \
                    top.parent
                if self.key is None:
                    self.key = top.key
            stack.append(self)
            self.start = time.time_ns()
        # inside the row's stamps, so the region lies within them
        if self.name is not None and _autograd_profiler._is_profiler_enabled:
            self.region = torch.profiler.record_function(self.name)
            self.region.__enter__()
        return self

    def __exit__(self, *exc):
        if self.region is not None:
            self.region.__exit__(*exc)
        stack = self.stack
        if stack is not None:
            end = time.time_ns()
            if stack[-1] is self:
                stack.pop()
            else:
                stack.remove(self)
            # a span still open at disable() adds no row, as add_row
            if self.name is not None and self.rec.on:
                self.rec._rows.append((self.name, self.start, end,
                                       _get_ident(), self.parent, self.key,
                                       None))
        return False


RECORDER = Recorder()
_OFF = contextlib.nullcontext()


def trace_span(name: str, key: Any = None):
    """A span of the program's work, as a context manager.  With the
    recorder enabled it adds a Row (`key`: a pack or request id; None takes
    the enclosing span's); while a torch.profiler captures it also opens
    record_function(name), so a trace carries the same names.  Otherwise it
    returns a shared empty context: no clock is read, no region opened."""
    if not (RECORDER.on or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return _Span(RECORDER, name, key)


def keyed(key: Any):
    """A frame that gives `key` to the spans opened inside it on this
    thread, itself no row."""
    if not RECORDER.on:
        return _OFF
    return _Span(RECORDER, None, key)


def stamp() -> Optional[int]:
    """time.time_ns() while the recorder is enabled, else None (no clock
    read): the start of a row that add_row closes later."""
    return time.time_ns() if RECORDER.on else None


def add_row(name: str, start_ns: Optional[int], end_ns: Optional[int] = None,
            key: Any = None, value: Any = None) -> None:
    """A row of `name` from `start_ns` (a stamp()) to `end_ns` (now if
    None); nothing when the stamp was taken with the recorder disabled, or
    it is disabled now."""
    if start_ns is not None and RECORDER.on:
        RECORDER.add(name, start_ns, end_ns, key, value)


def enable() -> None:
    RECORDER.enable()


def disable() -> None:
    RECORDER.disable()


def rows() -> List[Row]:
    return RECORDER.rows()


def clear() -> None:
    RECORDER.clear()


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture the enclosed region as a trace in `log_dir`; yields the
    torch.profiler.profile (its key_averages() and events() read the
    capture once the region has ended)."""
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=_activities())
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        _write_trace(prof, log_dir)


def _step_schedule(step: int):
    return torch.profiler.ProfilerAction.RECORD


class StepProfiler:
    """Bounded trace capture for training loops (`--profile_dir`).

    step() is called after every training step.  With an empty `log_dir`
    every call is a no-op and no profiler is touched.  Otherwise the first
    `skip` calls pass, call `skip + 1` starts a capture and call
    `skip + steps + 1` stops it, so the trace holds the `steps` training
    steps after the first `skip + 1` (the JAX package's schedule), as the
    spans ProfilerStep#0 .. #steps-1; then it prints
    `profiler: <steps>-step device trace written`.  One capture per run.
    close() ends a capture the run cut short (its last span then holds what
    ran after the last step until close) and writes it.  Each rank writes
    its own file (`rank<r>.<ns>.pt.trace.json`)."""

    def __init__(self, log_dir: str, steps: int = 5, skip: int = 1):
        self.log_dir = log_dir
        self.steps = steps
        self.skip = skip
        self._seen = 0
        self._prof = None

    def step(self):
        if not self.log_dir:
            return
        self._seen += 1
        if self._seen == self.skip + 1 and self._prof is None:
            os.makedirs(self.log_dir, exist_ok=True)
            # a schedule that always records: it opens the ProfilerStep#n
            # spans, and start / stop below bound the capture
            self._prof = torch.profiler.profile(activities=_activities(),
                                                schedule=_step_schedule)
            self._prof.start()
        elif self._prof is not None and self._seen > self.skip + self.steps:
            self._finish()
            self.log_dir = ""  # one capture per run
            print(f"profiler: {self.steps}-step device trace written")
        elif self._prof is not None:
            self._prof.step()

    def _finish(self):
        prof, self._prof = self._prof, None
        prof.stop()
        _write_trace(prof, self.log_dir)

    def close(self):
        if self._prof is not None:
            self._finish()


class NanDebugging:
    """What enable_nan_debugging switched on; remove() restores the process
    as it was (anomaly mode's two settings and the hook)."""

    def __init__(self, hook, anomaly: bool, check_nan: bool):
        self._hook = hook
        self._anomaly = (anomaly, check_nan)

    def remove(self) -> None:
        if self._hook is not None:
            self._hook.remove()
            self._hook = None
            torch.autograd.set_detect_anomaly(*self._anomaly)


def _floating_tensors(out):
    if isinstance(out, torch.Tensor):
        if out.is_floating_point():
            yield out
    elif isinstance(out, (tuple, list)):
        for item in out:
            yield from _floating_tensors(item)
    elif isinstance(out, dict):
        for item in out.values():
            yield from _floating_tensors(item)


def _raise_on_nan(module, inputs, output):
    for t in _floating_tensors(output):
        if torch.isnan(t).any():
            raise FloatingPointError(
                f"NaN in the output of module {type(module).__name__}"
                f"({module.extra_repr()}), shape {tuple(t.shape)}")


def enable_nan_debugging() -> NanDebugging:
    """The counterpart of `jax_debug_nans`: raise FloatingPointError at the
    first operation that makes a NaN (not an inf), forward or backward.

    Forward: a global forward hook checks every module's floating outputs
    and names the first module whose output holds a NaN (inner modules
    finish first).  Backward: anomaly mode with check_nan, which raises when
    a backward Function (the kernels' autograd Functions included) returns
    a NaN; the train steps (train/steps.py::backward) raise that as
    FloatingPointError.  Nothing is computed differently: a clean step gives
    the same bits with and without it, only slower (a NaN test, and so a
    device sync, after every module and backward Function)."""
    handle = NanDebugging(
        torch.nn.modules.module.register_module_forward_hook(_raise_on_nan),
        torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
    torch.autograd.set_detect_anomaly(True, check_nan=True)
    return handle
