"""Reading a torch.profiler trace of the traced stretch of a window.

Device events are the card's kernels, copies and sets (not the copies of
user annotations the card also records).  A device event is tied to the
host call that launched it by its correlation id, so device time can be
charged to the benchmark's spans (record_function regions named
`perfbench.*`) around the calls into the program."""

from __future__ import annotations

import collections

SPAN_PREFIX = "perfbench."
WINDOW_SPAN = "perfbench.window"


RUNTIME = ("cuda", "cu")     # host calls that launch device work


def _is_device(e) -> bool:
    return "CUDA" in str(e.device_type()) or "GPU" in str(e.device_type())


def _start(e) -> int:
    f = getattr(e, "start_ns", None)
    return f() if f else int(e.start_us() * 1000)


def _dur(e) -> int:
    f = getattr(e, "duration_ns", None)
    return f() if f else int(e.duration_us() * 1000)


def _is_annotation(e) -> bool:
    flag = getattr(e, "is_user_annotation", None)
    return (flag is not None and flag()) or e.name().startswith(SPAN_PREFIX)


class Trace:
    """`host` is the benchmark's Spans, `t_on` the host clock at the traced
    window span's start."""

    def __init__(self, prof, host=None, t_on=None):
        events = list(prof.profiler.kineto_results.events())
        self.device = []          # (start_ns, end_ns, name, launch_ns)
        self.spans = []           # (start_ns, end_ns, name, thread)
        launch = {}
        window = None
        device_raw = []
        for e in events:
            name = e.name()
            if _is_device(e):
                if not _is_annotation(e):
                    device_raw.append(e)
                continue
            if name == WINDOW_SPAN:
                window = (_start(e), _start(e) + _dur(e))
            elif name.startswith(SPAN_PREFIX):
                self.spans.append((_start(e), _start(e) + _dur(e), name,
                                   None))
            if name.startswith(RUNTIME):
                launch[e.correlation_id()] = _start(e)
        for e in device_raw:
            at = launch.get(e.correlation_id())
            linked = getattr(e, "linked_correlation_id", None)
            if at is None and linked is not None:
                at = launch.get(linked())
            self.device.append((_start(e), _start(e) + _dur(e), e.name(),
                                at))
        if window is None:
            raise RuntimeError("the trace holds no perfbench.window span")
        self.window = window
        if host is not None:
            offset = window[0] - int(t_on * 1e9)
            self.spans += [(int(s * 1e9) + offset, int(e * 1e9) + offset,
                            name, None) for name, s, e in host.rows]
        self.uncorrelated = sum(1 for d in self.device if d[3] is None)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def _in_window(self):
        lo, hi = self.window
        return [d for d in self.device if d[1] > lo and d[0] < hi]

    def launched_in_window(self):
        lo, hi = self.window
        return [d for d in self.device
                if d[3] is not None and lo <= d[3] <= hi]

    def merged(self):
        """Union of the device intervals inside the window."""
        lo, hi = self.window
        out = []
        for s, e, _, _ in sorted(self._in_window()):
            s, e = max(s, lo), min(e, hi)
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.merged()) / 1e9

    def device_ops(self, top=10):
        tot = collections.Counter()
        for s, e, name, _ in self._in_window():
            tot[short(name)] += (e - s) / 1e9
        return [[k, v] for k, v in tot.most_common(top)]

    def span_at(self, t):
        """The innermost benchmark span open at host time t."""
        best = None
        for s, e, name, _ in self.spans:
            if s <= t <= e and (best is None or e - s < best[1] - best[0]):
                best = (s, e, name)
        return best[2] if best else "no perfbench span"

    def _gaps(self):
        """The idle gaps inside the window, longest first."""
        lo, hi = self.window
        gaps, prev = [], lo
        for s, e in self.merged():
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if hi > prev:
            gaps.append((prev, hi))
        return sorted(gaps, key=lambda g: g[0] - g[1])

    def idle_gaps(self, top=10):
        return [[self.span_at((s + e) // 2), (e - s) / 1e9]
                for s, e in self._gaps()[:top]]

    def longest_gap(self):
        """(its span, its start in seconds after the window's, seconds)."""
        gaps = self._gaps()
        if not gaps:
            return "none", 0.0, 0.0
        s, e = gaps[0]
        return (self.span_at((s + e) // 2), (s - self.window[0]) / 1e9,
                (e - s) / 1e9)

    def span_device_s(self, name) -> tuple[float, int]:
        """(device seconds launched under spans called `name`, spans)."""
        spans = [(s, e) for s, e, n, _ in self.spans if n == name]
        total = 0
        for s, e, _, at in self.launched_in_window():
            if any(a <= at <= b for a, b in spans):
                total += e - s
        return total / 1e9, len(spans)

    def count(self, ident) -> int:
        """Device events launched in the window whose kernel is `ident`."""
        return sum(1 for d in self.launched_in_window()
                   if kernel_ident(d[2]) == ident)

    def device_s_of(self, idents) -> float:
        return sum(e - s for s, e, name, _ in self.launched_in_window()
                   if kernel_ident(name) in idents) / 1e9


def kernel_ident(name: str) -> str:
    """A device kernel's identifier: its name without return type, template
    arguments, parameters or namespaces."""
    n = name.replace("(anonymous namespace)::", "").replace("void ", "")
    n = n.strip()
    for cut in ("<", "("):
        n = n.split(cut)[0]
    return n.split("::")[-1].strip()


def short(name: str, width: int = 120) -> str:
    return name if len(name) <= width else name[:width]
