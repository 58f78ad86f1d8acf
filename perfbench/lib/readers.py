"""The per-layer readers, one function per quantity; each metric file under
metrics/ names the one it uses.  `r` is the dict of readings a runner
collects; a reader that finds nothing to read returns None."""

from __future__ import annotations

import statistics

from perfbench.lib.bounds import bound_s
from perfbench.lib.flops import H100_BF16_PEAK_FLOPS


def pack_fill(r):
    sizes = r.get("pack_sizes")
    return statistics.fmean(sizes) if sizes else None


def build_pack_ms(r):
    s = r.get("build_pack_s")
    return statistics.fmean(s) * 1e3 if s else None


def input_ms(r):
    s = r.get("input_s")
    return statistics.fmean(s) * 1e3 if s else None


def optimizer_ms(r):
    t = r.get("trace")
    if t is None:
        return None
    dev, spans = t.span_device_s("perfbench.optimizer")
    return dev / spans * 1e3 if spans and dev > 0 else None


def device_idle_pct(r):
    t = r.get("trace")
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)


def mfu_pct(r):
    macs, secs = r.get("macs"), r.get("macs_window_s")
    if not macs or not secs:
        return None
    return 100.0 * 2.0 * macs / secs / H100_BF16_PEAK_FLOPS


def kernel_roofline_pct(r):
    """The least time of every kernel launch of the program in the traced
    stretch (work counted from shapes by kernels/*.py), over the device time
    of the program's kernels launched there.  The launches the work model
    counts are held to the program's own counters (`launched`, from
    ops/kernels.launch_counts()); where the trace holds fewer events of a
    kernel's marker than the program launched, that kernel's least time is
    scaled to the share of its launches the trace kept."""
    t, steps, models = r.get("trace"), r.get("traced_steps"), r.get("kernels")
    if t is None or not steps or not models:
        return None
    launched = r.get("launched", {})
    least, idents = 0.0, set()
    for name, mod in models.items():
        work = [w for step in steps for w in mod.launches(r["tree"], step)]
        if not work:
            continue
        counted = sum(launched.get(c, 0) for c in mod.COUNTERS)
        if counted != len(work):
            r.setdefault("launch_mismatch", {})[name] = [len(work), counted]
        idents.update(mod.DEVICE_KERNELS)
        share = 1.0
        if mod.MARKER:
            seen = t.count(mod.MARKER)
            if seen < counted:
                r.setdefault("shortfall", {})[name] = [seen, counted]
                share = seen / counted
        least += share * sum(bound_s(f, b) for f, b in work)
    spent = t.device_s_of(idents)
    return 100.0 * least / spent if spent > 0 and least > 0 else None
