"""Run one cell as run.py does, with the program's span recorder on
(facialmmt_tpu_torch/utils/observability.py), and read the program's own
spans (lib/program_spans.py).

    python3 perfbench/program_spans_run.py --workload NAME --seed N \\
        --seconds S --trace 0|1

The recorder is enabled at the end of set-up (the runner's first
ctx.elapsed()) and read over the measured window.  Host readings (queue
wait, dispatch, fetch) need no trace; a traced run takes them before its
profiler starts to record (the first Tracer.record), and full collections
over the whole window.  With --trace 1 the device readings (device ms a
pack or a step launched under each module span, and the share the module
spans hold) and the idle gaps named by the innermost span of either kind
are read too, and one line sets each program span beside the benchmark's
own around the same call.  A ring that filled up (its oldest rows lost)
is reported.  The last line of standard output is run.py's result with two
more keys: `program_spans` (the readings) and, traced, `program_gaps`.
run.py's runs of a cell leave the recorder off.

To go once the runners enable the recorder themselves and hand its rows
to their readings (a `benchmark` change): this file stands beside run.py
until then."""

import time

T_START = time.perf_counter()

import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from perfbench import run  # noqa: E402
from perfbench.lib import program_spans as ps  # noqa: E402
from perfbench.lib.tracer import Tracer  # noqa: E402

SERVE = "serve"     # the runner of the serving cells
FETCH = ("fmmt.data.fetch",)


def readings(ctx, out, marks):
    """The program-span readings of a finished run, named as the metrics
    they would be in this cell (`<quantity>.<the cell's suffix>`).
    `marks`: the window's start and, traced, the profiler's, in ns."""
    from facialmmt_tpu_torch.utils import observability as obs

    rows = obs.rows()
    if len(rows) >= obs.RECORDER.capacity:
        ctx.say(f"WARNING: the span recorder's ring of {len(rows)} rows "
                f"filled up: the window's first rows are lost")
    lo = marks["window"]
    window = (lo, lo + int(ctx.seconds * 1e9))
    trace = out["readings"].get("trace")
    host = (window if trace is None else
            (window[0], marks.get("recording", window[1])))
    # a full collection or two a run: read over the whole window, traced
    # or not
    values = {"gc_ms_per_s": ps.gc_ms_per_s(rows, window)}
    if ctx.traffic["runner"] == SERVE:
        values.update(
            queue_wait_ms=ps.queue_wait_p95_ms(rows, host),
            dispatch_ms=ps.host_ms(rows, "fmmt.serve.dispatch", host),
            program_build_pack_ms=ps.host_ms(rows, "fmmt.serve.build_pack",
                                             host))
        unit, modules, of = ("fmmt.serve.dispatch", ps.SERVE_MODULES,
                             ("fmmt.serve.dispatch",))
        parts = {"stage_device_ms": ps.STAGE}
    else:
        values["fetch_ms"] = ps.host_ms(rows, FETCH[0], host)
        unit, modules = "fmmt.train.optimizer", ps.TRAIN_MODULES
        of = ("fmmt.train.forward",) + ps.BACKWARD + ps.OPTIMIZER
        parts = {"backward_device_ms": ps.BACKWARD,
                 "optimizer_device_ms": ps.OPTIMIZER}
    if trace is not None:
        if ctx.traffic["runner"] == SERVE:   # the packs the stretch holds
            stretch = ps.within_units(trace, rows, unit, modules)[1]
        else:                                # every step the stretch holds
            stretch = ps.spans(rows, within=trace.window)
        parts.update(swin_device_ms=ps.SWIN, text_device_ms=ps.TEXT,
                     fusion_device_ms=ps.FUSION)
        for name, names in parts.items():
            values[name] = ps.device_ms_per(trace, stretch, names, unit)
        values["module_share_pct"] = ps.share_pct(trace, stretch, modules,
                                                  of)
        values["module_share_of_stretch_pct"] = ps.share_pct(
            trace, stretch, modules)
        ctx.say("program spans beside the benchmark's: "
                + ps.twins_line(trace, rows, host))
    suffix = ctx.per_layer()[0]["name"].split(".", 1)[1]
    return ({f"{k}.{suffix}": v for k, v in values.items()
             if v is not None},
            ps.idle_gaps(trace, rows) if trace is not None else None)


def main(argv=None, device=None, t_start=T_START):
    """run.main with the recorder on from the end of set-up; returns (exit
    code, result)."""
    args = run.parse(argv)
    run._environment()
    from facialmmt_tpu_torch.utils import observability as obs

    from perfbench.lib import config as cfgmod

    spec = cfgmod.traffic_file(
        cfgmod.workload_entry(args.workload, REPO)["traffic"])
    runner = importlib.import_module(f"perfbench.runners.{spec['runner']}")
    seen, marks = {}, {}
    real_run, real_record = runner.run, Tracer.record

    def kept(ctx):
        setup = ctx.elapsed

        def setup_done():     # the runner's first call ends its set-up
            if "window" not in marks:
                obs.enable()
                marks["window"] = time.time_ns()
            return setup()

        ctx.elapsed = setup_done
        seen["ctx"], seen["out"] = ctx, real_run(ctx)
        return seen["out"]

    def record(tracer):
        marks.setdefault("recording", time.time_ns())
        real_record(tracer)

    runner.run, Tracer.record = kept, record
    try:
        code, result = run.main(argv, device, t_start)
    finally:
        runner.run, Tracer.record = real_run, real_record
        obs.disable()
    if result is not None:
        result["program_spans"], gaps = readings(seen["ctx"], seen["out"],
                                                 marks)
        if gaps is not None:
            result["program_gaps"] = gaps
    obs.clear()
    return code, result


if __name__ == "__main__":
    code, result = main()
    if result is not None:
        print(json.dumps(result), flush=True)
    sys.exit(code)
