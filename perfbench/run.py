"""Run one cell of the benchmark of facialmmt_tpu_torch.

    python3 perfbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  The cell's entries are read from
BENCHMARK.json, its configuration from configs/, its traffic from
workloads/<NAME>.json, whose `runner` names the module of runners/ that
drives it.  The last line of standard output is the result as one JSON
object; the numbers the check compared, each beside its limit, are the last
lines of standard error and the last key of the result."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _environment():
    """Every build and kernel cache inside the checkout, at fixed paths;
    no library may load JAX."""
    cache = os.path.join(REPO, "perfbench", "_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, device=None, t_start=T_START):
    """Run a cell; returns (exit code, result or None).  `device` is for the
    tests: without it the run needs as many cards as the cell asks for."""
    args = parse(argv)
    _environment()
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import torch

    from perfbench.lib import harness

    if device is None:
        from perfbench.lib import config as cfgmod
        chips = cfgmod.workload_entry(args.workload, REPO)["chips"]
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if seen < chips:
            print(f"perfbench: the cell needs {chips} CUDA device(s); "
                  f"{seen} visible", file=sys.stderr)
            return 2, None
        device = torch.device("cuda", 0)
    ctx = harness.Context(args, t_start, torch.device(device), REPO)
    runner = importlib.import_module(
        f"perfbench.runners.{ctx.traffic['runner']}")
    out = runner.run(ctx)
    found = harness.forbidden_modules()
    if found:
        print(f"perfbench: modules that must not load were loaded: {found}",
              file=sys.stderr)
        return 3, None
    names = {m["name"]: m["unit"] for m in ctx.bench["end_to_end"]}
    if ctx.trace:
        metrics = harness.per_layer_metrics(ctx, out["readings"])
        if out["readings"].get("shortfall"):
            ctx.say(f"profiler events short of the launches (seen, "
                    f"launched): {out['readings']['shortfall']}")
        if out["readings"].get("launch_mismatch"):
            ctx.say(f"launches the work model counts against the program's "
                    f"counters: {out['readings']['launch_mismatch']}")
    else:
        metrics = {k: {"value": v, "unit": names[k]}
                   for k, v in out["metrics"].items()}
    result = {"correct": bool(out["correct"]), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": out["device"]}
    if ctx.trace and out.get("breakdown"):
        result["breakdown"] = out["breakdown"]
    result["checks"] = {k: {"value": v[0], "limit": v[1]}
                        for k, v in out["checks"].items()}
    print("checks: " + harness.checks_line(out["checks"]), file=sys.stderr)
    for k, v in out["checks"].items():
        print(f"{k} {v[0]!r} limit {v[1]!r}", file=sys.stderr)
    sys.stderr.flush()
    return 0, result


if __name__ == "__main__":
    code, result = main()
    if result is not None:
        print(json.dumps(result), flush=True)
    sys.exit(code)
