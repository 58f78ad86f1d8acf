"""What every runner shares: the run's context, the program's kernel launch
counters, the per-layer readers found by name, and the result line."""

from __future__ import annotations

import importlib.util
import os
import sys
import time

from perfbench.lib import config as cfgmod

FORBIDDEN = ("jax", "jaxlib", "flax", "facialmmt_tpu")


class Context:
    """One run: its arguments, its workload's entries and files, the device
    it runs on and the process's start on the host clock."""

    def __init__(self, args, t_start, device, repo=cfgmod.REPO):
        self.args = args
        self.t_start = t_start
        self.device = device
        self.repo = repo
        self.root = os.path.join(repo, "perfbench")
        self.bench = cfgmod.benchmark(repo)
        self.workload = cfgmod.workload_entry(args.workload, repo)
        self.cfg_file = cfgmod.config_file(self.workload["config"], repo)
        self.tree = self.cfg_file["config"]
        self.traffic = cfgmod.traffic_file(self.workload["traffic"],
                                           self.root)
        self.seed = int(args.seed)
        self.seconds = float(args.seconds)
        self.trace = bool(int(args.trace))

    def say(self, line: str):
        print(line, file=sys.stderr, flush=True)

    def elapsed(self) -> float:
        return time.perf_counter() - self.t_start

    def end_to_end(self):
        """The end-to-end metrics this cell reports."""
        name = self.workload["name"]
        return [m for m in self.bench["end_to_end"]
                if name in m.get("workloads", [name])]

    def per_layer(self):
        """The per-layer metrics whose `workloads` list this cell."""
        name = self.workload["name"]
        return [m for m in self.bench["per_layer"]
                if name in m["workloads"]]


def load_file(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(ctx: Context, metric: str):
    return load_file(os.path.join(ctx.root, "metrics", metric + ".py"),
                     "perfbench_metric_" + metric.replace(".", "_")).read


def kernel_models(root: str):
    """Every kernel work file under kernels/, by name."""
    d = os.path.join(root, "kernels")
    return {f[:-3]: load_file(os.path.join(d, f), "perfbench_kernel_" + f[:-3])
            for f in sorted(os.listdir(d)) if f.endswith(".py")}


def steps_in_window(ends, seconds):
    """(steps completed in the window, the time the last of them ended): a
    rate over whole steps, without the fraction of a step the window's
    close cuts."""
    done = [t for t in ends if t <= seconds]
    return len(done), (done[-1] if done else seconds)


def launch_counts():
    from facialmmt_tpu_torch.ops import kernels
    return kernels.launch_counts()


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def device_info(torch, device, count, trace=None):
    info = {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
            "count": count,
            "memory_peak_bytes": (int(torch.cuda.max_memory_allocated(device))
                                  if device.type == "cuda" else 0)}
    if trace is not None:
        info["busy_s"] = trace.busy_s()
        info["window_s"] = trace.window_s
    return info


def per_layer_metrics(ctx, readings):
    out = {}
    for m in ctx.per_layer():
        value = reader(ctx, m["name"])(readings)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def checks_line(checks: dict) -> str:
    return "; ".join(f"{k} {v[0]:.6g} (limit {v[1]:.6g})"
                     for k, v in checks.items())
