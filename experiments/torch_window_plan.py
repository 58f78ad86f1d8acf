"""Kernels 8-10 (csrc/window_attention.cu) under each face chunk, at every
Swin-tiny stage of a 64-face pack.  Needs one NVIDIA GPU:

    python3 experiments/torch_window_plan.py [OUT.json]

For each stage shape (shifted bias nW = 64 / 16 / 4, and nW = 1) and each
entry point (1 window a block, the pair's 2, v2's group of 4), the kernel's
device time from torch.profiler (no host time in it) at the chunk the launch
plan picks for 4, 8 and 16 window slots per SM (SLOTS_PER_SM; at least 2
blocks per SM throughout) and at one face a block.  The
bias is bf16 already, so no cast is timed.  Prints one line per setting and
the sum over the 7 shapes per (entry point, slots per SM); with a
path, writes them as JSON.
"""

import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FACES = 64
STAGES = ((56, 3), (28, 6), (14, 12), (7, 24))     # (resolution, heads)
N, HD = 49, 32


def device_ms(fn, iters=10):
    """Summed kernel durations of one fn() from torch.profiler, in ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA)
    return total / iters / 1e3 if total > 0 else None


def main(out_path=""):
    sys.path.insert(0, ROOT)
    from facialmmt_tpu_torch.ops import kernels
    from facialmmt_tpu_torch.ops.kernels import window_attention as wa

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "-i", "0"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    kernels.library()
    for line in (kernels.BUILD_DIR / "build.log").read_text().splitlines():
        if "window_attention" in line and ("Compiling" in line
                                           or "Used" in line):
            print("build: " + line.strip()[:160])
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(0)
    bf = lambda a: torch.tensor(a).to(dev, torch.bfloat16).contiguous()
    rows, sums = [], {}
    for res, heads in STAGES:
        side = res // 7
        w = FACES * side * side
        for nw in ((side * side, 1) if side > 1 else (1,)):
            q, k, v = (bf(rng.normal(size=(w, heads, N, HD)) * s)
                       for s in (HD ** -0.5, 1.0, 1.0))
            bias = bf(rng.normal(size=(nw, heads, N, N)))
            want = None
            for entry, conc in (("fused", 1), ("paired", 2),
                                ("v2", wa._group_size(w, nw, 4))):
                for per_sm in (4, 8, 16, 0):
                    if per_sm:
                        wa.SLOTS_PER_SM = per_sm
                        plan = wa.launch_plan(w, heads, HD, nw, conc, sms)
                    else:
                        plan = wa.launch_plan(w, heads, HD, nw, conc, sms, 1)
                    run = lambda: wa._launch(wa.fused_window_attention_cuda,
                                             q, k, v, bias, conc, plan.chunk)
                    got = run()
                    if want is None:
                        want = got
                    same = torch.equal(got, want)
                    ms = device_ms(run)
                    row = {"W": w, "heads": heads, "nW": nw, "entry": entry,
                           "slots_per_sm": per_sm or "one face",
                           "chunk": plan.chunk, "blocks": plan.blocks,
                           "device_ms": ms, "bits_as_first": same}
                    rows.append(row)
                    key = (entry, row["slots_per_sm"])
                    sums[key] = sums.get(key, 0.0) + (ms or float("nan"))
                    print(f"W={w} h={heads} nW={nw} {entry} target "
                          f"{row['slots_per_sm']} slots/SM: chunk "
                          f"{plan.chunk}, {plan.blocks} blocks, "
                          f"{'not measured' if ms is None else ms} ms, "
                          f"bits {'same' if same else 'DIFFER'}")
    for (entry, per_sm), ms in sums.items():
        print(f"sum over 7 shapes: {entry} target {per_sm} slots/SM "
              f"{ms:.4f} ms")
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=1)
    return 0 if all(r["bits_as_first"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:2]))
