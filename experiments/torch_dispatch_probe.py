"""Where the host time of one serving pack's dispatch goes on the card.
Needs one NVIDIA GPU:

    python3 experiments/torch_dispatch_probe.py [OUT_DIR]

Builds a (32, 256) EmotionServer on FacialMMTConfig() (random weights,
deterministic gumbel) and, after two warm-up packs, dispatches default
requests' packs:
  * under torch.cuda.set_sync_debug_mode("warn"): every operation that
    synchronizes the host with the card is printed with its stack;
  * timed in pieces on the host clock (build_pack, staging, the eval
    transform, the model), each piece followed by a query of an event
    recorded after the pack before;
  * under torch.profiler: the host's and the device's busy time of one
    pack, the top host operations by self time and the top device kernels;
    the trace is written to OUT_DIR (default chiprun_out/) as
    dispatch_trace.json.
"""

import os
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from facialmmt_tpu_torch import serving  # noqa: E402
from facialmmt_tpu_torch.config import (FacialMMTConfig,  # noqa: E402
                                        RuntimeConfig)
from facialmmt_tpu_torch.data.image_pipeline import \
    meld_face_eval_transform  # noqa: E402
from facialmmt_tpu_torch.ops import kernels  # noqa: E402
from facialmmt_tpu_torch.ops.kernels import to_device_async  # noqa: E402


def main(out_dir=os.path.join(ROOT, "chiprun_out")):
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True).stdout.strip()
    print(gpu)
    kernels.build()
    kernels.library()
    cfg = FacialMMTConfig().replace(
        runtime=RuntimeConfig(deterministic_gumbel=True))
    server = serving.EmotionServer(cfg, max_batch=32, face_capacity=256,
                                   device="cuda")
    reqs = [serving.default_load_request(cfg) for _ in range(32)]
    for _ in range(2):
        server.predict_raw(*server.build_pack(reqs))
    torch.cuda.synchronize()

    # 1. synchronizing operations
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            server.predict_device(*server.build_pack(reqs))
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = [w for w in caught if "prototype" not in str(w.message)]
    print(f"sync debug: {len(syncs)} synchronizing operations in one "
          f"build_pack + predict_device")
    for w in syncs[:10]:
        print(f"  {w.category.__name__}: {str(w.message)[:300]}")

    # 2. the pieces on the host clock, three packs back to back
    @torch.no_grad()
    def pieces(prev):
        marks = []

        def mark(name):
            marks.append((name, time.perf_counter(),
                          None if prev is None else prev.query()))

        mark("start")
        batch, faces_raw = server.build_pack(reqs)
        mark("build_pack")
        full = {k: to_device_async(torch.from_numpy(v), server.device)
                for k, v in batch.items()}
        full["audio_inputs"] = full["audio_inputs"].float()
        full["vision_feats"] = full["vision_feats"].float()
        faces = to_device_async(torch.from_numpy(faces_raw), server.device)
        mark("staging")
        full["faces"] = meld_face_eval_transform(
            faces.float(), cfg.data.swin_img_size).to(server.dtype)
        mark("transform")
        logits = server.model(full, generator=server.generator)
        probs = torch.softmax(logits.float(), dim=-1)
        mark("model")
        done = torch.cuda.Event()
        done.record()
        return probs, done, marks

    prev = None
    for i in range(3):
        _, prev, marks = pieces(prev)
        line = ", ".join(
            f"{n} {1000 * (t - marks[j][1]):.2f} ms"
            + ("" if q is None else f" (previous pack done: {q})")
            for j, (n, t, q) in enumerate(marks[1:]))
        print(f"pack {i}: {line}")
    torch.cuda.synchronize()

    # 3. one pack under the profiler
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = server.predict_device(*server.build_pack(reqs))
        t1 = time.perf_counter()
        out.cpu()
        t2 = time.perf_counter()
    print(f"profiled pack: dispatch {1000 * (t1 - t0):.2f} ms, then the wait "
          f"for the rows {1000 * (t2 - t1):.2f} ms (host clock)")
    events = prof.key_averages()
    device_us = sum(e.self_device_time_total for e in events
                    if e.device_type.name == "CUDA")
    host_us = sum(e.self_cpu_time_total for e in events)
    n_kernels = sum(e.count for e in events if e.device_type.name == "CUDA")
    print(f"device busy {device_us / 1000:.2f} ms over {n_kernels} device "
          f"operations; host self time {host_us / 1000:.2f} ms")
    print(events.table(sort_by="self_cpu_time_total", row_limit=15,
                       max_name_column_width=60))
    print(events.table(sort_by="self_device_time_total", row_limit=15,
                       max_name_column_width=60))
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "dispatch_trace.json"))
    print(gpu)
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:2]))
