"""chip_smoke.py's serving front-end phase (12) alone, then its closed burst
under two older dispatch designs, in turns.  Needs one NVIDIA GPU:

    python3 experiments/torch_front_end.py

Builds the kernels and runs chip_smoke.phase_front_end.  Then, on a fresh
(32, 256) server, the closed burst of 256 default requests at
pipeline_depth 2 in the order A B C C B A:
  A  as shipped: inputs staged in pinned memory, each pack's rows copied to
     the host right behind it, the packer waiting on that copy's event;
  B  the staging before the front end was ported: features copied with
     non_blocking=True from pageable memory, faces with a blocking copy;
  C  as shipped, but the packer reads a pack's rows with `.cpu()` when it
     resolves the pack (queued behind every pack dispatched since).
Each line gives utterances/s and the shares of packs built, and of
dispatches returned, while the previous pack still computed.  Last, one
default request's pack on a (1, 12) server, 20 times back to back and 20
times after 100 ms of idle card each (the open load's light end leaves the
card idle between requests), with the SM clock nvidia-smi reads after the
idle and during a run of packs.
"""

import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from facialmmt_tpu_torch import serving  # noqa: E402
from facialmmt_tpu_torch.config import (FacialMMTConfig,  # noqa: E402
                                        RuntimeConfig)
from facialmmt_tpu_torch.data.image_pipeline import \
    meld_face_eval_transform  # noqa: E402
from facialmmt_tpu_torch.ops import kernels  # noqa: E402


@torch.no_grad()
def pageable_predict_device(server, batch, faces_raw):
    """B: EmotionServer.predict_device as it was before pinned staging."""
    dev = server.device
    full = {k: torch.from_numpy(np.asarray(v)).to(dev, non_blocking=True)
            for k, v in batch.items()}
    full["audio_inputs"] = full["audio_inputs"].float()
    full["vision_feats"] = full["vision_feats"].float()
    faces = torch.from_numpy(np.asarray(faces_raw)).to(dev)
    full["faces"] = meld_face_eval_transform(
        faces.float(), server.cfg.data.swin_img_size).to(server.dtype)
    logits = server.model(full, generator=server.generator)
    return torch.softmax(logits.float(), dim=-1)


class CpuAtResolve:
    """C: rows read with `.cpu()` when the packer resolves the pack."""

    def __init__(self, probs):
        self.probs = probs

    def __array__(self, dtype=None, copy=None):
        return self.probs.cpu().numpy()


def main():
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True).stdout.strip()
    print(gpu)
    t0 = time.perf_counter()
    path, seconds = kernels.build()
    kernels.library()
    print(f"build: {os.path.relpath(path, ROOT)} in {seconds:.1f} s")
    dev = torch.device("cuda:0")
    paths = chip_smoke.phase_front_end(torch, dev, gpu)
    print({k: {n: c for n, c in p.items() if c} for k, p in paths.items()})
    torch.cuda.empty_cache()

    cfg = FacialMMTConfig().replace(
        runtime=RuntimeConfig(deterministic_gumbel=True))
    big = serving.EmotionServer(cfg, max_batch=32, face_capacity=256,
                                device=dev)
    requests = [serving.default_load_request(cfg)
                for _ in range(chip_smoke.FRONT_BURST)]
    shipped = serving._start_readback
    for variant in "ABCCBA":
        if variant == "B":
            big.predict_device = lambda b, f: pageable_predict_device(
                big, b, f)
        if variant == "C":
            serving._start_readback = lambda probs: (CpuAtResolve(probs),
                                                     None)
        try:
            chip_smoke.closed_burst(torch, cfg, big, requests, 2, gpu,
                                    f" [{variant}]")
        finally:
            serving._start_readback = shipped
            big.__dict__.pop("predict_device", None)
    del big
    torch.cuda.empty_cache()
    solo = serving.EmotionServer(cfg, max_batch=1, face_capacity=12,
                                 device=dev)
    pack = solo.build_pack([serving.default_load_request(cfg)])

    def clock():
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader",
             "-i", "0"], capture_output=True, text=True).stdout.strip()

    for idle_s in (0.0, 0.1, 0.0, 0.1):
        times = []
        for _ in range(20):
            time.sleep(idle_s)
            t1 = time.perf_counter()
            solo.predict_raw(*pack)
            times.append((time.perf_counter() - t1) * 1000)
        idle_clock = clock() if idle_s else ""
        print(f"(1, 12) pack after {idle_s * 1000:.0f} ms idle: p50 "
              f"{np.percentile(times, 50):.2f} ms, min {min(times):.2f} ms"
              + (f"; SM clock after idle {idle_clock}" if idle_s else ""))
    for _ in range(30):
        solo.predict_device(*pack)
    busy_clock = clock()
    torch.cuda.synchronize()
    print(f"SM clock during 30 queued packs: {busy_clock}")
    print(f"{time.perf_counter() - t0:.1f} s on {gpu}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
