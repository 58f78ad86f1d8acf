#!/usr/bin/env python3
"""chip_smoke.py's phase 15 alone on one NVIDIA H100: the serving front
(AsyncBatchServer, its bucket router, benchmark_load) over mesh servers at
FacialMMTConfig(), two rank processes sharing the card over gloo (a tp=2
router over (1, 12) / (8, 64), a dp=2 front over (2, 12) / (8, 64), an
idle gap, close) and a one-rank NCCL group at dp=1 against the front
without a plan, after building the kernels.

    python3 experiments/torch_front_mesh.py [OUT.json]

With a path, the launch counts of its paths are written there.
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(out: str = "") -> int:
    import torch

    import chip_smoke
    from facialmmt_tpu_torch.ops import kernels

    if not torch.cuda.is_available():
        print("no CUDA device visible", file=sys.stderr)
        return 2
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True,
                         check=True).stdout.strip()
    print(gpu)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    path, seconds = kernels.build()
    kernels.library()
    print(f"build: {os.path.relpath(path, ROOT)} in {seconds:.1f} s")
    paths = chip_smoke.phase_front_mesh(torch, torch.device("cuda:0"), gpu)
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump({"card": gpu, "launches": paths}, f, indent=1)
    print(json.dumps({k: {n: c for n, c in v.items() if c}
                      for k, v in paths.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:2]))
