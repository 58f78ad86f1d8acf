"""chip_smoke.py's two command-line phases alone (9, eval; 10, training),
without the kernel, serving and in-memory training phases before them.
Needs one NVIDIA GPU:

    python3 experiments/torch_cli_phases.py

Builds the kernels, then runs chip_smoke.phase_cli_eval and phase_cli_train
in one temporary directory as the full script does; phase 10's in-memory
step times (phase 7's) are not taken, so they print as nan.  Prints the
launch counts per phase and the seconds taken.
"""

import os
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from facialmmt_tpu_torch.ops import kernels  # noqa: E402


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
    nan = float("nan")
    with tempfile.TemporaryDirectory() as root:
        paths = chip_smoke.phase_cli_eval(torch, dev, gpu, root)
        torch.cuda.empty_cache()
        paths.update(chip_smoke.phase_cli_train(
            torch, dev, gpu, root, {"aux_step": [nan, nan],
                                    "trg_step": [nan, nan]}))
    print({k: {n: c for n, c in p.items() if c} for k, p in paths.items()})
    print(f"{time.perf_counter() - t0:.1f} s on {gpu}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
