#!/usr/bin/env python3
"""chip_smoke.py's phase 16 alone on one NVIDIA H100: Swin drop rates on the
kernel routes, kernels 1-12 on fp32 tokens, the BERT-architecture text
towers (bert-large on MELD, chinese-roberta-large on M3ED) through
`main.run`, and the model under --compute_dtype float32 (against its own
CPU reference, made here), after building the kernels.

    python3 experiments/torch_configurations.py [OUT.json]

With a path, the launch counts of its paths and the fp32 kernel rows are
written there.
"""

import json
import os
import subprocess
import sys
import tempfile

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
    with tempfile.TemporaryDirectory() as root:
        paths, rows = chip_smoke.phase_configurations(
            torch, torch.device("cuda:0"), gpu, root)
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump({"card": gpu, "launches": paths, "fp32_kernels": rows},
                      f, indent=1)
    print(json.dumps({k: {n: c for n, c in v.items() if c}
                      for k, v in paths.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:2]))
