#!/usr/bin/env python3
"""chip_smoke.py's phase 12 (the one-process serving front end) from two
checkouts in turns on one NVIDIA H100: PAIRS pairs (default 2), the first
BASE then this checkout, the next the other way round, and so on (BASE,
this, this, BASE, ...), each turn in a process of its own that imports its
checkout's package and builds its kernels there.

    python3 experiments/torch_front_turns.py BASE [PAIRS]

BASE is another checkout of the repository, e.g. the parent commit unpacked
with `git archive` into the git-ignored `_proof/`.  Prints each turn's
"front:" lines (the closed bursts' utterances/s at depth 1 and 2, the
router's open load, bucket p50s) prefixed with the turn.
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TURN = """
import subprocess, sys, torch
sys.path.insert(0, {root!r})
import chip_smoke
from facialmmt_tpu_torch.ops import kernels
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
kernels.build()
kernels.library()
gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader", "-i", "0"],
                     capture_output=True, text=True, check=True).stdout.strip()
chip_smoke.phase_front_end(torch, torch.device("cuda:0"), gpu)
"""


def main(base: str, pairs: str = "2") -> int:
    base = os.path.abspath(base)
    turns = [("base", base), ("this", ROOT)]
    for i in range(int(pairs)):
        for label, root in turns[::-1 if i % 2 else 1]:
            run = subprocess.run(
                [sys.executable, "-c", TURN.format(root=root)], cwd=root,
                capture_output=True, text=True,
                env={**os.environ, "PYTHONPATH": root})
            if run.returncode:
                print(run.stdout[-3000:], run.stderr[-3000:], file=sys.stderr)
                return run.returncode
            for line in run.stdout.splitlines():
                if line.startswith("front:"):
                    print(f"[{label}] {line}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:3]))
