#!/usr/bin/env python3
"""chip_smoke.py's phase 14 alone on one NVIDIA H100: `tools doctor`,
`print-flops` and the mfu reading, `--profile_dir` on run_multimodal,
`--debug_nans` on an auxiliary and a target step, and the convert / export
round trip of a released pair, after building the kernels.  In place of
phases 4 and 9 it times benchmark_latency(10) of an (8, 64) EmotionServer
and writes phase 9's files (the MELD layout and the released pair from
seed-7 weights) into a temporary directory.

    python3 experiments/torch_tooling.py [OUT.json]

With a path, the launch counts of its paths are written there.  About 3
minutes with the build.
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
    from facialmmt_tpu_torch import main as cli
    from facialmmt_tpu_torch.config import FacialMMTConfig
    from facialmmt_tpu_torch.data.meld import MeldMultimodalDataset
    from facialmmt_tpu_torch.ops import kernels
    from facialmmt_tpu_torch.serving import EmotionServer

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
    dev = torch.device("cuda:0")
    server = EmotionServer(FacialMMTConfig(), max_batch=8,
                           face_capacity=chip_smoke.FACES, device=dev)
    p50 = server.benchmark_latency(10)["p50_ms"]
    print(f"serving: benchmark_latency(10) p50 {p50:.2f} ms on {gpu}")
    del server
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        argv = chip_smoke.cli_argv(root, "--choice_modality", "T+A+V",
                                   "--doEval", "1", "--deterministic_gumbel",
                                   "1")
        cfg = cli.config_from_args(cli.build_argparser().parse_args(argv))
        chip_smoke.write_meld_layout(os.path.join(root, "meld"), cfg)
        test_ds = MeldMultimodalDataset(os.path.join(root, "meld"), "test",
                                        cli.text_arrays(cfg, "test"))
        chip_smoke.write_released(torch, dev,
                                  cli._adapt_static_shapes(cfg, test_ds),
                                  os.path.join(root, "pretrained_model"))
        paths = chip_smoke.phase_tooling(torch, dev, gpu, root, p50)
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump({"card": gpu, "launches": paths}, f, indent=1)
    print(json.dumps({k: {n: c for n, c in v.items() if c}
                      for k, v in paths.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:2]))
