"""Offline tools of the port (counterpart of facialmmt_tpu/tools.py).

    python -m facialmmt_tpu_torch.tools doctor [--device cuda|cpu]
    python -m facialmmt_tpu_torch.tools print-flops [--batch N] \
        [--faces_per_utt F]
    python -m facialmmt_tpu_torch.tools convert-checkpoint \
        --kind unimodal|multimodal|swin|swin_backbone \
        --input pretrained_model/unimodal_model_V.pt --output ckpt/unimodal
    python -m facialmmt_tpu_torch.tools export-checkpoint \
        --kind unimodal|multimodal|swin|pipeline \
        --input saved_model/best_3 --output best.pt

doctor: can this machine run the port?  The device answers a small matmul
  read back to the host (name, compute capability, nvidia-smi's power limit,
  torch and CUDA versions, device count); on `cuda`, nvcc and its version,
  the kernel library of csrc/ built (or found) in the package's `_build/`
  and loaded; the native face loader (native/) and the optional modules.
  Exit 0 when the device answered and, on `cuda`, the kernels built and
  loaded; else 3.  `--device cpu` builds nothing.
print-flops: the analytic MACs of Swin-tiny per image and of a T+A+V eval
  batch (ops/swin.py::swin_flops, utils/flops.py).
convert-checkpoint: a reference `.pt` (whole-module pickle, state_dict, or
  the Ms-Celeb-1M backbone's `backbone.*` file for swin_backbone; read by
  checkpoint/torch_load.py) checked by a strict load into the port's module
  of that kind at FacialMMTConfig(plm_name=...), then written in the port's
  checkpoint format (checkpoint/io.py: `<dir>/<tag>`).
export-checkpoint: a port checkpoint back to the reference's `.pt` layout,
  after the same strict check; `--kind pipeline` reads a best file of
  Trainer.run_multimodal (the pipeline's state_dict) and writes
  `<base>_multimodal.pt` and `<base>_swin.pt`, the reference's two released
  files (reference utils/util.py:121-159).

The strict checks build the module on the meta device: no weights are
allocated, and a missing, unexpected or misshapen tensor raises.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import shutil
import subprocess
import sys


def config_for(plm_name: str):
    """The configuration the checkpoint tools check against."""
    from facialmmt_tpu_torch.config import FacialMMTConfig

    return FacialMMTConfig(plm_name=plm_name)


def _module(kind: str, cfg):
    """The port's module of `kind`, on the meta device."""
    import torch

    from facialmmt_tpu_torch.models.multimodal import \
        MultiModalTransformerForClassification
    from facialmmt_tpu_torch.models.pipeline import FacialMMTPipeline
    from facialmmt_tpu_torch.models.swin_fer import \
        SwinForAffwildClassification
    from facialmmt_tpu_torch.models.unimodal import MeldUttTransformer
    from facialmmt_tpu_torch.ops.swin import SwinTransformer

    build = {"unimodal": MeldUttTransformer,
             "multimodal": MultiModalTransformerForClassification,
             "swin": SwinForAffwildClassification,
             "swin_backbone": lambda c: SwinTransformer(c.swin),
             "pipeline": FacialMMTPipeline}[kind]
    with torch.device("meta"):
        return build(cfg)


def checked_state_dict(kind: str, state_dict, plm_name: str) -> dict:
    """`state_dict` after a strict load into the port's `kind` module
    (raises on a missing, unexpected or misshapen tensor); the tensors are
    returned as they came."""
    _module(kind, config_for(plm_name)).load_state_dict(state_dict,
                                                        strict=True,
                                                        assign=True)
    return dict(state_dict)


def _split_output(path: str):
    out_dir, tag = os.path.split(path.rstrip("/"))
    return out_dir or ".", tag


def convert_checkpoint(args) -> None:
    from facialmmt_tpu_torch.checkpoint.io import CheckpointManager
    from facialmmt_tpu_torch.checkpoint.torch_load import (
        load_pretrained_swin_backbone, load_torch_state_dict)

    if args.kind == "swin_backbone":
        sd = load_pretrained_swin_backbone(args.input)
    else:
        sd = load_torch_state_dict(args.input)
        if args.kind == "multimodal":
            # the HF tower's pooler, which the reference never reads and
            # the port does not hold (torch_load.released_state_dict)
            sd = {k: v for k, v in sd.items() if ".pooler." not in f".{k}"}
    sd = checked_state_dict(args.kind, sd, args.plm_name)
    out_dir, tag = _split_output(args.output)
    path = CheckpointManager(out_dir, keep_steps=0).save(tag, sd)
    n = sum(v.numel() for v in sd.values() if v.is_floating_point())
    print(f"converted {args.input} ({args.kind}, {n / 1e6:.1f}M params) "
          f"-> {path}")


def export_checkpoint(args) -> None:
    import torch

    from facialmmt_tpu_torch.checkpoint.io import CheckpointManager
    from facialmmt_tpu_torch.checkpoint.torch_load import (MULTIMODAL, SWIN,
                                                           save_released)

    in_dir, tag = _split_output(args.input)
    sd = checked_state_dict(
        args.kind, CheckpointManager(in_dir, keep_steps=0).restore(tag),
        args.plm_name)
    if args.kind == "pipeline":
        base = args.output[:-3] if args.output.endswith(".pt") else args.output
        paths = (f"{base}_multimodal.pt", f"{base}_swin.pt")
        save_released(sd, *paths)
        for prefix, path in zip((MULTIMODAL, SWIN), paths):
            n = sum(k.startswith(prefix) for k in sd)
            print(f"exported {n} tensors -> {path}")
    else:
        torch.save(sd, args.output)
        print(f"exported {len(sd)} tensors -> {args.output}")


def print_flops(args) -> None:
    from facialmmt_tpu_torch.config import FacialMMTConfig
    from facialmmt_tpu_torch.ops.swin import swin_flops
    from facialmmt_tpu_torch.utils.flops import eval_step_macs

    cfg = FacialMMTConfig()
    f = swin_flops(cfg.swin)
    print(f"swin-tiny forward: {f / 1e9:.2f} GMACs/image "
          f"({f * args.batch / 1e12:.2f} TMACs at batch {args.batch})")
    m = eval_step_macs(cfg, args.batch, max(args.batch // 8, 1),
                       args.faces_per_utt * args.batch)
    print(f"full T+A+V eval batch ({args.batch} utts, "
          f"{args.faces_per_utt} faces/utt): {m / 1e9:.1f} GMACs "
          f"= {2 * m / 1e12:.2f} TFLOPs")


def _line(what: str, text: str) -> None:
    print(f"  {what:<19}: {text}")


def _power_limit() -> str:
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "nvidia-smi not found"
    proc = subprocess.run([smi, "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "-i", "0"],
                          capture_output=True, text=True)
    return (proc.stdout.strip() if proc.returncode == 0
            else f"nvidia-smi exit {proc.returncode}")


def _probe_device(device: str) -> bool:
    """A 256 x 256 fp32 matmul on `device`, read back and held to the CPU's
    within 1e-4 of its scale."""
    import torch

    if device == "cuda" and not torch.cuda.is_available():
        _line("device", f"no CUDA device visible (torch {torch.__version__}, "
                        f"CUDA {torch.version.cuda}); --device cpu checks "
                        f"the CPU")
        return False
    a = torch.arange(256 * 256, dtype=torch.float32).reshape(256, 256)
    a = torch.sin(a)
    want = a @ a.T
    got = (a.to(device) @ a.to(device).T).cpu()
    err = float((got - want).abs().max() / want.abs().max())
    if device == "cuda":
        cap = torch.cuda.get_device_capability(0)
        _line("device", f"{torch.cuda.get_device_name(0)} x"
                        f"{torch.cuda.device_count()}, capability "
                        f"{cap[0]}.{cap[1]}, torch {torch.__version__}, "
                        f"CUDA {torch.version.cuda}")
        _line("name, power.limit", _power_limit())
    else:
        _line("device", f"cpu, {torch.get_num_threads()} threads, torch "
                        f"{torch.__version__}")
    ok = err <= 1e-4
    _line("matmul readback", f"{'OK' if ok else 'WRONG'} (max|d| {err:.1e} "
                             f"of the CPU's scale)")
    return ok


def _check_kernels() -> bool:
    """nvcc, the kernel library built or found, and loaded."""
    from facialmmt_tpu_torch.ops import kernels

    try:
        nvcc = kernels._nvcc()
    except RuntimeError as e:
        _line("nvcc", f"MISSING ({e})")
        return False
    proc = subprocess.run([nvcc, "--version"], capture_output=True, text=True)
    version = (proc.stdout.strip().splitlines() or ["?"])[-1]
    _line("nvcc", f"{nvcc} ({version})")
    try:
        path, seconds = kernels.build()
    except RuntimeError as e:
        _line("kernel library", f"BUILD FAILED ({str(e)[:400]})")
        return False
    entries = sorted(kernels.BUILD_DIR.iterdir())
    size = sum(p.stat().st_size for p in entries if p.is_file())
    how = f"built in {seconds:.1f} s" if seconds else "found"
    _line("kernel library", f"{path.name} ({how}); {kernels.BUILD_DIR}: "
                            f"{len(entries)} entries, {size / 1e6:.1f} MB")
    try:
        kernels.library()
    except OSError as e:
        _line("kernels", f"LOAD FAILED ({e})")
        return False
    _line("kernels", f"loaded ({len(kernels._SIGNATURES)} entry points)")
    return True


def doctor(args) -> None:
    print("facialmmt-tpu-torch doctor")
    ok = _probe_device(args.device)
    if args.device == "cuda":
        ok = _check_kernels() and ok
    else:
        _line("kernels", "not built (--device cpu: the plain versions run)")

    from facialmmt_tpu_torch import native

    if native.load_library() is not None:
        _line("native face loader", "OK (libjpeg decode + resize)")
    else:
        _line("native face loader", f"unavailable -> cv2 "
                                    f"({native._build_error})"[:200])
    for mod, why in (("transformers", "HF tokenizer for uncached text"),
                     ("cv2", "face-loader fallback"),
                     ("yaml", "--swin_config_path"),
                     ("sklearn", "metrics cross-check (tests only)")):
        found = importlib.util.find_spec(mod) is not None
        _line(mod, f"{'OK' if found else 'MISSING'} ({why})")
    sys.stdout.flush()
    raise SystemExit(0 if ok else 3)


def main(argv=None):
    p = argparse.ArgumentParser(prog="facialmmt_tpu_torch.tools")
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("convert-checkpoint")
    c.add_argument("--kind", required=True,
                   choices=["unimodal", "multimodal", "swin", "swin_backbone"])
    c.add_argument("--input", required=True)
    c.add_argument("--output", required=True,
                   help="<dir>/<tag> of the port checkpoint to write")
    c.add_argument("--plm_name", default="roberta-large")
    c.set_defaults(func=convert_checkpoint)

    e = sub.add_parser("export-checkpoint")
    e.add_argument("--kind", required=True,
                   choices=["unimodal", "multimodal", "swin", "pipeline"])
    e.add_argument("--input", required=True,
                   help="port checkpoint (e.g. saved_model/best_3)")
    e.add_argument("--output", required=True, help=".pt path to write")
    e.add_argument("--plm_name", default="roberta-large")
    e.set_defaults(func=export_checkpoint)

    f = sub.add_parser("print-flops")
    f.add_argument("--batch", type=int, default=1)
    f.add_argument("--faces_per_utt", type=int, default=8)
    f.set_defaults(func=print_flops)

    d = sub.add_parser("doctor")
    d.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    d.set_defaults(func=doctor)

    args = p.parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    main()
