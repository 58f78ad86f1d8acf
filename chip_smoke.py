#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on one NVIDIA H100.

    python3 chip_smoke.py

Phases (each prints a line; any failure raises and the exit code is non-zero):
  1. the card: nvidia-smi name and power limit, compute capability 9.0;
  2. build the CUDA kernels from facialmmt_tpu_torch/csrc (timed);
  3. every kernel of the serving path against its plain PyTorch version on
     the card, in bf16, at the serving path's shapes (the text tower's 8 x 16
     x 512 x 64 attention; every Swin stage at 64 faces), with the median
     kernel and plain times from CUDA events;
  4. the headline model (FacialMMTConfig(): RoBERTa-large, Swin-tiny at 224 px,
     the 768-wide fusion stack) behind EmotionServer(max_batch=8,
     face_capacity=64) on cuda:0, random bf16 weights from the config's seed:
     four packs of synthetic requests through predict(), every kernel's launch
     count > 0, one pack held against the same weights on the CPU in fp32, and
     benchmark_latency(20).
The line before the last is {"kernels": [...]} and the last line is
{"ok": true, "device": {...}}.  Exits non-zero with no result when no CUDA
device is visible or the package is missing.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FACES = 64                # the serving bucket's packed-face capacity
KERNEL_BOUND = 2e-2       # max|kernel - plain| <= KERNEL_BOUND * max|plain|
# bf16 serving vs fp32 on the CPU, compared on the logits the probabilities
# imply (log p centred per row): max|d| <= SERVING_BOUND * max|logit|.  bf16
# keeps 8 bits of mantissa (relative rounding 2^-9 per op), compounded
# through 24 text layers, 12 Swin blocks and 11 fusion layers
SERVING_BOUND = 0.1
KERNELS = {
    "fused_attention": ("facialmmt_tpu_torch/csrc/attention.cu",
                        "facialmmt_tpu/ops/pallas/attention.py:100"),
    "fused_attention_block": ("facialmmt_tpu_torch/csrc/fused_block.cu",
                              "facialmmt_tpu/ops/pallas/fused_block.py:213"),
    "fused_ln_mlp_residual": ("facialmmt_tpu_torch/csrc/block_mlp.cu",
                              "facialmmt_tpu/ops/pallas/block_mlp.py:134"),
}


def cuda_ms(torch, fn, iters: int = 10) -> float:
    """Median device time of fn() in ms (CUDA events, after one warm-up)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(torch, name, kernel, plain, args, results):
    """Run kernel and plain on the same inputs, check the bound, time both."""
    got = kernel(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    if not (torch.isfinite(got).all() and err <= KERNEL_BOUND * scale):
        raise AssertionError(f"{name}: max|d| {err} > {KERNEL_BOUND} * {scale}")
    ms = cuda_ms(torch, lambda: kernel(*args))
    plain_ms = cuda_ms(torch, lambda: plain(*args))
    r = results.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0,
                                  "plain_ms": 0.0})
    r["max_abs_err"] = max(r["max_abs_err"], err)
    r["ms"] += ms
    r["plain_ms"] += plain_ms
    return err, scale, ms, plain_ms


def phase_kernels(torch, dev, rng):
    from facialmmt_tpu_torch.ops.kernels import attention, block_mlp, fused_block
    from facialmmt_tpu_torch.ops.swin import shifted_window_mask

    bf = lambda a: torch.tensor(a).to(dev, torch.bfloat16).contiguous()
    results = {}

    # kernel 1: text tower attention, 8 dialogues x 16 heads x 512 x 64
    b, h, s, d = 8, 16, 512, 64
    bias = np.zeros((b, s), np.float32)
    for i in range(b - 1):
        bias[i, rng.integers(200, s):] = -1e30     # padded tails
    bias[-1] = -1e30                               # an all-padding dialogue
    args = (bf(rng.normal(size=(b, h, s, d)) * d ** -0.5),
            bf(rng.normal(size=(b, h, s, d))), bf(rng.normal(size=(b, h, s, d))),
            torch.tensor(bias, device=dev))
    out = compare(torch, "fused_attention", attention.fused_attention_cuda,
                  attention.fused_attention_plain, args, results)
    print(f"kernel fused_attention {b}x{h}x{s}x{d}: max|d| {out[0]:.3g} "
          f"(max|out| {out[1]:.3g}), {out[2]:.4f} ms vs plain {out[3]:.4f} ms")

    # kernels 2 and 3: every Swin-tiny stage at 64 faces of 224 px
    for stage, (res, c, heads) in enumerate(((56, 96, 3), (28, 192, 6),
                                             (14, 384, 12), (7, 768, 24))):
        n = 49
        w = FACES * (res // 7) ** 2
        for shifted in ((False, True) if res > 7 else (False,)):
            rel = rng.normal(size=(1, heads, n, n)) * 0.5
            mask = (shifted_window_mask(res, res, 7, 3)[:, None] if shifted
                    else np.zeros((1, 1, n, n)))
            args = (bf(rng.normal(size=(w, n, c))),
                    bf(1 + 0.1 * rng.normal(size=c)), bf(0.1 * rng.normal(size=c)),
                    bf(rng.normal(size=(3 * c, c)) / np.sqrt(c)),
                    bf(0.1 * rng.normal(size=3 * c)),
                    bf(rng.normal(size=(c, c)) / np.sqrt(c)),
                    bf(0.1 * rng.normal(size=c)),
                    torch.tensor(rel + mask, dtype=torch.float32, device=dev))
            out = compare(torch, "fused_attention_block",
                          fused_block.fused_attention_block_cuda,
                          fused_block.fused_attention_block_plain, args, results)
            kind = f"shifted nW={mask.shape[0]}" if shifted else "nW=1"
            print(f"kernel fused_attention_block stage {stage} W={w} C={c} "
                  f"h={heads} {kind}: "
                  f"max|d| {out[0]:.3g} (max|out| {out[1]:.3g}), "
                  f"{out[2]:.4f} ms vs plain {out[3]:.4f} ms")
        t = FACES * res * res
        args = (bf(rng.normal(size=(t, c))), bf(1 + 0.1 * rng.normal(size=c)),
                bf(0.1 * rng.normal(size=c)),
                bf(rng.normal(size=(4 * c, c)) / np.sqrt(c)),
                bf(0.1 * rng.normal(size=4 * c)),
                bf(rng.normal(size=(c, 4 * c)) / np.sqrt(4 * c)),
                bf(0.1 * rng.normal(size=c)))
        out = compare(torch, "fused_ln_mlp_residual",
                      block_mlp.fused_ln_mlp_residual_cuda,
                      block_mlp.fused_ln_mlp_residual_plain, args, results)
        print(f"kernel fused_ln_mlp_residual stage {stage} T={t} C={c}: "
              f"max|d| {out[0]:.3g} (max|out| {out[1]:.3g}), "
              f"{out[2]:.4f} ms vs plain {out[3]:.4f} ms")
    return results


def synthetic_requests(rng, cfg, faces_per_utt, text_len):
    """One request per entry of faces_per_utt: a text_len-token dialogue with
    utterance separators every 40 tokens, 157 x 768 audio, 32 x 512 vision
    features and that many 160 x 160 x 3 face crops."""
    d = cfg.data
    reqs = []
    for j, nf in enumerate(faces_per_utt):
        sep = np.zeros(text_len, np.int32)
        sep[39::40] = 1
        reqs.append({
            "input_ids": rng.integers(3, cfg.text.vocab_size, size=text_len),
            "sep_mask": sep,
            "utt_in_dia_idx": j % max(1, int(sep.sum())),
            "audio": rng.normal(size=(d.audio_utt_max_len, d.audio_feat_dim)),
            "vision": rng.normal(size=(d.vision_utt_max_len, d.vision_feat_dim)),
            "faces": rng.integers(0, 256, (nf, 160, 160, 3), dtype=np.uint8),
        })
    return reqs


def phase_serving(torch, dev, rng, gpu_name):
    from facialmmt_tpu_torch.config import FacialMMTConfig, RuntimeConfig
    from facialmmt_tpu_torch.ops import kernels
    from facialmmt_tpu_torch.serving import EmotionServer

    cfg = FacialMMTConfig()
    t0 = time.perf_counter()
    server = EmotionServer(cfg, max_batch=8, face_capacity=FACES, device=dev)
    torch.cuda.synchronize()
    print(f"serving: EmotionServer(FacialMMTConfig(), max_batch=8, "
          f"face_capacity={FACES}) on {dev}, bf16, built and warmed in "
          f"{time.perf_counter() - t0:.1f} s")
    packs = [synthetic_requests(rng, cfg, [8] * 8, 512),
             synthetic_requests(rng, cfg, [32, 0, 32], 512),
             synthetic_requests(rng, cfg, [5, 11, 0, 16, 2], 300),
             synthetic_requests(rng, cfg, [1], 64)]

    kernels.reset_launch_counts()
    outs = [server.predict(reqs) for reqs in packs]
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    for reqs, out in zip(packs, outs):
        rows = np.stack(out)
        if not (rows.shape == (len(reqs), cfg.num_labels)
                and np.isfinite(rows).all()
                and np.allclose(rows.sum(-1), 1.0, atol=1e-3)):
            raise AssertionError(f"bad probabilities {rows}")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the path: {missing}")
    print(f"serving: {len(packs)} packs answered ({sum(map(len, packs))} "
          f"requests), finite rows summing to 1; launches {launches}")

    # the same weights, deterministic gumbel: bf16 on the card vs fp32 on CPU
    det = cfg.replace(runtime=RuntimeConfig(deterministic_gumbel=True))
    sd = server.model.state_dict()
    card = EmotionServer(det, sd, max_batch=8, face_capacity=FACES, device=dev)
    host = EmotionServer(det, {k: (v.float() if v.is_floating_point() else v)
                               .cpu() for k, v in sd.items()},
                         max_batch=8, face_capacity=FACES,
                         dtype=torch.float32, transfer_dtype=np.float32)
    batch, faces = card.build_pack(packs[0])
    got = card.predict_raw(batch, faces)
    want = host.predict_raw(*host.build_pack(packs[0]))
    z_got, z_want = (np.log(p) - np.log(p).mean(-1, keepdims=True)
                     for p in (got.astype(np.float64), want.astype(np.float64)))
    diff = float(np.abs(z_got - z_want).max())
    scale = float(np.abs(z_want).max())
    if not (np.isfinite(z_got).all() and diff <= SERVING_BOUND * scale):
        raise AssertionError(f"card vs CPU fp32: logits max|d| {diff} > "
                             f"{SERVING_BOUND} * {scale}")
    print(f"serving: card bf16 vs CPU fp32 on one 8-request pack: logits "
          f"max|d| {diff:.3g} <= {SERVING_BOUND} * max|logit| {scale:.3g}; "
          f"probabilities max|d| {float(np.abs(got - want).max()):.3g}")
    del card, host

    lat = server.benchmark_latency(20)
    print(f"serving: benchmark_latency(20) p50 {lat['p50_ms']:.2f} ms, p99 "
          f"{lat['p99_ms']:.2f} ms, mean {lat['mean_ms']:.2f} ms on {gpu_name}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from facialmmt_tpu_torch.ops import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True)
    gpu_name = smi.stdout.strip()
    print(gpu_name)
    cap = torch.cuda.get_device_capability(0)
    print(f"card: {torch.cuda.get_device_name(0)} | "
          f"capability {cap} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    if cap != (9, 0):
        raise AssertionError(f"compute capability {cap}, the kernels are "
                             f"built for sm_90a")

    path, seconds = kernels.build()
    kernels.library()
    print(f"build: {os.path.relpath(path, ROOT)} in {seconds:.1f} s")
    log = (kernels.BUILD_DIR / "build.log").read_text().splitlines()
    for line in log:
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print("build: " + line.strip())

    rng = np.random.default_rng(0)
    results = phase_kernels(torch, dev, rng)
    launches = phase_serving(torch, dev, rng, gpu_name)

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **results[name]}
        for name, (src, rep) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
