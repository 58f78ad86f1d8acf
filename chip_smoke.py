#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on one NVIDIA H100.

    python3 chip_smoke.py [kernels.json]

With a path, the per-shape kernel times and the launch counts per path are
also written there as JSON.  Phases (each prints lines; any failure raises and the exit code is non-zero):
  1. the card: nvidia-smi name and power limit, compute capability 9.0;
  2. build the CUDA kernels from facialmmt_tpu_torch/csrc (timed);
  3. every kernel against its plain PyTorch version on the card, in bf16, at
     the shapes the paths give it: the text tower's 8 x 16 x 512 x 64
     attention; the forward Swin halves at every stage at 64 faces (serving)
     and, with a stochastic-depth `keep`, at 150 images (the auxiliary batch);
     the three backward kernels at every stage they serve at 150 images, with
     and without `keep`, shifted and unshifted bias, every output compared.
     Median times from CUDA events stand next to each call's bound: the
     larger of its matmul FLOPs over the dense bf16 peak and the bytes it
     must move (inputs read once, outputs written once) over the HBM rate;
  4. serving: the headline model (FacialMMTConfig(): RoBERTa-large, Swin-tiny
     at 224 px, the 768-wide fusion stack) behind EmotionServer(max_batch=8,
     face_capacity=64), random bf16 weights from the config's seed: packs of
     synthetic requests through predict(), launch counts > 0, one pack held
     against the same weights on the CPU in fp32, benchmark_latency;
  5. training: Trainer(FacialMMTConfig()).run_multimodal on synthetic
     in-memory datasets (300 auxiliary images at 150 a step, 8 utterances at 4
     a step): 2 auxiliary steps, 2 target steps, validation and the test
     eval, with the parameter-movement and launch-count assertions per pass;
     one joint step (swin_from_target, the microbatch step); a step-time
     breakdown; one auxiliary batch's gradients on the card held against the
     CPU in fp32.
The line before the last is {"kernels": [...]} and the last line is
{"ok": true, "device": {...}}.  Exits non-zero with no result when no CUDA
device is visible or the package is missing.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FACES = 64                # the serving bucket's packed-face capacity
AUX_IMAGES = 150          # the auxiliary FER batch (optim.aux_batch_size)
KERNEL_BOUND = 2e-2       # max|kernel - plain| <= KERNEL_BOUND * max|plain|
# bf16 serving vs fp32 on the CPU, compared on the logits the probabilities
# imply (log p centred per row): max|d| <= SERVING_BOUND * max|logit|.  bf16
# keeps 8 bits of mantissa (relative rounding 2^-9 per op), compounded
# through 24 text layers, 12 Swin blocks and 11 fusion layers
SERVING_BOUND = 0.1
# one auxiliary step's gradients, bf16 kernels on the card vs fp32 on the CPU:
# per leaf max|d| <= GRAD_BOUND * max|grad|, the same compounding through 12
# Swin blocks forward and backward
GRAD_BOUND = 0.1
PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense
PEAK_HBM_BYTES = 3.35e12  # per second
SWIN_STAGES = ((56, 96, 3), (28, 192, 6), (14, 384, 12), (7, 768, 24))
KERNELS = {
    "fused_attention": ("facialmmt_tpu_torch/csrc/attention.cu",
                        "facialmmt_tpu/ops/pallas/attention.py:100"),
    "fused_attention_block": ("facialmmt_tpu_torch/csrc/fused_block.cu",
                              "facialmmt_tpu/ops/pallas/fused_block.py:213"),
    "fused_ln_mlp_residual": ("facialmmt_tpu_torch/csrc/block_mlp.cu",
                              "facialmmt_tpu/ops/pallas/block_mlp.py:134"),
    "fused_ln_mlp_residual_bwd": (
        "facialmmt_tpu_torch/csrc/block_mlp_bwd.cu",
        "facialmmt_tpu/ops/pallas/block_mlp.py:257"),
    "fused_attention_block_bwd": (
        "facialmmt_tpu_torch/csrc/fused_block_bwd.cu",
        "facialmmt_tpu/ops/pallas/fused_block.py:512"),
    "fused_attention_block_bwd_spill": (
        "facialmmt_tpu_torch/csrc/fused_block_bwd.cu",
        "facialmmt_tpu/ops/pallas/fused_block.py:573"),
}
MLP_BWD_NAMES = ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2")
ATTN_BWD_NAMES = ("dx", "dgamma", "dbeta", "dwqkv", "dbqkv", "dwproj",
                  "dbproj", "dbias")


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


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def compare(torch, name, kernel, plain, args, results, *, flops, out_names=None,
            timed=True, library=None, label=""):
    """Run kernel and plain on the same inputs and hold every output to the
    bound (a bias cotangent by its group sum, the only part of it that is
    defined).  When `timed`, add the call's median kernel, plain and library
    times and its bound to the kernel's totals.  Prints one line."""
    got = kernel(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    single = not isinstance(got, tuple)
    outs = [(out_names[i] if out_names else "out", g, w) for i, (g, w) in
            enumerate(zip((got,) if single else got,
                          (want,) if single else want))]
    worst = 0.0
    for oname, g, w in outs:
        if oname == "dbias":
            g, w = g.sum(0), w.sum(0)
        err = float((g.float() - w.float()).abs().max())
        scale = float(w.float().abs().max())
        if not (torch.isfinite(g).all() and err <= KERNEL_BOUND * scale):
            raise AssertionError(f"{name} {label} {oname}: max|d| {err} > "
                                 f"{KERNEL_BOUND} * {scale}")
        worst = max(worst, err / max(scale, 1e-30))
    r = results.setdefault(name, {
        "max_abs_err": 0.0, "max_rel_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
        "bound_ms": 0.0, "flops_ms": 0.0, "bytes_ms": 0.0, "library_ms": None,
        "shapes": []})
    first = outs[0]
    r["max_abs_err"] = max(r["max_abs_err"], float(
        (first[1].float() - first[2].float()).abs().max()))
    r["max_rel_err"] = max(r["max_rel_err"], worst)
    line = f"kernel {name} {label}: worst output max|d|/max|plain| {worst:.3g}"
    if timed:
        moved = tensor_bytes(*[a for a in args if torch.is_tensor(a)],
                             *[g for _, g, _ in outs])
        flops_ms = flops / PEAK_BF16_FLOPS * 1e3
        bytes_ms = moved / PEAK_HBM_BYTES * 1e3
        ms = cuda_ms(torch, lambda: kernel(*args))
        plain_ms = cuda_ms(torch, lambda: plain(*args), iters=5)
        entry = {"shape": label, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": max(flops_ms, bytes_ms),
                 "bound_by": "operations" if flops_ms >= bytes_ms else "bytes",
                 "gflop": flops / 1e9, "mbytes": moved / 1e6}
        line += (f", {ms:.4f} ms vs bound {entry['bound_ms']:.4f} ms "
                 f"({entry['bound_by']}: {entry['gflop']:.2f} GFLOP, "
                 f"{entry['mbytes']:.1f} MB), plain {plain_ms:.4f} ms")
        if library is not None:
            entry["library_ms"] = cuda_ms(torch, library)
            r["library_ms"] = (r["library_ms"] or 0.0) + entry["library_ms"]
            line += f", library call {entry['library_ms']:.4f} ms"
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        r["bound_ms"] += entry["bound_ms"]
        r["flops_ms"] += flops_ms
        r["bytes_ms"] += bytes_ms
        r["shapes"].append(entry)
    print(line)


def attn_block_flops(w, n, c, backward: bool) -> float:
    """Matmul FLOPs of the attention half over w windows of n tokens.
    Forward: qkv 6nc^2, scores and PV 4n^2c, proj 2nc^2.  Backward (from x and
    dy): qkv, scores and PV recomputed (6nc^2 + 4n^2c), dattn 2nc^2, dP, dv,
    dq, dk 8n^2c, dxn 6nc^2, dWqkv 6nc^2, dWproj 2nc^2."""
    if backward:
        return w * (22.0 * n * c * c + 12.0 * n * n * c)
    return w * (8.0 * n * c * c + 4.0 * n * n * c)


def mlp_flops(t, c, backward: bool) -> float:
    """Matmul FLOPs of the MLP half over t tokens, hidden width 4c.  Forward:
    fc1 and fc2.  Backward (from x and dy): fc1 recomputed, dgm, dxn, dW1,
    dW2, five products of 2 * t * c * 4c."""
    return (5 if backward else 2) * 2.0 * t * c * 4 * c


def phase_kernels(torch, dev, rng):
    import torch.nn.functional as F

    from facialmmt_tpu_torch.ops.kernels import attention, block_mlp, fused_block
    from facialmmt_tpu_torch.ops.swin import shifted_window_mask

    bf = lambda a: torch.tensor(a).to(dev, torch.bfloat16).contiguous()
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    results = {}

    # kernel 1: text tower attention, 8 dialogues x 16 heads x 512 x 64
    b, h, s, d = 8, 16, 512, 64
    bias = np.zeros((b, s), np.float32)
    for i in range(b - 1):
        bias[i, rng.integers(200, s):] = -1e30     # padded tails
    bias[-1] = -1e30                               # an all-padding dialogue
    q, k, v = (bf(rng.normal(size=(b, h, s, d)) * scale)
               for scale in (d ** -0.5, 1.0, 1.0))
    bias_t = f32(bias)
    mask = bias_t.to(torch.bfloat16)[:, None, None, :]
    compare(torch, "fused_attention", attention.fused_attention_cuda,
            attention.fused_attention_plain, (q, k, v, bias_t), results,
            flops=4.0 * b * h * s * s * d, label=f"{b}x{h}x{s}x{d}",
            library=lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, scale=1.0))

    def block_args(w, c, heads, res, shifted):
        n = 49
        rel = rng.normal(size=(1, heads, n, n)) * 0.5
        mask = (shifted_window_mask(res, res, 7, 3)[:, None] if shifted
                else np.zeros((1, 1, n, n)))
        return (bf(rng.normal(size=(w, n, c))),
                bf(1 + 0.1 * rng.normal(size=c)), bf(0.1 * rng.normal(size=c)),
                bf(rng.normal(size=(3 * c, c)) / np.sqrt(c)),
                bf(0.1 * rng.normal(size=3 * c)),
                bf(rng.normal(size=(c, c)) / np.sqrt(c)),
                bf(0.1 * rng.normal(size=c)), f32(rel + mask))

    def mlp_args(t, c):
        return (bf(rng.normal(size=(t, c))), bf(1 + 0.1 * rng.normal(size=c)),
                bf(0.1 * rng.normal(size=c)),
                bf(rng.normal(size=(4 * c, c)) / np.sqrt(c)),
                bf(0.1 * rng.normal(size=4 * c)),
                bf(rng.normal(size=(c, 4 * c)) / np.sqrt(4 * c)),
                bf(0.1 * rng.normal(size=c)))

    def image_keep(images, repeat):
        """Stochastic-depth multipliers at rate 0.3: 0 or 1/0.7 per image,
        repeated per window / per token."""
        per_image = (rng.random(images) > 0.3) / 0.7
        return f32(per_image).repeat_interleave(repeat).contiguous()

    # kernels 2 and 3, forward: every Swin-tiny stage at 64 faces of 224 px
    # (the serving pack), timed; then with `keep` at the 150-image auxiliary
    # batch, checked only
    for stage, (res, c, heads) in enumerate(SWIN_STAGES):
        nw = (res // 7) ** 2
        for shifted in ((False, True) if res > 7 else (False,)):
            w = FACES * nw
            compare(torch, "fused_attention_block",
                    fused_block.fused_attention_block_cuda,
                    fused_block.fused_attention_block_plain,
                    block_args(w, c, heads, res, shifted), results,
                    flops=attn_block_flops(w, 49, c, False),
                    label=f"stage {stage} W={w} C={c} h={heads} "
                          f"{'shifted' if shifted else 'unshifted'}")
        t = FACES * res * res
        compare(torch, "fused_ln_mlp_residual",
                block_mlp.fused_ln_mlp_residual_cuda,
                block_mlp.fused_ln_mlp_residual_plain, mlp_args(t, c), results,
                flops=mlp_flops(t, c, False), label=f"stage {stage} T={t} C={c}")
        w, t = AUX_IMAGES * nw, AUX_IMAGES * res * res
        compare(torch, "fused_attention_block",
                fused_block.fused_attention_block_cuda,
                fused_block.fused_attention_block_plain,
                (*block_args(w, c, heads, res, res > 7),
                 image_keep(AUX_IMAGES, nw)), results, flops=0, timed=False,
                label=f"stage {stage} W={w} C={c} with keep")
        compare(torch, "fused_ln_mlp_residual",
                block_mlp.fused_ln_mlp_residual_cuda,
                block_mlp.fused_ln_mlp_residual_plain,
                (*mlp_args(t, c), image_keep(AUX_IMAGES, res * res)), results,
                flops=0, timed=False, label=f"stage {stage} T={t} C={c} with keep")

    # kernels 4, 5 and 6, backward, at the 150-image auxiliary batch.  Which
    # attention backward serves a width is decided by backward_variant alone.
    print("dispatch: attention-half backward by width C: " + ", ".join(
        f"C={c} -> {fused_block.backward_variant(c)}" for _, c, _ in SWIN_STAGES)
        + "; MLP-half backward: one kernel at every stage")
    variants = {
        "resident": ("fused_attention_block_bwd",
                     fused_block.fused_attention_block_bwd_cuda,
                     fused_block.fused_attention_block_bwd_plain),
        "spill": ("fused_attention_block_bwd_spill",
                  fused_block.fused_attention_block_bwd_spill_cuda,
                  fused_block.fused_attention_block_bwd_spill_plain)}
    for stage, (res, c, heads) in enumerate(SWIN_STAGES):
        nw = (res // 7) ** 2
        w, t = AUX_IMAGES * nw, AUX_IMAGES * res * res
        name, kernel, plain = variants[fused_block.backward_variant(c)]
        # (shifted, keep, timed)
        cases = (((False, False, True), (True, True, True),
                  (False, True, False), (True, False, False)) if res > 7
                 else ((False, False, True), (False, True, False)))
        for shifted, keep, timed in cases:
            x, *params = block_args(w, c, heads, res, shifted)
            args = (x, bf(rng.normal(size=(w, 49, c))), *params[:5], params[6],
                    image_keep(AUX_IMAGES, nw) if keep else None)
            compare(torch, name, kernel, plain, args, results,
                    flops=attn_block_flops(w, 49, c, True),
                    out_names=ATTN_BWD_NAMES, timed=timed,
                    label=f"stage {stage} W={w} C={c} h={heads} "
                          f"{'shifted' if shifted else 'unshifted'}"
                          f"{' with keep' if keep else ''}")
        for keep, timed in ((False, True), (True, False)):
            x, *params = mlp_args(t, c)
            args = (x, bf(rng.normal(size=(t, c))), *params[:5],
                    image_keep(AUX_IMAGES, res * res) if keep else None)
            compare(torch, "fused_ln_mlp_residual_bwd",
                    block_mlp.fused_ln_mlp_residual_bwd_cuda,
                    block_mlp.fused_ln_mlp_residual_bwd_plain, args, results,
                    flops=mlp_flops(t, c, True), out_names=MLP_BWD_NAMES,
                    timed=timed, label=f"stage {stage} T={t} C={c}"
                                       f"{' with keep' if keep else ''}")
        torch.cuda.empty_cache()
    # the spill kernel also takes the narrower widths: check it at stage 2
    res, c, heads = SWIN_STAGES[2]
    w = AUX_IMAGES * 4
    x, *params = block_args(w, c, heads, res, True)
    compare(torch, *variants["spill"],
            (x, bf(rng.normal(size=(w, 49, c))), *params[:5], params[6], None),
            results, flops=0, out_names=ATTN_BWD_NAMES, timed=False,
            label=f"stage 2 W={w} C={c} shifted (off its dispatch)")
    for r in results.values():
        r["bound_by"] = ("operations" if r.pop("flops_ms") >= r.pop("bytes_ms")
                         else "bytes")
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
    require_launched(launches, SERVING_KERNELS, "the serving path")
    print(f"serving: {len(packs)} packs answered ({sum(map(len, packs))} "
          f"requests), finite rows summing to 1; launches {launches}")

    # the same weights, deterministic gumbel: bf16 on the card vs fp32 on CPU
    det = cfg.replace(runtime=RuntimeConfig(deterministic_gumbel=True))
    sd = server.model.state_dict()
    card = EmotionServer(det, sd, max_batch=8, face_capacity=FACES, device=dev)
    host = EmotionServer(det, {k: (v.float() if v.is_floating_point() else v)
                               .cpu() for k, v in sd.items()},
                         max_batch=8, face_capacity=FACES,
                         dtype=torch.float32, transfer_dtype=np.float32,
                         device="cpu")
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

    lat = server.benchmark_latency(10)
    print(f"serving: benchmark_latency(10) p50 {lat['p50_ms']:.2f} ms, p99 "
          f"{lat['p99_ms']:.2f} ms, mean {lat['mean_ms']:.2f} ms on {gpu_name}")
    return launches


SERVING_KERNELS = ("fused_attention", "fused_attention_block",
                   "fused_ln_mlp_residual")
BACKWARD_KERNELS = ("fused_ln_mlp_residual_bwd", "fused_attention_block_bwd",
                    "fused_attention_block_bwd_spill")


def require_launched(launches, names, where):
    missing = [k for k in names if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on {where}: {missing}")


def snapshot(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def changed_names(module, before):
    return {k for k, v in module.state_dict().items()
            if not torch_equal(v, before[k])}


def torch_equal(a, b):
    return bool((a == b).all())


def phase_training(torch, dev, gpu_name, base=None, aux_size=112):
    """`base`: the model configuration, FacialMMTConfig() unless a rehearsal
    at a small size passes another."""
    from facialmmt_tpu_torch.config import FacialMMTConfig
    from facialmmt_tpu_torch.data.meld import (SyntheticFerDataset,
                                               SyntheticMeldDataset)
    from facialmmt_tpu_torch.ops import kernels
    from facialmmt_tpu_torch.train.trainer import Trainer

    base = base or FacialMMTConfig()
    cfg = base.replace(optim=dataclasses.replace(
        base.optim, num_epochs=1, aux_batch_size=AUX_IMAGES, trg_batch_size=1,
        trg_accumulation_steps=4))
    aux_ds = SyntheticFerDataset(2 * AUX_IMAGES, aux_size, cfg.num_labels,
                                 seed=11)
    faces = [8, 7, 9, 8, 6, 10, 8, 8]
    train_ds = SyntheticMeldDataset(cfg, 8, 2, faces, seed=12, split="train")
    eval_ds = SyntheticMeldDataset(cfg, 8, 2, faces, seed=13, split="eval")

    trainer = Trainer(cfg)            # the default device: the card
    if trainer.device.type != dev.type:
        raise AssertionError(f"Trainer defaulted to {trainer.device}")
    seen = {"losses": [], "times": {"aux_step": [], "trg_step": []},
            "launches": {}, "peak": {}}
    mark = {}

    def params_of(branch):
        return {k for k, _ in getattr(trainer.state.model, branch)
                .named_parameters()}

    def on_event(name, **info):
        torch.cuda.synchronize()
        now = time.perf_counter()
        model = trainer.state.model
        if name in ("aux_step", "trg_step"):
            seen["losses"].append(info["loss"])
            seen["times"][name].append(now - mark["t"])
        elif name in ("aux_pass", "trg_pass"):
            swin_changed = changed_names(model.swin_model, mark["swin"])
            mm_changed = changed_names(model.multimodal, mark["mm"])
            seen["launches"][name] = kernels.launch_counts()
            seen["peak"][name] = torch.cuda.max_memory_allocated()
            bn = {"swin.output_layer.3.running_mean",
                  "swin.output_layer.3.running_var"}
            if name == "aux_pass":
                still = params_of("swin_model") - swin_changed
                if still or mm_changed:
                    raise AssertionError(
                        f"aux pass: Swin parameters unchanged {sorted(still)}, "
                        f"multimodal tensors changed {sorted(mm_changed)}")
                require_launched(seen["launches"][name],
                                 SERVING_KERNELS[1:] + BACKWARD_KERNELS,
                                 "the auxiliary pass")
            else:
                still = params_of("multimodal") - mm_changed
                moved = swin_changed & params_of("swin_model")
                if still or moved or not bn <= swin_changed:
                    raise AssertionError(
                        f"target pass: multimodal parameters unchanged "
                        f"{sorted(still)}, Swin parameters changed "
                        f"{sorted(moved)}, Swin tensors changed "
                        f"{sorted(swin_changed)} (expected the BatchNorm "
                        f"running statistics)")
                back = {k: seen["launches"][name][k] for k in BACKWARD_KERNELS}
                if any(back.values()):
                    raise AssertionError(f"default target pass launched a "
                                         f"backward kernel: {back}")
                require_launched(seen["launches"][name], SERVING_KERNELS[1:],
                                 "the target pass")
        if name in ("start", "aux_pass", "trg_pass", "valid"):
            mark["swin"] = snapshot(model.swin_model)
            mark["mm"] = snapshot(model.multimodal)
            kernels.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
        mark["t"] = time.perf_counter()

    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mark["t"] = t0
    f1 = trainer.run_multimodal(aux_ds, train_ds, eval_ds, eval_ds,
                                on_event=on_event)
    torch.cuda.synchronize()
    seen["launches"]["eval"] = kernels.launch_counts()
    require_launched(seen["launches"]["eval"], SERVING_KERNELS,
                     "the test evaluation")
    if not (np.isfinite(f1) and np.isfinite(seen["losses"]).all()
            and len(seen["times"]["aux_step"]) == 2
            and len(seen["times"]["trg_step"]) == 2):
        raise AssertionError(f"training: W-F1 {f1}, losses {seen['losses']}")
    print(f"training: run_multimodal at FacialMMTConfig() width and depth in "
          f"{time.perf_counter() - t0:.1f} s: 2 aux steps of {AUX_IMAGES} "
          f"images, 2 target steps of 4 utterances, validation, test W-F1 "
          f"{f1:.4f}; losses {[round(x, 4) for x in seen['losses']]}")
    for name, what in (("aux_step", f"aux step ({AUX_IMAGES} images, augment "
                        f"included)"), ("trg_step", "target step (4 "
                        "utterances, 64-face bucket, augment included)")):
        times = seen["times"][name]
        print(f"training: {what}: first {times[0] * 1e3:.1f} ms, after the "
              f"first {statistics.median(times[1:]) * 1e3:.1f} ms on "
              f"{gpu_name}")
    for name in ("aux_pass", "trg_pass"):
        print(f"training: {name}: peak memory "
              f"{seen['peak'][name] / 2 ** 30:.2f} GiB, launches "
              f"{seen['launches'][name]} on {gpu_name}")
    paths = {"aux": seen["launches"]["aux_pass"],
             "target": seen["launches"]["trg_pass"],
             "eval": seen["launches"]["eval"]}

    # one joint step (swin_from_target: the microbatch step) on the same model
    model = trainer.state.model
    jcfg = cfg.replace(swin_from_target=True)
    joint = Trainer(jcfg)
    state, _, trg_bsz = joint._init_multitask_state(model, train_ds,
                                                    len(aux_ds))
    _, trg_step, _, use_micro = joint._make_steps(model)
    if not use_micro:
        raise AssertionError("joint training did not pick the microbatch step")
    batch, _ = next(iter(joint._target_loader(train_ds, trg_bsz, True).epoch(1)))
    device_batch = joint._prepare_faces(batch, train=True)
    before_swin, before_mm = snapshot(model.swin_model), snapshot(model.multimodal)
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = float(trg_step(state, device_batch, joint.generator))
    torch.cuda.synchronize()
    joint_s = time.perf_counter() - t0
    paths["joint"] = kernels.launch_counts()
    require_launched(paths["joint"], SERVING_KERNELS[1:] + BACKWARD_KERNELS,
                     "the joint step")
    swin_params = {k for k, _ in model.swin_model.named_parameters()}
    mm_params = {k for k, _ in model.multimodal.named_parameters()}
    swin_moved = swin_params & changed_names(model.swin_model, before_swin)
    mm_moved = mm_params & changed_names(model.multimodal, before_mm)
    if not (swin_moved and mm_moved and np.isfinite(loss)
            and (state.swin_step, state.mm_step) == (1, 1)):
        raise AssertionError(f"joint step: loss {loss}, {len(swin_moved)} Swin "
                             f"and {len(mm_moved)} multimodal parameters moved")
    print(f"training: joint step (4 microbatches of 1 utterance, 64-face "
          f"bucket): loss {loss:.4f}, {len(swin_moved)}/{len(swin_params)} "
          f"Swin and {len(mm_moved)}/{len(mm_params)} multimodal parameters "
          f"moved, {joint_s * 1e3:.1f} ms (first call), "
          f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, "
          f"launches {paths['joint']} on {gpu_name}")

    step_breakdown(torch, trainer, aux_ds, train_ds, gpu_name)
    grad_check(torch, dev, cfg, model, aux_ds, trainer.generator)
    return paths


def step_breakdown(torch, trainer, aux_ds, train_ds, gpu_name, repeats=3):
    """Where one auxiliary and one default target step spend their time: each
    piece runs between two synchronisations on the host clock; medians of
    `repeats` steps from the trainer's state."""
    from facialmmt_tpu_torch.data.image_pipeline import affwild2_train_augment
    from facialmmt_tpu_torch.train.steps import compute_context, cross_entropy

    state, cfg, gen = trainer.state, trainer.cfg, trainer.generator
    model, dev = state.model, trainer.device
    dtype = cfg.runtime.compute_dtype

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def report(what, rows):
        med = {k: statistics.median(v) for k, v in rows.items()}
        print(f"training: {what} breakdown (median of {repeats}, ms): "
              + ", ".join(f"{k} {v:.1f}" for k, v in med.items())
              + f", sum {sum(med.values()):.1f} on {gpu_name}")

    model.train()
    images_np, labels_np = aux_ds.get_batch(range(AUX_IMAGES))
    rows = {k: [] for k in ("copy + augment", "Swin forward", "Swin backward",
                            "clip + AdamW")}
    for _ in range(repeats):
        images, t = timed(lambda: affwild2_train_augment(
            gen, trainer._to_device(images_np).float(),
            img_size=cfg.data.swin_img_size))
        rows["copy + augment"].append(t)
        labels = trainer._to_device(labels_np)

        def forward():
            with compute_context(dev, dtype):
                return cross_entropy(model.aux_logits(images, generator=gen),
                                     labels)

        loss, t = timed(forward)
        rows["Swin forward"].append(t)
        rows["Swin backward"].append(timed(loss.backward)[1])
        rows["clip + AdamW"].append(timed(state.swin_opt.step)[1])
    report(f"aux step ({AUX_IMAGES} images)", rows)

    batch, _ = next(iter(trainer._target_loader(train_ds, 4, False).epoch(1)))
    rows = {k: [] for k in ("copy + augment", "Swin forward (no graph)",
                            "text + fusion forward", "backward",
                            "clip + AdamW")}
    for _ in range(repeats):
        device_batch, t = timed(lambda: trainer._prepare_faces(batch, True))
        rows["copy + augment"].append(t)

        def swin_forward():
            with torch.no_grad(), compute_context(dev, dtype):
                return model.fer_probs(device_batch["faces"], generator=gen)

        probs, t = timed(swin_forward)
        rows["Swin forward (no graph)"].append(t)

        def fusion_forward():
            with compute_context(dev, dtype):
                logits = model(dict(device_batch, face_probs=probs),
                               generator=gen)
            return cross_entropy(logits, device_batch["labels"])

        loss, t = timed(fusion_forward)
        rows["text + fusion forward"].append(t)
        rows["backward"].append(timed(loss.backward)[1])
        rows["clip + AdamW"].append(timed(state.mm_opt.step)[1])
    report("target step (4 utterances, 64-face bucket)", rows)


def grad_check(torch, dev, cfg, model, aux_ds, generator):
    """The gradients of one auxiliary batch's loss, drop-path off: bf16
    kernels on the card against fp32 plain versions on the CPU, same weights
    and batch, every leaf of the first and last Swin block and the head.

    Two things are taken out of the auxiliary step's loss, because with them
    the comparison measures bf16, not the kernels: the ReLU between the head's
    two Linears, of whose gates a 1 % difference in the features flips about
    1 %, and the BatchNorm's batch statistics (it normalises with its running
    statistics here).  experiments/torch_grad_noise.py measures it: with both
    in, the kernels, their plain bf16 versions on the card and fp32 on the CPU
    are 9 to 20 % of a leaf's largest gradient apart from each other, while
    Swin's features agree to 1.2 %; with the ReLU out 1.3 to 2.9 %; with both
    out 1.1 to 1.7 %."""
    import copy

    from facialmmt_tpu_torch.data.image_pipeline import affwild2_train_augment
    from facialmmt_tpu_torch.train.steps import compute_context, cross_entropy

    images, labels = aux_ds.get_batch(range(AUX_IMAGES))
    images = affwild2_train_augment(
        generator, torch.from_numpy(images).to(dev).float(),
        img_size=cfg.data.swin_img_size)
    labels = torch.from_numpy(labels).to(dev)
    card = model.swin_model
    host = copy.deepcopy(card).to("cpu").float()
    blocks = sum(cfg.swin.depths)
    grads = {}
    for name, net, x, y in (("card", card, images, labels),
                            ("cpu", host, images.cpu(), labels.cpu())):
        net.train()
        net.zero_grad(set_to_none=True)
        t0 = time.perf_counter()
        with compute_context(x.device, cfg.runtime.compute_dtype):
            feats = net.swin(x, keeps=[(None, None)] * blocks,
                             use_running_average=True)
            logits = net.classifier(net.linear(feats))
        cross_entropy(logits, y).backward()
        if x.is_cuda:
            torch.cuda.synchronize()
        grads[name] = {k: p.grad.float().cpu() for k, p in
                       net.named_parameters()}
        print(f"training: gradient check, {name} forward + backward of "
              f"{AUX_IMAGES} images in {time.perf_counter() - t0:.1f} s")
        net.zero_grad(set_to_none=True)
    last = f"swin.layers.{len(cfg.swin.depths) - 1}.blocks." \
           f"{cfg.swin.depths[-1] - 1}."
    groups = {"first block": "swin.layers.0.blocks.0.", "last block": last,
              "head": ("swin.output_layer.", "linear.", "classifier.")}
    # A leaf is held to GRAD_BOUND of its own largest gradient, but to no
    # less than 1e-3 of the largest gradient of all held leaves, so that a
    # leaf whose gradient is (nearly) zero is not held to its rounding noise.
    held = [k for k in grads["cpu"]
            if any(k.startswith(p) for p in groups.values())]
    top = max(float(grads["cpu"][k].abs().max()) for k in held)
    for group, prefix in groups.items():
        worst = ("", 0.0)
        for k in (k for k in held if k.startswith(prefix)):
            want, got = grads["cpu"][k], grads["card"][k]
            scale = max(float(want.abs().max()), 1e-3 * top)
            rel = float((got - want).abs().max()) / scale
            if not (torch.isfinite(got).all() and rel <= GRAD_BOUND):
                raise AssertionError(f"gradient check {k}: max|d| {rel} * "
                                     f"{scale} > {GRAD_BOUND}")
            worst = max(worst, (k, rel), key=lambda kv: kv[1])
        print(f"training: card bf16 vs CPU fp32 gradients of one aux batch, "
              f"{group}: worst max|d|/max|grad| {worst[1]:.3g} at {worst[0]} "
              f"<= {GRAD_BOUND} (largest held |grad| {top:.3g})")


def main(json_out: str = "") -> int:
    """`json_out`: where to write the per-shape kernel times and the launch
    counts per path, if anywhere."""
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
            print("build: " + line.strip()[:160])

    rng = np.random.default_rng(0)
    results = phase_kernels(torch, dev, rng)
    torch.cuda.empty_cache()
    paths = {"serving": phase_serving(torch, dev, rng, gpu_name)}
    torch.cuda.empty_cache()
    paths.update(phase_training(torch, dev, gpu_name))

    if json_out:
        os.makedirs(os.path.dirname(os.path.abspath(json_out)), exist_ok=True)
        with open(json_out, "w") as f:
            json.dump({"card": gpu_name, "kernels": results,
                       "launches": paths}, f, indent=1)
    print(gpu_name)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": sum(p[name] for p in paths.values()),
         "launches_by_path": {k: p[name] for k, p in paths.items()},
         **{k: v for k, v in results[name].items() if k != "shapes"}}
        for name, (src, rep) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:2]))
