#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on one NVIDIA H100.

    python3 chip_smoke.py [kernels.json]

With a path, the per-shape kernel times and the launch counts per path are
also written there as JSON.  Phases (each prints lines; any failure raises and the exit code is non-zero):
  1. the card: nvidia-smi name and power limit, compute capability 9.0;
  2. build the CUDA kernels from facialmmt_tpu_torch/csrc (timed);
  3. every kernel against its plain PyTorch version on the card, in bf16, at
     the shapes the paths give it: the text tower's 8 x 16 x 512 x 64
     attention (padded; beside it, outside the row's sums, the same shape
     unpadded and the fusion stacks' 157 x 157 and 38 x 157 at 8 x 12 heads,
     with plain attention's and SDPA's device times), and kernel 1's
     gradients in a train-mode text layer against the plain attention's;
     the forward Swin halves at every stage at 64 faces (serving), two
     launches bit for bit, each beside the same half as the other route
     computes it (LN, qkv, kernel 8, proj; the 'xla' MLP half) and with the
     times of its device kernels, and, with a stochastic-depth `keep`, at
     150 images (the auxiliary batch);
     the three backward kernels at every stage they serve at 150 images, with
     and without `keep`, shifted and unshifted bias, every output compared,
     two launches bit for bit (kernel 6 at stage 3 also twice into outputs
     and scratch filled with NaN), and beside each timed shape the times of
     the wrapper's device kernels and the same half's backward as torch
     autograd (xla_mlp_half, xla_attention_half: a yardstick only);
     the three window-attention entry points at every stage of a 64-face pack
     (shifted bias, nW = 64 / 16 / 4, and nW = 1; the bias in bf16, with the
     fp32 bias's cast and the share of the HBM bound beside each shape) and
     the merge tail at the
     three stage transitions; the whole block at every stage shape of a
     64-face pack, two launches bit for bit, also into NaN-filled outputs
     and scratch (beside it the split, kernel 2 then kernel 3, on the same
     inputs, and both calls' device kernels) and the shift permutation both
     ways at stages 0-2, bit for bit.
     Median times from CUDA events (5 launches
     between two events for every kernel, since the window-attention kernels
     were added: `ms` values taken before that, with one launch between two
     events, are not comparable with these), and the kernels' own durations from torch.profiler
     (no host time in them), stand next to each call's bound: the larger of its matmul FLOPs over the dense bf16
     peak and the bytes it must move (inputs read once, outputs written once)
     over the HBM rate;
  4. serving: the headline model (FacialMMTConfig(): RoBERTa-large, Swin-tiny
     at 224 px, the 768-wide fusion stack) behind EmotionServer(max_batch=8,
     face_capacity=64), random bf16 weights from the config's seed: packs of
     synthetic requests through predict(), launch counts > 0, one pack held
     against the same weights on the CPU in fp32, benchmark_latency.  Then
     the same weights behind servers whose Swin takes the routes
     (attention_impl, mlp_impl, merge_impl) = ('pallas', 'xla', 'window') and
     ('pair', 'auto', 'raster'): the same packs, their own kernels launched
     12 times a pack and the fused block kernel never, the answers held
     against the default server's, benchmark_latency per route;
  5. Swin routes: one 64-face forward on the ('pallas', 'xla', 'window')
     route whose q, k, v, bias of every block and gathered rows of every
     stage transition are captured: fused_window_attention_v2 on them against
     what fused_window_attention returned, fused_merge against the module's
     LayerNorm + Linear; a 63-face forward under 'pair', whose last stage
     (an odd window count) must launch fused_window_attention; the forward's
     time under nine routes;
  6. whole block and shift permutation: kernels 7 and 12 on every block's
     input of one 64-face forward on the default route, composed as the
     block (shift_permute, fused_whole_block, the inverse), held against the
     block's own output, the whole block against its plain version, the
     permutations and one backward bit for bit against the index gathers,
     exact launch counts; the 12 blocks timed three ways (this composition,
     the default route, ('pallas', 'xla'));
  7. training: Trainer(FacialMMTConfig()).run_multimodal on synthetic
     in-memory datasets (300 auxiliary images at 150 a step, 8 utterances at 4
     a step): 2 auxiliary steps, 2 target steps, validation and the test
     eval, with the parameter-movement and launch-count assertions per pass,
     checkpoints to a temporary directory (size and write time of each);
     one joint step (swin_from_target, the microbatch step); a step-time
     breakdown with the auxiliary step's peak memory; one auxiliary batch's
     gradients on the card held against the CPU in fp32; two auxiliary steps
     under ('pallas', 'xla', 'window') and that route's auxiliary breakdown
     (its Swin backward and peak memory beside the default route's);
  8. resume: the same run again uninterrupted, and preempted after its
     first target step and resumed by a fresh Trainer; each run's first
     auxiliary step (its loss and every Swin tensor after it) and its final
     resume file held against the first run's, per kind of tensor; the
     trained model out as the reference's two released files and back in
     behind an EmotionServer, answers unchanged;
  9. command-line eval: files in the reference's MELD layout at full
     width, written to a temporary directory by tests/fixtures.py's writers
     (feature pickles, profile and face-path JSONs, face JPEGs by cv2) with
     the text npz cache from its whitespace tokenizer; the decoder the
     machine picks held to PIL's decode within one level; a released pair
     and a unimodal_model_V.pt from seed-7 weights; `main.run` with
     --choice_modality T+A+V --doEval 1 on 24 test utterances (two eval
     batches), its W-F1 equal to Trainer.eval_multimodal_only's on the same
     files and exactly kernels 1-3 launched; the same command with its eval
     loop under torch.profiler; the time end to end, of the loop and of its
     first batch, the decoder's faces/s and the device's share of the
     profiled loop, all of two batches (smoke readings, not rates:
     experiments/torch_file_steps.py takes them at MELD's test-split
     size); then `python -m facialmmt_tpu_torch.main --choice_modality V
     --doEval 1` in its own process, equal to eval_unimodal_only;
 10. command-line training: an Aff-Wild2 tree (tests/fixtures.py, the
     decoder held to PIL on its frames), a `backbone.*` Swin file and an
     HF-layout text directory; --doEval 0 --num_epochs 1 (2 auxiliary steps
     of 150 frames, 2 target steps of 4 utterances, validation, test): the
     grafted towers equal the files before the first step, finite losses,
     kernels 2-6 launched, best and resume files written; the same command
     with --resume 1 runs no step and gives the same W-F1; step times from
     files beside phase 7's in-memory ones, and each batch's decode time
     alone.
The line before the last is {"kernels": [...]} and the last line is
{"ok": true, "device": {...}}.  Exits non-zero with no result when no CUDA
device is visible or the package is missing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FACES = 64                # the serving bucket's packed-face capacity
AUX_IMAGES = 150          # the auxiliary FER batch (optim.aux_batch_size)
KERNEL_BOUND = 2e-2       # max|kernel - plain| <= KERNEL_BOUND * max|plain|
KERNEL_REPS = 5           # launches between two timing events (cuda_ms)
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
    "fused_attention_block": ("facialmmt_tpu_torch/csrc/attention_block.cu",
                              "facialmmt_tpu/ops/pallas/fused_block.py:213"),
    "fused_ln_mlp_residual": ("facialmmt_tpu_torch/csrc/block_mlp.cu",
                              "facialmmt_tpu/ops/pallas/block_mlp.py:134"),
    "fused_ln_mlp_residual_bwd": (
        "facialmmt_tpu_torch/csrc/block_mlp_bwd.cu",
        "facialmmt_tpu/ops/pallas/block_mlp.py:257"),
    "fused_attention_block_bwd": (
        "facialmmt_tpu_torch/csrc/attention_block_bwd.cu",
        "facialmmt_tpu/ops/pallas/fused_block.py:512"),
    "fused_attention_block_bwd_spill": (
        "facialmmt_tpu_torch/csrc/attention_block_bwd.cu",
        "facialmmt_tpu/ops/pallas/fused_block.py:573"),
    "fused_window_attention": (
        "facialmmt_tpu_torch/csrc/window_attention.cu",
        "facialmmt_tpu/ops/pallas/window_attention.py:57"),
    "paired_window_attention": (
        "facialmmt_tpu_torch/csrc/window_attention.cu",
        "facialmmt_tpu/ops/pallas/window_attention.py:252"),
    "fused_window_attention_v2": (
        "facialmmt_tpu_torch/csrc/window_attention.cu",
        "facialmmt_tpu/ops/pallas/window_attention.py:290"),
    "fused_merge": ("facialmmt_tpu_torch/csrc/merge_kernel.cu",
                    "facialmmt_tpu/ops/pallas/merge_kernel.py:103"),
    "fused_whole_block": ("facialmmt_tpu_torch/csrc/attention_block.cu",
                          "facialmmt_tpu/ops/pallas/fused_block.py:848"),
    "shift_permute": ("facialmmt_tpu_torch/csrc/shift_permute.cu",
                      "facialmmt_tpu/ops/pallas/shift_permute.py:122"),
}
WINDOW_KERNELS = ("fused_window_attention", "paired_window_attention",
                  "fused_window_attention_v2")
# Swin routes (attention_impl, mlp_impl, merge_impl) beside the default
ROUTE_PALLAS = ("pallas", "xla", "window")
ROUTE_PAIR = ("pair", "auto", "raster")
MLP_BWD_NAMES = ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2")
ATTN_BWD_NAMES = ("dx", "dgamma", "dbeta", "dwqkv", "dbqkv", "dwproj",
                  "dbproj", "dbias")


def cuda_ms(torch, fn, iters: int = 10, reps: int = 1) -> float:
    """Median device time of one fn() in ms (CUDA events, after one warm-up).
    `reps` calls go between each pair of events, so that a call shorter than
    the host takes to launch it is timed back to back and not with the card
    idle in between."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def device_ms(torch, fn, iters: int = 5):
    """Device time of one fn() in ms: the durations of the kernels it
    launches, summed, from torch.profiler's trace of `iters` calls.  Unlike
    cuda_ms it holds none of the host's time to launch them.  Once in a
    hundred or so traces the profiler hands back no kernel event; after one
    more try the answer is None (not measured), never a guess."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        # kernel events only: an operator's entry repeats its kernels' time
        total_us = sum(e.self_device_time_total for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA)
        if total_us > 0:
            return total_us / iters / 1e3
    return None


def device_kernels_ms(torch, fn, iters: int = 5):
    """{device kernel name: ms per fn()} from torch.profiler's trace of
    `iters` calls, for a wrapper that launches several device kernels; {}
    when the trace holds no kernel event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key.replace("(anonymous namespace)::", "").split("(")[0]
            .replace("void ", "").strip():
            e.self_device_time_total / iters / 1e3
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0}


def nan_filled_launches(torch, kernel, args) -> bool:
    """Two launches of `kernel` with every tensor its wrapper allocates
    (outputs and scratch) filled with NaN first, uint8 scratch with 255:
    True when both give the bits of a launch into fresh memory, so that
    every output element is written and no scratch element is read before
    it is written."""
    from unittest import mock

    empty, empty_like = torch.empty, torch.empty_like

    def filled(t):
        return t.fill_(float("nan")) if t.is_floating_point() else t.fill_(255)

    flat = lambda out: out if isinstance(out, tuple) else (out,)
    want = flat(kernel(*args))
    with mock.patch.object(torch, "empty",
                           lambda *a, **k: filled(empty(*a, **k))), \
            mock.patch.object(torch, "empty_like",
                              lambda *a, **k: filled(empty_like(*a, **k))):
        got = [flat(kernel(*args)) for _ in range(2)]
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for g in got for a, b in zip(g, want))


def add_ms(total, part):
    """Sum of per-shape times; None (not measured) if any part is."""
    return None if total is None or part is None else total + part


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def compare(torch, name, kernel, plain, args, results, *, flops, out_names=None,
            timed=True, library=None, label="", summed=True, bitwise=False):
    """Run kernel and plain on the same inputs and hold every output to the
    bound (a bias cotangent by its group sum, the only part of it that is
    defined); with `bitwise`, a second launch must give the same bits.  When
    `timed`, time the call (median kernel, plain and library times) beside
    its bound and add them to the kernel's totals, unless `summed` is false:
    then the shape is only printed and listed.  Prints one line."""
    got = kernel(*args)
    want = plain(*args)
    single = not isinstance(got, tuple)
    if bitwise:
        again = kernel(*args)
        if not all(torch.equal(a, b) for a, b in
                   zip((got,) if single else got,
                       (again,) if single else again)):
            raise AssertionError(f"{name} {label}: two launches differ")
        del again
    torch.cuda.synchronize()
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
        "max_abs_err": 0.0, "max_rel_err": 0.0, "ms": 0.0, "device_ms": 0.0,
        "plain_ms": 0.0, "bound_ms": 0.0, "flops_ms": 0.0, "bytes_ms": 0.0,
        "library_ms": None, "library_device_ms": None, "shapes": []})
    first = outs[0]
    r["max_abs_err"] = max(r["max_abs_err"], float(
        (first[1].float() - first[2].float()).abs().max()))
    r["max_rel_err"] = max(r["max_rel_err"], worst)
    line = f"kernel {name} {label}: worst output max|d|/max|plain| {worst:.3g}"
    if bitwise:
        line += ", two launches bit for bit"
    if timed:
        moved = tensor_bytes(*[a for a in args if torch.is_tensor(a)],
                             *[g for _, g, _ in outs])
        flops_ms = flops / PEAK_BF16_FLOPS * 1e3
        bytes_ms = moved / PEAK_HBM_BYTES * 1e3
        ms = cuda_ms(torch, lambda: kernel(*args), reps=KERNEL_REPS)
        plain_ms = cuda_ms(torch, lambda: plain(*args), iters=5)
        dev_ms = device_ms(torch, lambda: kernel(*args))
        entry = {"shape": label, "summed": summed, "ms": ms,
                 "device_ms": dev_ms,
                 "plain_ms": plain_ms, "bound_ms": max(flops_ms, bytes_ms),
                 "bound_by": "operations" if flops_ms >= bytes_ms else "bytes",
                 "gflop": flops / 1e9, "mbytes": moved / 1e6}
        line += (f", {ms:.4f} ms ({fmt_ms(dev_ms)} on the device alone) vs "
                 f"bound {entry['bound_ms']:.4f} ms "
                 f"({entry['bound_by']}: {entry['gflop']:.2f} GFLOP, "
                 f"{entry['mbytes']:.1f} MB), plain {plain_ms:.4f} ms")
        if library is not None:
            entry["library_ms"] = cuda_ms(torch, library, reps=KERNEL_REPS)
            entry["library_device_ms"] = device_ms(torch, library)
            line += (f", library call {entry['library_ms']:.4f} ms "
                     f"({fmt_ms(entry['library_device_ms'])} on the device "
                     f"alone)")
        if summed:
            if library is not None:
                r["library_ms"] = ((r["library_ms"] or 0.0)
                                   + entry["library_ms"])
                r["library_device_ms"] = add_ms(
                    0.0 if len(r["shapes"]) == 0 else r["library_device_ms"],
                    entry["library_device_ms"])
            r["ms"] += ms
            r["device_ms"] = add_ms(r["device_ms"], dev_ms)
            r["plain_ms"] += plain_ms
            r["bound_ms"] += entry["bound_ms"]
            r["flops_ms"] += flops_ms
            r["bytes_ms"] += bytes_ms
        else:
            line += " (not in the row's sums)"
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


def pallas_attention_half(torch, x, gamma, beta, wqkv, bqkv, wproj, bproj,
                          bias):
    """The attention half as the ('pallas', *, *) route computes it (ops/
    swin.py: SwinBlock._attention_half, WindowAttention.forward): LayerNorm,
    the qkv Linear, the head transposes, kernel 8, proj, the residual."""
    import torch.nn.functional as F

    from facialmmt_tpu_torch.ops.kernels import window_attention

    w, n, c = x.shape
    heads = bias.shape[1]
    hd = c // heads
    y = F.layer_norm(x, (c,), gamma, beta, 1e-5)
    q, k, v = F.linear(y, wqkv, bqkv).reshape(w, n, 3, heads, hd).permute(
        2, 0, 3, 1, 4)
    core = window_attention.fused_window_attention_cuda(
        (q * hd ** -0.5).contiguous(), k.contiguous(), v.contiguous(), bias)
    return x + F.linear(core.permute(0, 2, 1, 3).reshape(w, n, c), wproj,
                        bproj)


def xla_mlp_half(torch, x, gamma, beta, w1, b1, w2, b2):
    """The MLP half as the (*, 'xla', *) route computes it (SwinBlock.
    _mlp_half): LayerNorm, fc1, exact GELU, fc2, the residual."""
    import torch.nn.functional as F

    y = F.layer_norm(x, (x.shape[-1],), gamma, beta, 1e-5)
    return x + F.linear(F.gelu(F.linear(y, w1, b1)), w2, b2)


def xla_attention_half(torch, x, gamma, beta, wqkv, bqkv, wproj, bproj, bias):
    """The attention half in plain PyTorch operators, no SDPA (the 'xla'
    formulation, batched over heads): LayerNorm, the qkv Linear, q k^T with
    the bias, an fp32 softmax, P v, proj, the residual."""
    import torch.nn.functional as F

    w, n, c = x.shape
    nw, heads = bias.shape[0], bias.shape[1]
    hd = c // heads
    y = F.layer_norm(x, (c,), gamma, beta, 1e-5)
    q, k, v = F.linear(y, wqkv, bqkv).reshape(w, n, 3, heads, hd).permute(
        2, 0, 3, 1, 4)
    s = (q * hd ** -0.5) @ k.transpose(-1, -2)
    s = (s.reshape(w // nw, nw, heads, n, n) + bias).reshape(w, heads, n, n)
    p = torch.softmax(s.float(), dim=-1).to(x.dtype)
    o = (p @ v).permute(0, 2, 1, 3).reshape(w, n, c)
    return x + F.linear(o, wproj, bproj)


def autograd_backward(torch, half, args, dy):
    """The backward of `half` (xla_mlp_half or xla_attention_half) as torch
    autograd computes it, every floating-point input a leaf, the forward's
    graph built once: (ms by CUDA events, ms on the device alone).  A
    yardstick beside kernels 4-6; the port never calls it."""
    leaves = [a.detach().requires_grad_() for a in args]
    out = half(torch, *leaves)
    grads = lambda: torch.autograd.grad(out, leaves, dy, retain_graph=True)
    result = (cuda_ms(torch, grads, reps=KERNEL_REPS),
              device_ms(torch, grads))
    del out
    return result


def text_layer_gradients(torch, dev):
    """Kernel 1 in training: a text layer (1024 wide, 16 heads of 64, 8 x 512
    tokens with padded tails, train mode, attention dropout 0) under bf16
    autocast, a loss linear in its output; every weight gradient through
    kernel 1 held within KERNEL_BOUND * max of the same layer's with the
    plain attention (autocast off inside it, as in the Function's backward).
    The key bias's gradient is 0 in exact arithmetic (a
    per-query constant shift of the scores): its scale is the key weight's."""
    import dataclasses as dc

    from facialmmt_tpu_torch.config import TextEncoderConfig
    from facialmmt_tpu_torch.models import text_encoder
    from facialmmt_tpu_torch.ops import kernels
    from facialmmt_tpu_torch.ops.kernels import attention

    cfg = dc.replace(TextEncoderConfig(), hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0)
    gen = torch.Generator(device="cpu").manual_seed(7)
    layer = text_encoder.TextEncoderLayer(cfg).to(dev).train()
    x = torch.randn(8, 512, cfg.hidden_size, generator=gen).to(dev)
    cot = torch.randn(8, 512, cfg.hidden_size, generator=gen).to(dev)
    bias = torch.zeros(8, 512, device=dev)
    for i in range(8):
        bias[i, 200 + 40 * i:] = -1e30

    def grads(attend):
        text_encoder.fused_attention = attend
        layer.zero_grad()
        with torch.autocast("cuda", dtype=torch.bfloat16):
            out = layer(x, bias)
        if out.grad_fn is None:
            raise AssertionError("text layer: no gradient through attention")
        (out.float() * cot).sum().backward()
        return {n: p.grad.float().clone() for n, p in layer.named_parameters()}

    def plain(q, k, v, b):
        with torch.autocast("cuda", enabled=False):
            return attention.fused_attention_plain(q, k, v, b)

    kernels.reset_launch_counts()
    try:
        got = grads(attention.fused_attention)
        launches = kernels.launch_counts()["fused_attention"]
        want = grads(plain)
    finally:
        text_encoder.fused_attention = attention.fused_attention
    if launches != 1:
        raise AssertionError(f"text layer: kernel 1 launched {launches} times")
    worst = 0.0
    for name, g in got.items():
        ref = want["attention.self.key.weight" if name ==
                   "attention.self.key.bias" else name]
        rel = float((g - want[name]).abs().max() / ref.abs().max())
        if not (torch.isfinite(g).all() and rel <= KERNEL_BOUND):
            raise AssertionError(f"text layer gradient {name}: {rel} > "
                                 f"{KERNEL_BOUND}")
        worst = max(worst, rel)
    print(f"kernel fused_attention: a train-mode text layer's {len(got)} "
          f"weight gradients through the kernel vs the plain attention, worst "
          f"max|d|/max {worst:.3g} (bound {KERNEL_BOUND})")


def phase_kernels(torch, dev, rng):
    import torch.nn.functional as F

    from facialmmt_tpu_torch.ops.kernels import (attention, block_mlp,
                                                 fused_block, merge_kernel,
                                                 shift_permute,
                                                 window_attention)
    from facialmmt_tpu_torch.ops.swin import (shifted_window_mask,
                                              shifted_window_perms)

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
    # beside the row, not in its sums: the same shape with no padding (every
    # key real: the comparison with SDPA on full work), then the fusion
    # stacks' shapes at the serving batch (8 utterances, 12 heads of 64, the
    # encoders' -10000 padding bias): the audio tower's 157 x 157 and the
    # crossmodal 38 x 157, which the JAX package's TPU-measured Sk >= 256 gate
    # sends to plain attention.  "plain" there is that path's matmul, fp32
    # softmax, matmul.
    zero = f32(np.zeros((b, s), np.float32))
    compare(torch, "fused_attention", attention.fused_attention_cuda,
            attention.fused_attention_plain, (q, k, v, zero), results,
            flops=4.0 * b * h * s * s * d, label=f"{b}x{h}x{s}x{d} no padding",
            library=lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=zero.to(torch.bfloat16)[:, None, None, :],
                scale=1.0), summed=False)
    fuse_b, fuse_h, fuse_d = 8, 12, 64
    for what, sq, sk in (("audio tower", 157, 157), ("crossmodal", 38, 157)):
        fbias = np.zeros((fuse_b, sk), np.float32)
        for i in range(fuse_b):
            fbias[i, rng.integers(sk // 2, sk + 1):] = -10000.0
        fq = bf(rng.normal(size=(fuse_b, fuse_h, sq, fuse_d))
                * fuse_d ** -0.5)
        fk, fv = (bf(rng.normal(size=(fuse_b, fuse_h, sk, fuse_d)))
                  for _ in range(2))
        fbias_t = f32(fbias)
        fmask = fbias_t.to(torch.bfloat16)[:, None, None, :]
        compare(torch, "fused_attention", attention.fused_attention_cuda,
                attention.fused_attention_plain, (fq, fk, fv, fbias_t),
                results, flops=4.0 * fuse_b * fuse_h * sq * sk * fuse_d,
                label=f"{what} {fuse_b}x{fuse_h}x{sq}x{sk}x{fuse_d}",
                summed=False,
                library=lambda: F.scaled_dot_product_attention(
                    fq, fk, fv, attn_mask=fmask, scale=1.0))
        plain_dev = device_ms(torch, lambda: attention.fused_attention_plain(
            fq, fk, fv, fbias_t))
        results["fused_attention"]["shapes"][-1]["plain_device_ms"] = plain_dev
        print(f"kernel fused_attention {what}: plain attention "
              f"{fmt_ms(plain_dev)} on the device alone")

    # kernel 1's gradient: a train-mode text layer with attention dropout 0
    # (the path that sends training to kernel 1) under bf16 autocast, its
    # weight gradients held against the same layer's with plain attention
    text_layer_gradients(torch, dev)

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
    # (the serving pack), timed, two launches bit for bit, and beside each
    # shape the same half as the other route computes it (device alone and
    # by events); then with `keep` at the 150-image auxiliary batch, checked
    # only
    other_route = {"fused_attention_block": pallas_attention_half,
                   "fused_ln_mlp_residual": xla_mlp_half}
    for stage, (res, c, heads) in enumerate(SWIN_STAGES):
        nw = (res // 7) ** 2
        cases = [("fused_attention_block",
                  fused_block.fused_attention_block_cuda,
                  fused_block.fused_attention_block_plain,
                  block_args(FACES * nw, c, heads, res, shifted),
                  attn_block_flops(FACES * nw, 49, c, False),
                  f"stage {stage} W={FACES * nw} C={c} h={heads} "
                  f"{'shifted' if shifted else 'unshifted'}")
                 for shifted in ((False, True) if res > 7 else (False,))]
        t = FACES * res * res
        cases.append(("fused_ln_mlp_residual",
                      block_mlp.fused_ln_mlp_residual_cuda,
                      block_mlp.fused_ln_mlp_residual_plain, mlp_args(t, c),
                      mlp_flops(t, c, False), f"stage {stage} T={t} C={c}"))
        for name, kernel, plain, args, flops, label in cases:
            compare(torch, name, kernel, plain, args, results, flops=flops,
                    label=label, bitwise=True)
            route = lambda: other_route[name](torch, *args)
            entry = results[name]["shapes"][-1]
            entry["route_ms"] = cuda_ms(torch, route, reps=KERNEL_REPS)
            entry["route_device_ms"] = device_ms(torch, route)
            results[name]["route_ms"] = results[name].get("route_ms", 0.0) \
                + entry["route_ms"]
            results[name]["route_device_ms"] = add_ms(
                results[name].get("route_device_ms", 0.0),
                entry["route_device_ms"])
            print(f"kernel {name} {label}: the other route's half "
                  f"{entry['route_ms']:.4f} ms "
                  f"({fmt_ms(entry['route_device_ms'])} on the device alone)")
            entry["device_kernels_ms"] = device_kernels_ms(
                torch, lambda: kernel(*args))
            print(f"kernel {name} {label}: its device kernels, ms on the "
                  f"device alone: " + ", ".join(
                      f"{k} {v:.4f}"
                      for k, v in entry["device_kernels_ms"].items()))
        # the MLP half's two products alone as cuBLAS computes them (F.linear
        # in bf16), the yardstick for the tiled product of kernels 2 and 3
        x, _, _, w1, b1, w2, b2 = cases[-1][3]
        hidden = F.linear(x, w1, b1)
        fc1 = device_ms(torch, lambda: F.linear(x, w1, b1))
        fc2 = device_ms(torch, lambda: F.linear(hidden, w2, b2))
        results["fused_ln_mlp_residual"]["shapes"][-1]["cublas_ms"] = [fc1,
                                                                      fc2]
        print(f"kernel fused_ln_mlp_residual stage {stage}: fc1 and fc2 as "
              f"F.linear (cuBLAS), {fmt_ms(fc1)} and {fmt_ms(fc2)} on the "
              f"device alone ({mlp_flops(t, c, False) / 2e9:.2f} GFLOP each)")
        del hidden
        w, t = AUX_IMAGES * nw, AUX_IMAGES * res * res
        compare(torch, "fused_attention_block",
                fused_block.fused_attention_block_cuda,
                fused_block.fused_attention_block_plain,
                (*block_args(w, c, heads, res, res > 7),
                 image_keep(AUX_IMAGES, nw)), results, flops=0, timed=False,
                label=f"stage {stage} W={w} C={c} with keep", bitwise=True)
        compare(torch, "fused_ln_mlp_residual",
                block_mlp.fused_ln_mlp_residual_cuda,
                block_mlp.fused_ln_mlp_residual_plain,
                (*mlp_args(t, c), image_keep(AUX_IMAGES, res * res)), results,
                flops=0, timed=False, bitwise=True,
                label=f"stage {stage} T={t} C={c} with keep")
        torch.cuda.empty_cache()

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

    def backward_yardsticks(name, kernel, label, args, half, inputs):
        """Beside a timed backward shape: the times of the wrapper's device
        kernels, and the same half's backward as torch autograd on the
        half's inputs with the kernel's output gradient args[1]."""
        entry = results[name]["shapes"][-1]
        entry["device_kernels_ms"] = device_kernels_ms(
            torch, lambda: kernel(*args))
        print(f"kernel {name} {label}: its device kernels, ms on the device "
              f"alone: " + ", ".join(f"{k} {v:.4f}" for k, v in
                                     entry["device_kernels_ms"].items()))
        entry["autograd_ms"], entry["autograd_device_ms"] = autograd_backward(
            torch, half, inputs, args[1])
        r = results[name]
        r["autograd_ms"] = r.get("autograd_ms", 0.0) + entry["autograd_ms"]
        r["autograd_device_ms"] = add_ms(r.get("autograd_device_ms", 0.0),
                                         entry["autograd_device_ms"])
        print(f"kernel {name} {label}: the same half's backward as torch "
              f"autograd {entry['autograd_ms']:.4f} ms "
              f"({fmt_ms(entry['autograd_device_ms'])} on the device alone)")

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
            label = (f"stage {stage} W={w} C={c} h={heads} "
                     f"{'shifted' if shifted else 'unshifted'}"
                     f"{' with keep' if keep else ''}")
            compare(torch, name, kernel, plain, args, results,
                    flops=attn_block_flops(w, 49, c, True),
                    out_names=ATTN_BWD_NAMES, timed=timed, label=label,
                    bitwise=True)
            if timed:
                backward_yardsticks(name, kernel, label, args,
                                    xla_attention_half, (x, *params))
            if name == "fused_attention_block_bwd_spill" and timed:
                if not nan_filled_launches(torch, kernel, args):
                    raise AssertionError(f"{name} {label}: a launch into "
                                         f"NaN-filled memory differs")
                print(f"kernel {name} {label}: two launches into NaN-filled "
                      f"outputs and scratch give the bits of a launch into "
                      f"fresh memory")
        for keep, timed in ((False, True), (True, False)):
            x, *params = mlp_args(t, c)
            args = (x, bf(rng.normal(size=(t, c))), *params[:5],
                    image_keep(AUX_IMAGES, res * res) if keep else None)
            label = f"stage {stage} T={t} C={c}{' with keep' if keep else ''}"
            compare(torch, "fused_ln_mlp_residual_bwd",
                    block_mlp.fused_ln_mlp_residual_bwd_cuda,
                    block_mlp.fused_ln_mlp_residual_bwd_plain, args, results,
                    flops=mlp_flops(t, c, True), out_names=MLP_BWD_NAMES,
                    timed=timed, label=label, bitwise=True)
            if timed:
                backward_yardsticks("fused_ln_mlp_residual_bwd",
                                    block_mlp.fused_ln_mlp_residual_bwd_cuda,
                                    label, args, xla_mlp_half, (x, *params))
        torch.cuda.empty_cache()
    # the spill kernel also takes the narrower widths: check it at stage 2
    res, c, heads = SWIN_STAGES[2]
    w = AUX_IMAGES * 4
    x, *params = block_args(w, c, heads, res, True)
    compare(torch, *variants["spill"],
            (x, bf(rng.normal(size=(w, 49, c))), *params[:5], params[6], None),
            results, flops=0, out_names=ATTN_BWD_NAMES, timed=False,
            label=f"stage 2 W={w} C={c} shifted (off its dispatch)",
            bitwise=True)

    # kernels 8, 9, 10: the window-attention core at every stage of a 64-face
    # pack, with the shifted blocks' bias (nW = 64 / 16 / 4) and the unshifted
    # blocks' (nW = 1).  The library call is scaled_dot_product_attention with
    # the bf16 bias as attn_mask: faces as its batch, (window, head) as its
    # heads, so that the (nW, h, N, N) bias broadcasts over the faces.  The
    # kernels get the bias in bf16, so their times hold no cast; the cast of
    # the route's fp32 bias (the wrapper's first device kernel on the
    # 'pallas' / 'pair' routes) is timed apart.
    n, hd = 49, 32
    for stage, (res, c, heads) in enumerate(SWIN_STAGES):
        w = FACES * (res // 7) ** 2
        for nw in (((res // 7) ** 2, 1) if res > 7 else (1,)):
            rel = rng.normal(size=(1, heads, n, n)) * 0.5
            mask = shifted_window_mask(res, res, 7, 3)[:, None] if nw > 1 else 0
            q, k, v = (bf(rng.normal(size=(w, heads, n, hd)) * scale)
                       for scale in (hd ** -0.5, 1.0, 1.0))
            bias32 = f32(rel + mask)
            bias = bias32.to(torch.bfloat16)
            cast_ms = device_ms(torch, lambda: bias32.to(torch.bfloat16))
            sdpa = [t.view(w // nw, nw * heads, n, hd) for t in (q, k, v)]
            sdpa_mask = bias.view(1, nw * heads, n, n)
            label = f"stage {stage} W={w} h={heads} nW={nw}"
            for name in WINDOW_KERNELS:
                compare(torch, name, getattr(window_attention, name + "_cuda"),
                        window_attention.window_attention_plain,
                        (q, k, v, bias), results,
                        flops=4.0 * w * heads * n * n * hd, label=label,
                        library=lambda: F.scaled_dot_product_attention(
                            *sdpa, attn_mask=sdpa_mask, scale=1.0))
                entry = results[name]["shapes"][-1]
                share = (None if entry["device_ms"] is None
                         else entry["bound_ms"] / entry["device_ms"])
                entry.update(cast_device_ms=cast_ms, hbm_bound_share=share)
                print(f"kernel {name} {label}: "
                      + ("share of its bound not measured" if share is None
                         else f"{share:.1%} of its {entry['bound_by']} bound "
                              f"on the device alone")
                      + f"; the fp32 bias's cast to bf16 {fmt_ms(cast_ms)} "
                        f"on the device alone")
    # kernel 11: the merge tail at the three stage transitions of a 64-face
    # pack.  No single PyTorch call computes it; layer_norm + linear, two
    # calls, are timed for information.
    for stage, (res, c, _) in enumerate(SWIN_STAGES[:-1]):
        rows = (res // 2) ** 2
        args = (bf(rng.normal(size=(FACES, rows, 4 * c))),
                bf(1 + 0.1 * rng.normal(size=4 * c)),
                bf(0.1 * rng.normal(size=4 * c)),
                bf(rng.normal(size=(4 * c, 2 * c)) / np.sqrt(4 * c)))
        label = f"transition {stage} T={FACES * rows} 4C={4 * c}"
        compare(torch, "fused_merge", merge_kernel.fused_merge_cuda,
                merge_kernel.fused_merge_plain, args, results,
                flops=2.0 * FACES * rows * 4 * c * 2 * c, label=label)
        x, gamma, beta, wt = args[0], args[1], args[2], args[3].t().contiguous()
        two_calls = lambda: F.linear(
            F.layer_norm(x, (4 * c,), gamma, beta, 1e-5), wt)
        print(f"kernel fused_merge {label}: F.layer_norm + F.linear (two "
              f"library calls, bf16) "
              f"{cuda_ms(torch, two_calls, reps=KERNEL_REPS):.4f} ms "
              f"({fmt_ms(device_ms(torch, two_calls))} on the device alone)")
    # kernel 7: the whole block at every Swin-tiny stage of a 64-face pack.
    # No single PyTorch call computes it; beside it the split (kernel 2, then
    # kernel 3) on the same inputs, and both calls' device kernels: the
    # whole block's proj (with LN2's partials) and fc1 (merging them)
    # against the split's proj, LN2 statistics and fc1.
    split_ms = split_dev = 0.0
    for stage, (res, c, heads) in enumerate(SWIN_STAGES):
        nw = (res // 7) ** 2
        for shifted in ((False, True) if res > 7 else (False,)):
            w = FACES * nw
            args = (*block_args(w, c, heads, res, shifted),
                    *mlp_args(1, c)[1:])
            label = (f"stage {stage} W={w} C={c} h={heads} "
                     f"{'shifted' if shifted else 'unshifted'}")
            compare(torch, "fused_whole_block",
                    fused_block.fused_whole_block_cuda,
                    fused_block.fused_whole_block_plain, args, results,
                    flops=(attn_block_flops(w, 49, c, False)
                           + mlp_flops(w * 49, c, False)), label=label,
                    bitwise=True)
            if not nan_filled_launches(
                    torch, fused_block.fused_whole_block_cuda, args):
                raise AssertionError(f"fused_whole_block {label}: a launch "
                                     f"into NaN-filled memory differs")
            split = lambda: block_mlp.fused_ln_mlp_residual_cuda(
                fused_block.fused_attention_block_cuda(*args[:8]).view(-1, c),
                *args[8:])
            ms = cuda_ms(torch, split, reps=KERNEL_REPS)
            dev_ms = device_ms(torch, split)
            split_ms += ms
            split_dev = add_ms(split_dev, dev_ms)
            entry = results["fused_whole_block"]["shapes"][-1]
            entry["split_ms"], entry["split_device_ms"] = ms, dev_ms
            print(f"kernel fused_whole_block {label}: the split (kernel 2 + "
                  f"kernel 3) on the same inputs {ms:.4f} ms "
                  f"({fmt_ms(dev_ms)} on the device alone); two launches "
                  f"into NaN-filled outputs and scratch give the same bits")
            for what, fn in (("whole block", lambda: (
                    fused_block.fused_whole_block_cuda(*args))),
                             ("split", split)):
                kms = device_kernels_ms(torch, fn)
                entry[f"{what} device_kernels_ms"] = kms
                print(f"kernel fused_whole_block {label}: the {what}'s device "
                      f"kernels, ms on the device alone: " + ", ".join(
                          f"{k} {v:.4f}" for k, v in kms.items()))
        torch.cuda.empty_cache()
    whole = results["fused_whole_block"]
    whole["split_ms"], whole["split_device_ms"] = split_ms, split_dev

    # kernel 12: the shifted blocks' permutation and its inverse at 64 faces
    # (stages 0-2; stage 3 has no shift), bit for bit; the library call is
    # the index gather itself, x.index_select(1, perm)
    for stage, (res, c, _) in enumerate(SWIN_STAGES[:-1]):
        x = bf(rng.normal(size=(FACES, res * res, c)))
        for inverse, idx in zip((False, True),
                                shifted_window_perms(res, res, 7, 3)):
            idx = torch.from_numpy(idx).to(dev)
            kernel = lambda x, inverse=inverse: shift_permute.shift_permute_cuda(
                x, res, res, 7, 3, inverse)
            plain = lambda x, inverse=inverse: shift_permute.shift_permute_plain(
                x, res, res, 7, 3, inverse)
            compare(torch, "shift_permute", kernel, plain, (x,), results,
                    flops=0, library=lambda: x.index_select(1, idx),
                    label=f"stage {stage} B={FACES} L={res * res} C={c} "
                          f"{'inverse' if inverse else 'forward'}")
            if not torch.equal(kernel(x), x.index_select(1, idx)):
                raise AssertionError(f"shift_permute stage {stage}: not bit "
                                     f"for bit the index gather")
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
    paths = {"serving": launches}

    # the same weights behind the two other Swin routes: the same packs
    blocks = sum(cfg.swin.depths) * len(packs)
    for key, route, own in (
            ("serving_pallas", ROUTE_PALLAS, "fused_window_attention"),
            ("serving_pair", ROUTE_PAIR, "paired_window_attention")):
        routed = EmotionServer(swin_route(det, route), sd, max_batch=8,
                               face_capacity=FACES, device=dev)
        kernels.reset_launch_counts()
        outs = [routed.predict(reqs) for reqs in packs]
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        rows = np.concatenate([np.stack(out) for out in outs])
        if not (np.isfinite(rows).all()
                and np.allclose(rows.sum(-1), 1.0, atol=1e-3)):
            raise AssertionError(f"route {route}: bad probabilities {rows}")
        expect = dict.fromkeys(WINDOW_KERNELS + ("fused_attention_block",), 0)
        expect[own] = blocks
        expect["fused_ln_mlp_residual"] = 0 if route[1] == "xla" else blocks
        expect["fused_attention"] = paths["serving"]["fused_attention"]
        wrong = {k: launches[k] for k, n in expect.items() if launches[k] != n}
        if wrong:
            raise AssertionError(f"route {route}: launches {wrong}, expected "
                                 f"{expect}")
        p = routed.predict_raw(batch, faces).astype(np.float64)
        z = np.log(p) - np.log(p).mean(-1, keepdims=True)
        diff = float(np.abs(z - z_got).max())
        scale = float(np.abs(z_got).max())
        if not (np.isfinite(z).all() and diff <= SERVING_BOUND * scale):
            raise AssertionError(f"route {route} vs the default route: logits "
                                 f"max|d| {diff} > {SERVING_BOUND} * {scale}")
        lat = routed.benchmark_latency(10)
        print(f"serving: route {route}: {len(packs)} packs answered, {own} "
              f"launched {launches[own]} times ({blocks // len(packs)} a "
              f"pack), fused_attention_block 0; logits vs the default route "
              f"max|d| {diff:.3g} <= {SERVING_BOUND} * {scale:.3g}; "
              f"benchmark_latency(10) p50 {lat['p50_ms']:.2f} ms, p99 "
              f"{lat['p99_ms']:.2f} ms on {gpu_name}")
        paths[key] = launches
        del routed
    return paths, server


def swin_route(cfg, route):
    """cfg with its Swin on (attention_impl, mlp_impl, merge_impl) = route."""
    attention_impl, mlp_impl, merge_impl = route
    return cfg.replace(swin=dataclasses.replace(
        cfg.swin, attention_impl=attention_impl, mlp_impl=mlp_impl,
        merge_impl=merge_impl))


def phase_swin_routes(torch, dev, rng, server, gpu_name):
    """Kernels 10 and 11 on the tensors of a full-width forward, and the
    forward's time per route.  No module calls fused_window_attention_v2 or
    fused_merge (in the JAX package neither); their path is the public
    function, driven here on what one 64-face forward on ROUTE_PALLAS hands
    fused_window_attention (q, k, v, bias of every block) and PatchMerging
    (the gathered rows of every stage transition)."""
    from unittest import mock

    from facialmmt_tpu_torch.data.image_pipeline import \
        meld_face_eval_transform
    from facialmmt_tpu_torch.ops import kernels
    from facialmmt_tpu_torch.ops import swin as swin_ops
    from facialmmt_tpu_torch.ops.kernels import merge_kernel, window_attention

    cfg = server.cfg
    base = server.model.swin_model.swin

    def routed(route):
        with torch.device(dev):
            module = swin_ops.SwinTransformer(swin_route(cfg, route).swin)
        module.to(dev, torch.bfloat16).eval()
        module.load_state_dict(base.state_dict(), strict=True)
        return module

    def held(what, got, want):
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        if not (torch.isfinite(got).all() and err <= KERNEL_BOUND * scale):
            raise AssertionError(f"{what}: max|d| {err} > {KERNEL_BOUND} * "
                                 f"{scale}")
        return err / scale

    faces = torch.from_numpy(rng.integers(0, 256, (FACES, 160, 160, 3),
                                          dtype=np.uint8)).to(dev)
    x = meld_face_eval_transform(faces.float(), cfg.data.swin_img_size).to(
        torch.bfloat16)
    swin = routed(ROUTE_PALLAS)
    attn, merges = [], []
    real = swin_ops.fused_window_attention

    def recording(q, k, v, bias):
        out = real(q, k, v, bias)
        attn.append((q, k, v, bias, out))
        return out

    hooks = [layer.downsample.register_forward_hook(
        lambda module, args, out: merges.append((module, args[0], out)))
        for layer in swin.layers if layer.downsample is not None]
    with torch.no_grad():
        want = base(x)                      # the default route's features
    kernels.reset_launch_counts()
    with torch.no_grad(), mock.patch.object(swin_ops, "fused_window_attention",
                                            recording):
        feats = swin(x)
        worst_attn = max(held(
            f"fused_window_attention_v2 on block {i}'s q, k, v, bias",
            window_attention.fused_window_attention_v2(q, k, v, bias), out)
            for i, (q, k, v, bias, out) in enumerate(attn))
        worst_merge = max(held(
            f"fused_merge on the rows of transition {i}",
            merge_kernel.fused_merge(
                module.gather(rows), module.norm.weight, module.norm.bias,
                module.reduction.weight.t().contiguous()), out)
            for i, (module, rows, out) in enumerate(merges))
    torch.cuda.synchronize()
    for hook in hooks:
        hook.remove()
    launches = kernels.launch_counts()
    blocks, transitions = sum(cfg.swin.depths), len(cfg.swin.depths) - 1
    expect = {"fused_window_attention": blocks,
              "fused_window_attention_v2": blocks, "fused_merge": transitions,
              "fused_attention_block": 0}
    wrong = {k: launches[k] for k, n in expect.items() if launches[k] != n}
    if wrong or len(attn) != blocks or len(merges) != transitions:
        raise AssertionError(f"route forward: launches {wrong}, expected "
                             f"{expect}")
    rel = float((feats.float() - want.float()).abs().max()
                / want.float().abs().max())
    if not (torch.isfinite(feats).all() and rel <= SERVING_BOUND):
        raise AssertionError(f"route {ROUTE_PALLAS} features vs the default "
                             f"route: max|d| {rel} of max|features|")
    print(f"routes: one {FACES}-face forward on {ROUTE_PALLAS}: "
          f"fused_window_attention_v2 on the {blocks} captured (q, k, v, "
          f"bias) vs fused_window_attention's outputs worst max|d|/max "
          f"{worst_attn:.3g}; fused_merge on the {transitions} captured "
          f"transitions vs LayerNorm + Linear worst {worst_merge:.3g} (bound "
          f"{KERNEL_BOUND}); features vs the default route {rel:.3g}")
    del swin, attn, merges

    # the forward's time per route: every route once in this order, then once
    # in the reverse order (medians of 10 launches each)
    routes = (("auto", "auto", "raster"), ("auto", "auto", "window"),
              ("pallas", "auto", "raster"), ROUTE_PAIR, ("xla", "auto", "raster"),
              ("auto", "xla", "raster"), ("xla", "xla", "raster"),
              ("pallas", "xla", "raster"), ROUTE_PALLAS)
    modules = {route: routed(route) for route in routes}
    # 'pair' at an odd face count: the last stage's windows (one a face, an
    # odd count) do not pair and go one to a block through
    # fused_window_attention; no block leaves the kernels
    odd = x[:FACES - 1]
    with torch.no_grad():
        want = base(odd)
        kernels.reset_launch_counts()
        got = modules[ROUTE_PAIR](odd)
    odd_launches = kernels.launch_counts()
    last = cfg.swin.depths[-1]
    expect = {"paired_window_attention": blocks - last,
              "fused_window_attention": last, "fused_attention_block": 0}
    wrong = {k: odd_launches[k] for k, n in expect.items()
             if odd_launches[k] != n}
    if wrong:
        raise AssertionError(f"route {ROUTE_PAIR} at {FACES - 1} faces: "
                             f"launches {wrong}, expected {expect}")
    rel = float((got.float() - want.float()).abs().max()
                / want.float().abs().max())
    if not (torch.isfinite(got).all() and rel <= SERVING_BOUND):
        raise AssertionError(f"route {ROUTE_PAIR} at {FACES - 1} faces vs the "
                             f"default route: max|d| {rel} of max|features|")
    print(f"routes: {ROUTE_PAIR} at {FACES - 1} faces: paired_window_attention "
          f"launched {blocks - last} times, fused_window_attention {last} "
          f"times (the last stage's odd window count), features vs the "
          f"default route {rel:.3g}")
    times = {route: [] for route in routes}
    with torch.no_grad():
        for route in routes + routes[::-1]:
            times[route].append(cuda_ms(torch, lambda: modules[route](x)))
    for route in routes:
        a, b = times[route]
        print(f"routes: Swin forward of {FACES} faces, bf16, route {route}: "
              f"{a:.3f} ms then {b:.3f} ms on {gpu_name}")
    route_ms = {"/".join(route): ms for route, ms in times.items()}

    # the three stage transitions alone, both layouts on the same
    # window-layout rows (what merge_impl='auto' is decided on): raster is
    # window_reverse -> PatchMerging -> window_partition, window the one
    # gather; forward, and forward + backward, order raster window window
    # raster
    raster_swin = modules[("auto", "auto", "raster")]
    window_swin = modules[("auto", "auto", "window")]
    ws = cfg.swin.window_size
    totals = {"raster": [0.0, 0.0], "window": [0.0, 0.0]}
    for s, (res, c, _) in enumerate(SWIN_STAGES[:-1]):
        rows = torch.randn(FACES, res * res, c, device=dev,
                           dtype=torch.bfloat16, requires_grad=True)
        cot = torch.randn(FACES, res * res // 4, 2 * c, device=dev,
                          dtype=torch.bfloat16)

        def raster(x, merge=raster_swin.layers[s].downsample):
            grid = swin_ops.window_reverse(x.reshape(-1, ws * ws, c), ws, res,
                                           res).reshape(x.shape)
            y = merge(grid)
            return swin_ops.window_partition(
                y.reshape(FACES, res // 2, res // 2, 2 * c), ws).reshape(y.shape)

        window = window_swin.layers[s].downsample
        with torch.no_grad():
            held(f"transition {s}: window layout vs raster layout",
                 window(rows), raster(rows))
        for name, fn in (("raster", raster), ("window", window),
                         ("window", window), ("raster", raster)):
            with torch.no_grad():
                totals[name][0] += cuda_ms(torch, lambda: fn(rows),
                                           reps=KERNEL_REPS) / 2
            totals[name][1] += cuda_ms(
                torch, lambda: torch.autograd.grad(fn(rows), rows, cot),
                reps=KERNEL_REPS) / 2
    for name, (fwd, both) in totals.items():
        print(f"routes: the three stage transitions of {FACES} faces, "
              f"merge layout {name}: forward {fwd:.4f} ms, forward + backward "
              f"{both:.4f} ms (mean of two medians) on {gpu_name}")
        route_ms[f"transitions/{name}"] = [fwd, both]
    return {"swin_route_forward": launches}, route_ms


def phase_whole_shift(torch, dev, rng, server, gpu_name):
    """Kernels 7 and 12 on the tensors of one 64-face Swin forward on the
    default route.  No module calls fused_whole_block or shift_permute (in
    the JAX package neither); their path is the public functions, driven
    here on every block's input x as SwinBlock would use them: the shifted
    blocks' permutation by shift_permute, the block by fused_whole_block,
    the inverse permutation by shift_permute again.  Each result is held
    against the block's own output (kernels 2 and 3 with the index gathers);
    the whole block against its plain version, the permutations against the
    gathers bit for bit, one backward through ShiftPermute against the
    inverse gather of the cotangent bit for bit.  Then the 12 blocks' time
    three ways: this composition, the block on the default route (the
    split), and the block on ('pallas', 'xla') (cuBLAS GEMMs and kernel 8)."""
    from facialmmt_tpu_torch.data.image_pipeline import \
        meld_face_eval_transform
    from facialmmt_tpu_torch.ops import kernels
    from facialmmt_tpu_torch.ops.kernels import fused_block, shift_permute

    cfg = server.cfg
    swin = server.model.swin_model.swin
    faces = torch.from_numpy(rng.integers(0, 256, (FACES, 160, 160, 3),
                                          dtype=np.uint8)).to(dev)
    x = meld_face_eval_transform(faces.float(), cfg.data.swin_img_size).to(
        torch.bfloat16)
    seen = []
    side = cfg.swin.patches_resolution[0]
    blocks = [(s, side // 2 ** s, block) for s, layer in enumerate(swin.layers)
              for block in layer.blocks]
    hooks = [block.register_forward_hook(
        lambda module, args, out: seen.append((args[0], out)))
        for _, _, block in blocks]
    with torch.no_grad():
        swin(x)
    for hook in hooks:
        hook.remove()
    if len(seen) != len(blocks):
        raise AssertionError(f"captured {len(seen)} blocks of {len(blocks)}")

    def whole_args(block, xp):
        b, l, c = xp.shape
        n = block.ws * block.ws
        a, mlp = block.attn, block.mlp
        return (xp.reshape(b * (l // n), n, c), block.norm1.weight,
                block.norm1.bias, a.qkv.weight, a.qkv.bias, a.proj.weight,
                a.proj.bias, block.window_bias(), block.norm2.weight,
                block.norm2.bias, mlp.fc1.weight, mlp.fc1.bias,
                mlp.fc2.weight, mlp.fc2.bias)

    def composed(block, res, xb):
        """The block as shift_permute -> fused_whole_block -> inverse."""
        geo = (res, res, block.ws, block.shift)
        xp = shift_permute.shift_permute(xb, *geo) if block.shift else xb
        y = fused_block.fused_whole_block(*whole_args(block, xp)).view(
            xb.shape)
        return (shift_permute.shift_permute(y, *geo, inverse=True)
                if block.shift else y), xp, y

    worst = {"plain": 0.0, "block": 0.0}
    kernels.reset_launch_counts()
    with torch.no_grad():
        for i, ((s, res, block), (xb, want)) in enumerate(zip(blocks, seen)):
            out, xp, y = composed(block, res, xb)
            if block.shift:
                geo = (res, res, block.ws, block.shift)
                back = shift_permute.shift_permute(xp, *geo, inverse=True)
                if not (torch.equal(xp, xb[:, block.perm])
                        and torch.equal(out, y[:, block.inv])
                        and torch.equal(back, xb)):
                    raise AssertionError(f"block {i}: shift_permute is not "
                                         f"bit for bit the index gather")
            plain = fused_block.fused_whole_block_plain(
                *whole_args(block, xp)).view(xb.shape)
            for key, ref, bound in (("plain", plain, KERNEL_BOUND),
                                    ("block", want, SERVING_BOUND)):
                err = float((y.float() - ref.float()).abs().max()
                            if key == "plain" else
                            (out.float() - ref.float()).abs().max())
                rel = err / float(ref.float().abs().max())
                if not (torch.isfinite(out).all() and rel <= bound):
                    raise AssertionError(f"fused_whole_block on block {i} "
                                         f"vs {key}: {rel} > {bound}")
                worst[key] = max(worst[key], rel)
    # one backward through ShiftPermute: the inverse kernel on the cotangent
    i = next(i for i, (_, _, b) in enumerate(blocks) if b.shift)
    _, res, block = blocks[i]
    xg = seen[i][0].detach().requires_grad_()
    cot = torch.randn_like(xg)
    (grad,) = torch.autograd.grad(
        shift_permute.shift_permute(xg, res, res, block.ws, block.shift), xg,
        cot)
    torch.cuda.synchronize()
    if not torch.equal(grad, cot[:, block.inv]):
        raise AssertionError("ShiftPermute backward is not the inverse gather")
    launches = kernels.launch_counts()
    shifted = sum(1 for _, _, b in blocks if b.shift)
    expect = {"fused_whole_block": len(blocks), "shift_permute": 3 * shifted + 2,
              "fused_attention_block": 0, "fused_ln_mlp_residual": 0}
    wrong = {k: launches[k] for k, n in expect.items() if launches[k] != n}
    if wrong:
        raise AssertionError(f"whole-block path: launches {wrong}, expected "
                             f"{expect}")
    print(f"whole block: fused_whole_block on the {len(blocks)} blocks of one "
          f"{FACES}-face forward vs its plain version worst max|d|/max "
          f"{worst['plain']:.3g} (bound {KERNEL_BOUND}), composed with "
          f"shift_permute vs the blocks' own outputs {worst['block']:.3g} "
          f"(bound {SERVING_BOUND}); shift_permute on the {shifted} shifted "
          f"blocks bit for bit the gathers both ways and round trip, its "
          f"backward the inverse gather; launches {expect}")

    # the 12 blocks three ways, each timed once in this order and once in the
    # reverse order (medians of 10 calls)
    ways = {"whole": lambda blk, res, xb: composed(blk, res, xb)[0],
            "split": lambda blk, res, xb: blk(xb),
            "pallas_xla": lambda blk, res, xb: blk(
                xb, attention_impl="pallas", mlp_impl="xla")}
    order = list(ways) + list(ways)[::-1]
    times = {k: [] for k in ways}
    with torch.no_grad():
        for way in order:
            times[way].append(sum(
                cuda_ms(torch, lambda: ways[way](blk, res, xb))
                for (_, res, blk), (xb, _) in zip(blocks, seen)))
    for way, (a, b) in times.items():
        print(f"whole block: the {len(blocks)} blocks of a {FACES}-face "
              f"forward, bf16, {way}: {a:.3f} ms then {b:.3f} ms on "
              f"{gpu_name}")
    del seen
    return {"swin_whole_shift": launches}, {k: statistics.mean(v)
                                            for k, v in times.items()}


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


def phase_training(torch, dev, gpu_name, save_dir, base=None, aux_size=112):
    """`base`: the model configuration, FacialMMTConfig() unless a rehearsal
    at a small size passes another.  The run's checkpoints go to `save_dir`;
    its final resume file is read back and returned, with the run's
    configuration, datasets and test F1, for phase_resume, and the files
    are deleted."""
    from facialmmt_tpu_torch.checkpoint.io import CheckpointManager
    from facialmmt_tpu_torch.config import FacialMMTConfig
    from facialmmt_tpu_torch.data.meld import (SyntheticFerDataset,
                                               SyntheticMeldDataset)
    from facialmmt_tpu_torch.ops import kernels
    from facialmmt_tpu_torch.train.trainer import Trainer

    base = base or FacialMMTConfig()
    cfg = base.replace(optim=dataclasses.replace(
        base.optim, num_epochs=1, aux_batch_size=AUX_IMAGES, trg_batch_size=1,
        trg_accumulation_steps=4), runtime=dataclasses.replace(
            base.runtime, save_model_path=save_dir))
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
        if name == "aux_step" and info["index"] == 0:
            seen["first_aux"] = first_aux_step(model, info)
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

    print(f"training: checkpoints to a temporary directory with "
          f"{shutil.disk_usage(save_dir).free / 2 ** 30:.1f} GiB free")
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mark["t"] = t0
    with timed_saves(gpu_name):
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

    ckpt = CheckpointManager(save_dir)
    run = {"cfg": cfg, "datasets": (aux_ds, train_ds, eval_ds), "f1": f1,
           "final": ckpt.restore(f"step_{cfg.optim.num_epochs}"),
           "first_aux": seen["first_aux"], "step_times": seen["times"]}
    for name in os.listdir(save_dir):
        os.remove(os.path.join(save_dir, name))

    breakdown = {"default": step_breakdown(torch, trainer, aux_ds, train_ds,
                                           gpu_name)}
    grad_check(torch, dev, cfg, model, aux_ds, trainer.generator)
    paths["aux_pallas"], breakdown[str(ROUTE_PALLAS)] = route_aux_steps(
        torch, cfg, aux_ds, train_ds, aux_size, gpu_name)
    (d, d_peak), (r, r_peak) = breakdown.values()
    step = lambda m: m["Swin forward"] + m["Swin backward"] + m["clip + AdamW"]
    print(f"training: aux step's Swin backward, default route "
          f"{d['Swin backward']:.1f} ms at {d_peak:.2f} GiB peak vs route "
          f"{ROUTE_PALLAS} {r['Swin backward']:.1f} ms at {r_peak:.2f} GiB; "
          f"forward + backward + optimizer {step(d):.1f} vs {step(r):.1f} ms "
          f"on {gpu_name}")
    run["aux_breakdown"] = breakdown
    return paths, run


@contextlib.contextmanager
def timed_saves(gpu_name):
    """Print the size and write time of every checkpoint file written inside
    the block (CheckpointManager.save, timed on the host clock around the
    write, which ends in an fsync)."""
    from unittest import mock

    from facialmmt_tpu_torch.checkpoint.io import CheckpointManager

    real = CheckpointManager.save

    def save(manager, tag, tree):
        t0 = time.perf_counter()
        path = real(manager, tag, tree)
        seconds = time.perf_counter() - t0
        size = os.path.getsize(path)
        print(f"checkpoint: {tag} {size / 1e9:.3f} GB written in "
              f"{seconds:.2f} s ({size / 1e9 / seconds:.2f} GB/s) on "
              f"{gpu_name}")
        return path

    with mock.patch.object(CheckpointManager, "save", save):
        yield


def first_aux_step(model, info):
    """What a run's first auxiliary step left: its loss and a copy of every
    Swin tensor (parameters and BatchNorm statistics) after it."""
    return {"loss": info["loss"], "swin": snapshot(model.swin_model)}


def first_difference(what, ref, other):
    """Print how a run's first auxiliary step differs from the first run's:
    the loss, how many Swin tensors differ and, of those, the one latest in
    the forward's order, the first that the backward reaches; raise if
    anything differs."""
    names = list(ref["swin"])
    differ = [k for k in names
              if not torch_equal(ref["swin"][k], other["swin"][k])]
    line = (f"resume: {what}, first auxiliary step vs the first run's: loss "
            f"{'equal' if other['loss'] == ref['loss'] else 'differs'} "
            f"({other['loss']!r} vs {ref['loss']!r}), "
            f"{len(differ)} of {len(names)} Swin tensors differ")
    if differ:
        k = differ[-1]
        d = float((ref["swin"][k].float() - other["swin"][k].float())
                  .abs().max())
        line += (f"; the latest in the forward's order {k} (max|d| {d:.3g}), "
                 f"the first in it {differ[0]}")
    print(line)
    if differ or other["loss"] != ref["loss"]:
        raise AssertionError(f"{what}: the first auxiliary step is not bit "
                             f"for bit the first run's")


def phase_resume(torch, dev, gpu_name, run, save_dir):
    """run_multimodal of phase_training twice more: once uninterrupted, once
    preempted (guard.trigger()) right after its first target step and
    resumed by a fresh Trainer.  No kernel of the port adds with atomics, so
    the card repeats a run bit for bit: each run's first auxiliary step (its
    loss, every Swin tensor after it) and the final resume files of the
    second run and of the resumed one equal the first run's, parameters,
    BatchNorm statistics and both AdamW moments bit for bit, and step
    counts, schedules, generator state and test F1 exactly.
    Then the trained model goes out as the reference's two released files
    and back in through load_torch_state_dict + released_state_dict, behind
    an EmotionServer whose answers must not change."""
    from facialmmt_tpu_torch.checkpoint.io import CheckpointManager
    from facialmmt_tpu_torch.checkpoint.torch_load import (released_state_dict,
                                                           save_released)
    from facialmmt_tpu_torch.config import RuntimeConfig
    from facialmmt_tpu_torch.ops import kernels
    from facialmmt_tpu_torch.serving import EmotionServer
    from facialmmt_tpu_torch.train.trainer import Trainer
    from facialmmt_tpu_torch.utils import preemption

    cfg = run["cfg"].replace(runtime=dataclasses.replace(
        run["cfg"].runtime, save_model_path=save_dir))
    guard = preemption.install_preemption_guard()
    fired = []
    first = {}

    def capture(key):
        """An on_event hook that keeps the run's first auxiliary step."""
        def on_event(name, **info):
            if name == "aux_step" and info["index"] == 0:
                first[key] = first_aux_step(trainer_of[key].state.model, info)
        return on_event

    def preempt_after_first_target_step(name, **info):
        capture("preempted")(name, **info)
        if name == "trg_step" and not fired:
            fired.append(info["index"])
            guard.trigger()

    ckpt = CheckpointManager(save_dir)
    final = f"step_{cfg.optim.num_epochs}"

    def take_final():
        payload = ckpt.restore(final)
        for name in os.listdir(save_dir):
            os.remove(os.path.join(save_dir, name))
        return payload

    # the same run again, uninterrupted: it must repeat the first bit for bit
    trainer_of = {"rerun": Trainer(cfg), "preempted": Trainer(cfg)}
    with timed_saves(gpu_name):
        f1_rerun = trainer_of["rerun"].run_multimodal(
            *run["datasets"], run["datasets"][2], on_event=capture("rerun"))
    rerun = take_final()

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with timed_saves(gpu_name):
            try:
                trainer_of["preempted"].run_multimodal(
                    *run["datasets"], run["datasets"][2],
                    on_event=preempt_after_first_target_step)
                raise AssertionError("the preemption request was not taken")
            except preemption.Preempted as e:
                print(f"resume: preempted after target step {fired}: {e}")
            preempted_s = time.perf_counter() - t0
            preemption.install_preemption_guard()     # clears the request
            t0 = time.perf_counter()
            trainer = Trainer(cfg)
            f1 = trainer.run_multimodal(*run["datasets"], run["datasets"][2],
                                        resume=True)
    finally:
        guard.uninstall()
    torch.cuda.synchronize()
    resumed_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    require_launched(launches, SERVING_KERNELS + BACKWARD_KERNELS,
                     "the preempted and resumed run")
    got = ckpt.restore(final)
    want = run["final"]
    for key in ("rerun", "preempted"):
        first_difference(f"the {key} run", run["first_aux"], first[key])

    model = trainer.state.model
    trainable = {name for name, _ in model.named_parameters()}

    def named(payload):
        """kind -> {name: tensor} of a resume file."""
        out = {"trainable parameters": {}, "BatchNorm running statistics": {},
               "exp_avg": {}, "exp_avg_sq": {}}
        for name, t in payload["model"].items():
            if name in trainable:
                out["trainable parameters"][name] = t
            elif "running_" in name:
                out["BatchNorm running statistics"][name] = t
        for opt, branch in (("swin_opt", model.swin_model),
                            ("mm_opt", model.multimodal)):
            names = [name for name, _ in branch.named_parameters()]
            for i, st in payload["optim"][opt]["adamw"]["state"].items():
                for key in ("exp_avg", "exp_avg_sq"):
                    out[key][f"{opt} {names[int(i)]}"] = st[key]
        return out

    ref, res, again = named(want), named(got), named(rerun)
    for kind, a in ref.items():
        if not (a and a.keys() == res[kind].keys() == again[kind].keys()):
            raise AssertionError(f"resume files differ in their {kind}")
        differ = {what: [k for k in a if not torch_equal(a[k], other[k])]
                  for what, other in (("resumed", res[kind]),
                                      ("second uninterrupted", again[kind]))}
        if any(differ.values()):
            raise AssertionError(
                f"resume files, {kind}: not bit for bit the first run's: "
                + "; ".join(f"the {what} run in {len(ks)} tensors, first "
                            f"{ks[0]}" for what, ks in differ.items() if ks))
        print(f"resume: {kind} ({len(a)} tensors) of the resumed run and of "
              f"a second uninterrupted run: bit for bit the first run's")
    exact = {"steps": [(p["optim"]["swin_step"], p["optim"]["mm_step"])
                       for p in (want, got, rerun)],
             "schedules": [[p["optim"][o]["schedule"]["last_epoch"]
                            for o in ("swin_opt", "mm_opt")]
                           for p in (want, got, rerun)],
             "generator": [want["generator"].tolist(),
                           got["generator"].tolist(),
                           rerun["generator"].tolist()],
             "test F1": [run["f1"], f1, f1_rerun]}
    wrong = {k: v for k, v in exact.items() if not v[0] == v[1] == v[2]}
    if wrong:
        raise AssertionError(f"resume vs uninterrupted: {sorted(wrong)} "
                             f"differ: {wrong}")
    print(f"resume: preempted run {preempted_s:.1f} s, resumed run "
          f"{resumed_s:.1f} s; steps {exact['steps'][1]}, schedules "
          f"{exact['schedules'][1]}, generator state and test W-F1 "
          f"{f1:.4f} equal to the uninterrupted runs'; launches {launches} "
          f"on {gpu_name}")

    # released weights: out as the reference's two files, in again
    det = cfg.replace(runtime=RuntimeConfig(deterministic_gumbel=True))
    sd = trainer.state.model.state_dict()
    mm_pt, swin_pt = (os.path.join(save_dir, name)
                      for name in ("multimodal.pt", "swin.pt"))
    save_released(sd, mm_pt, swin_pt)
    loaded = released_state_dict(mm_pt, swin_pt)
    rng = np.random.default_rng(3)
    pack = synthetic_requests(rng, det, [8] * 8, 512)
    answers = []
    for weights in (sd, loaded):
        server = EmotionServer(det, weights, max_batch=8, face_capacity=FACES,
                               device=dev)
        answers.append(server.predict_raw(*server.build_pack(pack)))
        del server
    if not np.array_equal(*answers):
        raise AssertionError("released files: the server's answers changed")
    print(f"resume: the trained model as the reference's two files "
          f"({os.path.getsize(mm_pt) / 1e9:.3f} + "
          f"{os.path.getsize(swin_pt) / 1e9:.3f} GB), loaded back with "
          f"released_state_dict (strict): an EmotionServer's answers on one "
          f"8-request pack unchanged")
    return {"resume": launches}


def route_aux_steps(torch, cfg, aux_ds, train_ds, aux_size, gpu_name):
    """Two auxiliary steps of 150 images under ROUTE_PALLAS, with a Trainer's
    own model, state and step.  The first step runs at learning rate 0 (the
    warm-up's first count); the second is timed and must move every Swin
    parameter through fused_window_attention forward and torch autograd of
    the plain versions backward, with no launch of kernels 2 to 6.  Then the
    route's aux_breakdown.  Returns (launches, that breakdown)."""
    from facialmmt_tpu_torch.data.image_pipeline import affwild2_train_augment
    from facialmmt_tpu_torch.ops import kernels
    from facialmmt_tpu_torch.train.trainer import Trainer

    rcfg = swin_route(cfg, ROUTE_PALLAS)
    trainer = Trainer(rcfg)
    model = trainer._build_model()
    state, _, _ = trainer._init_multitask_state(model, train_ds, len(aux_ds))
    aux_step = trainer._make_steps(model)[0]
    for i in range(2):
        images, labels = aux_ds.get_batch(range(i * AUX_IMAGES,
                                                (i + 1) * AUX_IMAGES))
        images = affwild2_train_augment(
            trainer.generator, trainer._to_device(images).float(),
            img_size=rcfg.data.swin_img_size)
        labels = trainer._to_device(labels)
        before = snapshot(model.swin_model)
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(aux_step(state, images, labels, trainer.generator))
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
    launches = kernels.launch_counts()
    params = {k for k, _ in model.swin_model.named_parameters()}
    still = params - changed_names(model.swin_model, before)
    blocks = sum(rcfg.swin.depths)
    expect = dict.fromkeys(SERVING_KERNELS[1:] + BACKWARD_KERNELS, 0)
    expect["fused_window_attention"] = blocks
    wrong = {k: launches[k] for k, n in expect.items() if launches[k] != n}
    if still or wrong or not np.isfinite(loss):
        raise AssertionError(f"aux step on {ROUTE_PALLAS}: loss {loss}, Swin "
                             f"parameters unchanged {sorted(still)}, launches "
                             f"{wrong} (expected {expect})")
    print(f"training: aux step ({AUX_IMAGES} images of {aux_size} px, augment "
          f"not included) on route {ROUTE_PALLAS}: loss {loss:.4f}, all "
          f"{len(params)} Swin parameters moved, fused_window_attention "
          f"launched {blocks} times, kernels 2-6 never; second step "
          f"{step_ms:.1f} ms, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB on "
          f"{gpu_name}")
    return launches, aux_breakdown(torch, trainer, state, aux_ds, gpu_name,
                                   str(ROUTE_PALLAS))


def timed_ms(torch, fn):
    """fn() between two synchronisations: (its result, ms on the host
    clock)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def report_breakdown(what, rows, repeats, gpu_name, extra=""):
    med = {k: statistics.median(v) for k, v in rows.items()}
    print(f"training: {what} breakdown (median of {repeats}, ms): "
          + ", ".join(f"{k} {v:.1f}" for k, v in med.items())
          + f", sum {sum(med.values()):.1f}{extra} on {gpu_name}")


def aux_breakdown(torch, trainer, state, aux_ds, gpu_name, route,
                  repeats=3):
    """Where one auxiliary step (150 images) of `state`'s model spends its
    time, piece by piece between synchronisations (medians of `repeats`),
    and the peak device memory over those steps beside what was allocated
    before them (the model, both optimizers' state and whatever the run
    holds)."""
    from facialmmt_tpu_torch.data.image_pipeline import affwild2_train_augment
    from facialmmt_tpu_torch.train.steps import compute_context, cross_entropy

    cfg, gen, model = trainer.cfg, trainer.generator, state.model
    model.train()
    images_np, labels_np = aux_ds.get_batch(range(AUX_IMAGES))
    rows = {k: [] for k in ("copy + augment", "Swin forward", "Swin backward",
                            "clip + AdamW")}
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() / 2 ** 30
    for _ in range(repeats):
        images, t = timed_ms(torch, lambda: affwild2_train_augment(
            gen, trainer._to_device(images_np).float(),
            img_size=cfg.data.swin_img_size))
        rows["copy + augment"].append(t)
        labels = trainer._to_device(labels_np)

        def forward():
            with compute_context(trainer.device, cfg.runtime.compute_dtype):
                return cross_entropy(model.aux_logits(images, generator=gen),
                                     labels)

        loss, t = timed_ms(torch, forward)
        rows["Swin forward"].append(t)
        rows["Swin backward"].append(timed_ms(torch, loss.backward)[1])
        rows["clip + AdamW"].append(timed_ms(torch, state.swin_opt.step)[1])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    report_breakdown(f"aux step ({AUX_IMAGES} images, route {route})", rows,
                     repeats, gpu_name, f", peak memory {peak:.2f} GiB "
                     f"({resident:.2f} GiB allocated before the steps)")
    return {k: statistics.median(v) for k, v in rows.items()}, peak


def step_breakdown(torch, trainer, aux_ds, train_ds, gpu_name, repeats=3):
    """Where one auxiliary and one default target step spend their time: each
    piece runs between two synchronisations on the host clock; medians of
    `repeats` steps from the trainer's state."""
    from facialmmt_tpu_torch.train.steps import compute_context, cross_entropy

    state, cfg, gen = trainer.state, trainer.cfg, trainer.generator
    model, dev = state.model, trainer.device
    dtype = cfg.runtime.compute_dtype
    timed = lambda fn: timed_ms(torch, fn)
    aux = aux_breakdown(torch, trainer, state, aux_ds, gpu_name,
                        "default ('auto', 'auto', 'auto')", repeats)

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
    report_breakdown("target step (4 utterances, 64-face bucket)", rows,
                     repeats, gpu_name)
    return aux


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


# ------------------------------------------------------------ command line --

CLI_SPLITS = {"train": (2, 4), "val": (2, 4), "test": (4, 6)}  # dias, utts
CLI_FACES_PER_UTT = 10                 # 1-10 face JPEGs an utterance
AFFWILD_VIDEOS, AFFWILD_FRAMES = 4, 90  # 277 kept: 2 steps of 150


def fixtures():
    """tests/fixtures.py, loaded by its path: the reference's MELD and
    Aff-Wild2 layout from numpy seeds, JPEGs written by cv2.  It imports
    nothing of JAX."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "repo_fixtures", os.path.join(ROOT, "tests", "fixtures.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def write_meld_layout(root, cfg, splits=CLI_SPLITS,
                      faces_per_utt=CLI_FACES_PER_UTT):
    """tests/fixtures.py's MELD layout under `root` at the config's widths,
    for `splits` {split: (dialogues, utterances a dialogue)} (per split the
    T+A+V and V pickles, profile and face-path JSONs, 1 to `faces_per_utt`
    face JPEGs an utterance, CSV and text JSON), and the tokenized-text npz
    cache at max_seq_length tokens from the fixtures' whitespace
    tokenizer."""
    from facialmmt_tpu_torch.data.text_prep import MeldTextPreprocessor

    fx, d = fixtures(), cfg.data
    roberta = cfg.plm_name == "roberta-large"
    prep = MeldTextPreprocessor(fx.WhitespaceTokenizer(roberta), roberta,
                                d.max_seq_length)
    for seed, (split, (dias, per)) in enumerate(splits.items()):
        fx.write_meld_fixture(
            root, split, dias, per, audio_len=d.audio_utt_max_len,
            vision_len=d.vision_utt_max_len, audio_dim=d.audio_feat_dim,
            vision_dim=d.vision_feat_dim, seed=seed,
            faces_per_utt=faces_per_utt)
        ids, mask, sep = MeldTextPreprocessor.to_arrays(prep.preprocess_split(
            os.path.join(root, f"{split}_sent_emo.csv"),
            os.path.join(root, f"{split}_text.json")))
        np.savez(os.path.join(root, "T+A+V",
                              f"text_{split}_{cfg.plm_name}.npz"),
                 ids=ids, mask=mask, sep=sep)


def check_decoder(gpu_name, kind, paths, px):
    """The decoder this machine picks against PIL's decode of the same
    JPEGs (written at `px`: no resize), within one level."""
    from PIL import Image

    from facialmmt_tpu_torch import native

    name = native.decoder_name()
    got = native.decode_images(paths, px).astype(np.int16)
    want = np.stack([np.asarray(Image.open(p).convert("RGB"))[..., ::-1]
                     for p in paths]).astype(np.int16)
    worst = int(np.abs(got - want).max())
    if got.shape != want.shape or worst > 1:
        raise AssertionError(f"decoder {name}: {kind} pixels off PIL's by "
                             f"{worst} levels (bound 1)")
    print(f"cli: JPEG decoder '{name}' within 1 level of PIL on {len(paths)} "
          f"{kind}s (max |d| {worst}) on {gpu_name}")
    return name


def cli_eval_timed(torch, argv, profiled=False):
    """`main.run(argv)` for a --doEval 1 T+A+V command line, its eval loop
    (Trainer._eval_multimodal) timed: (W-F1, the kernels' launch counts,
    {'total': the whole call, s (data, released weights, eval); 'loop': the
    eval loop, s; 'first': its first batch, s (the loader's first assembly
    included); 'wait': the loop's time waiting for the loader's batches, s;
    with `profiled`, the loop runs under torch.profiler and 'device' is its
    kernels' summed device time, s})."""
    from unittest import mock

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from facialmmt_tpu_torch import main as cli
    from facialmmt_tpu_torch.ops import kernels
    from facialmmt_tpu_torch.train import trainer as trainer_module
    from facialmmt_tpu_torch.train.trainer import Trainer

    timing = {"wait": 0.0}
    real_eval = Trainer._eval_multimodal

    class WaitTimedLoader(trainer_module.PrefetchLoader):
        def epoch(self, *args, **kwargs):
            batches = super().epoch(*args, **kwargs)
            while True:
                t = time.perf_counter()
                item = next(batches, None)
                timing["wait"] += time.perf_counter() - t
                if item is None:
                    return
                yield item

    def timed_eval(self, eval_step, ds, *args, **kwargs):
        def first_timed(*a, **k):
            out = eval_step(*a, **k)
            if "first" not in timing:
                torch.cuda.synchronize()
                timing["first"] = time.perf_counter() - start
            return out

        trace = (profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA])
                 if profiled else contextlib.nullcontext())
        torch.cuda.synchronize()
        with trace as prof:
            start = time.perf_counter()
            out = real_eval(self, first_timed, ds, *args, **kwargs)
            torch.cuda.synchronize()
            timing["loop"] = time.perf_counter() - start
        if profiled:
            timing["device"] = sum(
                e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA) / 1e6
        return out

    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(Trainer, "_eval_multimodal", timed_eval), \
            mock.patch.object(trainer_module, "PrefetchLoader",
                              WaitTimedLoader):
        f1 = cli.run(argv)
    torch.cuda.synchronize()
    timing["total"] = time.perf_counter() - t0
    return f1, kernels.launch_counts(), timing


def write_released(torch, dev, cfg, pm):
    """The released pair (save_released) and a unimodal_model_V.pt from
    seed-7 weights under `pm`: (multimodal path, Swin path)."""
    from facialmmt_tpu_torch.checkpoint.torch_load import save_released
    from facialmmt_tpu_torch.models.pipeline import build_pipeline, init_random_
    from facialmmt_tpu_torch.models.unimodal import MeldUttTransformer

    os.makedirs(pm, exist_ok=True)
    weights = build_pipeline(cfg.replace(runtime=dataclasses.replace(
        cfg.runtime, seed=7)), dev).state_dict()
    mm_pt = os.path.join(pm, cfg.load_multimodal_path)
    swin_pt = os.path.join(pm, cfg.load_swin_path)
    save_released(weights, mm_pt, swin_pt)
    with torch.device(dev):
        uni = init_random_(MeldUttTransformer(cfg),
                           torch.Generator(dev).manual_seed(7))
    torch.save({k: v.cpu() for k, v in uni.state_dict().items()},
               os.path.join(pm, cfg.load_unimodal_path))
    return mm_pt, swin_pt


def cli_argv(root, *extra):
    """The flags every command-line phase passes; `extra` (a rehearsal's
    --device cpu and small widths) and the phase's own follow."""
    return ["--data_load_path", os.path.join(root, "meld"),
            "--pretrained_model_dir", os.path.join(root, "pretrained_model"),
            "--save_Model_path", os.path.join(root, "saved_model"),
            "--metrics_path", os.path.join(root, "metrics.jsonl"), *extra]


def phase_cli_eval(torch, dev, gpu_name, root, extra=()):
    """The port's command line on files in the reference's layout
    (tests/fixtures.py's writers) at full width: `--choice_modality T+A+V
    --doEval 1` on a 24-utterance test split (two eval batches of 16) from a
    released pair written by save_released, its W-F1 held against
    Trainer.eval_multimodal_only on the same files, exactly kernels 1-3
    launched; the same command again with its eval loop under
    torch.profiler, for the device's share of the loop.  Two batches give
    smoke readings, not rates (experiments/torch_file_steps.py takes those
    at MELD's test-split size).  Then `python -m facialmmt_tpu_torch.main
    --choice_modality V --doEval 1` in a subprocess, its W-F1 held against
    eval_unimodal_only."""
    from facialmmt_tpu_torch import main as cli
    from facialmmt_tpu_torch.checkpoint.torch_load import (
        load_torch_state_dict, released_state_dict)
    from facialmmt_tpu_torch.data.meld import (RAW_FACE_SIZE,
                                               MeldMultimodalDataset,
                                               MeldVisionDataset)
    from facialmmt_tpu_torch.train.trainer import Trainer

    argv = cli_argv(root, *extra, "--choice_modality", "T+A+V", "--doEval",
                    "1", "--deterministic_gumbel", "1")
    cfg = cli.config_from_args(cli.build_argparser().parse_args(argv))
    t0 = time.perf_counter()
    write_meld_layout(os.path.join(root, "meld"), cfg)
    test_ds = MeldMultimodalDataset(os.path.join(root, "meld"), "test",
                                    cli.text_arrays(cfg, "test"))
    cfg = cli._adapt_static_shapes(cfg, test_ds)
    pm = os.path.join(root, "pretrained_model")
    mm_pt, swin_pt = write_released(torch, dev, cfg, pm)
    print(f"cli: files in the reference's layout written in "
          f"{time.perf_counter() - t0:.1f} s: splits {CLI_SPLITS} "
          f"(dialogues, utterances a dialogue), released pair "
          f"{(os.path.getsize(mm_pt) + os.path.getsize(swin_pt)) / 1e9:.3f} GB")

    face_paths = [p for name in sorted(test_ds.utt_face_path)
                  for p in test_ds.utt_face_path[name]]
    decoder = check_decoder(gpu_name, "face", face_paths, RAW_FACE_SIZE)
    t0 = time.perf_counter()
    test_ds._decode_faces(face_paths)
    decode_s = time.perf_counter() - t0

    f1_cli, launches, timing = cli_eval_timed(torch, argv)
    f1_prof, _, prof = cli_eval_timed(torch, argv, profiled=True)
    f1_api = Trainer(cfg, dev).eval_multimodal_only(
        released_state_dict(mm_pt, swin_pt), test_ds)
    require_launched(launches, SERVING_KERNELS, "the command line's eval")
    others = {k: n for k, n in launches.items()
              if n and k not in SERVING_KERNELS}
    if others:
        raise AssertionError(f"the command line's eval launched {others}")
    if not (np.isfinite(f1_cli) and abs(f1_cli - f1_api) <= 1e-6
            and f1_prof == f1_cli):
        raise AssertionError(f"command line W-F1 {f1_cli} (profiled "
                             f"{f1_prof}) vs eval_multimodal_only {f1_api}")
    n = len(test_ds)
    print(f"cli: --choice_modality T+A+V --doEval 1 at FacialMMTConfig() "
          f"width on {n} utterances ({len(face_paths)} faces): W-F1 "
          f"{f1_cli:.4f} = the profiled run's = eval_multimodal_only's "
          f"{f1_api:.4f}; launches {launches} on {gpu_name}")
    print(f"cli (two eval batches: smoke readings, not rates): end to end "
          f"{timing['total']:.2f} s, {n / timing['total']:.1f} utterances/s "
          f"(data, weights from the released files, eval); eval loop "
          f"{timing['loop']:.2f} s ({timing['wait']:.2f} s of it waiting for "
          f"the loader), first batch of 16 "
          f"{timing['first'] * 1e3:.0f} ms; decoder '{decoder}' "
          f"{len(face_paths) / decode_s:.0f} faces/s "
          f"({'one thread' if decoder == 'cv2' else 'thread pool'}, 160 px); "
          f"the command's eval loop under torch.profiler: device busy "
          f"{prof['device']:.3f} s of {prof['loop']:.2f} s "
          f"({100 * prof['device'] / prof['loop']:.1f} %) on {gpu_name}")

    # V-only through the module entry, in its own process
    argv_v = cli_argv(root, *extra, "--choice_modality", "V", "--doEval", "1")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "facialmmt_tpu_torch.main", *argv_v],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": ROOT})
    sub_s = time.perf_counter() - t0
    line = [x for x in proc.stdout.splitlines()
            if x.startswith("**TEST** | wg_av_f1")]
    if proc.returncode != 0 or len(line) != 1:
        raise AssertionError(f"python -m facialmmt_tpu_torch.main "
                             f"{' '.join(argv_v)}: exit "
                             f"{proc.returncode}\n{proc.stdout[-2000:]}\n"
                             f"{proc.stderr[-2000:]}")
    v_ds = MeldVisionDataset(os.path.join(root, "meld"), "test")
    cfg_v = cli._adapt_static_shapes(cli.config_from_args(
        cli.build_argparser().parse_args(argv_v)), v_ds)
    f1_v = Trainer(cfg_v, dev).eval_unimodal_only(load_torch_state_dict(
        os.path.join(pm, cfg.load_unimodal_path)), v_ds)
    if f"wg_av_f1 {f1_v:5.4f}" not in line[0]:
        raise AssertionError(f"V-only: the module printed {line[0]!r}, "
                             f"eval_unimodal_only gives {f1_v}")
    print(f"cli: python -m facialmmt_tpu_torch.main --choice_modality V "
          f"--doEval 1: {line[0].strip()} = eval_unimodal_only's, "
          f"{sub_s:.1f} s in its own process on {gpu_name}")
    return {"cli_eval": launches}


def phase_cli_train(torch, dev, gpu_name, root, in_memory, extra=()):
    """`--doEval 0 --num_epochs 1` T+A+V from files, with a `backbone.*` Swin
    file and an HF-layout text directory (both from seed-7 weights, not the
    run's seed): 2 auxiliary steps of 150 frames, 2 target steps of 4
    utterances, validation and test.  The Swin and the text tower before the
    first step are the files' tensors, losses are finite, kernels 2-6
    launch, the best and resume files are written; then the same command
    with --resume 1 takes the resume file (epoch 1 done: no step runs) and
    gives the same test W-F1.  Step times beside phase_training's on
    in-memory data (`in_memory`), and the decode time of one batch of
    each."""
    from unittest import mock

    from facialmmt_tpu_torch import main as cli
    from facialmmt_tpu_torch.checkpoint.torch_load import save_hf_text_tower
    from facialmmt_tpu_torch.data.affwild2 import AffwildDataset
    from facialmmt_tpu_torch.data.meld import MeldMultimodalDataset
    from facialmmt_tpu_torch.models.multimodal import text_prefix
    from facialmmt_tpu_torch.models.pipeline import build_pipeline
    from facialmmt_tpu_torch.ops import kernels
    from facialmmt_tpu_torch.train.trainer import Trainer
    from facialmmt_tpu_torch.utils import preemption

    aux_root = os.path.join(root, "affwild")
    frames = fixtures().write_affwild_fixture(aux_root, AFFWILD_VIDEOS,
                                              AFFWILD_FRAMES, seed=22)
    vid = os.path.join(frames["file_folder"], "vid0")
    check_decoder(gpu_name, "frame", [os.path.join(vid, f) for f in
                                      sorted(os.listdir(vid))], 112)
    save = os.path.join(root, "saved_train")
    argv = cli_argv(
        root, *extra, "--choice_modality", "T+A+V", "--doEval", "0",
        "--num_epochs", "1", "--save_Model_path", save,
        "--data_folder", os.path.join(aux_root, "cropped_aligned"),
        "--anno_folder", os.path.join(aux_root, "annos"),
        "--data_list_train", os.path.join(aux_root, "train_list.txt"),
        "--pretrained_backbone_path", os.path.join(root, "ms1m_swin.pt"),
        "--pretrainedtextmodel_path", os.path.join(root, "roberta-large"),
        "--aux_log_interval", "1", "--trg_log_interval", "1")
    cfg = cli._adapt_static_shapes(
        cli.config_from_args(cli.build_argparser().parse_args(argv)),
        MeldMultimodalDataset(os.path.join(root, "meld"), "test",
                              cli.text_arrays(cli.config_from_args(
                                  cli.build_argparser().parse_args(argv)),
                                  "test")))
    tower = text_prefix(cfg)
    files = {k: v.cpu() for k, v in build_pipeline(cfg.replace(
        runtime=dataclasses.replace(cfg.runtime, seed=7)), dev)
        .state_dict().items()}
    torch.save({**{"backbone." + k[len("swin_model.swin."):]: v
                   for k, v in files.items()
                   if k.startswith("swin_model.swin.")},
                "head.kernel": torch.zeros(8, 512)},
               os.path.join(root, "ms1m_swin.pt"))
    save_hf_text_tower(files, cfg.text, f"multimodal.{tower}",
                       os.path.join(root, "roberta-large"))
    grafted = [k for k in files
               if k.startswith(("swin_model.swin.", f"multimodal.{tower}."))
               and not k.endswith(("relative_position_index", "attn_mask",
                                   "num_batches_tracked"))]

    seen = {"losses": [], "aux_step": [], "trg_step": []}
    mark = {}

    def on_event(trainer, name, **info):
        torch.cuda.synchronize()
        now = time.perf_counter()
        if name == "start" and "grafted" not in seen:
            sd = trainer.state.model.state_dict()
            bad = [k for k in grafted if not torch.equal(sd[k].cpu(), files[k])]
            if bad or not grafted:
                raise AssertionError(f"grafts: {len(bad)} of {len(grafted)} "
                                     f"tensors differ from the files: "
                                     f"{bad[:4]}")
            seen["grafted"] = len(grafted)
        if name in ("aux_step", "trg_step"):
            seen["losses"].append(info["loss"])
            seen[name].append(now - mark["t"])
        mark["t"] = now

    real_run = Trainer.run_multimodal

    def run_with_events(self, *args, **kwargs):
        return real_run(self, *args, **kwargs,
                        on_event=lambda name, **info: on_event(self, name,
                                                               **info))

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with mock.patch.object(Trainer, "run_multimodal", run_with_events), \
                timed_saves(gpu_name):
            f1 = cli.run(argv)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            launches = kernels.launch_counts()
            written = sorted(os.listdir(save))
            seen_before = len(seen["losses"])
            f1_resumed = cli.run(argv + ["--resume", "1"])
    finally:
        if preemption._guard is not None:      # cli.run installed it
            preemption._guard.uninstall()
    require_launched(launches, SERVING_KERNELS[1:] + BACKWARD_KERNELS,
                     "the command line's training")
    if not (seen.get("grafted") and np.isfinite(seen["losses"]).all()
            and len(seen["aux_step"]) == 2 and len(seen["trg_step"]) == 2
            and "best_1" in written and "step_1" in written):
        raise AssertionError(f"cli training: losses {seen['losses']}, "
                             f"steps {len(seen['aux_step'])} + "
                             f"{len(seen['trg_step'])}, files {written}")
    if len(seen["losses"]) != seen_before or f1_resumed != f1:
        raise AssertionError(f"--resume 1: {len(seen['losses']) - seen_before} "
                             f"steps ran, W-F1 {f1_resumed} vs {f1}")
    print(f"cli: --doEval 0 --num_epochs 1 at FacialMMTConfig() width from "
          f"files in {train_s:.1f} s: {seen['grafted']} Swin and text-tower "
          f"tensors equal the backbone file's and the HF directory's before "
          f"the first step; losses {[round(x, 4) for x in seen['losses']]}; "
          f"test W-F1 {f1:.4f}; files {written}; --resume 1 ran no step and "
          f"gave W-F1 {f1_resumed:.4f}; launches {launches} on {gpu_name}")

    aux_ds = AffwildDataset(os.path.join(aux_root, "cropped_aligned"),
                            data_list=os.path.join(aux_root, "train_list.txt"))
    train_ds = MeldMultimodalDataset(os.path.join(root, "meld"), "train",
                                     cli.text_arrays(cfg, "train"))
    t0 = time.perf_counter()
    aux_ds.get_batch(range(150))
    aux_decode = time.perf_counter() - t0
    t0 = time.perf_counter()
    batch = train_ds.get_batch(range(4), face_capacity=64)
    trg_decode = time.perf_counter() - t0
    for name, what, decode, n in (
            ("aux_step", "aux step (150 frames)", aux_decode, "150 frames"),
            ("trg_step", "target step (4 utterances)", trg_decode,
             f"{int(batch['n_faces'].sum())} faces")):
        files_ms = [t * 1e3 for t in seen[name]]
        mem_ms = [t * 1e3 for t in in_memory[name]]
        print(f"cli: {what}, loader wait and augment included: from files "
              f"first {files_ms[0]:.1f} ms, then {files_ms[1]:.1f} ms; "
              f"in memory (phase 7) first {mem_ms[0]:.1f} ms, then "
              f"{statistics.median(mem_ms[1:]):.1f} ms; decoding its "
              f"{n} alone {decode * 1e3:.1f} ms on {gpu_name}")
    return {"cli_train": launches}


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
    paths, server = phase_serving(torch, dev, rng, gpu_name)
    route_paths, route_ms = phase_swin_routes(torch, dev, rng, server, gpu_name)
    paths.update(route_paths)
    whole_paths, whole_ms = phase_whole_shift(torch, dev, rng, server, gpu_name)
    paths.update(whole_paths)
    del server
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as save_dir:
        train_paths, run = phase_training(torch, dev, gpu_name, save_dir)
        paths.update(train_paths)
        torch.cuda.empty_cache()
        paths.update(phase_resume(torch, dev, gpu_name, run, save_dir))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as cli_root:
        paths.update(phase_cli_eval(torch, dev, gpu_name, cli_root))
        torch.cuda.empty_cache()
        paths.update(phase_cli_train(torch, dev, gpu_name, cli_root,
                                     run["step_times"]))

    if json_out:
        os.makedirs(os.path.dirname(os.path.abspath(json_out)), exist_ok=True)
        with open(json_out, "w") as f:
            json.dump({"card": gpu_name, "kernels": results,
                       "launches": paths,
                       "swin_forward_ms_by_route": route_ms,
                       "aux_step_breakdown_ms_peak_gib": run["aux_breakdown"],
                       "swin_blocks_ms_whole_split_pallas_xla": whole_ms},
                      f, indent=1)
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
