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
     alone;
 11. the appendix (CCAC2023/M3ED) through `main.run` at the same width:
     M3ED files from tests/fixtures.py's writers (8 dialogues of 6
     utterances a split, audio (157, 768) and vision (32, 512), text caches
     at 512 tokens, a 48-row submission template); --choice_modality T one
     epoch, then --doEval 1 twice with the CSV and the dump; M3ED utt T+A+V
     crossmodal and T+V concat; M3ED dia crossmodal (then --doEval 1 twice)
     and concat; MELD T+V on phase 9's files through the FER pipeline.
     Finite losses, kernel 1 never in a train step and once per text layer
     in every eval batch (nothing else on the M3ED paths), kernels 1-6 on
     MELD T+V, eval macro-F1 equal to eval_text_only / eval_dialogue_only,
     the second eval bit for bit with a byte-identical CSV in test order,
     one eval batch of the T and dialogue models on the card against fp32
     on the CPU; step-time medians, eval utterances/s and the dialogue
     step's peak memory as smoke readings;
 12. the serving front end: (1, 12), (8, 64) and (32, 256) EmotionServers
     with phase 4's weights (the same seed) and deterministic gumbel behind
     one AsyncBatchServer (a bucket router).  A light request (to (1, 12)),
     a 20-face request (to (8, 64)) and a burst of 32 mixed ones (0-16
     faces, 64-512 tokens; it reaches (32, 256)): finite rows summing to 1,
     each held to the solo prediction on the bucket its pack rode within
     SERVING_BOUND, kernels 1, 2 and 3 launched exactly 24, 12 and 12 times
     per dispatched pack and every other kernel never; benchmark_latency per
     bucket; a closed burst of 256 default requests on (32, 256) alone at
     pipeline_depth 1 and 2 (utterances/s; the shares of packs whose
     build_pack started, and whose dispatch returned, while the pack before
     still computed: the first 0 at depth 1 and above 0 at depth 2);
     benchmark_load on the router at 10 utt/s and at half the depth-2 rate,
     5 s each; the HTTP endpoint on a free port with 8 concurrent /predict
     posts, their replies held to the direct front's answers, /healthz and
     /stats; `python -m facialmmt_tpu_torch.streaming_demo --ticks 10` in a
     process of its own;
 13. remat and multi-device runs (phase_remat_mesh; experiments/
     torch_remat_mesh.py runs it alone): (a) one auxiliary batch (150
     images, drop-path on) through the Swin FER model with and without
     SwinConfig.remat, on the default route and on ('xla', 'xla',
     'window'): loss, gradients, BatchNorm statistics and generator bit for
     bit, kernels 2 / 3 launched 24 / 24 under remat (12 / 12 without) and
     4-6 unchanged; peak memory and step time of each; (b) the target
     step's forward and backward (4 utterances, every dropout on) with and
     without TextEncoderConfig.remat: the gradients and generator state of
     the step without it; (c) two rank processes sharing the card over gloo
     (NCCL takes one rank a card): one auxiliary and one target step of a
     Trainer at dp=2 (ZeRO-1 on) against the one-process steps (losses
     within 1e-2, the generator state equal, the first moments of eight
     groups of leaves within MESH_GRAD_BOUND of their group's largest, which
     the same steps with the data ranks' gradient sum skipped must exceed),
     and an EmotionServer at tp=2 whose text attention is kernel 1 on half
     the heads, 24 launches a pack, its logits within SERVING_BOUND of a
     one-rank server's; (d) a rank process that runs the same steps without
     a plan and then at dp=1 on a one-rank NCCL group: bit for bit;
 14. the tooling (phase_tooling; experiments/torch_tooling.py runs it
     alone): (a) `python -m facialmmt_tpu_torch.tools doctor` in its own
     process, exit 0, the card at capability 9.0, nvcc and the kernel
     library loaded; (b) `print-flops` against utils/flops.py, and the
     mfu of phase 4's (8, 64) pack (its model FLOPs at the pack's static
     shapes over its benchmark_latency p50, a smoke reading); (c)
     run_multimodal on phase 7's data with runtime.profile_dir: one trace,
     ProfilerStep#0-1 the two target steps (train steps 3-4, as JAX's
     schedule picks them) and #2 the validation until the run closes the
     capture; each step's calls of kernels 1-6, tied to their device
     kernels through spans around the library's C entry points
     (entry_spans), exactly TARGET_STEP_LAUNCHES; the ten device operations
     that took the most time and the device's idle share over the two
     steps; (d) one auxiliary and one target step with and without
     enable_nan_debugging, losses and every gradient bit for bit, then a
     NaN in one face (FloatingPointError naming the module) and a NaN put
     into the gradient at the Swin head (naming kernel 3's backward
     Function, which launches kernel 4); (e) phase 9's released pair
     through convert-checkpoint and export-checkpoint --kind pipeline, bit
     for bit, behind an EmotionServer with the same answers, kernels 1-3
     24 / 12 / 12 times a pack;
 15. the serving front over mesh servers (phase_front_mesh; experiments/
     torch_front_mesh.py runs it alone): two rank processes sharing the
     card over gloo, every rank constructing the front and rank 0
     submitting from 8 threads: (a) a tp=2 router over (1, 12) / (8, 64)
     and (b) a dp=2 front over (2, 12) / (8, 64), 64 default and 32 mixed
     requests (0-20 faces, 64-512 tokens) each, every answer held within
     SERVING_BOUND to one process replaying rank 0's recorded packs, the
     same packs and buckets on both ranks, kernels 1-3 24 / 12 / 12 times
     a pack on each, both ranks' generators equal the replay's; (c) an
     idle gap longer than the keepalive (patched to 2 s), the IDLE headers
     received, 8 more requests answered; (d) benchmark_load for 5 s called
     on both ranks, the same stats on both; (e) close() ends both ranks,
     exit 0; (f) a front at dp=1 on a one-rank NCCL group, bit for bit the
     front without a plan.  The closed bursts' utt/s and the broadcast's
     ms per pack are readings of two ranks sharing one card;
 16. the configurations of the JAX command line that no phase above runs
     (phase_configurations; experiments/torch_configurations.py runs it
     alone): (a) Swin drop_rate = attn_drop_rate = 0.1 on the default
     route: a 64-face eval launches kernels 2 / 3 12 / 12 times and equals
     the rate-0 model bit for bit; an auxiliary step with both rates
     launches no kernel 2-6 and one with attn_drop_rate alone only kernels
     3 and 4 (JAX's per-half rule), finite losses; (b) kernels 1-12 on fp32
     tokens against their fp32 plain versions at phase 3's shapes (kernel 1
     and kernels 8-10 in TF32 beside SDPA in fp32; kernels 8-11 each below
     the error of the same call through their former bf16 boundary, printed
     beside it; kernel 7 bit for bit kernel 2 then kernel 3, kernel 12 bit
     for bit the index gather); (c) the BERT-architecture towers through
     `main.run` at full width: MELD T+A+V with --plm_name bert-large
     (--doEval 1 twice, bit for bit, one eval batch against the CPU in
     fp32, one training epoch) and M3ED with chinese-roberta-large (T one
     epoch, --doEval 1 twice, one eval batch against the CPU; the dialogue
     model one epoch and one eval), kernel 1 exactly once per text layer
     per eval batch and never in a train step; (d) --compute_dtype
     float32: an (8, 64) pack in fp32 on the card (kernels 1 / 2 / 3 24 /
     12 / 12 times) against phase 4's CPU answer within FP32_BOUND, the
     same pack through the former bf16 boundary printed beside it; the same
     weights on the Swin routes ('pallas', 'auto', 'auto') and ('pair',
     'auto', 'auto') (kernels 1 / 3 / 8 or 9 24 / 12 / 12 times, kernel 2
     never) against the same route in fp32 on the CPU within FP32_BOUND,
     the reading through kernels 8 / 9's former bf16 boundary beside it, and
     its faces' Swin logits nearer the CPU's than through that boundary; an
     auxiliary step (kernels 4 / 5 / 6 12 / 10 / 2 times), one
     on ('pallas', 'xla', 'window') (kernel 8 12 times) and a target step in
     fp32, finite losses.
The line before the last is {"kernels": [...]} and the last line is
{"ok": true, "device": {...}}.  Exits non-zero with no result when no CUDA
device is visible or the package is missing.
"""

from __future__ import annotations

import base64
import contextlib
import dataclasses
import io
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
PEAK_TF32_FLOPS = 494.7e12  # the same in TF32 (kernel 1's fp32 products)
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
    "fused_add_layernorm": ("facialmmt_tpu_torch/csrc/add_layernorm.cu",
                            "none (LayerNormTF's fp32 chain at inference)"),
}
# the residual add + LayerNorm kernel: every forward with grad off launches
# it (add_ln_launches), so the tables of kernels 1-12 below name it only
# where they pin it
ADD_LN = "fused_add_layernorm"
WINDOW_KERNELS = ("fused_window_attention", "paired_window_attention",
                  "fused_window_attention_v2")
# Swin routes (attention_impl, mlp_impl, merge_impl) beside the default
ROUTE_PALLAS = ("pallas", "xla", "window")
ROUTE_PAIR = ("pair", "auto", "raster")
MLP_BWD_NAMES = ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2")
ATTN_BWD_NAMES = ("dx", "dgamma", "dbeta", "dwqkv", "dbqkv", "dwproj",
                  "dbproj", "dbias")


def add_ln_launches(cfg) -> int:
    """fused_add_layernorm launches of one forward of `cfg`'s model with
    grad off: the text tower's embeddings and two a layer, two a layer of
    the utterance encoders, and in each crossmodal application four a layer
    (q, k and v's LayerNorm, the FFN's) and the final one.  99 for
    FacialMMTConfig(): 49 + 14 + 36."""
    n = 1 + 2 * cfg.text.num_layers
    n += 2 * ((cfg.audio_utt_transformer_num if "A" in cfg.choice_modality
               else 0) + (cfg.vision_utt_transformer_num
                          if "V" in cfg.choice_modality else 0))
    if cfg.modality_fuse == "crossmodal" and len(cfg.choice_modality) > 1:
        n += 2 * (4 * cfg.crossmodal_ta.layers + 1)
        if cfg.choice_modality == "T+A+V":
            n += 2 * (4 * cfg.crossmodal_ta_v.layers + 1)
    return n


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
            timed=True, library=None, label="", summed=True, bitwise=False,
            peak_flops=PEAK_BF16_FLOPS):
    """Run kernel and plain on the same inputs and hold every output to the
    bound (a bias cotangent by its group sum, the only part of it that is
    defined); with `bitwise`, a second launch must give the same bits.  When
    `timed`, time the call (median kernel, plain and library times) beside
    its bound (the FLOPs at `peak_flops`: the bf16 rate, or TF32's for
    kernel 1's fp32 instantiation) and add them to the kernel's totals,
    unless `summed` is false: then the shape is only printed and listed.
    Prints one line."""
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
        flops_ms = flops / peak_flops * 1e3
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
    add_layernorm_rows(torch, dev, rng, results)
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


def bf16_ulps(torch, got, want, scale=None):
    """|got - want| in units of the bf16 spacing at the largest of |got|,
    |want| and `scale`."""
    g, w = got.float(), want.float()
    top = torch.maximum(g.abs(), w.abs())
    _, e = torch.frexp(top if scale is None else torch.maximum(top, scale))
    return (g - w).abs() / torch.ldexp(torch.ones_like(g), e - 8)


def add_layernorm_rows(torch, dev, rng, results):
    """The residual add + LayerNorm kernel at a (32, 256) serving pack's
    shapes, each with its residual, bf16: the text tower's 32 x 512 rows of
    1024 (eps 1e-5, RoBERTa's) and the audio encoder's 32 x 157 rows of 768
    (eps 1e-12); held to the plain chain within one bf16 ulp on at most
    0.1 % of the elements, two launches bit for bit.  The ulp is taken at
    the magnitude of gamma * y and beta, the two terms each output sums:
    where they cancel, the statistics' other summation order moves the small
    result by more than its own ulp in both versions (printed beside).  The bound counts x,
    the residual and out once; the library yardstick is what a port without
    the kernel would call: the add, then F.layer_norm (two calls)."""
    import torch.nn.functional as F

    from facialmmt_tpu_torch.ops.kernels import add_layernorm

    bf = lambda a: torch.from_numpy(a).to(dev, torch.bfloat16).contiguous()
    for rows, h, eps, what in ((32 * 512, 1024, 1e-5, "text tower"),
                               (32 * 157, 768, 1e-12, "audio encoder")):
        x, r = (bf(rng.normal(size=(rows, h)).astype(np.float32))
                for _ in range(2))
        w = bf((rng.normal(size=h) * 0.1 + 1.0).astype(np.float32))
        b = bf((rng.normal(size=h) * 0.1).astype(np.float32))
        args = (x, r, w, b, eps)
        compare(torch, ADD_LN, add_layernorm.fused_add_layernorm_cuda,
                add_layernorm.fused_add_layernorm_plain, args, results,
                flops=0.0, bitwise=True,
                label=f"{what} {rows}x{h} with its residual",
                library=lambda: F.layer_norm(x + r, (h,), w, b, eps))
        got = add_layernorm.fused_add_layernorm_cuda(*args)
        want = add_layernorm.fused_add_layernorm_plain(*args)
        s = (x + r).float()
        c = s - s.mean(-1, keepdim=True)
        y = c * torch.rsqrt(c.square().mean(-1, keepdim=True) + eps)
        terms = (w.float() * y).abs() + b.float().abs()
        ulps = float(bf16_ulps(torch, got, want, terms).max())
        own = bf16_ulps(torch, got, want)
        worst = int(own.argmax())
        share = float((got != want).float().mean())
        if ulps > 1.0 or share > 1e-3:
            raise AssertionError(f"{ADD_LN} {what}: {ulps} bf16 ulps, "
                                 f"{share:.3%} of the elements differ")
        print(f"kernel {ADD_LN} {what}: against the plain chain at most "
              f"{ulps:.0f} bf16 ulp at the terms' magnitude, on "
              f"{share:.4%} of the elements; at the output's own magnitude "
              f"{float(own.max()):.0f} ulps, where the plain output is "
              f"{float(want.flatten()[worst]):.4g} of terms "
              f"{float(terms.flatten()[worst]):.4g}")


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
    forwards = launches["fused_attention"] // cfg.text.num_layers
    require_counts(launches, {ADD_LN: add_ln_launches(cfg) * forwards},
                   "the serving path")
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
    # phase 16 holds the float32 model to the same CPU answer
    reference = {"requests": packs[0], "probs": want,
                 "state_dict": {k: v.cpu() for k, v in sd.items()}}
    del card, host

    lat = server.benchmark_latency(10)
    print(f"serving: benchmark_latency(10) p50 {lat['p50_ms']:.2f} ms, p99 "
          f"{lat['p99_ms']:.2f} ms, mean {lat['mean_ms']:.2f} ms on {gpu_name}")
    paths = {"serving": launches}
    p50_ms = lat["p50_ms"]

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
    return paths, server, p50_ms, reference


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


def training_config(base, save_dir):
    """`base` with phase 7's run: one epoch, auxiliary batches of
    AUX_IMAGES, target batches of 4 utterances, checkpoints to save_dir."""
    return base.replace(optim=dataclasses.replace(
        base.optim, num_epochs=1, aux_batch_size=AUX_IMAGES, trg_batch_size=1,
        trg_accumulation_steps=4), runtime=dataclasses.replace(
            base.runtime, save_model_path=save_dir))


def training_datasets(cfg, aux_size=112):
    """Phase 7's in-memory data: 2 auxiliary batches, 8 training and 8
    evaluation utterances of 6-10 faces."""
    from facialmmt_tpu_torch.data.meld import (SyntheticFerDataset,
                                               SyntheticMeldDataset)

    aux_ds = SyntheticFerDataset(2 * AUX_IMAGES, aux_size, cfg.num_labels,
                                 seed=11)
    faces = [8, 7, 9, 8, 6, 10, 8, 8]
    train_ds = SyntheticMeldDataset(cfg, 8, 2, faces, seed=12, split="train")
    eval_ds = SyntheticMeldDataset(cfg, 8, 2, faces, seed=13, split="eval")
    return aux_ds, train_ds, eval_ds


def phase_training(torch, dev, gpu_name, save_dir, base=None, aux_size=112):
    """`base`: the model configuration, FacialMMTConfig() unless a rehearsal
    at a small size passes another.  The run's checkpoints go to `save_dir`;
    its final resume file is read back and returned, with the run's
    configuration, datasets and test F1, for phase_resume, and the files
    are deleted."""
    from facialmmt_tpu_torch.checkpoint.io import CheckpointManager
    from facialmmt_tpu_torch.config import FacialMMTConfig
    from facialmmt_tpu_torch.ops import kernels
    from facialmmt_tpu_torch.train.trainer import Trainer

    cfg = training_config(base or FacialMMTConfig(), save_dir)
    aux_ds, train_ds, eval_ds = training_datasets(cfg, aux_size)

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
                require_counts(seen["launches"][name], {ADD_LN: 0},
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
                require_counts(seen["launches"][name], {ADD_LN: 0},
                               "the target pass (grad on)")
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
    require_launched(seen["launches"]["eval"], SERVING_KERNELS + (ADD_LN,),
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
                      faces_per_utt=CLI_FACES_PER_UTT, plm_name=None):
    """tests/fixtures.py's MELD layout under `root` at the config's widths,
    for `splits` {split: (dialogues, utterances a dialogue)} (per split the
    T+A+V and V pickles, profile and face-path JSONs, 1 to `faces_per_utt`
    face JPEGs an utterance, CSV and text JSON), and the tokenized-text npz
    cache at max_seq_length tokens from the fixtures' whitespace tokenizer,
    for `plm_name` (default the config's: RoBERTa's specials and cache
    name, or a BERT-architecture tower's)."""
    from facialmmt_tpu_torch.data.text_prep import MeldTextPreprocessor

    fx, d = fixtures(), cfg.data
    plm_name = plm_name or cfg.plm_name
    roberta = plm_name == "roberta-large"
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
        np.savez(os.path.join(root, "T+A+V", f"text_{split}_{plm_name}.npz"),
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
    and 13 launched; the same command again with its eval loop under
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
    require_launched(launches, SERVING_KERNELS + (ADD_LN,),
                     "the command line's eval")
    others = {k: n for k, n in launches.items()
              if n and k not in SERVING_KERNELS + (ADD_LN,)}
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


# --------------------------------------------------------------- appendix --

APPENDIX_SPLITS = ("train", "val", "test")
APPENDIX_DIALOGUES, APPENDIX_UTTS = 8, 6   # a split: 8 dialogues of 6


def expect_text_kernel(launches, want, where):
    """Kernel 1 launched exactly `want` times and no other kernel of 1-12
    (the residual add + LayerNorm runs in every evaluation)."""
    others = {k: n for k, n in launches.items()
              if n and k not in ("fused_attention", ADD_LN)}
    if launches["fused_attention"] != want or others:
        raise AssertionError(f"{where}: launches {launches}, expected "
                             f"fused_attention {want} and nothing else")


def write_m3ed_layout(root, cfg, plm_name=None):
    """tests/fixtures.py's M3ED layout at the config's feature widths under
    <root>/m3ed (per split the text JSON, the utterance- and dialogue-level
    audio and vision pickles, the profile JSONs), the text caches
    <root>/appendix_data/T/text_{split}_{plm}_m3ed.npz from the port's
    M3edTextPreprocessor with the fixtures' whitespace tokenizer at
    max_seq_length tokens (plm: `plm_name`, default the config's; the M3ED
    preprocessor joins BERT-style whatever the tower, as the reference's),
    and a 48-row submission template."""
    from facialmmt_tpu_torch.data.text_prep import M3edTextPreprocessor

    fx, d = fixtures(), cfg.data
    plm_name = plm_name or cfg.plm_name
    prep = M3edTextPreprocessor(fx.WhitespaceTokenizer(False),
                                d.max_seq_length)
    os.makedirs(os.path.join(root, "appendix_data", "T"), exist_ok=True)
    for seed, split in enumerate(APPENDIX_SPLITS):
        info = fx.write_m3ed_multimodal_fixture(
            os.path.join(root, "m3ed"), split, APPENDIX_DIALOGUES,
            APPENDIX_UTTS, audio_len=d.audio_utt_max_len,
            vision_len=d.vision_utt_max_len, audio_dim=d.audio_feat_dim,
            vision_dim=d.vision_feat_dim, seed=30 + seed)
        ids, mask, sep, labels = M3edTextPreprocessor.to_arrays(
            prep.preprocess_split(info["text"]["path"]))
        np.savez(os.path.join(root, "appendix_data", "T",
                              f"text_{split}_{plm_name}_m3ed.npz"),
                 ids=ids, mask=mask, sep=sep, labels=labels)
    template = os.path.join(root, "m3ed", "template.csv")
    with open(template, "w") as f:
        f.write("ID,Emotion\n")
        f.writelines(f"dia{i // APPENDIX_UTTS}_utt{i % APPENDIX_UTTS},\n"
                     for i in range(APPENDIX_DIALOGUES * APPENDIX_UTTS))
    return template


def appendix_run(torch, argv):
    """`main.run(argv)` for an appendix command, watched: (F1, launch
    counts, {'steps': each train step's seconds, 'losses', 'k1_at_steps':
    kernel 1's count at each step, 'eval_batches', 'eval_s': seconds in
    the prediction passes, 'logits': each pass's logits, 'peak_gib': peak
    device memory from the model's start to the first validation, 'total':
    the whole call, s})."""
    from unittest import mock

    from facialmmt_tpu_torch import main as cli
    from facialmmt_tpu_torch.ops import kernels
    from facialmmt_tpu_torch.train import trainer as tm

    cuda = torch.cuda.is_available()
    seen = {"steps": [], "losses": [], "k1_at_steps": [], "eval_batches": 0,
            "eval_s": 0.0, "logits": []}
    mark = {}
    real_run = tm._SingleModelTrainer._run

    def on_event(name, **info):
        torch.cuda.synchronize()
        now = time.perf_counter()
        if name == "start" and cuda:
            torch.cuda.reset_peak_memory_stats()
        if name == "trg_step":
            seen["steps"].append(now - mark["t"])
            seen["losses"].append(info["loss"])
            seen["k1_at_steps"].append(
                kernels.launch_counts()["fused_attention"])
        if name == "valid" and "peak_gib" not in seen and cuda:
            seen["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        mark["t"] = time.perf_counter()

    def run(self, *args, **kwargs):
        kwargs["on_event"] = on_event
        return real_run(self, *args, **kwargs)

    def watched(real):
        def predict(self, eval_step, ds, bsz):
            def counted(batch):
                seen["eval_batches"] += 1
                return eval_step(batch)

            torch.cuda.synchronize()
            t = time.perf_counter()
            out = real(self, counted, ds, bsz)
            torch.cuda.synchronize()
            seen["eval_s"] += time.perf_counter() - t
            seen["logits"].append(out[0])
            return out

        return predict

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with mock.patch.object(tm._SingleModelTrainer, "_run", run), \
            mock.patch.object(tm.TextTrainer, "_predict",
                              watched(tm.TextTrainer._predict)), \
            mock.patch.object(tm.DialogueTrainer, "_predict",
                              watched(tm.DialogueTrainer._predict)):
        f1 = cli.run(argv)
    torch.cuda.synchronize()
    seen["total"] = time.perf_counter() - t0
    return f1, kernels.launch_counts(), seen


class AppendixRuns:
    """The appendix's commands through `main.run` under `root`, watched:
    phase 11's, and phase 16's with a BERT-architecture text tower (`extra`
    carries --plm_name).  `layers`: the text tower's depth, kernel 1's
    launches per eval batch; `template`: the submission template that
    write_m3ed_layout wrote; `tag` begins each printed line."""

    def __init__(self, torch, dev, gpu_name, root, extra, template,
                 tag="appendix"):
        from facialmmt_tpu_torch import main as cli
        from facialmmt_tpu_torch.config import resolve_text_config

        self.torch, self.dev, self.gpu_name = torch, dev, gpu_name
        self.root, self.extra, self.template, self.tag = (root, tuple(extra),
                                                          template, tag)
        base = cli.config_from_args(cli.build_argparser().parse_args(
            list(extra)))
        self.layers = resolve_text_config(base).num_layers
        self.n_test = APPENDIX_DIALOGUES * APPENDIX_UTTS

    def argv(self, save, *own):
        return ["--data_load_path", os.path.join(self.root, "appendix_data"),
                "--m3ed_project_path", os.path.join(self.root, "m3ed"),
                "--save_Model_path", save,
                "--metrics_path", os.path.join(self.root, "appendix.jsonl"),
                *self.extra, *own]

    def train(self, key, save, *own, text_only=True):
        from facialmmt_tpu_torch.utils import preemption

        try:
            f1, launches, seen = appendix_run(self.torch, self.argv(
                save, "--doEval", "0", "--num_epochs", "1", *own))
        finally:
            if preemption._guard is not None:    # cli.run installed it
                preemption._guard.uninstall()
        if not (seen["losses"] and np.isfinite(seen["losses"]).all()
                and max(seen["k1_at_steps"]) == 0 and 0.0 <= f1 <= 1.0):
            raise AssertionError(f"{key}: losses {seen['losses']}, kernel "
                                 f"1 at the steps {seen['k1_at_steps']}, "
                                 f"F1 {f1}")
        if text_only:
            expect_text_kernel(launches, self.layers * seen["eval_batches"],
                               key)
        files = sorted(os.listdir(save))
        if "best_1" not in files or "step_1" not in files:
            raise AssertionError(f"{key}: files {files}")
        print(f"{self.tag}: {key}: one epoch at FacialMMTConfig() width, "
              f"{len(seen['steps'])} steps, losses "
              f"{[round(x, 4) for x in seen['losses'][:4]]}..., step median "
              f"{statistics.median(seen['steps']) * 1e3:.1f} ms (first "
              f"{seen['steps'][0] * 1e3:.0f} ms), test F1 {f1:.4f}, "
              f"{seen['eval_batches']} eval batches, {seen['total']:.1f} s in "
              f"all; launches {launches} on {self.gpu_name}")
        return launches, seen

    def evaluate_twice(self, key, save, api, *own):
        from facialmmt_tpu_torch.utils.submission import M3ED_EMOTIONS

        outs = []
        stem = os.path.join(self.root, key.replace(" ", "_"))
        for n in (1, 2):
            out_csv = f"{stem}_{n}.csv"
            f1, launches, seen = appendix_run(self.torch, self.argv(
                save, "--doEval", "1", *own, "--submission_template",
                self.template, "--submission_out", out_csv, "--pred_dump_path",
                f"{stem}_{n}.txt"))
            expect_text_kernel(launches, self.layers * seen["eval_batches"],
                               key)
            with open(out_csv, "rb") as f:
                outs.append((f1, launches, seen, f.read()))
        (f1, launches, seen, csv_bytes), second = outs
        logits = seen["logits"][0]
        rows = [line.split(",") for line in csv_bytes.decode().splitlines()]
        want_rows = [[f"dia{i // APPENDIX_UTTS}_utt{i % APPENDIX_UTTS}",
                      M3ED_EMOTIONS[int(k)]]
                     for i, k in enumerate(logits.argmax(-1))]
        if not (second[0] == f1 == api and second[3] == csv_bytes
                and np.array_equal(second[2]["logits"][0], logits)
                and rows[1:] == want_rows and logits.shape[0] == self.n_test):
            raise AssertionError(f"{key}: F1 {f1} / {second[0]} / API {api}, "
                                 f"CSV equal {second[3] == csv_bytes}, rows "
                                 f"{rows[1:4]} vs {want_rows[:3]}")
        print(f"{self.tag}: {key} --doEval 1: macro-F1 {f1:.4f} = the second "
              f"run's = the API's; logits bit for bit, the CSV byte for byte, "
              f"{len(rows) - 1} rows in test order; {seen['eval_batches']} "
              f"eval batches, {self.n_test / seen['eval_s']:.1f} utterances/s "
              f"in the eval loop ({seen['total']:.2f} s end to end); launches "
              f"{launches} on {self.gpu_name}")
        return launches, seen

    def card_vs_cpu(self, key, trainer_cls, cfg, ds, save):
        """One eval batch: bf16 on the card against fp32 on the CPU, on the
        best file's weights, compared on the per-row centred logits."""
        from facialmmt_tpu_torch.checkpoint.io import CheckpointManager

        _, best = CheckpointManager(save).restore_best()
        got = []
        for device, dtype in ((self.dev, cfg.runtime.compute_dtype),
                              (self.torch.device("cpu"), "float32")):
            trainer = trainer_cls(cfg.replace(runtime=dataclasses.replace(
                cfg.runtime, compute_dtype=dtype)), device)
            model = trainer._build_single(best)
            _, step = trainer._steps(model)
            batch = ds.get_batch(list(range(trainer._effective_batch())))
            logits = step(trainer._batch_to_device(batch))[0]
            got.append(logits.float().cpu().numpy().astype(np.float64))
            del model
        z_card, z_cpu = (z - z.mean(-1, keepdims=True) for z in got)
        diff = float(np.abs(z_card - z_cpu).max())
        scale = float(np.abs(z_cpu).max())
        if not (np.isfinite(z_card).all() and diff <= SERVING_BOUND * scale):
            raise AssertionError(f"{key}: card vs CPU fp32 max|d| {diff} > "
                                 f"{SERVING_BOUND} * {scale}")
        print(f"{self.tag}: {key}: one eval batch {tuple(got[0].shape)}, card "
              f"{cfg.runtime.compute_dtype} vs CPU fp32: centred logits "
              f"max|d| {diff:.3g} <= {SERVING_BOUND} * {scale:.3g}")


def phase_appendix(torch, dev, gpu_name, root, extra=()):
    """The appendix (CCAC2023/M3ED) through `main.run` at FacialMMTConfig()
    width (RoBERTa-large, 768-wide fusion) on files that tests/fixtures.py's
    writers put under `root` (M3ED: splits of 8 dialogues of 6 utterances,
    audio (157, 768) and vision (32, 512) features, text caches at 512
    tokens; MELD: phase 9's files, written here when absent), random weights
    from the seed: --choice_modality T trained one epoch, then --doEval 1
    with the submission template and the dump, twice; M3ED utt T+A+V
    crossmodal and T+V concat, one epoch each; M3ED dia crossmodal (one
    epoch, then --doEval 1 twice) and concat; MELD T+V through the FER
    pipeline with its auxiliary task, one epoch.  Held: finite losses;
    kernel 1 launched 0 times in the train steps and exactly once per text
    layer in every eval batch, no other kernel on the M3ED paths, kernels
    1-6 on MELD T+V; each eval's macro-F1 equal to eval_text_only's /
    eval_dialogue_only's on the same files, the second eval's logits equal
    to the first's bit for bit and its CSV byte for byte, the CSV's rows in
    the template's order with the emotions of the logits' argmax; one eval
    batch of the T model and of the dialogue model in bf16 on the card
    against the same weights in fp32 on the CPU.  Prints smoke readings:
    the step-time medians, eval utterances/s and the dialogue step's peak
    memory."""
    from facialmmt_tpu_torch import main as cli
    from facialmmt_tpu_torch.checkpoint.io import CheckpointManager
    from facialmmt_tpu_torch.data.m3ed import (M3edDialogueDataset,
                                               M3edTextDataset)
    from facialmmt_tpu_torch.train.trainer import DialogueTrainer, TextTrainer
    from facialmmt_tpu_torch.utils import preemption

    base = cli.config_from_args(cli.build_argparser().parse_args(list(extra)))
    t0 = time.perf_counter()
    template = write_m3ed_layout(root, base)
    meld = os.path.join(root, "meld")
    if not os.path.isdir(os.path.join(meld, "T+A+V")):
        write_meld_layout(meld, base)
    if not os.path.isdir(os.path.join(meld, "T+V")):
        shutil.copytree(os.path.join(meld, "T+A+V"), os.path.join(meld, "T+V"))
    aux_root = os.path.join(root, "affwild")
    if not os.path.isdir(aux_root):
        fixtures().write_affwild_fixture(aux_root, AFFWILD_VIDEOS,
                                         AFFWILD_FRAMES, seed=22)
    print(f"appendix: M3ED files ({len(APPENDIX_SPLITS)} splits of "
          f"{APPENDIX_DIALOGUES} dialogues x {APPENDIX_UTTS} utterances) "
          f"written in {time.perf_counter() - t0:.1f} s")
    runs = AppendixRuns(torch, dev, gpu_name, root, extra, template)
    argv, train = runs.argv, runs.train
    evaluate_twice, card_vs_cpu = runs.evaluate_twice, runs.card_vs_cpu
    n_test = runs.n_test

    paths, readings = {}, {}
    # ---- T: train one epoch, then --doEval 1 twice
    save = os.path.join(root, "appendix_t")
    paths["appendix_t_train"], seen = train("T", save, "--choice_modality",
                                            "T")
    readings["T step"] = seen["steps"]
    cfg_t = cli.config_from_args(cli.build_argparser().parse_args(
        argv(save, "--choice_modality", "T")))
    t_ds = M3edTextDataset(*cli.m3ed_text_arrays(cfg_t, "", "test"))
    api = TextTrainer(cfg_t, dev).eval_text_only(t_ds, ckpt_dir=save)
    paths["appendix_t_eval"], seen = evaluate_twice(
        "T", save, api, "--choice_modality", "T")
    readings["T eval utt/s"] = n_test / seen["eval_s"]
    card_vs_cpu("T", TextTrainer, cfg_t, t_ds, save)
    shutil.rmtree(save)
    torch.cuda.empty_cache()

    # ---- M3ED utterance level
    for key, own in (("M3ED utt T+A+V crossmodal", ("--choice_modality",
                                                    "T+A+V")),
                     ("M3ED utt T+V concat", ("--choice_modality", "T+V",
                                              "--modalityFuse", "concat"))):
        save = os.path.join(root, "appendix_utt")
        name = "appendix_" + key.split()[2].replace("+", "").lower() + "_utt"
        paths[name], seen = train(key, save, *own)
        readings[f"{key} step"] = seen["steps"]
        shutil.rmtree(save)
        torch.cuda.empty_cache()

    # ---- M3ED dialogue level
    save = os.path.join(root, "appendix_dia")
    dia = ("--choice_modality", "T+A+V", "--uttORdia", "dia")
    paths["appendix_dia_train"], seen = train("M3ED dia crossmodal", save,
                                              *dia)
    readings["dia step"] = seen["steps"]
    dia_peak = seen.get("peak_gib", float("nan"))
    cfg_d = cli.config_from_args(cli.build_argparser().parse_args(
        argv(save, *dia)))
    ids, mask, sep, _ = cli.m3ed_text_arrays(cfg_d, "", "test")
    d_ds = M3edDialogueDataset(os.path.join(root, "m3ed"), "test", ids, mask,
                               sep)
    cfg_d = cli._adapt_static_shapes(cfg_d, d_ds)
    api = DialogueTrainer(cfg_d, dev).eval_dialogue_only(d_ds, ckpt_dir=save)
    paths["appendix_dia_eval"], seen = evaluate_twice("M3ED dia", save, api,
                                                      *dia)
    readings["dia eval utt/s"] = n_test / seen["eval_s"]
    card_vs_cpu("M3ED dia", DialogueTrainer, cfg_d, d_ds, save)
    shutil.rmtree(save)
    torch.cuda.empty_cache()
    save = os.path.join(root, "appendix_dia_concat")
    paths["appendix_dia_concat_train"], seen = train(
        "M3ED dia concat", save, *dia, "--modalityFuse", "concat")
    readings["dia concat step"] = seen["steps"]
    shutil.rmtree(save)
    torch.cuda.empty_cache()

    # ---- MELD T+V through the FER pipeline, with the auxiliary task
    save = os.path.join(root, "appendix_meld_tv")
    meld_argv = cli_argv(
        root, *extra, "--choice_modality", "T+V", "--doEval", "0",
        "--num_epochs", "1", "--save_Model_path", save,
        "--data_folder", os.path.join(aux_root, "cropped_aligned"),
        "--anno_folder", os.path.join(aux_root, "annos"),
        "--data_list_train", os.path.join(aux_root, "train_list.txt"))
    from facialmmt_tpu_torch.ops import kernels

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        f1 = cli.run(meld_argv)
    finally:
        if preemption._guard is not None:
            preemption._guard.uninstall()
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    require_launched(launches, SERVING_KERNELS + BACKWARD_KERNELS,
                     "MELD T+V training")
    _, best = CheckpointManager(save).restore_best()
    if not (0.0 <= f1 <= 1.0
            and any(k.startswith("multimodal.CrossModalTrans_TV.")
                    for k in best)
            and not any(k.startswith("multimodal.audio") for k in best)):
        raise AssertionError(f"MELD T+V: F1 {f1}, best file "
                             f"{sorted(best)[:4]}...")
    paths["appendix_meld_tv_train"] = launches
    print(f"appendix: MELD --choice_modality T+V --doEval 0 --num_epochs 1 "
          f"through the FER pipeline (CrossModalTrans_TV, no audio tower): "
          f"test W-F1 {f1:.4f} in {time.perf_counter() - t0:.1f} s; "
          f"launches {launches} on {gpu_name}")
    shutil.rmtree(save)

    medians = "; ".join(
        f"{k} median {statistics.median(v) * 1e3:.1f} ms"
        if isinstance(v, list) else f"{k} {v:.1f}"
        for k, v in readings.items())
    print(f"appendix smoke readings (one epoch on 48 utterances: not rates): "
          f"{medians}; the dialogue step's peak memory {dia_peak:.2f} GiB "
          f"on {gpu_name}")
    return paths


FRONT_BUCKETS = ((1, 12), (8, 64), (32, 256))
FRONT_BURST = 256          # default requests of the closed burst
FRONT_LOAD_S = 5.0         # seconds of each open-load run
FRONT_POSTS = 8            # concurrent /predict posts


class DispatchProbe:
    """Wraps one server's build_pack and predict_device, and asks whether
    the event recorded after the previous pack's dispatch has fired at two
    points of the next pack: when its build_pack starts (`at_build`), and
    when its predict_device returns (`at_return`).  True in `at_build`
    means the host built that pack while the one before still computed.
    It also keeps each dispatch's host time and the time between
    consecutive packs' events."""

    def __init__(self, torch, server):
        self.server = server
        self.prev = None
        self.at_build, self.at_return = [], []
        self.dispatch_ms, self.events = [], []
        build_pack, predict_device = server.build_pack, server.predict_device

        def probed_build_pack(requests):
            if self.prev is not None:
                self.at_build.append(not self.prev.query())
            return build_pack(requests)

        def probed_predict_device(batch, faces_raw):
            t0 = time.perf_counter()
            out = predict_device(batch, faces_raw)
            self.dispatch_ms.append((time.perf_counter() - t0) * 1000)
            if self.prev is not None:
                self.at_return.append(not self.prev.query())
            self.prev = torch.cuda.Event(enable_timing=True)
            self.prev.record()
            self.events.append(self.prev)
            return out

        server.build_pack = probed_build_pack
        server.predict_device = probed_predict_device

    def close(self):
        del self.server.build_pack, self.server.predict_device
        if self.events:
            self.events[-1].synchronize()
        self.gap_ms = [a.elapsed_time(b)
                       for a, b in zip(self.events, self.events[1:])]


def require_front_launches(kernels, cfg, packs, where, got=None):
    """Kernels 1, 2 and 3 exactly once per text layer / Swin block of every
    dispatched pack, the residual add + LayerNorm once a LayerNorm, every
    other kernel never (`got`: counts read elsewhere, by default the counts
    now)."""
    got = kernels.launch_counts() if got is None else got
    want = dict.fromkeys(got, 0)
    want["fused_attention"] = cfg.text.num_layers * packs
    want[ADD_LN] = add_ln_launches(cfg) * packs
    want["fused_attention_block"] = sum(cfg.swin.depths) * packs
    want["fused_ln_mlp_residual"] = sum(cfg.swin.depths) * packs
    if got != want:
        raise AssertionError(f"{where}: launches {got}, expected {want} for "
                             f"{packs} packs")
    return got


def as_wire(req):
    """The request with its features in float32, as an HTTP body carries
    them, so that the direct and the HTTP path get the same bits."""
    return {k: (v.astype(np.float32) if k in ("audio", "vision") else v)
            for k, v in req.items()}


def http_body(req):
    faces = req["faces"]
    return {"audio": req["audio"].tolist(), "vision": req["vision"].tolist(),
            "faces": base64.b64encode(faces.tobytes()).decode(),
            "faces_shape": list(faces.shape),
            "input_ids": req["input_ids"].tolist(),
            "sep_mask": req["sep_mask"].tolist(),
            "utt_in_dia_idx": int(req["utt_in_dia_idx"])}


def held_logits(what, got, want):
    """got, want: probability rows; max|d| of the centred log-probabilities
    <= SERVING_BOUND * max|logit|.  Returns max|d| of the probabilities."""
    z_got, z_want = (np.log(p) - np.log(p).mean(-1, keepdims=True)
                     for p in (np.asarray(got, np.float64),
                               np.asarray(want, np.float64)))
    diff = float(np.abs(z_got - z_want).max())
    scale = float(np.abs(z_want).max())
    if not (np.isfinite(z_got).all() and diff <= SERVING_BOUND * scale):
        raise AssertionError(f"{what}: logits max|d| {diff} > "
                             f"{SERVING_BOUND} * {scale}")
    return float(np.abs(np.asarray(got) - np.asarray(want)).max())


def check_rows(what, rows, n, num_labels):
    rows = np.stack(rows)
    if not (rows.shape == (n, num_labels) and np.isfinite(rows).all()
            and np.allclose(rows.sum(-1), 1.0, atol=1e-3)):
        raise AssertionError(f"{what}: bad probabilities {rows}")
    return rows


def closed_burst(torch, cfg, server, requests, depth, gpu_name, what=""):
    """Every request submitted at once to an AsyncBatchServer over `server`
    alone at `depth`, under a DispatchProbe.  Prints and returns
    (utterances/s, the share of packs built while the previous pack still
    computed, the share of dispatches that returned while it still
    computed)."""
    from facialmmt_tpu_torch import serving
    from facialmmt_tpu_torch.ops import kernels

    probe = DispatchProbe(torch, server)
    front = serving.AsyncBatchServer(server, pipeline_depth=depth)
    kernels.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        futures = [front.submit(r) for r in requests]
        outs = [f.result(timeout=300) for f in futures]
        wall = time.perf_counter() - t0
        require_front_launches(kernels, cfg, len(front.pack_sizes),
                               f"the closed burst at depth {depth}")
    finally:
        front.close()
        probe.close()
    check_rows(f"closed burst, depth {depth}", outs, len(requests),
               cfg.num_labels)
    rate = len(requests) / wall
    built, returned = (float(np.mean(x)) for x in (probe.at_build,
                                                   probe.at_return))
    print(f"front: closed burst of {len(requests)} default requests on "
          f"{(server.max_batch, server.face_capacity)} alone{what}, "
          f"pipeline_depth {depth}: {rate:.1f} utt/s ({wall:.3f} s, packs "
          f"{front.pack_sizes}); the previous pack still computing when the "
          f"next build_pack started: {sum(probe.at_build)} of "
          f"{len(probe.at_build)} ({built:.2f}), when the next dispatch "
          f"returned: {sum(probe.at_return)} of {len(probe.at_return)} "
          f"({returned:.2f}); dispatch host ms median "
          f"{statistics.median(probe.dispatch_ms):.2f}, event to event ms "
          f"median {statistics.median(probe.gap_ms):.2f} on {gpu_name}")
    return rate, built, returned


def phase_front_end(torch, dev, gpu_name, cfg=None, demo_args=()):
    """Phase 12: the serving front end.  `cfg` (default FacialMMTConfig()
    with deterministic gumbel) and the demo's extra arguments are for a
    rehearsal at small size on the CPU, with the FRONT_* sizes set there."""
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    from facialmmt_tpu_torch import serving
    from facialmmt_tpu_torch.config import FacialMMTConfig, RuntimeConfig
    from facialmmt_tpu_torch.ops import kernels
    from facialmmt_tpu_torch.serve_http import serve

    t_phase = time.perf_counter()
    cfg = cfg or FacialMMTConfig().replace(
        runtime=RuntimeConfig(deterministic_gumbel=True))
    labels = cfg.num_labels
    t0 = time.perf_counter()
    servers = [serving.EmotionServer(cfg, max_batch=mb, face_capacity=cap,
                                     device=dev) for mb, cap in FRONT_BUCKETS]
    torch.cuda.synchronize()
    by_bucket = {(s.max_batch, s.face_capacity): s for s in servers}
    big = servers[-1]
    print(f"front: buckets {list(FRONT_BUCKETS)}, one bf16 pipeline each "
          f"(phase 4's weights: the same seed; deterministic gumbel), built "
          f"and warmed in {time.perf_counter() - t0:.1f} s; device memory "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    # routing: a light request, a 20-face request, a burst of 32 mixed ones
    rng = np.random.default_rng(12)
    light = synthetic_requests(rng, cfg, [2], 64)[0]
    heavy = synthetic_requests(rng, cfg, [20], 512)[0]
    mixed = [synthetic_requests(rng, cfg, [int(rng.integers(0, 17))],
                                int(rng.integers(64, 513)))[0]
             for _ in range(32)]
    front = serving.AsyncBatchServer(servers)
    kernels.reset_launch_counts()
    try:
        outs = [front.submit(light).result(timeout=300),
                front.submit(heavy).result(timeout=300)]
        futures = [front.submit(r) for r in mixed]
        outs += [f.result(timeout=300) for f in futures]
        torch.cuda.synchronize()
        launches = require_front_launches(kernels, cfg, len(front.pack_sizes),
                                          "the front end's routing")
    finally:
        front.close()
    reqs = [light, heavy] + mixed
    check_rows("routing", outs, len(reqs), labels)
    choices = front.bucket_choices
    if (choices[:2] != list(FRONT_BUCKETS[:2])
            or FRONT_BUCKETS[-1] not in choices[2:]):
        raise AssertionError(f"routing: bucket choices {choices}")
    # FIFO packs: request i rode the bucket of the pack holding it
    rode = [b for b, n in zip(choices, front.pack_sizes) for _ in range(n)]
    worst = max(held_logits(f"routing, request {i} on {b}", got,
                            by_bucket[b].predict([r])[0])
                for i, (r, got, b) in enumerate(zip(reqs, outs, rode)))
    print(f"front: routing: {len(reqs)} requests in {len(choices)} packs "
          f"{list(zip(front.pack_sizes, choices))}; every answer held to the "
          f"solo prediction on its bucket (probabilities max|d| "
          f"{worst:.3g}); launches "
          f"{ {k: n for k, n in launches.items() if n} }, every other "
          f"kernel 0")

    for s in servers:
        lat = s.benchmark_latency(10)
        print(f"front: bucket {(s.max_batch, s.face_capacity)} "
              f"benchmark_latency(10) p50 {lat['p50_ms']:.2f} ms, p99 "
              f"{lat['p99_ms']:.2f} ms on {gpu_name}")

    # a closed burst on the largest bucket alone, depth 1 then 2
    wanted = [serving.default_load_request(cfg) for _ in range(FRONT_BURST)]
    rates, built = {}, {}
    for depth in (1, 2):
        rates[depth], built[depth], _ = closed_burst(
            torch, cfg, big, wanted, depth, gpu_name)

    # open load on the router
    for rate in (10.0, rates[2] / 2):
        stats = serving.benchmark_load(servers, rate, duration_s=FRONT_LOAD_S,
                                       seed=12)
        if not (stats["n_requests"] > 0 and np.isfinite(stats["p99_ms"])):
            raise AssertionError(f"open load at {rate}: {stats}")
        print(f"front: benchmark_load on the router at {rate:.1f} utt/s "
              f"for {FRONT_LOAD_S:.0f} s: achieved "
              f"{stats['achieved_utt_per_s']:.2f} utt/s, p50 "
              f"{stats['p50_ms']:.2f} ms, p99 "
              f"{stats['p99_ms']:.2f} ms, mean fill "
              f"{stats['mean_batch_fill']:.2f}, packs per bucket "
              f"{stats['bucket_counts']}, {stats['n_requests']} requests on "
              f"{gpu_name}")

    # HTTP: concurrent posts against the same requests through the front
    posts = [as_wire(r) for r in synthetic_requests(
        rng, cfg, [int(rng.integers(0, 17)) for _ in range(FRONT_POSTS)],
        200)]
    front = serving.AsyncBatchServer(servers)
    httpd, _ = serve(front, port=0, block=False)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        if health != {"ok": True, "buckets": [list(b) for b in FRONT_BUCKETS]}:
            raise AssertionError(f"/healthz {health}")

        def post(req):
            body = json.dumps(http_body(req)).encode()
            call = urllib.request.Request(
                url + "/predict", data=body,
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(call, timeout=300) as r:
                return json.loads(r.read())

        t0 = time.perf_counter()
        with ThreadPoolExecutor(FRONT_POSTS) as pool:
            replies = list(pool.map(post, posts))
        http_s = time.perf_counter() - t0
        direct = [f.result(timeout=300) for f in
                  [front.submit(r) for r in posts]]
        with urllib.request.urlopen(url + "/stats", timeout=60) as r:
            stats = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        front.close()
    got = check_rows("HTTP", [np.asarray(r["probs"]) for r in replies],
                     FRONT_POSTS, labels)
    worst = max(held_logits(f"HTTP reply {i} against the direct front", g, d)
                for i, (g, d) in enumerate(zip(got, direct)))
    same = sum(bool((g == d).all()) for g, d in zip(got, direct))
    if [r["label"] for r in replies] != [int(np.argmax(d)) for d in direct]:
        raise AssertionError("HTTP labels differ from the direct front's")
    print(f"front: HTTP: {FRONT_POSTS} concurrent /predict posts in "
          f"{http_s * 1000:.1f} ms; replies against the direct front's "
          f"answers: {same} of {FRONT_POSTS} bit for bit, max|d| "
          f"{worst:.3g}, labels equal; /healthz {health['buckets']}; /stats "
          f"{stats}")

    # the streaming demo in its own process
    t0 = time.perf_counter()
    demo = subprocess.run(
        [sys.executable, "-m", "facialmmt_tpu_torch.streaming_demo",
         "--ticks", "10", *demo_args], cwd=ROOT, capture_output=True,
        text=True, timeout=600, env={**os.environ, "PYTHONPATH": ROOT})
    ticks = [line for line in demo.stdout.splitlines()
             if line.startswith("tick ")]
    p50 = [line for line in demo.stdout.splitlines() if "latency p50" in line]
    if demo.returncode != 0 or len(ticks) != 10 or not p50:
        raise AssertionError(f"streaming demo: rc {demo.returncode}\n"
                             f"{demo.stdout[-2000:]}\n{demo.stderr[-2000:]}")
    print(f"front: python -m facialmmt_tpu_torch.streaming_demo --ticks 10: "
          f"exit 0 in {time.perf_counter() - t0:.1f} s, {p50[0].strip()} on "
          f"{gpu_name}")
    print(f"front: phase 12 took {time.perf_counter() - t_phase:.1f} s")
    # depth 1 waits for a pack's rows before it builds the next pack; depth
    # 2 must build while the pack before computes.  A dispatch cannot return
    # before the pack before it ends: a (32, 256) pack queues about 2,700
    # device operations, more than the launch queue holds, so the host
    # blocks on it until the card has drained the previous pack (PERF.md)
    if built[1] != 0 or not built[2] > 0:
        raise AssertionError(f"closed burst: packs built while the previous "
                             f"one computed: {built[1]:.2f} at depth 1 "
                             f"(expected 0), {built[2]:.2f} at depth 2 "
                             f"(expected > 0)")
    return {"serving_front": launches}



# --------------------------------------------------------------- phase 13 --

REMAT_ROUTES = (("auto", "auto", "auto"), ("xla", "xla", "window"))
MESH_TIMEOUT = 600        # seconds for the rank processes of phase 13
# a dp=2 step's first moments against one process's, per leaf, as a share
# of the largest in its group: the two runs split the same sums otherwise,
# and bf16 rounding amplified through the head's ReLU gates and batch
# statistics puts them up to 0.094 apart (the Swin's last block; the text,
# audio, crossmodal and classifier groups 0.003-0.006), while the same
# steps without the gradient sum over the data ranks, which phase 13 runs
# as its control, sit 0.84-1.69 apart in every group (NVIDIA H100 80GB
# HBM3, 700 W; fp32 on the CPU: 1e-7 - 2e-6 against 0.61-2.30)
MESH_GRAD_BOUND = 0.25


def require_counts(launches, want, where):
    """Every kernel of `want` launched exactly that many times."""
    wrong = {k: launches[k] for k, n in want.items() if launches[k] != n}
    if wrong:
        raise AssertionError(f"{where}: launches {wrong}, expected "
                             f"{ {k: want[k] for k in wrong} }")


def sync(torch):
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def phase_remat_mesh(torch, dev, gpu_name, cfg=None):
    """Phase 13: remat (a, b), two ranks on the one card (c) and a one-rank
    NCCL group (d).  Returns the launch counts of its paths."""
    from facialmmt_tpu_torch.config import FacialMMTConfig

    cfg = cfg or FacialMMTConfig()
    paths = {"remat_aux": remat_aux(torch, dev, gpu_name, cfg)}
    torch.cuda.empty_cache()
    paths["remat_text_target"] = remat_text(torch, dev, gpu_name, cfg)
    torch.cuda.empty_cache()
    paths.update(mesh_runs(torch, dev, gpu_name, cfg))
    return paths


def remat_aux(torch, dev, gpu_name, cfg):
    """(a) One auxiliary batch (150 images, drop-path on) through the Swin
    FER model with and without SwinConfig.remat, on the default route and
    on ('xla', 'xla', 'window'): loss, every gradient, the BatchNorm
    statistics and the generator after it equal bit for bit on the default
    route (within 1e-3 of max elsewhere); kernels 2 and 3 launch twice a
    block under remat, the backward kernels as often as without.  Peak
    memory of that forward + backward and the median of three full steps
    (forward, backward, clip + AdamW) per case."""
    from facialmmt_tpu_torch.ops import kernels
    from facialmmt_tpu_torch.train.optim import make_optimizer
    from facialmmt_tpu_torch.train.steps import compute_context, cross_entropy

    model = fer_model(torch, dev, cfg)
    model.train()
    opt = make_optimizer(model.parameters(), cfg.optim, cfg.optim.aux_lr, 10)
    images, labels = aux_batch(torch, dev, cfg)
    start = snapshot(model)
    blocks = sum(cfg.swin.depths)
    dtype = cfg.runtime.compute_dtype

    def loss_of(gen):
        with compute_context(dev, dtype):
            return cross_entropy(model(images, generator=gen), labels)

    def run(route, remat):
        model.load_state_dict(start)
        model.swin.cfg = dataclasses.replace(
            cfg.swin, attention_impl=route[0], mlp_impl=route[1],
            remat=remat)
        model.zero_grad(set_to_none=True)
        gen = torch.Generator(dev).manual_seed(5)
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated() / 2 ** 30
        loss = loss_of(gen)
        loss.backward()
        torch.cuda.synchronize()
        out = {"peak": torch.cuda.max_memory_allocated() / 2 ** 30,
               "resident": resident, "launches": kernels.launch_counts(),
               "loss": loss.detach(), "gen": gen.get_state(),
               "grads": {n: p.grad.detach().clone()
                         for n, p in model.named_parameters()},
               "state": snapshot(model)}
        model.zero_grad(set_to_none=True)
        times = []
        for _ in range(3):
            def step():
                loss_of(gen).backward()
                opt.step()
            times.append(timed_ms(torch, step)[1])
        out["ms"] = statistics.median(times)
        return out

    paths = None
    for route in REMAT_ROUTES:
        if route[2] not in ("auto", model.swin.merge_layout):
            raise AssertionError(f"the module merges in layout "
                                 f"{model.swin.merge_layout}, not {route[2]}")
        plain, remat = run(route, False), run(route, True)
        worst = 0.0
        for name in plain["grads"]:
            a, b = plain["grads"][name], remat["grads"][name]
            worst = max(worst, float((a - b).abs().max())
                        / max(float(a.abs().max()), 1e-30))
        same = (torch.equal(plain["loss"], remat["loss"])
                and worst == 0.0
                and all(torch.equal(plain["state"][k], remat["state"][k])
                        for k in plain["state"])
                and torch.equal(plain["gen"], remat["gen"]))
        if route == REMAT_ROUTES[0]:
            if not same:
                raise AssertionError(f"remat on {route}: not bit for bit "
                                     f"(worst gradient {worst:.3g})")
            doubled = ("fused_attention_block", "fused_ln_mlp_residual")
            require_counts(plain["launches"], dict.fromkeys(doubled, blocks),
                           "the aux step without remat")
            require_counts(remat["launches"], {
                k: (2 * n if k in doubled else n)
                for k, n in plain["launches"].items()}, "the remat aux step")
            paths = remat["launches"]
        elif not (worst <= 1e-3 and torch.equal(plain["gen"], remat["gen"])):
            raise AssertionError(f"remat on {route}: worst gradient "
                                 f"{worst:.3g}")
        print(f"remat: aux step ({AUX_IMAGES} images, route {route}) with "
              f"SwinConfig.remat vs without: "
              f"{'bit for bit' if same else f'worst gradient {worst:.3g}'} "
              f"(loss, {len(plain['grads'])} gradients, BatchNorm "
              f"statistics, generator); peak memory {plain['peak']:.2f} -> "
              f"{remat['peak']:.2f} GiB ({plain['resident']:.2f} GiB "
              f"resident), step {plain['ms']:.1f} -> {remat['ms']:.1f} ms; "
              f"launches {remat['launches']} on {gpu_name}")
    del model, opt
    return paths


def remat_text(torch, dev, gpu_name, cfg):
    """(b) One target step's forward and backward of the pipeline (4
    utterances, 64-face bucket, every dropout on, sampled gumbel) with and
    without TextEncoderConfig.remat: the same loss, gradients and generator
    state after it.  The step without remat runs twice (before and after):
    where those two agree bit for bit, remat must too; peak memory and the
    median of three forward + backward times."""
    from facialmmt_tpu_torch.data.meld import SyntheticMeldDataset
    from facialmmt_tpu_torch.models.multimodal import text_prefix
    from facialmmt_tpu_torch.models.pipeline import build_pipeline
    from facialmmt_tpu_torch.ops import kernels
    from facialmmt_tpu_torch.train.steps import compute_context, cross_entropy
    from facialmmt_tpu_torch.train.trainer import Trainer

    tcfg = cfg.replace(optim=dataclasses.replace(
        cfg.optim, trg_batch_size=4, trg_accumulation_steps=1))
    trainer = Trainer(tcfg, device=dev)
    model = build_pipeline(tcfg, dev).float().train()
    ds = SyntheticMeldDataset(tcfg, 4, 2, [8, 7, 9, 8], seed=12,
                              split="train")
    batch = trainer._batch_with_escalation(
        lambda cap: ds.get_batch(range(4), face_capacity=cap),
        trainer._face_buckets(4))
    device_batch = trainer._prepare_faces(batch, train=True)
    tower = getattr(model.multimodal, text_prefix(tcfg))
    if tower.cfg.hidden_dropout_prob <= 0:
        raise AssertionError("the text tower's dropout is off")
    start = snapshot(model)
    dtype = tcfg.runtime.compute_dtype

    def loss_of(gen):
        with compute_context(dev, dtype):
            logits = model(device_batch, generator=gen,
                           stop_swin_gradient=True)
        return cross_entropy(logits, device_batch["labels"])

    def run(remat):
        model.load_state_dict(start)
        tower.cfg = dataclasses.replace(tower.cfg, remat=remat)
        model.zero_grad(set_to_none=True)
        gen = torch.Generator(dev).manual_seed(9)
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss = loss_of(gen)
        loss.backward()
        torch.cuda.synchronize()
        out = {"peak": torch.cuda.max_memory_allocated() / 2 ** 30,
               "launches": kernels.launch_counts(), "loss": loss.detach(),
               "gen": gen.get_state(),
               "grads": {n: p.grad.detach().clone() for n, p in
                         model.multimodal.named_parameters()
                         if p.grad is not None}}
        model.zero_grad(set_to_none=True)
        times = []
        for _ in range(3):
            times.append(timed_ms(torch, lambda: loss_of(gen).backward())[1])
            model.zero_grad(set_to_none=True)
        out["ms"] = statistics.median(times)
        return out

    plain, remat, again = run(False), run(True), run(False)

    def worst(a, b):
        return max(float((a["grads"][k] - b["grads"][k]).abs().max())
                   / max(float(a["grads"][k].abs().max()), 1e-30)
                   for k in a["grads"])

    spread, diff = worst(plain, again), worst(plain, remat)
    gens = torch.equal(plain["gen"], remat["gen"]) and torch.equal(
        plain["gen"], again["gen"])
    if not (gens and plain["grads"].keys() == remat["grads"].keys()
            and diff <= spread and (spread > 0 or torch.equal(
                plain["loss"], remat["loss"]))):
        raise AssertionError(f"text remat: worst gradient {diff:.3g} vs "
                             f"the plain step's own spread {spread:.3g}, "
                             f"generators equal {gens}")
    print(f"remat: target step (4 utterances, dropout on) with "
          f"TextEncoderConfig.remat vs without: "
          f"{'bit for bit' if diff == 0 else f'worst gradient {diff:.3g}'} "
          f"over {len(plain['grads'])} gradients (two steps without remat: "
          f"{spread:.3g}), generator state equal; forward + backward "
          f"{plain['ms']:.1f} -> {remat['ms']:.1f} ms, peak memory "
          f"{plain['peak']:.2f} -> {remat['peak']:.2f} GiB on {gpu_name}")
    del model, trainer
    return remat["launches"]


def mesh_groups(cfg):
    """The groups of leaves whose AdamW first moments phase 13 compares:
    the first and last Swin block, its head, the first and last text layer,
    an audio layer, a crossmodal layer and the classifier."""
    last_block = (f"swin.swin.layers.{len(cfg.swin.depths) - 1}.blocks."
                  f"{cfg.swin.depths[-1] - 1}.")
    return {"swin first block": ("swin.swin.layers.0.blocks.0.",),
            "swin last block": (last_block,),
            "swin head": ("swin.swin.output_layer.", "swin.linear.",
                          "swin.classifier."),
            "text layer 0": ("mm.roberta.encoder.layer.0.",),
            "last text layer": (f"mm.roberta.encoder.layer."
                                f"{cfg.text.num_layers - 1}.",),
            "audio layer 0": ("mm.audio_utt_transformer.layer.0.",),
            "crossmodal layer 0": ("mm.CrossModalTrans_TA.layers.0.",),
            "classifier": ("mm.classifier.",)}


def mesh_group(cfg, key):
    """The group of a "<branch>.<name>" key, or None."""
    return next((g for g, prefixes in mesh_groups(cfg).items()
                 if key.startswith(prefixes)), None)


def mesh_steps(torch, cfg, case, work):
    """One auxiliary and one target step of a Trainer's own model and
    steps (the run_multimodal step) on the case's batches, under cfg's
    layout; the losses, launches, generator state, the Swin head's running
    statistics and the chosen leaves' whole first moments."""
    from facialmmt_tpu_torch.checkpoint.io import CheckpointManager
    from facialmmt_tpu_torch.data.image_pipeline import affwild2_train_augment
    from facialmmt_tpu_torch.ops import kernels
    from facialmmt_tpu_torch.train.trainer import Trainer

    t = Trainer(cfg.replace(optim=dataclasses.replace(
        cfg.optim, aux_batch_size=AUX_IMAGES, trg_batch_size=4,
        trg_accumulation_steps=1)), device=case["device"])
    model = t._build_model()
    state, _, _ = t._init_multitask_state(model, range(4), AUX_IMAGES)
    aux_step, trg_step, _, _ = t._make_steps(model)
    kernels.reset_launch_counts()
    images = affwild2_train_augment(
        t.generator, t._to_device(case["images"]).float(),
        img_size=cfg.data.swin_img_size)
    aux_loss = float(aux_step(state, images, t._to_device(case["labels"]),
                              t.generator))
    trg_loss = float(trg_step(state, t._prepare_faces(case["batch"], True),
                              t.generator))
    sync(torch)
    out = {"aux_loss": aux_loss, "trg_loss": trg_loss,
           "launches": kernels.launch_counts(),
           "generator": t.generator.get_state(),
           "plan": None if t.plan is None else (t.plan.dp, t.plan.tp),
           "bn": {k: v.float().cpu() for k, v in model.swin_model.swin
                  .output_layer[3].state_dict().items()
                  if k.startswith("running")}, "m": {}}
    for branch, opt, module in (("swin", state.swin_opt, model.swin_model),
                                ("mm", state.mm_opt, model.multimodal)):
        for i, (name, _) in enumerate(module.named_parameters()):
            if mesh_group(cfg, f"{branch}.{name}"):
                out["m"][f"{branch}.{name}"] = opt.moments(i)[0].float().cpu()
    if t.plan is not None:      # a step boundary's preemption agreement
        t._maybe_preempt(CheckpointManager(os.path.join(work, "ckpt")), state,
                         -1.0, 1, {"aux_batch": 1, "trg_batch": 1},
                         {"best_val_loss": float("inf"),
                          "patience_counter": 0})
    return out


def mesh_server(torch, cfg, case, plan):
    """An EmotionServer under `plan` answering the case's pack: its rows,
    the head counts of the text tower's attention calls, the launches."""
    from facialmmt_tpu_torch.models import text_encoder
    from facialmmt_tpu_torch.ops import kernels
    from facialmmt_tpu_torch.serving import EmotionServer

    server = EmotionServer(cfg, max_batch=8, face_capacity=FACES,
                           device=case["device"], mesh_plan=plan)
    heads, real = [], text_encoder.fused_attention

    def seen(q, k, v, bias):
        heads.append(q.shape[1])
        return real(q, k, v, bias)

    text_encoder.fused_attention = seen
    kernels.reset_launch_counts()
    try:
        rows = np.stack(server.predict(case["requests"]))
        sync(torch)
    finally:
        text_encoder.fused_attention = real
    return {"rows": rows, "heads": heads, "launches": kernels.launch_counts()}


def gloo_cuda_gather():
    """Give the port's gathers (parallel/comm.py::all_gather_cat) a form
    gloo takes on CUDA tensors: it has all_reduce and broadcast for them but
    no all_gather, so the two ranks sharing the card gather by summing a
    zero-filled buffer that holds each rank's part at its place."""
    import torch
    import torch.distributed as dist

    from facialmmt_tpu_torch.parallel import comm, mesh

    real = comm.all_gather_cat

    def gather(t, group, dim=0):
        n = comm.group_size(group)
        if n == 1 or not t.is_cuda:
            return real(t, group, dim)
        wire = t.contiguous()
        wire = wire if wire.dtype != torch.bool else wire.to(torch.uint8)
        shape = list(wire.shape)
        k = shape[dim]
        shape[dim] *= n
        full = wire.new_zeros(shape)
        full.narrow(dim, dist.get_rank(group) * k, k).copy_(wire)
        dist.all_reduce(full, group=group)
        return full.to(t.dtype)

    comm.all_gather_cat = mesh.all_gather_cat = gather


def unsummed_steps(torch, cfg, case, work):
    """mesh_steps with the data ranks' gradient sum skipped: the control
    that MESH_GRAD_BOUND has to catch."""
    from facialmmt_tpu_torch.train.optim import ClippedAdamW

    real = ClippedAdamW._sum_over_data
    ClippedAdamW._sum_over_data = lambda self, grads: None
    try:
        return mesh_steps(torch, cfg, case, work)
    finally:
        ClippedAdamW._sum_over_data = real


def moment_gaps(cfg, ref, got):
    """{group: the largest max|d| of a leaf's first moment in `got`
    against `ref`, as a share of the largest |m| in its group}."""
    group_max = {}
    for k, m in ref["m"].items():
        g = mesh_group(cfg, k)
        group_max[g] = max(group_max.get(g, 0.0), float(m.abs().max()))
    gaps = dict.fromkeys(group_max, 0.0)
    for k, m in ref["m"].items():
        g = mesh_group(cfg, k)
        gaps[g] = max(gaps[g], float((got["m"][k] - m).abs().max())
                      / group_max[g])
    return gaps


def mesh_rank(kind, rank, world, work):
    """A rank process of phase 13 (chip_smoke.py --mesh-rank KIND RANK WORLD
    DIR): 'gloo2', two ranks sharing cuda:0 over gloo (NCCL takes one rank
    a card): the steps at dp=2 and a server at tp=2; 'nccl1', the steps
    without a plan, then at dp=1 on a one-rank NCCL group."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from facialmmt_tpu_torch.config import ParallelConfig
    from facialmmt_tpu_torch.ops import kernels
    from facialmmt_tpu_torch.parallel.mesh import build_mesh, init_distributed

    if kind.startswith("front"):
        return front_mesh_rank(kind, rank, world, work)
    rank, world = int(rank), int(world)
    case = torch.load(os.path.join(work, "case.pt"), weights_only=False)
    cfg = case["cfg"]
    dev = torch.device(case["device"])
    if dev.type == "cuda":
        kernels.library()
    init = "file://" + os.path.join(work, f"init_{kind}")
    out = {}
    if kind == "nccl1":
        out["none"] = mesh_steps(torch, cfg, case, work)
        init_distributed(dev, backend="nccl" if dev.type == "cuda" else "gloo",
                         init_method=init, rank=0, world_size=1)
        out["plan"] = mesh_steps(torch, cfg.replace(
            parallel=ParallelConfig(dp=1, tp=1)), case, work)
    else:
        init_distributed(dev, backend="gloo", init_method=init, rank=rank,
                         world_size=world)
        if dev.type == "cuda":
            gloo_cuda_gather()
        dp2 = cfg.replace(parallel=ParallelConfig(dp=2, tp=1))
        out["dp2"] = mesh_steps(torch, dp2, case, work)
        out["dp2_unsummed"] = unsummed_steps(torch, dp2, case, work)
        out["tp2_server"] = mesh_server(torch, cfg, case,
                                        build_mesh(1, 2, dev))
    torch.save(out, os.path.join(work, f"out_{kind}_{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def mesh_runs(torch, dev, gpu_name, cfg):
    """(c) and (d): the rank processes on the same batches, held against
    the step without a plan (d's first half) and a one-rank server."""
    from facialmmt_tpu_torch.data.meld import (SyntheticFerDataset,
                                               SyntheticMeldDataset)
    from facialmmt_tpu_torch.serving import EmotionServer

    work = tempfile.mkdtemp(prefix="mesh_")
    images, labels = SyntheticFerDataset(
        AUX_IMAGES, 112, cfg.num_labels, seed=21).get_batch(range(AUX_IMAGES))
    batch = SyntheticMeldDataset(cfg, 4, 2, [8, 7, 9, 8], seed=12,
                                 split="train").get_batch(range(4), FACES)
    requests = synthetic_requests(np.random.default_rng(13), cfg, [8] * 8,
                                  512)
    torch.save({"cfg": cfg, "images": images, "labels": labels,
                "batch": batch, "requests": requests, "device": str(dev)},
               os.path.join(work, "case.pt"))
    t0 = time.perf_counter()
    procs = {(kind, r): subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--mesh-rank", kind,
         str(r), str(n), work], cwd=ROOT)
        for kind, n in (("gloo2", 2), ("nccl1", 1)) for r in range(n)}
    try:
        one = EmotionServer(cfg, max_batch=8, face_capacity=FACES, device=dev)
        want_rows = np.stack(one.predict(requests))
        del one
        codes = {k: p.wait(timeout=MESH_TIMEOUT) for k, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    if any(codes.values()):
        raise AssertionError(f"phase 13 rank processes exited {codes}")
    out = {k: torch.load(os.path.join(work, f"out_{k[0]}_{k[1]}.pt"),
                         weights_only=False) for k in procs}
    shutil.rmtree(work, ignore_errors=True)
    seconds = time.perf_counter() - t0

    # (d) the one-rank NCCL group changes no bit
    ref, nccl = out["nccl1", 0]["none"], out["nccl1", 0]["plan"]
    if ref["plan"] is not None or nccl["plan"] != (1, 1):
        raise AssertionError(f"plans {ref['plan']}, {nccl['plan']}")
    same = ((ref["aux_loss"], ref["trg_loss"])
            == (nccl["aux_loss"], nccl["trg_loss"])
            and torch.equal(ref["generator"], nccl["generator"])
            and all(torch.equal(ref["m"][k], nccl["m"][k]) for k in ref["m"])
            and all(torch.equal(ref["bn"][k], nccl["bn"][k])
                    for k in ref["bn"])
            and ref["launches"] == nccl["launches"])
    if not same:
        raise AssertionError("dp=1 on a one-rank NCCL group is not bit for "
                             "bit the step without a plan")
    require_launched(nccl["launches"], SERVING_KERNELS[1:] + BACKWARD_KERNELS,
                     "the dp=1 NCCL steps")
    print(f"mesh: one auxiliary and one target step at dp=1 on a one-rank "
          f"NCCL group: bit for bit the steps without a plan (losses, "
          f"{len(ref['m'])} first moments, BatchNorm statistics, generator, "
          f"launches)")

    # (c) dp=2 over gloo, two ranks on the one card: a leaf's first moment
    # is held to MESH_GRAD_BOUND of the largest in its group (mesh_groups);
    # the same steps without the gradient sum must break it in every group
    worst = {g: max(moment_gaps(cfg, ref, out["gloo2", r]["dp2"])[g]
                    for r in range(2)) for g in mesh_groups(cfg)}
    control = {g: max(moment_gaps(cfg, ref, out["gloo2", r]["dp2_unsummed"])
                      [g] for r in range(2)) for g in mesh_groups(cfg)}
    print("mesh: dp=2 first moments against one process, worst max|d| of "
          "their group's largest (bound " + str(MESH_GRAD_BOUND) + "): "
          + ", ".join(f"{g} {w:.4g}" for g, w in worst.items())
          + "; the control, the data ranks' gradient sum skipped: "
          + ", ".join(f"{g} {w:.4g}" for g, w in control.items()))
    if min(control.values()) <= MESH_GRAD_BOUND:
        raise AssertionError(f"the control (no gradient sum over the data "
                             f"ranks) stays within MESH_GRAD_BOUND in a "
                             f"group: {control}")
    if max(worst.values()) > MESH_GRAD_BOUND:
        raise AssertionError(f"dp=2 first moments {worst} exceed "
                             f"{MESH_GRAD_BOUND} of their group's largest")
    for r in range(2):
        got = out["gloo2", r]["dp2"]
        if got["plan"] != (2, 1):
            raise AssertionError(f"rank {r}: plan {got['plan']}")
        for key in ("aux_loss", "trg_loss"):
            if abs(got[key] - ref[key]) > 1e-2 * abs(ref[key]):
                raise AssertionError(f"dp=2 rank {r} {key} {got[key]} vs "
                                     f"{ref[key]}")
        if not torch.equal(got["generator"], ref["generator"]):
            raise AssertionError(f"dp=2 rank {r}: the generator is not "
                                 f"the one-process run's")
        for k, v in ref["bn"].items():
            d = float((got["bn"][k] - v).abs().max())
            if d > GRAD_BOUND * float(v.abs().max()):
                raise AssertionError(f"dp=2 rank {r} BatchNorm {k}: {d}")
        require_launched(got["launches"],
                         SERVING_KERNELS[1:] + BACKWARD_KERNELS,
                         f"the dp=2 steps of rank {r}")
    print(f"mesh: one auxiliary ({AUX_IMAGES} images, {AUX_IMAGES // 2} a "
          f"rank) and one target step (4 utterances, 64 faces, 32 a rank) "
          f"at dp=2, two ranks on one card over gloo, ZeRO-1 on: losses "
          f"{out['gloo2', 0]['dp2']['aux_loss']:.5f} / "
          f"{out['gloo2', 0]['dp2']['trg_loss']:.5f} vs one process "
          f"{ref['aux_loss']:.5f} / {ref['trg_loss']:.5f}, the generator "
          f"state equal, {len(ref['m'])} first moments within "
          f"{MESH_GRAD_BOUND} of their group's largest (worst "
          f"{max(worst.values()):.4g}, the control's least group "
          f"{min(control.values()):.4g}); the Swin head's running "
          f"statistics within {GRAD_BOUND}")

    # (c) the tp=2 server: kernel 1 on half the heads
    z_want = np.log(want_rows) - np.log(want_rows).mean(-1, keepdims=True)
    heads = cfg.text.num_heads // 2
    for r in range(2):
        got = out["gloo2", r]["tp2_server"]
        if got["heads"] != [heads] * cfg.text.num_layers:
            raise AssertionError(f"tp=2 server rank {r}: attention heads "
                                 f"{got['heads']}")
        require_counts(got["launches"], {
            "fused_attention": cfg.text.num_layers,
            "fused_attention_block": sum(cfg.swin.depths),
            "fused_ln_mlp_residual": sum(cfg.swin.depths)},
            f"the tp=2 server's pack on rank {r}")
        z = np.log(got["rows"]) - np.log(got["rows"]).mean(-1, keepdims=True)
        diff = float(np.abs(z - z_want).max())
        scale = float(np.abs(z_want).max())
        if not (np.isfinite(z).all() and diff <= SERVING_BOUND * scale):
            raise AssertionError(f"tp=2 server rank {r}: logits max|d| "
                                 f"{diff} > {SERVING_BOUND} * {scale}")
    print(f"mesh: EmotionServer at tp=2 (two ranks, gloo): the text tower's "
          f"attention is kernel 1 on {heads} of {cfg.text.num_heads} heads, "
          f"{cfg.text.num_layers} launches a pack on each rank; one pack's "
          f"logits vs the one-rank server max|d| {diff:.3g} <= "
          f"{SERVING_BOUND} * {scale:.3g}; phase 13's rank processes took "
          f"{seconds:.1f} s on {gpu_name}")
    return {"mesh_dp2_steps": out["gloo2", 0]["dp2"]["launches"],
            "mesh_tp2_server": out["gloo2", 0]["tp2_server"]["launches"],
            "nccl_dp1_steps": nccl["launches"]}


# ------------------------------------------- phase 15: the front on a mesh --

# layout: ((dp, tp), buckets); max_batch and face_capacity divide dp
FRONT_MESH_LAYOUTS = {"tp2": ((1, 2), ((1, 12), (8, 64))),
                      "dp2": ((2, 1), ((2, 12), (8, 64)))}
FRONT_MESH_DEFAULT = 64     # default requests of each layout's burst
FRONT_MESH_MIXED = 32       # mixed ones: 0-20 faces, 64-512 tokens
FRONT_MESH_THREADS = 8      # threads submitting the burst on the main rank
FRONT_MESH_KEEPALIVE_S = 2.0    # serving.KEEPALIVE_S in the rank processes
FRONT_MESH_IDLE_S = 5.0     # the idle gap, longer than the keepalive
FRONT_MESH_AFTER = 8        # requests answered after the gap
FRONT_MESH_LOAD_S = 5.0     # benchmark_load's seconds (dp=2)
FRONT_MESH_RATE = 20.0      # and its utterances/s
FRONT_MESH_TIMEOUT = 600    # seconds for the rank processes of phase 15


def front_mesh_requests(cfg):
    """The burst's requests (FRONT_MESH_DEFAULT default ones, then
    FRONT_MESH_MIXED mixed ones) and the FRONT_MESH_AFTER sent after the
    idle gap, the same on every process."""
    from facialmmt_tpu_torch.serving import default_load_request

    rng = np.random.default_rng(15)
    mixed = [synthetic_requests(rng, cfg, [int(rng.integers(0, 21))],
                                int(rng.integers(64, 513)))[0]
             for _ in range(FRONT_MESH_MIXED)]
    burst = [default_load_request(cfg)
             for _ in range(FRONT_MESH_DEFAULT)] + mixed
    return burst, [dict(r) for r in mixed[:FRONT_MESH_AFTER]]


def recorded_packs(servers, requests, into):
    """Wrap each server's build_pack to append (bucket index, the indices
    in `requests` of the pack's requests) to `into`."""
    index = {id(r): i for i, r in enumerate(requests)}
    for b, server in enumerate(servers):
        def build(reqs, b=b, real=server.build_pack):
            into.append((b, [index[id(r)] for r in reqs]))
            return real(reqs)
        server.build_pack = build


def submit_from_threads(front, requests):
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(FRONT_MESH_THREADS) as pool:
        futures = list(pool.map(front.submit, requests))
    return [f.result(timeout=300) for f in futures]


def front_mesh_layout(torch, cfg, dev, plan, buckets, rank, requests,
                      after=None, load=False, serial=False):
    """One layout on this rank: its servers behind one AsyncBatchServer;
    rank 0 submits the requests (from FRONT_MESH_THREADS threads, or one at
    a time when `serial`; with `after`, more after an idle gap longer than
    the keepalive); then benchmark_load on every rank when `load`."""
    from facialmmt_tpu_torch import serving
    from facialmmt_tpu_torch.ops import kernels

    servers = [serving.EmotionServer(cfg, max_batch=mb, face_capacity=cap,
                                     device=dev, mesh_plan=plan)
               for mb, cap in buckets]
    submit = submit_from_threads
    if serial:
        def submit(front, reqs):
            return [front.submit(r).result(timeout=300) for r in reqs]
    everything = requests + (after or [])
    out = {"packs_run": [], "pack_bytes": {
        (s.max_batch, s.face_capacity): sum(a.nbytes for a in (
            serving._pack_arrays(s._zero_batch(), np.zeros(
                (s.face_capacity,) + serving.FACE_SHAPE, np.uint8))))
        for s in servers}}
    if rank == 0:
        recorded_packs(servers, everything, out["packs_run"])
    sync(torch)
    kernels.reset_launch_counts()
    front = serving.AsyncBatchServer(servers)
    if rank == 0:
        t0 = time.perf_counter()
        out["answers"] = submit(front, requests)
        out["burst_s"] = time.perf_counter() - t0
        out["burst_packs"] = len(front.pack_sizes)
        if after:
            time.sleep(FRONT_MESH_IDLE_S)
            out["answers"] += submit(front, after)
    front.close()
    sync(torch)
    for s in servers:
        s.__dict__.pop("build_pack", None)      # recorded_packs' wrapper
    out.update(launches=kernels.launch_counts(), packs=front.pack_sizes,
               buckets=front.bucket_choices, keepalives=front.keepalives,
               broadcast_ms=front.broadcast_ms,
               generators=[s.generator.get_state() for s in servers])
    if load:
        out["load"] = serving.benchmark_load(
            servers, FRONT_MESH_RATE, duration_s=FRONT_MESH_LOAD_S, seed=15)
    del servers, front
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def front_mesh_rank(kind, rank, world, work):
    """A rank process of phase 15 (chip_smoke.py --mesh-rank KIND RANK
    WORLD DIR): 'front2', two ranks sharing cuda:0 over gloo, the tp=2
    router then the dp=2 front; 'front_nccl1', a front without a plan,
    then at dp=1 on a one-rank NCCL group, on the same requests one at a
    time."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from facialmmt_tpu_torch import serving
    from facialmmt_tpu_torch.ops import kernels
    from facialmmt_tpu_torch.parallel.mesh import build_mesh, init_distributed

    rank, world = int(rank), int(world)
    case = torch.load(os.path.join(work, "case.pt"), weights_only=False)
    cfg, dev = case["cfg"], torch.device(case["device"])
    if dev.type == "cuda":
        kernels.library()
    init = "file://" + os.path.join(work, f"init_{kind}")
    burst, after = front_mesh_requests(cfg)
    out = {}
    if kind == "front_nccl1":
        buckets = FRONT_MESH_LAYOUTS["tp2"][1]
        out["none"] = front_mesh_layout(torch, cfg, dev, None, buckets, 0,
                                        after, serial=True)
        init_distributed(dev, backend="nccl" if dev.type == "cuda" else "gloo",
                         init_method=init, rank=0, world_size=1)
        out["plan"] = front_mesh_layout(torch, cfg, dev, build_mesh(1, 1, dev),
                                        buckets, 0, after, serial=True)
    else:
        init_distributed(dev, backend="gloo", init_method=init, rank=rank,
                         world_size=world)
        if dev.type == "cuda":
            gloo_cuda_gather()
        serving.KEEPALIVE_S = FRONT_MESH_KEEPALIVE_S
        for name, ((dp, tp), buckets) in FRONT_MESH_LAYOUTS.items():
            out[name] = front_mesh_layout(
                torch, cfg, dev, build_mesh(dp, tp, dev), buckets, rank,
                burst, after if name == "tp2" else None, load=name == "dp2")
    torch.save(out, os.path.join(work, f"out_{kind}_{rank}.pt"))
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    return 0


def replayed_answers(servers, starts, requests, packs):
    """Each request's row from one-process servers (by bucket index) that
    run the recorded packs in order, each from the generator state it had
    when built; and the generators after."""
    for server, state in zip(servers, starts):
        server.generator.set_state(state)
    rows = {}
    for b, ids in packs:
        server = servers[b]
        got = server.predict_raw(*server.build_pack([requests[i]
                                                     for i in ids]))
        rows.update({i: got[j] for j, i in enumerate(ids)})
    return ([rows[i] for i in range(len(requests))],
            [s.generator.get_state() for s in servers])


def phase_front_mesh(torch, dev, gpu_name, cfg=None):
    """Phase 15: the serving front over mesh servers, two rank processes
    sharing the card over gloo (a tp=2 router, a dp=2 front; an idle gap;
    benchmark_load; close), and a one-rank NCCL group at dp=1 against the
    front without a plan.  Returns the launch counts of its paths."""
    from facialmmt_tpu_torch.config import FacialMMTConfig
    from facialmmt_tpu_torch.ops import kernels
    from facialmmt_tpu_torch.serving import EmotionServer

    t_phase = time.perf_counter()
    cfg = cfg or FacialMMTConfig()
    work = tempfile.mkdtemp(prefix="front_mesh_")
    torch.save({"cfg": cfg, "device": str(dev)}, os.path.join(work, "case.pt"))

    def start(kind, world):
        return {(kind, r): subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--mesh-rank", kind,
             str(r), str(world), work], cwd=ROOT) for r in range(world)}

    def wait(procs):
        try:
            codes = {k: p.wait(timeout=FRONT_MESH_TIMEOUT)
                     for k, p in procs.items()}
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
        if any(codes.values()):
            raise AssertionError(f"phase 15 rank processes exited {codes}")
        return {k: torch.load(os.path.join(work, f"out_{k[0]}_{k[1]}.pt"),
                              weights_only=False) for k in procs}

    t0 = time.perf_counter()
    out = wait(start("front2", 2))
    rank_s = time.perf_counter() - t0
    procs = start("front_nccl1", 1)
    try:
        refs = {b: EmotionServer(cfg, max_batch=b[0], face_capacity=b[1],
                                 device=dev)
                for b in sorted({b for _, bs in FRONT_MESH_LAYOUTS.values()
                                 for b in bs})}
        starts = {b: s.generator.get_state() for b, s in refs.items()}
        burst, after = front_mesh_requests(cfg)
        paths = {}
        for name, ((dp, tp), buckets) in FRONT_MESH_LAYOUTS.items():
            main, other = out["front2", 0][name], out["front2", 1][name]
            everything = burst + (after if name == "tp2" else [])
            want, gens = replayed_answers(
                [refs[b] for b in buckets], [starts[b] for b in buckets],
                everything, main["packs_run"])
            got = check_rows(f"front {name}", main["answers"],
                             len(everything), cfg.num_labels)
            worst = max(held_logits(f"front {name}, request {i}", g, w)
                        for i, (g, w) in enumerate(zip(got, want)))
            if (main["packs"], main["buckets"]) != (other["packs"],
                                                    other["buckets"]):
                raise AssertionError(f"front {name}: rank 0 ran packs "
                                     f"{main['packs']} on {main['buckets']}, "
                                     f"rank 1 {other['packs']} on "
                                     f"{other['buckets']}")
            for r, o in enumerate((main, other)):
                require_front_launches(kernels, cfg, len(o["packs"]),
                                       f"front {name}, rank {r}",
                                       got=o["launches"])
                if not all(torch.equal(a, b) for a, b in
                           zip(o["generators"], gens)):
                    raise AssertionError(f"front {name}, rank {r}: the "
                                         f"generators differ from one "
                                         f"process's after the same packs")
            if set(main["buckets"]) != set(buckets):
                raise AssertionError(f"front {name}: buckets used "
                                     f"{sorted(set(main['buckets']))}")
            by_bucket = {}
            for b, ms in zip(main["buckets"], main["broadcast_ms"]):
                by_bucket.setdefault(b, []).append(ms)
            ms = ", ".join(f"{b} {statistics.median(v):.2f} ms "
                           f"({main['pack_bytes'][b] / 1e6:.2f} MB, {len(v)} "
                           f"packs)" for b, v in sorted(by_bucket.items()))
            print(f"front mesh: {name} (dp={dp}, tp={tp}) over {buckets}, "
                  f"two ranks sharing one card over gloo: a closed burst of "
                  f"{len(burst)} requests ({FRONT_MESH_DEFAULT} default, "
                  f"{FRONT_MESH_MIXED} mixed) from {FRONT_MESH_THREADS} "
                  f"threads on rank 0 in {main['burst_packs']} packs, "
                  f"{len(burst) / main['burst_s']:.1f} utt/s (two ranks "
                  f"sharing one card: no scaling figure); broadcast per pack "
                  f"median {ms}; packs {main['packs']} on the same buckets "
                  f"on both ranks; every answer held to one process "
                  f"replaying the recorded packs (max|d| {worst:.3g}); "
                  f"launches per rank "
                  f"{ {k: n for k, n in main['launches'].items() if n} } "
                  f"for {len(main['packs'])} packs; both ranks' generators "
                  f"equal the replay's after {len(main['packs'])} packs on "
                  f"{gpu_name}")
            paths[f"front_mesh_{name}"] = main["launches"]
        tp2 = (out["front2", 0]["tp2"], out["front2", 1]["tp2"])
        if not (tp2[0]["keepalives"] == tp2[1]["keepalives"]
                >= int(FRONT_MESH_IDLE_S / FRONT_MESH_KEEPALIVE_S)):
            raise AssertionError(f"keepalives sent {tp2[0]['keepalives']}, "
                                 f"received {tp2[1]['keepalives']}")
        print(f"front mesh: an idle gap of {FRONT_MESH_IDLE_S:.0f} s with "
              f"KEEPALIVE_S {FRONT_MESH_KEEPALIVE_S:.0f} s: "
              f"{tp2[0]['keepalives']} IDLE headers sent and received, then "
              f"{FRONT_MESH_AFTER} requests answered (held above)")
        loads = [out["front2", r]["dp2"]["load"] for r in range(2)]
        if loads[0] != loads[1] or not loads[0]["n_requests"]:
            raise AssertionError(f"benchmark_load: {loads}")
        print(f"front mesh: benchmark_load at {FRONT_MESH_RATE:.0f} utt/s "
              f"for {FRONT_MESH_LOAD_S:.0f} s over the dp=2 front, called "
              f"on both ranks: the same stats on both {loads[0]} on "
              f"{gpu_name}; both ranks exited 0 after close(), the rank "
              f"processes took {rank_s:.1f} s")
        del refs
        nccl = wait(procs)["front_nccl1", 0]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
        shutil.rmtree(work, ignore_errors=True)
    none, one = nccl["none"], nccl["plan"]
    same = (all((a == b).all() for a, b in zip(none["answers"],
                                                one["answers"]))
            and (none["packs"], none["buckets"]) == (one["packs"],
                                                     one["buckets"])
            and all(torch.equal(a, b) for a, b in zip(none["generators"],
                                                      one["generators"]))
            and none["launches"] == one["launches"]
            and one["broadcast_ms"] == [] and one["keepalives"] == 0)
    if not same:
        raise AssertionError("the front at dp=1 on a one-rank NCCL group is "
                             "not bit for bit the front without a plan")
    require_front_launches(kernels, cfg, len(one["packs"]),
                           "the front at dp=1 on a one-rank NCCL group",
                           got=one["launches"])
    print(f"front mesh: the front at dp=1 on a one-rank NCCL group: "
          f"{len(one['answers'])} requests one at a time bit for bit the "
          f"front without a plan (answers, packs {one['packs']} on "
          f"{one['buckets']}, generators, launches), no broadcast")
    paths["front_nccl_dp1"] = one["launches"]
    print(f"front mesh: phase 15 took {time.perf_counter() - t_phase:.1f} s")
    return paths


# ------------------------------------------------------- phase 14: tooling --

# the C entry points of kernels 1-6 (ops/kernels/__init__.py::_SIGNATURES)
ENTRY_OF = {"fused_attention": "fmmt_fused_attention",
            "fused_attention_block": "fmmt_fused_attention_block",
            "fused_ln_mlp_residual": "fmmt_fused_ln_mlp_residual",
            "fused_ln_mlp_residual_bwd": "fmmt_fused_ln_mlp_residual_bwd",
            "fused_attention_block_bwd": "fmmt_fused_attention_block_bwd",
            "fused_attention_block_bwd_spill":
                "fmmt_fused_attention_block_bwd_spill"}
# launches in one default target step (PERF.md section 6): the Swin forward
# without a graph, the text tower in train mode on plain attention
TARGET_STEP_LAUNCHES = {"fused_attention": 0, "fused_attention_block": 12,
                        "fused_ln_mlp_residual": 12,
                        "fused_ln_mlp_residual_bwd": 0,
                        "fused_attention_block_bwd": 0,
                        "fused_attention_block_bwd_spill": 0}
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def phase_tooling(torch, dev, gpu_name, cli_root, pack_p50_ms, cfg=None,
                  extra=()):
    """Phase 14: the tools module, --profile_dir and --debug_nans on the
    card.  (a) `python -m facialmmt_tpu_torch.tools doctor` in its own
    process; (b) print-flops against utils/flops.py in process, and the mfu
    of phase 4's pack; (c) run_multimodal on phase 7's data with
    runtime.profile_dir: the trace's ProfilerStep spans and, by the C entry
    point that launched them, its device kernels; (d) one auxiliary and one
    target step with and without enable_nan_debugging, bit for bit, then a
    NaN face and a NaN gradient; (e) phase 9's released pair through
    convert-checkpoint and export-checkpoint --kind pipeline, bit for bit,
    and behind an EmotionServer.  Returns the launch counts of its paths."""
    from facialmmt_tpu_torch.config import FacialMMTConfig

    cfg = cfg or FacialMMTConfig()
    t0 = time.perf_counter()
    tooling_doctor(torch)
    tooling_flops(gpu_name, pack_p50_ms)
    paths = {}
    with tempfile.TemporaryDirectory() as work:
        paths["tooling_profile"] = tooling_profile(torch, dev, gpu_name, work,
                                                   cfg)
    torch.cuda.empty_cache()
    paths["tooling_debug_nans"] = tooling_debug_nans(torch, dev, gpu_name,
                                                     cfg)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work:
        paths["tooling_roundtrip"] = tooling_roundtrip(
            torch, dev, gpu_name, cli_root, work, extra)
    print(f"tooling: phase 14 in {time.perf_counter() - t0:.1f} s")
    return paths


def tooling_doctor(torch):
    """`tools doctor` in its own process: exit 0, the card at capability
    9.0, nvcc, the kernel library found (phase 2 built it) and loaded."""
    proc = subprocess.run(
        [sys.executable, "-m", "facialmmt_tpu_torch.tools", "doctor"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": ROOT})
    need = (torch.cuda.get_device_name(0), "capability 9.0", "nvcc",
            "kernel library", "kernels            : loaded")
    if proc.returncode != 0 or not all(n in proc.stdout for n in need):
        raise AssertionError(f"tools doctor: exit {proc.returncode}, "
                             f"wanted {need}\n{proc.stdout}\n"
                             f"{proc.stderr[-2000:]}")
    for line in proc.stdout.splitlines():
        print("tooling: doctor: " + line.strip())


def tooling_flops(gpu_name, pack_p50_ms):
    """print-flops' lines equal those of ops/swin.py::swin_flops and
    utils/flops.py::eval_step_macs called here; then the model FLOPs of
    phase 4's (8, 64) pack over its benchmark_latency p50 as a share of
    the card's bf16 peak (a smoke reading, no gate)."""
    from facialmmt_tpu_torch import tools
    from facialmmt_tpu_torch.config import FacialMMTConfig
    from facialmmt_tpu_torch.ops.swin import swin_flops
    from facialmmt_tpu_torch.utils.flops import (H100_BF16_PEAK_FLOPS,
                                                 eval_step_macs)

    cfg = FacialMMTConfig()
    batch, per = 8, 8
    f = swin_flops(cfg.swin)
    m = eval_step_macs(cfg, batch, 1, per * batch)
    want = [f"swin-tiny forward: {f / 1e9:.2f} GMACs/image "
            f"({f * batch / 1e12:.2f} TMACs at batch {batch})",
            f"full T+A+V eval batch ({batch} utts, {per} faces/utt): "
            f"{m / 1e9:.1f} GMACs = {2 * m / 1e12:.2f} TFLOPs"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tools.main(["print-flops", "--batch", str(batch), "--faces_per_utt",
                    str(per)])
    if out.getvalue().splitlines() != want:
        raise AssertionError(f"print-flops printed {out.getvalue()!r}, "
                             f"utils/flops.py gives {want}")
    for line in want:
        print(f"tooling: print-flops: {line}")
    # the pack's static shapes: 8 dialogue rows of 512 tokens, 64 face slots
    pack = eval_step_macs(cfg, 8, 8, FACES)
    rate = 2 * pack / (pack_p50_ms / 1e3)
    print(f"tooling: mfu (smoke reading): phase 4's (8, {FACES}) pack, "
          f"2 x {pack / 1e9:.1f} GMACs at its static shapes over its "
          f"benchmark_latency p50 {pack_p50_ms:.2f} ms = "
          f"{rate / 1e12:.2f} TFLOP/s, mfu {100 * rate / H100_BF16_PEAK_FLOPS:.2f} "
          f"% of {H100_BF16_PEAK_FLOPS / 1e12:.1f} TFLOP/s on {gpu_name}")


@contextlib.contextmanager
def entry_spans(torch):
    """Every launching C entry point of the kernel library inside a
    torch.profiler span of its name, so that a trace ties each device kernel
    to the entry point (and so the kernel of this script) that launched
    it.  The wrappers look the entry points up on the library at every
    launch."""
    from facialmmt_tpu_torch.ops import kernels

    lib = kernels.library()
    saved = {name: getattr(lib, name) for name in ENTRY_OF.values()}

    def spanned(name, fn):
        def call(*args):
            with torch.profiler.record_function(name):
                return fn(*args)
        return call

    for name, fn in saved.items():
        setattr(lib, name, spanned(name, fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(lib, name, fn)


def read_step_trace(path):
    """The trace of a StepProfiler capture: its ProfilerStep spans in
    order, per span the entry-point spans of kernels 1-6 and the device
    kernels they launched (by the launch's correlation id), and the device
    events (kernels, copies, sets) whose launch lies in each span."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    # the host's spans (the card's copies of them are 'gpu_user_annotation')
    host = [e for e in events if e.get("cat") == "user_annotation"]
    steps = sorted((e for e in host if e["name"].startswith("ProfilerStep#")),
                   key=lambda e: e["ts"])
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    entries = [e for e in host if e["name"] in ENTRY_OF.values()]
    device = [e for e in events if e.get("cat") in DEVICE_CATEGORIES
              and e.get("args", {}).get("correlation") in launch_ts]

    def inside(ts, span):
        return span["ts"] <= ts <= span["ts"] + span["dur"]

    out = []
    for step in steps:
        mine = [d for d in device
                if inside(launch_ts[d["args"]["correlation"]], step)]
        spans = {}
        for kernel, entry in ENTRY_OF.items():
            calls = [e for e in entries
                     if e["name"] == entry and inside(e["ts"], step)]
            spans[kernel] = [
                [d["name"] for d in mine if d.get("cat") == "kernel"
                 and inside(launch_ts[d["args"]["correlation"]], call)]
                for call in calls]
        out.append({"name": step["name"], "span": step, "device": mine,
                    "entries": spans})
    return out


def tooling_profile(torch, dev, gpu_name, work, base):
    """Trainer(FacialMMTConfig()).run_multimodal on phase 7's in-memory data
    (2 auxiliary steps of 150 images, 2 target steps of 4 utterances) with
    runtime.profile_dir: one trace file, ProfilerStep#0-1 the target steps
    (train steps 3-4, as JAX's schedule picks them) and #2 what ran after
    them until the run closed the capture (validation); in each captured
    step the entry points of kernels 1-6 called TARGET_STEP_LAUNCHES times,
    each call with its device kernels; the ten device operations that took
    the most time, and the device's idle share over the two steps."""
    from facialmmt_tpu_torch.ops import kernels
    from facialmmt_tpu_torch.train.trainer import Trainer

    trace = os.path.join(work, "trace")
    cfg = training_config(base, os.path.join(work, "saved"))
    cfg = cfg.replace(runtime=dataclasses.replace(cfg.runtime,
                                                  profile_dir=trace))
    aux_ds, train_ds, eval_ds = training_datasets(cfg)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with entry_spans(torch):
        f1 = Trainer(cfg, dev).run_multimodal(aux_ds, train_ds, eval_ds,
                                              eval_ds)
    sync(torch)
    seconds = time.perf_counter() - t0
    launches = kernels.launch_counts()
    files = [name for name in os.listdir(trace)
             if name.startswith("rank0.") and name.endswith(".pt.trace.json")]
    if len(files) != 1 or not np.isfinite(f1):
        raise AssertionError(f"--profile_dir: files {files}, W-F1 {f1}")
    path = os.path.join(trace, files[0])
    steps = read_step_trace(path)
    names = [s["name"] for s in steps]
    if names != ["ProfilerStep#0", "ProfilerStep#1", "ProfilerStep#2"]:
        raise AssertionError(f"--profile_dir: spans {names}, expected the "
                             f"two target steps and the tail")
    for step in steps[:2]:
        calls = {k: len(v) for k, v in step["entries"].items()}
        empty = {k: sum(not c for c in v) for k, v in step["entries"].items()
                 if any(not c for c in v)}
        if calls != TARGET_STEP_LAUNCHES or empty:
            raise AssertionError(f"{step['name']}: kernel calls {calls}, "
                                 f"expected {TARGET_STEP_LAUNCHES}; calls "
                                 f"without a device kernel {empty}")
        print(f"tooling: --profile_dir: {step['name']} (a target step): "
              + ", ".join(f"{k} {n} calls, "
                          f"{sum(map(len, step['entries'][k]))} device kernels"
                          for k, n in calls.items() if n))
    tail = {k: len(v) for k, v in steps[2]["entries"].items() if v}
    lo = steps[0]["span"]["ts"]
    hi = steps[1]["span"]["ts"] + steps[1]["span"]["dur"]
    device = steps[0]["device"] + steps[1]["device"]
    by_name = {}
    for d in device:
        ms, n = by_name.get(d["name"], (0.0, 0))
        by_name[d["name"]] = (ms + d["dur"] / 1e3, n + 1)
    busy, end = 0.0, lo
    for d in sorted(device, key=lambda d: d["ts"]):
        a, b = max(d["ts"], end), min(d["ts"] + d["dur"], hi)
        if b > a:
            busy += b - a
        end = max(end, min(d["ts"] + d["dur"], hi))
    window = hi - lo
    print(f"tooling: --profile_dir: run_multimodal in {seconds:.1f} s, "
          f"trace {os.path.getsize(path) / 1e6:.1f} MB, spans {names}; the "
          f"tail (validation until close) called {tail}; launches of the "
          f"run {launches} on {gpu_name}")
    print(f"tooling: --profile_dir: device idle {100 * (1 - busy / window):.1f} "
          f"% of the two target steps' {window / 1e3:.1f} ms ({len(device)} "
          f"device operations, busy {busy / 1e3:.1f} ms) on {gpu_name}")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0]
                                )[:10]:
        print(f"tooling: --profile_dir: top device op {ms:.3f} ms in {n} "
              f"({name.replace('(anonymous namespace)::', '')[:110]})")
    return launches


def tooling_debug_nans(torch, dev, gpu_name, base):
    """One auxiliary and one target step of run_multimodal's (phase 7's
    data, from one snapshot of the model) with and without
    enable_nan_debugging: the losses and every gradient the optimizers
    receive bit for bit, kernels 2-6 launched alike.  Then, debugging on, a
    NaN in one face raises FloatingPointError naming a module, and a NaN put
    by a tensor hook into the gradient arriving at the Swin head (the last
    block's MLP half) raises it naming kernel 3's backward Function, which
    launches kernel 4.  The handle is removed afterwards."""
    import facialmmt_tpu_torch.ops.swin as swin_ops
    from facialmmt_tpu_torch.data.image_pipeline import affwild2_train_augment
    from facialmmt_tpu_torch.ops import kernels
    from facialmmt_tpu_torch.train.trainer import Trainer
    from facialmmt_tpu_torch.utils.observability import enable_nan_debugging

    cfg = training_config(base, "unused")
    aux_ds, train_ds, _ = training_datasets(cfg)
    trainer = Trainer(cfg, dev)
    model = trainer._build_model(None)
    gen = torch.Generator(dev).manual_seed(5)
    images, labels = aux_ds.get_batch(range(AUX_IMAGES))
    images = affwild2_train_augment(gen, trainer._to_device(images).float(),
                                    img_size=cfg.data.swin_img_size)
    labels = trainer._to_device(labels)
    _, _, trg_bsz = trainer._init_multitask_state(model, train_ds,
                                                  len(aux_ds))
    batch, _ = next(iter(trainer._target_loader(train_ds, trg_bsz, False)
                         .epoch(1)))
    batch = trainer._prepare_faces(batch, train=True)
    start = snapshot(model)

    def steps(debug, aux_images=images):
        """(losses, gradients, launches, seconds) of the two steps."""
        model.load_state_dict(start)
        state, _, _ = trainer._init_multitask_state(model, train_ds,
                                                    len(aux_ds))
        aux_step, trg_step, _, _ = trainer._make_steps(model)
        grads = {}
        for key, opt, branch in (("aux", state.swin_opt, model.swin_model),
                                 ("target", state.mm_opt, model.multimodal)):
            opt.step = recorded_step(opt.step, grads.setdefault(key, {}),
                                     branch)
        g = torch.Generator(dev).manual_seed(6)
        handle = enable_nan_debugging() if debug else None
        try:
            kernels.reset_launch_counts()
            sync(torch)
            t0 = time.perf_counter()
            losses = (float(aux_step(state, aux_images, labels, g)),
                      float(trg_step(state, batch, g)))
            sync(torch)
            return (losses, grads, kernels.launch_counts(),
                    time.perf_counter() - t0)
        finally:
            if handle is not None:
                handle.remove()

    plain = steps(False)
    debug = steps(True)
    differ = [f"{key}.{name}" for key in ("aux", "target")
              for name, g in plain[1][key].items()
              if not torch.equal(g, debug[1][key][name])]
    if (debug[0] != plain[0] or differ or debug[2] != plain[2]
            or set(plain[1]["aux"]) != set(debug[1]["aux"])):
        raise AssertionError(f"--debug_nans changed the steps: losses "
                             f"{plain[0]} vs {debug[0]}, gradients "
                             f"{differ[:5]}, launches {plain[2]} vs "
                             f"{debug[2]}")
    require_launched(debug[2], SERVING_KERNELS[1:] + BACKWARD_KERNELS,
                     "the NaN-checked steps")
    n = sum(len(g) for g in debug[1].values())
    print(f"tooling: --debug_nans: one aux and one target step, losses "
          f"{debug[0]} and {n} gradients bit for bit with and without "
          f"debugging; {plain[3] * 1e3:.0f} -> {debug[3] * 1e3:.0f} ms "
          f"(first calls); launches {debug[2]} on {gpu_name}")

    bad = images.clone()
    bad[7, 0, 0, 0] = float("nan")
    try:
        steps(True, bad)
    except FloatingPointError as e:
        if "module" not in str(e):
            raise
        print(f"tooling: --debug_nans: a NaN in face 7 of 150 raised "
              f"FloatingPointError: {e}")
    else:
        raise AssertionError("--debug_nans: a NaN face raised nothing")

    mlp, last, calls = swin_ops.fused_ln_mlp_residual, sum(
        cfg.swin.depths), []

    def nan_gradient(*args, **kwargs):
        out = mlp(*args, **kwargs)
        calls.append(1)
        if len(calls) == last:      # the last block's MLP half: the head's input
            out.register_hook(lambda grad: grad * float("nan"))
        return out

    swin_ops.fused_ln_mlp_residual = nan_gradient
    try:
        steps(True)
    except FloatingPointError as e:
        if "FusedLnMlpResidualBackward" not in str(e):
            raise
        print(f"tooling: --debug_nans: a NaN put into the gradient at the "
              f"Swin head raised FloatingPointError: {str(e)[:200]}")
    else:
        raise AssertionError("--debug_nans: a NaN gradient raised nothing")
    finally:
        swin_ops.fused_ln_mlp_residual = mlp
    if torch.is_anomaly_enabled():
        raise AssertionError("anomaly mode left on")
    return debug[2]


def recorded_step(step, into, module):
    """An optimizer step that first copies `module`'s gradients `into`."""
    def recorded(*args):
        into.update({name: p.grad.detach().clone()
                     for name, p in module.named_parameters()
                     if p.grad is not None})
        return step(*args)
    return recorded


def tooling_roundtrip(torch, dev, gpu_name, cli_root, work, extra=()):
    """Phase 9's released pair (seed-7 weights) through `tools
    convert-checkpoint` (--kind multimodal, swin), joined into a pipeline
    checkpoint, and `tools export-checkpoint --kind pipeline`: the two
    files it writes hold the input's tensors bit for bit; behind an
    EmotionServer the exported pair answers as phase 9's does (the same
    bits on two packs), kernels 1-3 launched 24 / 12 / 12 times a pack."""
    from facialmmt_tpu_torch import main as cli
    from facialmmt_tpu_torch import tools
    from facialmmt_tpu_torch.checkpoint.io import CheckpointManager
    from facialmmt_tpu_torch.checkpoint.torch_load import (
        MULTIMODAL, SWIN, load_torch_state_dict, released_state_dict)
    from facialmmt_tpu_torch.data.meld import MeldMultimodalDataset
    from facialmmt_tpu_torch.ops import kernels
    from facialmmt_tpu_torch.serving import EmotionServer

    argv = cli_argv(cli_root, *extra, "--choice_modality", "T+A+V",
                    "--doEval", "1", "--deterministic_gumbel", "1")
    cfg = cli.config_from_args(cli.build_argparser().parse_args(argv))
    test_ds = MeldMultimodalDataset(os.path.join(cli_root, "meld"), "test",
                                    cli.text_arrays(cfg, "test"))
    cfg = cli._adapt_static_shapes(cfg, test_ds)
    pm = os.path.join(cli_root, "pretrained_model")
    pair = (os.path.join(pm, cfg.load_multimodal_path),
            os.path.join(pm, cfg.load_swin_path))
    t0 = time.perf_counter()
    ckpt = os.path.join(work, "ckpt")
    for kind, path in zip(("multimodal", "swin"), pair):
        tools.main(["convert-checkpoint", "--kind", kind, "--input", path,
                    "--output", os.path.join(ckpt, kind)])
    manager = CheckpointManager(ckpt)
    joined = {MULTIMODAL + k: v for k, v in manager.restore("multimodal")
              .items()}
    joined.update({SWIN + k: v for k, v in manager.restore("swin").items()})
    manager.save("best_1", joined)
    base = os.path.join(work, "exported.pt")
    tools.main(["export-checkpoint", "--kind", "pipeline", "--input",
                os.path.join(ckpt, "best_1"), "--output", base])
    exported = (base[:-3] + "_multimodal.pt", base[:-3] + "_swin.pt")
    seconds = time.perf_counter() - t0
    for src, out in zip(pair, exported):
        want, got = load_torch_state_dict(src), load_torch_state_dict(out)
        differ = [k for k in want if k not in got
                  or want[k].dtype != got[k].dtype
                  or not torch.equal(want[k], got[k])]
        if differ or set(got) != set(want):
            raise AssertionError(f"round trip of {src}: {differ[:5]}, keys "
                                 f"{set(got) ^ set(want)}")
    print(f"tooling: convert-checkpoint x2 + export-checkpoint --kind "
          f"pipeline of phase 9's pair "
          f"({sum(map(os.path.getsize, pair)) / 1e9:.3f} GB) in "
          f"{seconds:.1f} s: every tensor bit for bit")

    rng = np.random.default_rng(14)
    packs = [synthetic_requests(rng, cfg, [8] * 8, 512),
             synthetic_requests(rng, cfg, [5, 11, 0, 16, 2], 300)]
    answers = []
    for files in (pair, exported):
        server = EmotionServer(cfg, released_state_dict(*files), max_batch=8,
                               face_capacity=FACES, device=dev)
        kernels.reset_launch_counts()
        answers.append([np.stack(server.predict(reqs)) for reqs in packs])
        sync(torch)
        launches = kernels.launch_counts()
        del server
    require_counts(launches, {"fused_attention": 24 * len(packs),
                              "fused_attention_block": 12 * len(packs),
                              "fused_ln_mlp_residual": 12 * len(packs)},
                   "the exported pair's server")
    if not all(np.array_equal(a, b) for a, b in zip(*answers)):
        raise AssertionError("the exported pair answers otherwise than "
                             "phase 9's")
    print(f"tooling: the exported pair behind an EmotionServer: "
          f"{sum(map(len, packs))} answers equal to phase 9's pair's bit for "
          f"bit; launches {launches} ({len(packs)} packs) on {gpu_name}")
    return launches


# --------------------------------------------------------- configurations --

# launches of one (8, 64) eval pack and of one auxiliary step (12 Swin
# blocks, 10 of them at C <= 384)
PACK_LAUNCHES = {"fused_attention": 24, "fused_attention_block": 12,
                 "fused_ln_mlp_residual": 12, ADD_LN: 99}
AUX_STEP_LAUNCHES = {ADD_LN: 0,
                     "fused_attention_block": 12, "fused_ln_mlp_residual": 12,
                     "fused_ln_mlp_residual_bwd": 12,
                     "fused_attention_block_bwd": 10,
                     "fused_attention_block_bwd_spill": 2}
# phase 16 (d)'s float32 packs on the window-attention routes, and the
# kernel each route's cores launch once a block (64 faces: every stage's
# window count is even, so 'pair' pairs every block's windows)
FP32_ROUTES = ((("pallas", "auto", "auto"), "fused_window_attention"),
               (("pair", "auto", "auto"), "paired_window_attention"))
FP32_AUX_ROUTE = ("pallas", "xla", "window")
SWIN_DROP = 0.1        # phase 16's Swin drop_rate and attn_drop_rate
# The (8, 64) pack under --compute_dtype float32 on the card against the
# same weights in fp32 on the CPU: centred logits max|d| <= FP32_BOUND *
# max|logit|.  Measured 3.9e-5 on an NVIDIA H100 80GB HBM3 at 700 W
# (PERF.md section 6): the bound leaves 5x, is 500x under SERVING_BOUND and
# 8x under the 1.67e-3 that the same pack reads through the former bf16
# boundary of kernels 1-6, which the phase also prints and holds above it
FP32_BOUND = 2e-4
BERT_TOWERS = ("bert-large", "chinese-roberta-large")


def exactly(launches, want):
    """{kernel: want's count, 0 for every kernel want does not name}; the
    residual add + LayerNorm (every evaluation launches it) only where
    `want` names it."""
    return {k: want.get(k, 0) for k in launches if k != ADD_LN or k in want}


def aux_batch(torch, dev, cfg):
    """The auxiliary batch of phases 13 and 16: AUX_IMAGES synthetic FER
    frames through the training augmentation, and their labels."""
    from facialmmt_tpu_torch.data.image_pipeline import affwild2_train_augment
    from facialmmt_tpu_torch.data.meld import SyntheticFerDataset

    images_np, labels_np = SyntheticFerDataset(
        AUX_IMAGES, 112, cfg.num_labels, seed=21).get_batch(range(AUX_IMAGES))
    images = affwild2_train_augment(
        torch.Generator(dev).manual_seed(3),
        torch.from_numpy(images_np).to(dev).float(),
        img_size=cfg.data.swin_img_size)
    return images, torch.from_numpy(labels_np).to(dev)


def fer_model(torch, dev, cfg, state=None):
    """The Swin FER model of `cfg` on `dev`: random weights from the seed,
    or `state`."""
    from facialmmt_tpu_torch.models.pipeline import init_random_
    from facialmmt_tpu_torch.models.swin_fer import \
        SwinForAffwildClassification

    with torch.device(dev):
        model = SwinForAffwildClassification(cfg)
    model.to(dev)          # the buffers made from numpy arrays
    if state is None:
        init_random_(model, torch.Generator(dev).manual_seed(cfg.runtime.seed))
    else:
        model.load_state_dict(state, strict=True)
    return model


def aux_step(torch, dev, model, images, labels, dtype):
    """One auxiliary forward and backward under `dtype`: (loss, launches,
    ms on the host clock around it, every gradient finite)."""
    from facialmmt_tpu_torch.ops import kernels
    from facialmmt_tpu_torch.train.steps import compute_context, cross_entropy

    model.train()
    model.zero_grad(set_to_none=True)
    gen = torch.Generator(dev).manual_seed(5)
    kernels.reset_launch_counts()

    def step():
        with compute_context(dev, dtype):
            loss = cross_entropy(model(images, generator=gen), labels)
        loss.backward()
        return loss.detach()

    sync(torch)
    t0 = time.perf_counter()
    loss = step()
    sync(torch)
    ms = (time.perf_counter() - t0) * 1e3
    finite = all(torch.isfinite(p.grad).all() for p in model.parameters()
                 if p.grad is not None)
    return float(loss), kernels.launch_counts(), ms, bool(finite)


def configurations_drop_rates(torch, dev, gpu_name, cfg):
    """(a) Swin drop_rate = attn_drop_rate = SWIN_DROP on the default route.
    Eval of a 64-face pack: kernels 2 / 3 once a block and nothing else,
    bit for bit the rate-0 model's.  Training: one auxiliary step with both
    rates (JAX's rule sends every half to 'xla': no kernel 2-6) and one with
    attn_drop_rate alone (the attention halves to 'xla', the MLP halves on
    kernels 3 and 4), finite losses and gradients."""
    from facialmmt_tpu_torch.data.image_pipeline import \
        meld_face_eval_transform
    from facialmmt_tpu_torch.ops import kernels
    from facialmmt_tpu_torch.train.steps import compute_context

    rated = lambda drop, attn: cfg.replace(swin=dataclasses.replace(
        cfg.swin, drop_rate=drop, attn_drop_rate=attn))
    blocks = sum(cfg.swin.depths)
    plain = fer_model(torch, dev, cfg)
    start = snapshot(plain)
    model = fer_model(torch, dev, rated(SWIN_DROP, SWIN_DROP), start)
    faces = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (FACES, 160, 160, 3), dtype=np.uint8)).to(dev)
    x = meld_face_eval_transform(faces.float(), cfg.data.swin_img_size)
    dtype = cfg.runtime.compute_dtype
    outs = []
    for m in (model, plain):
        m.eval()
        kernels.reset_launch_counts()
        with torch.no_grad(), compute_context(dev, dtype):
            outs.append(m(x))
        sync(torch)
        if m is model:
            eval_launches = kernels.launch_counts()
    require_counts(eval_launches, exactly(eval_launches, {
        "fused_attention_block": blocks, "fused_ln_mlp_residual": blocks}),
        "eval with Swin drop rates")
    if not torch.equal(*outs):
        raise AssertionError("eval with Swin drop rates differs from the "
                             "rate-0 model")
    print(f"configurations: Swin drop_rate = attn_drop_rate = {SWIN_DROP}, "
          f"eval of {FACES} faces ({dtype}): kernels 2 / 3 launched "
          f"{eval_launches['fused_attention_block']} / "
          f"{eval_launches['fused_ln_mlp_residual']} times, bit for bit "
          f"the rate-0 model's on {gpu_name}")
    images, labels = aux_batch(torch, dev, cfg)
    aux_launches = {}
    for key, drop, attn, want in (
            ("both rates", SWIN_DROP, SWIN_DROP, {}),
            ("attn_drop_rate alone", 0.0, SWIN_DROP,
             {"fused_ln_mlp_residual": blocks,
              "fused_ln_mlp_residual_bwd": blocks})):
        m = fer_model(torch, dev, rated(drop, attn), start)
        loss, launches, ms, finite = aux_step(torch, dev, m, images, labels,
                                              dtype)
        require_counts(launches, exactly(launches, want),
                       f"an aux step with {key}")
        if not (np.isfinite(loss) and finite):
            raise AssertionError(f"aux step with {key}: loss {loss}, "
                                 f"gradients finite {finite}")
        print(f"configurations: aux step ({AUX_IMAGES} images, {dtype}) with "
              f"Swin {key} {SWIN_DROP}: the halves JAX's rule sends to 'xla' "
              f"launch no kernel (launches "
              f"{ {k: n for k, n in launches.items() if n} }), loss "
              f"{loss:.4f}, gradients finite, {ms:.1f} ms on {gpu_name}")
        aux_launches = launches
        del m
    del model, plain
    return {"configurations_drop_eval": eval_launches,
            "configurations_drop_aux": aux_launches}


def fp32_kernel_rows(torch, dev, rng):
    """(b) Kernels 1-12 on fp32 tokens (x, dy; the attention cores' q, k, v)
    against their plain versions on the same operands, at the shapes of
    phase 1: kernel 1 at the text tower's 8 x 16 x 512 x 64 (padded;
    unpadded and the fusion stacks' shapes beside it, outside the row's
    sums; the library call SDPA in fp32), kernels 2 and 3 at every stage of
    a 64-face pack (then with keep at 150 images, checked only), kernels 4-6
    at every stage of 150 images, kernels 7-10 at the 7 stage shapes of a
    64-face pack, kernel 11 at its 3 transitions, kernel 12 at stages 0-2
    both ways.  The bound takes the FLOPs at TF32's rate for kernels 1 and
    8-10 and at bf16's for kernels 2-7 and 11, whose products keep bf16
    operands.  Kernels 8-11 are also run through their former bf16 boundary
    (fp32_below_boundary).  Returns the rows as phase_kernels does."""
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

    b, h, s, d = 8, 16, 512, 64
    bias = np.zeros((b, s), np.float32)
    for i in range(b - 1):
        bias[i, rng.integers(200, s):] = -1e30
    bias[-1] = -1e30
    q, k, v = (f32(rng.normal(size=(b, h, s, d)) * scale)
               for scale in (d ** -0.5, 1.0, 1.0))
    bias_t = f32(bias)
    for label, bias_k, summed in ((f"fp32 {b}x{h}x{s}x{d}", bias_t, True),
                                  (f"fp32 {b}x{h}x{s}x{d} no padding",
                                   torch.zeros_like(bias_t), False)):
        mask = bias_k[:, None, None, :]
        compare(torch, "fused_attention", attention.fused_attention_cuda,
                attention.fused_attention_plain, (q, k, v, bias_k), results,
                flops=4.0 * b * h * s * s * d, label=label, summed=summed,
                bitwise=True, peak_flops=PEAK_TF32_FLOPS,
                library=lambda mask=mask: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, scale=1.0))
    for what, sq, sk in (("audio tower", 157, 157), ("crossmodal", 38, 157)):
        fbias = np.zeros((8, sk), np.float32)
        for i in range(8):
            fbias[i, rng.integers(sk // 2, sk + 1):] = -10000.0
        fq = f32(rng.normal(size=(8, 12, sq, 64)) * 0.125)
        fk, fv = (f32(rng.normal(size=(8, 12, sk, 64))) for _ in range(2))
        compare(torch, "fused_attention", attention.fused_attention_cuda,
                attention.fused_attention_plain, (fq, fk, fv, f32(fbias)),
                results, flops=4.0 * 8 * 12 * sq * sk * 64, summed=False,
                label=f"fp32 {what} 8x12x{sq}x{sk}x64",
                peak_flops=PEAK_TF32_FLOPS)

    def block_args(w, c, heads, res, shifted):
        rel = rng.normal(size=(1, heads, 49, 49)) * 0.5
        mask = (shifted_window_mask(res, res, 7, 3)[:, None] if shifted
                else np.zeros((1, 1, 49, 49)))
        return (f32(rng.normal(size=(w, 49, c))),
                bf(1 + 0.1 * rng.normal(size=c)), bf(0.1 * rng.normal(size=c)),
                bf(rng.normal(size=(3 * c, c)) / np.sqrt(c)),
                bf(0.1 * rng.normal(size=3 * c)),
                bf(rng.normal(size=(c, c)) / np.sqrt(c)),
                bf(0.1 * rng.normal(size=c)), f32(rel + mask))

    def mlp_args(t, c):
        return (f32(rng.normal(size=(t, c))), bf(1 + 0.1 * rng.normal(size=c)),
                bf(0.1 * rng.normal(size=c)),
                bf(rng.normal(size=(4 * c, c)) / np.sqrt(c)),
                bf(0.1 * rng.normal(size=4 * c)),
                bf(rng.normal(size=(c, 4 * c)) / np.sqrt(4 * c)),
                bf(0.1 * rng.normal(size=c)))

    def image_keep(images, repeat):
        per_image = (rng.random(images) > 0.3) / 0.7
        return f32(per_image).repeat_interleave(repeat).contiguous()

    for stage, (res, c, heads) in enumerate(SWIN_STAGES):
        nw = (res // 7) ** 2
        for shifted in ((False, True) if res > 7 else (False,)):
            compare(torch, "fused_attention_block",
                    fused_block.fused_attention_block_cuda,
                    fused_block.fused_attention_block_plain,
                    block_args(FACES * nw, c, heads, res, shifted), results,
                    flops=attn_block_flops(FACES * nw, 49, c, False),
                    bitwise=True,
                    label=f"fp32 stage {stage} W={FACES * nw} C={c} "
                          f"h={heads} {'shifted' if shifted else 'unshifted'}")
        t = FACES * res * res
        compare(torch, "fused_ln_mlp_residual",
                block_mlp.fused_ln_mlp_residual_cuda,
                block_mlp.fused_ln_mlp_residual_plain, mlp_args(t, c), results,
                flops=mlp_flops(t, c, False), bitwise=True,
                label=f"fp32 stage {stage} T={t} C={c}")
        w, t = AUX_IMAGES * nw, AUX_IMAGES * res * res
        compare(torch, "fused_attention_block",
                fused_block.fused_attention_block_cuda,
                fused_block.fused_attention_block_plain,
                (*block_args(w, c, heads, res, res > 7),
                 image_keep(AUX_IMAGES, nw)), results, flops=0, timed=False,
                label=f"fp32 stage {stage} W={w} C={c} with keep",
                bitwise=True)
        compare(torch, "fused_ln_mlp_residual",
                block_mlp.fused_ln_mlp_residual_cuda,
                block_mlp.fused_ln_mlp_residual_plain,
                (*mlp_args(t, c), image_keep(AUX_IMAGES, res * res)), results,
                flops=0, timed=False, bitwise=True,
                label=f"fp32 stage {stage} T={t} C={c} with keep")
        torch.cuda.empty_cache()

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
        cases = (((False, False, True), (True, True, True),
                  (False, True, False), (True, False, False)) if res > 7
                 else ((False, False, True), (False, True, False)))
        for shifted, keep, timed in cases:
            x, *params = block_args(w, c, heads, res, shifted)
            args = (x, f32(rng.normal(size=(w, 49, c))), *params[:5],
                    params[6], image_keep(AUX_IMAGES, nw) if keep else None)
            compare(torch, name, kernel, plain, args, results,
                    flops=attn_block_flops(w, 49, c, True),
                    out_names=ATTN_BWD_NAMES, timed=timed, bitwise=True,
                    label=f"fp32 stage {stage} W={w} C={c} h={heads} "
                          f"{'shifted' if shifted else 'unshifted'}"
                          f"{' with keep' if keep else ''}")
        for keep, timed in ((False, True), (True, False)):
            x, *params = mlp_args(t, c)
            args = (x, f32(rng.normal(size=(t, c))), *params[:5],
                    image_keep(AUX_IMAGES, res * res) if keep else None)
            compare(torch, "fused_ln_mlp_residual_bwd",
                    block_mlp.fused_ln_mlp_residual_bwd_cuda,
                    block_mlp.fused_ln_mlp_residual_bwd_plain, args, results,
                    flops=mlp_flops(t, c, True), out_names=MLP_BWD_NAMES,
                    timed=timed, bitwise=True,
                    label=f"fp32 stage {stage} T={t} C={c}"
                          f"{' with keep' if keep else ''}")
        torch.cuda.empty_cache()

    # kernel 7: the whole block at every stage shape of a 64-face pack; bit
    # for bit kernel 2 then kernel 3 on the same fp32 tokens (the split,
    # timed beside it)
    for stage, (res, c, heads) in enumerate(SWIN_STAGES):
        nw = (res // 7) ** 2
        for shifted in ((False, True) if res > 7 else (False,)):
            w = FACES * nw
            args = (*block_args(w, c, heads, res, shifted),
                    *mlp_args(1, c)[1:])
            label = (f"fp32 stage {stage} W={w} C={c} h={heads} "
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
                *args[8:]).view(w, 49, c)
            if not torch.equal(fused_block.fused_whole_block_cuda(*args),
                               split()):
                raise AssertionError(f"fused_whole_block {label}: not bit "
                                     f"for bit kernel 2 then kernel 3")
            entry = results["fused_whole_block"]["shapes"][-1]
            entry["split_ms"] = cuda_ms(torch, split, reps=KERNEL_REPS)
            entry["split_device_ms"] = device_ms(torch, split)
            print(f"kernel fused_whole_block {label}: bit for bit kernel 2 "
                  f"then kernel 3 on the same fp32 tokens, the split "
                  f"{entry['split_ms']:.4f} ms "
                  f"({fmt_ms(entry['split_device_ms'])} on the device alone)")
        torch.cuda.empty_cache()

    # kernels 8, 9, 10 at every stage shape of a 64-face pack with the bf16
    # bias; the library call SDPA in fp32 with the bias as attn_mask
    n, hd = 49, 32
    for stage, (res, c, heads) in enumerate(SWIN_STAGES):
        w = FACES * (res // 7) ** 2
        for nw in (((res // 7) ** 2, 1) if res > 7 else (1,)):
            rel = rng.normal(size=(1, heads, n, n)) * 0.5
            mask = shifted_window_mask(res, res, 7, 3)[:, None] if nw > 1 else 0
            q, k, v = (f32(rng.normal(size=(w, heads, n, hd)) * scale)
                       for scale in (hd ** -0.5, 1.0, 1.0))
            bias = f32(rel + mask).to(torch.bfloat16)
            sdpa = [t.view(w // nw, nw * heads, n, hd) for t in (q, k, v)]
            sdpa_mask = bias.float().view(1, nw * heads, n, n)
            label = f"fp32 stage {stage} W={w} h={heads} nW={nw}"
            for name in WINDOW_KERNELS:
                kernel = getattr(window_attention, name + "_cuda")
                compare(torch, name, kernel,
                        window_attention.window_attention_plain,
                        (q, k, v, bias), results,
                        flops=4.0 * w * heads * n * n * hd, label=label,
                        bitwise=True, peak_flops=PEAK_TF32_FLOPS,
                        library=lambda: F.scaled_dot_product_attention(
                            *sdpa, attn_mask=sdpa_mask, scale=1.0))
                fp32_below_boundary(
                    torch, name, label, results, kernel(q, k, v, bias),
                    kernel(*map(bf16_boundary, (q, k, v)), bias),
                    window_attention.window_attention_plain(q, k, v, bias))
        torch.cuda.empty_cache()

    # kernel 11 at the three stage transitions of a 64-face pack; no single
    # PyTorch call computes it: layer_norm + linear in fp32, two calls, are
    # timed for information
    for stage, (res, c, _) in enumerate(SWIN_STAGES[:-1]):
        rows = (res // 2) ** 2
        args = (f32(rng.normal(size=(FACES, rows, 4 * c))),
                bf(1 + 0.1 * rng.normal(size=4 * c)),
                bf(0.1 * rng.normal(size=4 * c)),
                bf(rng.normal(size=(4 * c, 2 * c)) / np.sqrt(4 * c)))
        label = f"fp32 transition {stage} T={FACES * rows} 4C={4 * c}"
        compare(torch, "fused_merge", merge_kernel.fused_merge_cuda,
                merge_kernel.fused_merge_plain, args, results,
                flops=2.0 * FACES * rows * 4 * c * 2 * c, label=label,
                bitwise=True)
        fp32_below_boundary(
            torch, "fused_merge", label, results,
            merge_kernel.fused_merge_cuda(*args),
            merge_kernel.fused_merge_cuda(bf16_boundary(args[0]), *args[1:]),
            merge_kernel.fused_merge_plain(*args))
        x, gamma, beta = args[0], args[1].float(), args[2].float()
        wt = args[3].float().t().contiguous()
        two_calls = lambda: F.linear(
            F.layer_norm(x, (4 * c,), gamma, beta, 1e-5), wt)
        print(f"kernel fused_merge {label}: F.layer_norm + F.linear (two "
              f"library calls, fp32) "
              f"{cuda_ms(torch, two_calls, reps=KERNEL_REPS):.4f} ms "
              f"({fmt_ms(device_ms(torch, two_calls))} on the device alone)")

    # kernel 12 on fp32 rows: stages 0-2 both ways, bit for bit the index
    # gather, which is its library call
    for stage, (res, c, _) in enumerate(SWIN_STAGES[:-1]):
        x = f32(rng.normal(size=(FACES, res * res, c)))
        for inverse, idx in zip((False, True),
                                shifted_window_perms(res, res, 7, 3)):
            idx = torch.from_numpy(idx).to(dev)
            kernel = lambda x, inverse=inverse: shift_permute.shift_permute_cuda(
                x, res, res, 7, 3, inverse)
            plain = lambda x, inverse=inverse: shift_permute.shift_permute_plain(
                x, res, res, 7, 3, inverse)
            compare(torch, "shift_permute", kernel, plain, (x,), results,
                    flops=0, library=lambda: x.index_select(1, idx),
                    label=f"fp32 stage {stage} B={FACES} L={res * res} C={c} "
                          f"{'inverse' if inverse else 'forward'}")
            if not torch.equal(kernel(x), x.index_select(1, idx)):
                raise AssertionError(f"shift_permute fp32 stage {stage}: not "
                                     f"bit for bit the index gather")
        torch.cuda.empty_cache()
    for r in results.values():
        r["bound_by"] = ("operations" if r.pop("flops_ms") >= r.pop("bytes_ms")
                         else "bytes")
    return results


def bf16_boundary(t):
    """The tokens as kernels 1-11 took them before they had an fp32
    instantiation: cast to bf16 at the boundary (the Functions cast the
    result back to the tokens' dtype)."""
    return t.detach().bfloat16().contiguous()


def fp32_below_boundary(torch, name, label, results, got, before, want):
    """A kernel's fp32 output `got` nearer its fp32 plain version `want`
    than `before`, the same call through the former bf16 boundary; both
    errors printed (of max|plain|) and kept on the shape's entry."""
    scale = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    err_before = float((before.float() - want.float()).abs().max())
    if not err < err_before:
        raise AssertionError(f"{name} {label}: fp32 max|d| {err} not below "
                             f"the former bf16 boundary's {err_before}")
    results[name]["shapes"][-1].update(
        rel_err=err / scale, bf16_boundary_rel_err=err_before / scale)
    print(f"kernel {name} {label}: max|d|/max|plain| {err / scale:.3g} in "
          f"fp32, {err_before / scale:.3g} through the former bf16 boundary")


def hold_fp32_pack(finite, diff, diff_before, scale):
    """The float32 pack's centred logits within FP32_BOUND of the CPU's,
    and the former bf16 boundary's reading above that bound."""
    if not (finite and diff <= FP32_BOUND * scale < diff_before):
        raise AssertionError(
            f"float32 pack vs CPU fp32: centred logits max|d| {diff} (the "
            f"former bf16 boundary {diff_before}) against {FP32_BOUND} * "
            f"{scale}")


def hold_fp32_route(finite, diff, scale, fer_diff, fer_before):
    """A float32 pack on a window-attention route: its centred logits
    within FP32_BOUND of the CPU's, and its faces' Swin logits nearer the
    CPU's than through the cores' former bf16 boundary."""
    if not (finite and diff <= FP32_BOUND * scale and fer_diff < fer_before):
        raise AssertionError(
            f"float32 route pack vs CPU fp32: centred logits max|d| {diff} "
            f"against {FP32_BOUND} * {scale}; Swin logits max|d| {fer_diff} "
            f"(the former bf16 boundary {fer_before})")


def configurations_float32(torch, dev, gpu_name, cfg, reference=None):
    """(b) The model under --compute_dtype float32 on the card.  One (8, 64)
    eval pack of `cfg` (EmotionServer in fp32, deterministic gumbel): kernels
    1 / 2 / 3 launched exactly 24 / 12 / 12 times, its centred logits within
    FP32_BOUND of the same weights in fp32 on the CPU (`reference`: phase
    4's pack, weights and CPU answer; made here when None); the same pack
    through the former bf16 boundary (bf16_boundary) printed beside it and
    held above the bound.  The same pack and weights on each of
    FP32_ROUTES (float32_route_pack).  One auxiliary step in fp32 (kernels
    2-6 exactly AUX_STEP_LAUNCHES) and one on FP32_AUX_ROUTE (kernel 8 once
    a block), one target step in fp32 (TARGET_STEP_LAUNCHES), finite
    losses, their times."""
    from unittest import mock

    from facialmmt_tpu_torch.config import RuntimeConfig
    from facialmmt_tpu_torch.data.meld import SyntheticMeldDataset
    from facialmmt_tpu_torch.models.pipeline import build_pipeline
    from facialmmt_tpu_torch.ops import kernels
    from facialmmt_tpu_torch.serving import EmotionServer
    from facialmmt_tpu_torch.train.optim import MultiTaskState
    from facialmmt_tpu_torch.train.steps import make_multimodal_train_step
    from facialmmt_tpu_torch.train.trainer import Trainer

    det = cfg.replace(runtime=RuntimeConfig(deterministic_gumbel=True))
    fp32_server = lambda sd, device, c=det: EmotionServer(
        c, {k: (v.float() if v.is_floating_point() else v)
            for k, v in sd.items()}, max_batch=8, face_capacity=FACES,
        dtype=torch.float32, transfer_dtype=np.float32, device=device)
    if reference is None:
        server = EmotionServer(cfg, max_batch=8, face_capacity=FACES,
                               device=dev)
        reference = {"requests": synthetic_requests(
            np.random.default_rng(0), cfg, [8] * 8, 512),
            "state_dict": {k: v.cpu() for k, v in
                           server.model.state_dict().items()}}
        del server
        host = fp32_server(reference["state_dict"], "cpu")
        reference["probs"] = host.predict_raw(
            *host.build_pack(reference["requests"]))
        del host
    card = fp32_server(reference["state_dict"], dev)
    batch, faces = card.build_pack(reference["requests"])
    kernels.reset_launch_counts()
    got = card.predict_raw(batch, faces)
    sync(torch)
    pack_launches = kernels.launch_counts()
    require_counts(pack_launches, exactly(pack_launches, PACK_LAUNCHES),
                   "the float32 (8, 64) pack")
    with mock.patch.object(kernels, "token_operand", bf16_boundary):
        before = card.predict_raw(batch, faces)
    t_pack = card.benchmark_latency(5)["p50_ms"]
    del card
    centred = lambda p: (np.log(p.astype(np.float64))
                         - np.log(p.astype(np.float64)).mean(-1,
                                                             keepdims=True))
    z_want = centred(reference["probs"])
    scale = float(np.abs(z_want).max())
    diff = float(np.abs(centred(got) - z_want).max())
    diff_before = float(np.abs(centred(before) - z_want).max())
    hold_fp32_pack(np.isfinite(centred(got)).all(), diff, diff_before, scale)
    print(f"configurations: --compute_dtype float32, one (8, 64) pack on the "
          f"card vs the same weights in fp32 on the CPU: centred logits "
          f"max|d| {diff:.3g} = {diff / scale:.3g} of max|logit| {scale:.3g} "
          f"<= FP32_BOUND {FP32_BOUND} (SERVING_BOUND {SERVING_BOUND}); the "
          f"same pack through the former bf16 boundary of kernels 1-6: "
          f"{diff_before:.3g} = {diff_before / scale:.3g} of max|logit|; "
          f"launches {pack_launches}; benchmark_latency(5) p50 "
          f"{t_pack:.2f} ms on {gpu_name}")
    route_paths = {}
    for route, core in FP32_ROUTES:
        route_paths[f"configurations_fp32_pack_{route[0]}"] = \
            float32_route_pack(torch, dev, gpu_name, fp32_server,
                               swin_route(det, route), reference, core,
                               centred)

    f32cfg = cfg.replace(runtime=dataclasses.replace(cfg.runtime,
                                                     compute_dtype="float32"))
    images, labels = aux_batch(torch, dev, cfg)
    model = fer_model(torch, dev, f32cfg)
    loss, aux_launches, aux_ms, finite = aux_step(torch, dev, model, images,
                                                  labels, "float32")
    require_counts(aux_launches, exactly(aux_launches, AUX_STEP_LAUNCHES),
                   "the float32 aux step")
    if not (np.isfinite(loss) and finite):
        raise AssertionError(f"float32 aux step: loss {loss}, gradients "
                             f"finite {finite}")
    print(f"configurations: --compute_dtype float32 aux step ({AUX_IMAGES} "
          f"images): kernels 2-6 launched {aux_launches['fused_attention_block']}"
          f" / {aux_launches['fused_ln_mlp_residual']} / "
          f"{aux_launches['fused_ln_mlp_residual_bwd']} / "
          f"{aux_launches['fused_attention_block_bwd']} / "
          f"{aux_launches['fused_attention_block_bwd_spill']} times, loss "
          f"{loss:.4f}, gradients finite, forward + backward {aux_ms:.1f} ms "
          f"(first call) on {gpu_name}")
    del model
    model = fer_model(torch, dev, swin_route(f32cfg, FP32_AUX_ROUTE))
    loss, route_aux, aux_ms, finite = aux_step(torch, dev, model, images,
                                               labels, "float32")
    require_counts(route_aux, exactly(route_aux, {
        "fused_window_attention": sum(cfg.swin.depths)}),
        f"the float32 aux step on {FP32_AUX_ROUTE}")
    if not (np.isfinite(loss) and finite):
        raise AssertionError(f"float32 aux step on {FP32_AUX_ROUTE}: loss "
                             f"{loss}, gradients finite {finite}")
    print(f"configurations: --compute_dtype float32 aux step ({AUX_IMAGES} "
          f"images) on the Swin route {FP32_AUX_ROUTE}: fused_window_attention "
          f"launched {route_aux['fused_window_attention']} times and no other "
          f"kernel, loss {loss:.4f}, gradients finite, forward + backward "
          f"{aux_ms:.1f} ms (first call) on {gpu_name}")
    del model

    tcfg = f32cfg.replace(optim=dataclasses.replace(
        cfg.optim, trg_batch_size=4, trg_accumulation_steps=1))
    trainer = Trainer(tcfg, device=dev)
    model = build_pipeline(tcfg, dev).float()
    state = MultiTaskState.create(model, tcfg.optim, 10, 10)
    step = make_multimodal_train_step(model, compute_dtype="float32")
    ds = SyntheticMeldDataset(tcfg, 4, 2, [8, 7, 9, 8], seed=12,
                              split="train")
    batch = trainer._prepare_faces(trainer._batch_with_escalation(
        lambda cap: ds.get_batch(range(4), face_capacity=cap),
        trainer._face_buckets(4)), train=True)
    gen = torch.Generator(dev).manual_seed(9)
    times = []
    for _ in range(3):
        kernels.reset_launch_counts()
        loss, ms = timed_ms(torch, lambda: float(step(state, batch, gen)))
        times.append(ms)
        trg_launches = kernels.launch_counts()
        require_counts(trg_launches, exactly(trg_launches, {
            **TARGET_STEP_LAUNCHES, ADD_LN: 0}), "the float32 target step")
        if not np.isfinite(loss):
            raise AssertionError(f"float32 target step: loss {loss}")
    print(f"configurations: --compute_dtype float32 target step (4 "
          f"utterances, full step with AdamW): loss {loss:.4f}, "
          f"{times[0]:.1f} ms first, {statistics.median(times[1:]):.1f} ms "
          f"after; launches {trg_launches} on {gpu_name}")
    del model, state, trainer
    return {"configurations_fp32_pack": pack_launches, **route_paths,
            "configurations_fp32_aux": aux_launches,
            "configurations_fp32_aux_pallas": route_aux,
            "configurations_fp32_target": trg_launches}


def float32_route_pack(torch, dev, gpu_name, fp32_server, rcfg, reference,
                       core, centred):
    """Phase 16 (d) on one window-attention route: `reference`'s (8, 64)
    pack and weights in fp32 under `rcfg` on the card (kernels 1 / 3 / the
    route's `core` 24 / 12 / 12 times, kernel 2 never) against the same
    route in fp32 on the CPU within FP32_BOUND, and the same pack through
    the cores' former bf16 boundary (q, k, v cast to bf16 at the kernel,
    the output cast back) printed beside it.  The pack's logits weigh its
    64 faces' Swin pass too little to tell the two apart (PERF.md §6),
    so the Swin's own logits of those faces (the auxiliary FER head) are
    held nearer the CPU's than through the former boundary.  Returns the
    pack's launch counts."""
    from unittest import mock

    from facialmmt_tpu_torch.data.image_pipeline import \
        meld_face_eval_transform
    from facialmmt_tpu_torch.ops import kernels
    from facialmmt_tpu_torch.ops.kernels import window_attention

    route = (rcfg.swin.attention_impl, rcfg.swin.mlp_impl,
             rcfg.swin.merge_impl)

    def swin_logits(server, device):
        x = meld_face_eval_transform(
            torch.from_numpy(faces).to(device).float(),
            rcfg.data.swin_img_size)
        with torch.no_grad():
            return server.model.aux_logits(x).float().cpu().numpy()

    host = fp32_server(reference["state_dict"], "cpu", rcfg)
    batch, faces = host.build_pack(reference["requests"])
    want = host.predict_raw(batch, faces)
    fer_want = swin_logits(host, "cpu")
    del host
    card = fp32_server(reference["state_dict"], dev, rcfg)
    kernels.reset_launch_counts()
    got = card.predict_raw(batch, faces)
    sync(torch)
    launches = kernels.launch_counts()
    blocks = sum(rcfg.swin.depths)
    require_counts(launches, exactly(launches, {
        "fused_attention": PACK_LAUNCHES["fused_attention"],
        ADD_LN: PACK_LAUNCHES[ADD_LN],
        "fused_ln_mlp_residual": blocks, core: blocks}),
        f"the float32 (8, 64) pack on {route}")
    fer_got = swin_logits(card, dev)
    operands = window_attention.kernel_operands
    with mock.patch.object(window_attention, "kernel_operands",
                           lambda q, k, v, bias: operands(
                               *map(bf16_boundary, (q, k, v)), bias)):
        before = card.predict_raw(batch, faces)
        fer_before = swin_logits(card, dev)
    t_pack = card.benchmark_latency(5)["p50_ms"]
    del card
    z_want = centred(want)
    scale = float(np.abs(z_want).max())
    diff = float(np.abs(centred(got) - z_want).max())
    diff_before = float(np.abs(centred(before) - z_want).max())
    fer_scale = float(np.abs(fer_want).max())
    fer_diff = float(np.abs(fer_got - fer_want).max()) / fer_scale
    fer_diff_before = float(np.abs(fer_before - fer_want).max()) / fer_scale
    hold_fp32_route(np.isfinite(centred(got)).all(), diff, scale, fer_diff,
                    fer_diff_before)
    print(f"configurations: --compute_dtype float32 on the Swin route "
          f"{route}, one (8, 64) pack on the card vs the same weights and "
          f"route in fp32 on the CPU: centred logits max|d| {diff:.3g} = "
          f"{diff / scale:.3g} of max|logit| {scale:.3g} <= FP32_BOUND "
          f"{FP32_BOUND}, through {core}'s former bf16 boundary "
          f"{diff_before:.3g} = {diff_before / scale:.3g}; the 64 faces' "
          f"Swin logits max|d| {fer_diff:.3g} of max|logit| {fer_scale:.3g}, "
          f"through the former boundary {fer_diff_before:.3g}; launches "
          f"{launches}; benchmark_latency(5) p50 {t_pack:.2f} ms on "
          f"{gpu_name}")
    return launches


def meld_run(torch, argv):
    """`main.run(argv)` for a MELD T+A+V command, watched: (W-F1, launch
    counts, {'eval_batches': the eval loops' batches, 'logits': each eval
    loop's logits, 'losses': each train step's, 'total': s})."""
    from unittest import mock

    from facialmmt_tpu_torch import main as cli
    from facialmmt_tpu_torch.ops import kernels
    from facialmmt_tpu_torch.train.trainer import Trainer
    from facialmmt_tpu_torch.utils import preemption

    seen = {"eval_batches": 0, "logits": [], "losses": []}
    real_eval, real_run = Trainer._eval_multimodal, Trainer.run_multimodal

    def counted_eval(self, eval_step, ds, *args, **kwargs):
        def step(*a, **k):
            seen["eval_batches"] += 1
            return eval_step(*a, **k)

        out = real_eval(self, step, ds, *args, **kwargs)
        seen["logits"].append(out[0])
        return out

    def run_with_losses(self, *args, **kwargs):
        def on_event(name, **info):
            if name in ("aux_step", "trg_step"):
                seen["losses"].append(info["loss"])

        return real_run(self, *args, **kwargs, on_event=on_event)

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with mock.patch.object(Trainer, "_eval_multimodal", counted_eval), \
                mock.patch.object(Trainer, "run_multimodal", run_with_losses):
            f1 = cli.run(argv)
    finally:
        if preemption._guard is not None:      # cli.run installed it
            preemption._guard.uninstall()
    sync(torch)
    seen["total"] = time.perf_counter() - t0
    return f1, kernels.launch_counts(), seen


def meld_card_vs_cpu(torch, dev, gpu_name, cfg, state_dict, ds, what, n=4):
    """One eval batch of the split's first `n` utterances through the
    trainer's eval loop: `cfg`'s compute dtype on the card against the same
    weights in fp32 on the CPU, held on the per-row centred logits at
    SERVING_BOUND."""
    from facialmmt_tpu_torch.train.steps import make_multimodal_eval_step
    from facialmmt_tpu_torch.train.trainer import Trainer

    class FirstUtterances:
        def __len__(self):
            return n

        def __getattr__(self, name):
            return getattr(ds, name)

    got = []
    for device, dtype in ((dev, cfg.runtime.compute_dtype),
                          (torch.device("cpu"), "float32")):
        c = cfg.replace(runtime=dataclasses.replace(cfg.runtime,
                                                    compute_dtype=dtype))
        trainer = Trainer(c, device)
        model = trainer._build_model(state_dict)
        step = make_multimodal_eval_step(
            model, face_chunk=c.runtime.eval_face_chunk, compute_dtype=dtype)
        logits, _ = trainer._eval_multimodal(step, FirstUtterances(), n)
        got.append(logits.astype(np.float64))
        del model, trainer
    z_card, z_cpu = (z - z.mean(-1, keepdims=True) for z in got)
    diff = float(np.abs(z_card - z_cpu).max())
    scale = float(np.abs(z_cpu).max())
    if not (np.isfinite(z_card).all() and diff <= SERVING_BOUND * scale):
        raise AssertionError(f"{what}: card vs CPU fp32 max|d| {diff} > "
                             f"{SERVING_BOUND} * {scale}")
    print(f"configurations: {what}: one eval batch {tuple(got[0].shape)}, "
          f"card {cfg.runtime.compute_dtype} vs CPU fp32: centred logits "
          f"max|d| {diff:.3g} <= {SERVING_BOUND} * {scale:.3g} on {gpu_name}")


def configurations_bert_meld(torch, dev, gpu_name, root, extra=()):
    """(c) MELD T+A+V with --plm_name bert-large (type vocabulary 2, pad 0,
    LayerNorm eps 1e-12, no position offset) through `main.run` at full
    width on phase 9's file sizes, random weights from the seed: --doEval 1
    twice on a released pair (W-F1 and every logit bit for bit; kernel 1
    exactly once per text layer per eval batch), one eval batch against the
    CPU in fp32, then --doEval 0 --num_epochs 1 (2 auxiliary and 2 target
    steps from an Aff-Wild2 tree, validation and test): finite losses,
    kernel 1 only in the eval batches, kernels 4-6 launched."""
    from facialmmt_tpu_torch import main as cli
    from facialmmt_tpu_torch.checkpoint.torch_load import released_state_dict
    from facialmmt_tpu_torch.config import resolve_text_config
    from facialmmt_tpu_torch.data.meld import MeldMultimodalDataset

    plm = "bert-large"
    meld = os.path.join(root, "meld")
    argv = cli_argv(root, *extra, "--plm_name", plm, "--choice_modality",
                    "T+A+V", "--deterministic_gumbel", "1")
    cfg = cli.config_from_args(cli.build_argparser().parse_args(
        argv + ["--doEval", "1"]))
    layers = resolve_text_config(cfg).num_layers
    write_meld_layout(meld, cfg, plm_name=plm)
    test_ds = MeldMultimodalDataset(meld, "test", cli.text_arrays(cfg, "test"))
    cfg = cli._adapt_static_shapes(cfg, test_ds)
    mm_pt, swin_pt = write_released(torch, dev, cfg,
                                    os.path.join(root, "pretrained_model"))
    runs = [meld_run(torch, argv + ["--doEval", "1"]) for _ in range(2)]
    for f1, launches, seen in runs:
        require_counts(launches, {
            "fused_attention": layers * seen["eval_batches"],
            **dict.fromkeys(BACKWARD_KERNELS, 0)}, f"{plm} --doEval 1")
        require_launched(launches, SERVING_KERNELS, f"{plm} --doEval 1")
    (f1, launches, seen), (f1_again, _, seen_again) = runs
    same = (len(seen["logits"]) == len(seen_again["logits"]) == 1
            and np.array_equal(seen["logits"][0], seen_again["logits"][0]))
    if not (np.isfinite(f1) and f1_again == f1 and same):
        raise AssertionError(f"{plm} --doEval 1: W-F1 {f1} then {f1_again}, "
                             f"logits bit for bit {same}")
    print(f"configurations: MELD T+A+V --plm_name {plm} --doEval 1 on "
          f"{len(test_ds)} utterances: W-F1 {f1:.4f}, the second run's "
          f"W-F1 and logits bit for bit; {seen['eval_batches']} eval "
          f"batches, kernel 1 {launches['fused_attention']} = {layers} text "
          f"layers x {seen['eval_batches']}; {seen['total']:.1f} s; "
          f"launches {launches} on {gpu_name}")
    meld_card_vs_cpu(torch, dev, gpu_name, cfg,
                     released_state_dict(mm_pt, swin_pt), test_ds,
                     f"MELD T+A+V {plm}")

    aux_root = os.path.join(root, "affwild")
    fixtures().write_affwild_fixture(aux_root, AFFWILD_VIDEOS, AFFWILD_FRAMES,
                                     seed=22)
    save = os.path.join(root, "saved_bert")
    f1_t, launches_t, seen_t = meld_run(torch, cli_argv(
        root, *extra, "--plm_name", plm, "--choice_modality", "T+A+V",
        "--doEval", "0", "--num_epochs", "1", "--save_Model_path", save,
        "--data_folder", os.path.join(aux_root, "cropped_aligned"),
        "--anno_folder", os.path.join(aux_root, "annos"),
        "--data_list_train", os.path.join(aux_root, "train_list.txt")))
    require_launched(launches_t, SERVING_KERNELS + BACKWARD_KERNELS,
                     f"{plm} training")
    require_counts(launches_t, {
        "fused_attention": layers * seen_t["eval_batches"]},
        f"{plm} training (kernel 1 in the eval batches only)")
    if not (len(seen_t["losses"]) == 4 and np.isfinite(seen_t["losses"]).all()
            and 0.0 <= f1_t <= 1.0):
        raise AssertionError(f"{plm} training: losses {seen_t['losses']}, "
                             f"W-F1 {f1_t}")
    print(f"configurations: MELD T+A+V --plm_name {plm} --doEval 0 "
          f"--num_epochs 1 (random towers from the seed): losses "
          f"{[round(x, 4) for x in seen_t['losses']]}, test W-F1 "
          f"{f1_t:.4f}, kernel 1 {launches_t['fused_attention']} = {layers} "
          f"x {seen_t['eval_batches']} eval batches and none in the steps; "
          f"{seen_t['total']:.1f} s; launches {launches_t} on {gpu_name}")
    shutil.rmtree(save)
    return {"configurations_bert_meld_eval": launches,
            "configurations_bert_meld_train": launches_t}


def configurations_bert_m3ed(torch, dev, gpu_name, root, extra=()):
    """(c) M3ED with --plm_name chinese-roberta-large (M3ED's own tower, a
    BERT architecture) through `main.run` at full width on phase 11's file
    sizes: T trained one epoch, then --doEval 1 twice (macro-F1 equal to
    eval_text_only's, logits bit for bit, the CSV byte for byte) and one
    eval batch against the CPU in fp32; the dialogue model trained one
    epoch, then --doEval 1 once.  Kernel 1 exactly once per text layer per
    eval batch and never in a train step."""
    from facialmmt_tpu_torch import main as cli
    from facialmmt_tpu_torch.data.m3ed import M3edTextDataset
    from facialmmt_tpu_torch.train.trainer import TextTrainer
    from facialmmt_tpu_torch.utils import preemption

    plm = "chinese-roberta-large"
    extra = (*extra, "--plm_name", plm)
    base = cli.config_from_args(cli.build_argparser().parse_args(list(extra)))
    template = write_m3ed_layout(root, base, plm_name=plm)
    runs = AppendixRuns(torch, dev, gpu_name, root, extra, template,
                        tag=f"configurations M3ED {plm}")
    paths = {}
    save = os.path.join(root, "m3ed_t")
    paths["configurations_m3ed_t_train"], _ = runs.train(
        "T", save, "--choice_modality", "T")
    cfg_t = cli.config_from_args(cli.build_argparser().parse_args(
        runs.argv(save, "--choice_modality", "T")))
    t_ds = M3edTextDataset(*cli.m3ed_text_arrays(cfg_t, "", "test"))
    api = TextTrainer(cfg_t, dev).eval_text_only(t_ds, ckpt_dir=save)
    paths["configurations_m3ed_t_eval"], _ = runs.evaluate_twice(
        "T", save, api, "--choice_modality", "T")
    runs.card_vs_cpu("T", TextTrainer, cfg_t, t_ds, save)
    shutil.rmtree(save)
    torch.cuda.empty_cache()

    save = os.path.join(root, "m3ed_dia")
    dia = ("--choice_modality", "T+A+V", "--uttORdia", "dia")
    paths["configurations_m3ed_dia_train"], _ = runs.train(
        "M3ED dia crossmodal", save, *dia)
    try:
        f1, launches, seen = appendix_run(torch, runs.argv(
            save, "--doEval", "1", *dia))
    finally:
        if preemption._guard is not None:
            preemption._guard.uninstall()
    expect_text_kernel(launches, runs.layers * seen["eval_batches"],
                       "M3ED dia --doEval 1")
    if not 0.0 <= f1 <= 1.0:
        raise AssertionError(f"M3ED dia --doEval 1 with {plm}: F1 {f1}")
    print(f"configurations M3ED {plm}: M3ED dia --doEval 1: macro-F1 "
          f"{f1:.4f}, {seen['eval_batches']} eval batches, kernel 1 "
          f"{launches['fused_attention']} = {runs.layers} x "
          f"{seen['eval_batches']}; {seen['total']:.2f} s on {gpu_name}")
    paths["configurations_m3ed_dia_eval"] = launches
    shutil.rmtree(save)
    return paths


def phase_configurations(torch, dev, gpu_name, root, cfg=None, reference=None,
                         extra=(), kernel_rows=True):
    """Phase 16: the configurations of the JAX command line that the
    phases before run on another setting: (a) Swin drop rates on the kernel
    routes (configurations_drop_rates), (b) --compute_dtype float32 with
    kernels 1-12 in the tokens' own dtype (fp32_kernel_rows, unless
    `kernel_rows` is false, and configurations_float32), (c) the
    BERT-architecture text towers (configurations_bert_meld,
    configurations_bert_m3ed) on files written under `root`.  `reference`:
    phase 4's pack, weights and CPU answer (None: made here).  Returns
    (launch counts per path, the fp32 kernel rows)."""
    from facialmmt_tpu_torch.config import FacialMMTConfig

    cfg = cfg or FacialMMTConfig()
    rng = np.random.default_rng(16)
    paths, seconds = {}, {}
    t0 = time.perf_counter()
    paths.update(configurations_drop_rates(torch, dev, gpu_name, cfg))
    seconds["drop rates"] = time.perf_counter() - t0
    rows = {}
    if kernel_rows:
        t0 = time.perf_counter()
        rows = fp32_kernel_rows(torch, dev, rng)
        seconds["fp32 kernels"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    paths.update(configurations_bert_meld(torch, dev, gpu_name, root, extra))
    seconds["bert-large MELD"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    paths.update(configurations_bert_m3ed(torch, dev, gpu_name, root, extra))
    seconds["chinese-roberta-large M3ED"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    paths.update(configurations_float32(torch, dev, gpu_name, cfg, reference))
    seconds["float32 model"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    print(f"configurations: phase 16 in {sum(seconds.values()):.1f} s ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items())
          + f") on {gpu_name}")
    return paths, rows


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
    paths, server, pack_p50_ms, reference = phase_serving(torch, dev, rng,
                                                          gpu_name)
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
        torch.cuda.empty_cache()
        paths.update(phase_appendix(torch, dev, gpu_name, cli_root))
        torch.cuda.empty_cache()
        paths.update(phase_front_end(torch, dev, gpu_name))
        torch.cuda.empty_cache()
        paths.update(phase_remat_mesh(torch, dev, gpu_name))
        torch.cuda.empty_cache()
        paths.update(phase_tooling(torch, dev, gpu_name, cli_root,
                                   pack_p50_ms))
    torch.cuda.empty_cache()
    paths.update(phase_front_mesh(torch, dev, gpu_name))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as conf_root:
        conf_paths, fp32_rows = phase_configurations(
            torch, dev, gpu_name, conf_root, reference=reference)
    paths.update(conf_paths)
    fp32_paths = [p for k, p in conf_paths.items()
                  if k.startswith("configurations_fp32")]

    if json_out:
        os.makedirs(os.path.dirname(os.path.abspath(json_out)), exist_ok=True)
        with open(json_out, "w") as f:
            json.dump({"card": gpu_name, "kernels": results,
                       "launches": paths,
                       "swin_forward_ms_by_route": route_ms,
                       "aux_step_breakdown_ms_peak_gib": run["aux_breakdown"],
                       "swin_blocks_ms_whole_split_pallas_xla": whole_ms,
                       "fp32_kernels": fp32_rows},
                      f, indent=1)
    print(gpu_name)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": sum(p.get(name, 0) for p in paths.values()),
         "launches_by_path": {k: p.get(name, 0) for k, p in paths.items()},
         **{k: v for k, v in results[name].items() if k != "shapes"},
         **({"fp32": {
             "launches": sum(p.get(name, 0) for p in fp32_paths),
             **{k: v for k, v in fp32_rows[name].items() if k != "shapes"}}}
            if name in fp32_rows else {})}
        for name, (src, rep) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.exit(mesh_rank(*sys.argv[2:6]))
    sys.exit(main(*sys.argv[1:2]))
