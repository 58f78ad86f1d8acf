"""Whether two builds of the port's kernels give the same bits.  Needs one
NVIDIA GPU:

    python3 experiments/torch_kernel_bits.py ROOT OUT.pt [BASE.pt]

ROOT is the checkout whose `facialmmt_tpu_torch` is imported (its kernels are
built there); OUT.pt receives the outputs.  With BASE.pt, written by the same
script from another checkout, every output is compared with it bit for bit
and one line per kernel is printed.  Run it twice in one process tree, once
per checkout, so that both see the same card.

The inputs are made from a numpy seed at the shapes the training path gives
the kernels: kernel 2 (the attention half, forward) and kernel 3 (the MLP
half, forward) at stage 1 of a 64-face pack, kernel 6 (the spill backward)
at stage 3 of the 150-image auxiliary batch with a stochastic-depth keep;
kernels 8-10 (the window-attention core's three entry points) at every
stage shape of a 64-face pack, shifted bias and nW = 1 (the first entry
point's outputs whole, with max|d| beside a difference; the others as a
SHA-256 of their bits); then, in bf16, kernel 1 at the text tower's padded
8 x 16 x 512 x 64, kernel 4 (the MLP backward) and kernel 5 (the resident
attention backward) at stage 1 of the auxiliary batch with keep, kernel 7
(the whole block) at stage 1 of a 64-face pack with the shifted bias,
kernel 11 (the merge tail) at transition 0 and kernel 12 (the shift
permutation) at stage 0 both ways.
No kernel of the port adds with atomics, so every output repeats launch
after launch: a difference is the two builds'.
"""

import hashlib
import os
import sys

import numpy as np
import torch


def outputs(root):
    sys.path.insert(0, os.path.abspath(root))
    from facialmmt_tpu_torch.ops.kernels import (attention, block_mlp,
                                                 fused_block, merge_kernel,
                                                 shift_permute,
                                                 window_attention)

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    bf = lambda a: torch.tensor(a).to(dev, torch.bfloat16).contiguous()
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)

    def block(w, n, c, h, nw):
        return (bf(rng.normal(size=(w, n, c))),
                bf(1 + 0.1 * rng.normal(size=c)), bf(0.1 * rng.normal(size=c)),
                bf(rng.normal(size=(3 * c, c)) / np.sqrt(c)),
                bf(0.1 * rng.normal(size=3 * c)),
                bf(rng.normal(size=(c, c)) / np.sqrt(c)),
                bf(0.1 * rng.normal(size=c)),
                f32(rng.normal(size=(nw, h, n, n)) * 0.5))

    out = {}
    out["fused_attention_block"] = (fused_block.fused_attention_block_cuda(
        *block(64 * 16, 49, 192, 6, 16)),)
    c = 192
    mlp = (bf(rng.normal(size=(64 * 784, c))),
           bf(1 + 0.1 * rng.normal(size=c)), bf(0.1 * rng.normal(size=c)),
           bf(rng.normal(size=(4 * c, c)) / np.sqrt(c)),
           bf(0.1 * rng.normal(size=4 * c)),
           bf(rng.normal(size=(c, 4 * c)) / np.sqrt(4 * c)),
           bf(0.1 * rng.normal(size=c)))
    out["fused_ln_mlp_residual"] = (
        block_mlp.fused_ln_mlp_residual_cuda(*mlp),)
    s = block(150, 49, 768, 24, 1)
    dy = bf(rng.normal(size=(150, 49, 768)))
    keep = f32(np.tile([0.0, 1.43], 75))
    out["fused_attention_block_bwd_spill"] = \
        fused_block.fused_attention_block_bwd_spill_cuda(
            s[0], dy, *s[1:6], s[7], keep)
    torch.cuda.synchronize()
    out = {k: [t.cpu() for t in v] for k, v in out.items()}
    for res, heads in ((56, 3), (28, 6), (14, 12), (7, 24)):
        side = res // 7
        w = 64 * side * side
        for nw in ((side * side, 1) if side > 1 else (1,)):
            args = (*(bf(rng.normal(size=(w, heads, 49, 32)) * s)
                      for s in (32 ** -0.5, 1.0, 1.0)),
                    f32(rng.normal(size=(nw, heads, 49, 49))))
            for name in ("fused_window_attention", "paired_window_attention",
                         "fused_window_attention_v2"):
                got = getattr(window_attention, name + "_cuda")(*args)
                out[f"{name} W={w} nW={nw}"] = [
                    got.cpu() if name == "fused_window_attention" else
                    hashlib.sha256(got.view(torch.int16).cpu().numpy()
                                   .tobytes()).hexdigest()]
    bias = np.zeros((8, 512), np.float32)
    for i in range(7):
        bias[i, rng.integers(200, 512):] = -1e30
    bias[-1] = -1e30
    out["fused_attention"] = [attention.fused_attention_cuda(
        *(bf(rng.normal(size=(8, 16, 512, 64)) * s)
          for s in (0.125, 1.0, 1.0)), f32(bias)).cpu()]
    keep = f32(np.tile([0.0, 1.43], 75))
    x, *params = mlp
    t = 150 * 784
    out["fused_ln_mlp_residual_bwd"] = [
        g.cpu() for g in block_mlp.fused_ln_mlp_residual_bwd_cuda(
            bf(rng.normal(size=(t, c))), bf(rng.normal(size=(t, c))),
            *params[:5], keep.repeat_interleave(784))]
    s = block(150 * 16, 49, 192, 6, 16)
    out["fused_attention_block_bwd"] = [
        g.cpu() for g in fused_block.fused_attention_block_bwd_cuda(
            s[0], bf(rng.normal(size=(150 * 16, 49, 192))), *s[1:6], s[7],
            keep.repeat_interleave(16))]
    out["fused_whole_block"] = [fused_block.fused_whole_block_cuda(
        *block(64 * 16, 49, c, 6, 16), *mlp[1:]).cpu()]
    out["fused_merge"] = [merge_kernel.fused_merge_cuda(
        bf(rng.normal(size=(64, 784, 384))), bf(1 + 0.1 * rng.normal(size=384)),
        bf(0.1 * rng.normal(size=384)),
        bf(rng.normal(size=(384, 192)) / np.sqrt(384))).cpu()]
    x = bf(rng.normal(size=(64, 3136, 96)))
    for inverse in (False, True):
        out[f"shift_permute inverse={inverse}"] = [
            shift_permute.shift_permute_cuda(x, 56, 56, 7, 3, inverse).cpu()]
    torch.cuda.synchronize()
    return out


SPILL_NAMES = ("dx", "dgamma", "dbeta", "dwqkv", "dbqkv", "dwproj", "dbproj",
               "dbias")
MLP_BWD_NAMES = ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2")


def main(root, out_path, base_path=None):
    got = outputs(root)
    torch.save(got, out_path)
    if base_path is None:
        return 0
    base = torch.load(base_path)
    for name, tensors in got.items():
        names = (("out",) if len(tensors) == 1 else MLP_BWD_NAMES
                 if name == "fused_ln_mlp_residual_bwd" else SPILL_NAMES)
        same = {n: a == b if isinstance(a, str) else torch.equal(a, b)
                for n, a, b in zip(names, tensors, base[name])}
        line = f"bits: {name} vs {base_path}: " + ", ".join(
            f"{n} {'same' if v else 'differ'}" for n, v in same.items())
        if len(tensors) == 1 and torch.is_tensor(tensors[0]):
            d = (tensors[0].float() - base[name][0].float()).abs().max()
            line += (f" (max|d| {float(d):.3g} = "
                     f"{float(d / base[name][0].float().abs().max()):.3g} of "
                     f"max|base|)")
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:4]))
