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
at stage 3 of the 150-image auxiliary batch with a stochastic-depth keep.
Kernel 6 adds dgamma, dbeta and dbias across windows with fp32 atomics, so
those three can differ from run to run in any build; its other outputs (dx,
and the weight gradients it forms outside) cannot.
"""

import os
import sys

import numpy as np
import torch


def outputs(root):
    sys.path.insert(0, os.path.abspath(root))
    from facialmmt_tpu_torch.ops.kernels import block_mlp, fused_block

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
    return {k: [t.cpu() for t in v] for k, v in out.items()}


SPILL_NAMES = ("dx", "dgamma", "dbeta", "dwqkv", "dbqkv", "dwproj", "dbproj",
               "dbias")


def main(root, out_path, base_path=None):
    got = outputs(root)
    torch.save(got, out_path)
    if base_path is None:
        return 0
    base = torch.load(base_path)
    for name, tensors in got.items():
        names = SPILL_NAMES if len(tensors) > 1 else ("out",)
        same = {n: torch.equal(a, b) for n, a, b in zip(names, tensors,
                                                        base[name])}
        print(f"bits: {name} vs {base_path}: " + ", ".join(
            f"{n} {'same' if v else 'differ'}" for n, v in same.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:4]))
