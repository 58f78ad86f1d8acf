"""Kernel 3 (csrc/block_mlp.cu): a Swin block's MLP half (LN2, fc1 + GELU,
fc2, residual), one launch a block of every Swin forward."""

from perfbench.lib.bounds import swin_stages

DEVICE_KERNELS = ("row_stats_kernel", "tile_gemm_kernel")
COUNTERS = ("fused_ln_mlp_residual",)
MARKER = None


def launches(c, step):
    images = step.get("faces", step.get("images", 0))
    r = c["swin"]["mlp_ratio"]
    out = []
    for res, ch, heads, blocks, nw, n in swin_stages(c["swin"]):
        t = images * res * res
        hidden = int(ch * r)
        flops = 2 * 2.0 * t * ch * hidden
        nbytes = 2 * t * ch * 2 + 2 * ch * hidden * 2 + (hidden + 3 * ch) * 4
        out += [(flops, nbytes)] * blocks
    return out
