"""Kernel 4 (csrc/block_mlp_bwd.cu): the MLP half's backward from x and dy,
one launch a block of the auxiliary step's backward: fc1 recomputed, the
GELU backward, dx, dW1, dW2 (five products of 2 T C 4C).  Bytes: x, dy, dx
in bf16, the bf16 weights read and their gradients written."""

from perfbench.lib.bounds import swin_stages

DEVICE_KERNELS = ("dual_gelu_bwd_kernel", "wgrad_kernel", "sum_rows_kernel",
                  "prep_rows_kernel", "ln_bwd_rows_kernel", "row_stats_kernel",
                  "tile_gemm_kernel")
COUNTERS = ("fused_ln_mlp_residual_bwd",)
MARKER = "dual_gelu_bwd_kernel"


def launches(c, step):
    if step["kind"] != "aux":
        return []
    images = step["images"]
    r = c["swin"]["mlp_ratio"]
    out = []
    for res, ch, heads, blocks, nw, n in swin_stages(c["swin"]):
        t = images * res * res
        hidden = int(ch * r)
        flops = 5 * 2.0 * t * ch * hidden
        nbytes = 3 * t * ch * 2 + 2 * (2 * ch * hidden * 2)
        out += [(flops, nbytes)] * blocks
    return out
