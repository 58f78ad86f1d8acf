"""Kernel 2 (csrc/attention_block.cu): a Swin block's attention half (LN1,
qkv, window attention, proj, residual), one launch a block of every Swin
forward.  Bytes: x and out in bf16, the bf16 weights, the fp32 window bias,
the per-window drop-path multipliers in training."""

from perfbench.lib.bounds import swin_stages

DEVICE_KERNELS = ("window_pass_kernel", "row_stats_kernel",
                  "tile_gemm_kernel")
COUNTERS = ("fused_attention_block",)
MARKER = "window_pass_kernel"


def launches(c, step):
    images = step.get("faces", step.get("images", 0))
    out = []
    for res, ch, heads, blocks, nw, n in swin_stages(c["swin"]):
        w = images * nw
        flops = w * (8.0 * n * ch * ch + 4.0 * n * n * ch)
        nbytes = (2 * w * n * ch * 2 + 4 * ch * ch * 2 + 6 * ch * 4
                  + nw * heads * n * n * 4
                  + (w * 4 if step["kind"] != "serve" else 0))
        out += [(flops, nbytes)] * blocks
    return out
