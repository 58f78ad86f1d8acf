"""Kernels 5 and 6 (csrc/attention_block_bwd.cu, the resident variant for
widths up to 384 and the spill variant above): the attention half's
backward from x and dy, one launch a block of the auxiliary step's
backward: qkv, scores and PV recomputed, dattn, dP, dv, dq, dk, dxn, dWqkv,
dWproj.  Bytes: x, dy, dx in bf16, weights read and their gradients
written, the window bias read and its gradient written in fp32."""

from perfbench.lib.bounds import swin_stages

DEVICE_KERNELS = ("window_bwd_kernel", "wgrad_kernel", "sum_rows_kernel",
                  "prep_rows_kernel", "ln_bwd_rows_kernel", "row_stats_kernel",
                  "tile_gemm_kernel")
COUNTERS = ("fused_attention_block_bwd",
            "fused_attention_block_bwd_spill")
MARKER = "window_bwd_kernel"


def launches(c, step):
    if step["kind"] != "aux":
        return []
    images = step["images"]
    out = []
    for res, ch, heads, blocks, nw, n in swin_stages(c["swin"]):
        w = images * nw
        flops = w * (22.0 * n * ch * ch + 12.0 * n * n * ch)
        nbytes = (3 * w * n * ch * 2 + 2 * (4 * ch * ch * 2)
                  + 2 * nw * heads * n * n * 4)
        out += [(flops, nbytes)] * blocks
    return out
