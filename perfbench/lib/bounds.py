"""The least time of a kernel launch on one NVIDIA H100 SXM5 (the bound
arithmetic of the program's chip_smoke.py): the larger of its matmul FLOPs
at the dense bf16 peak and its bytes, each input read once and each output
written once, at the HBM peak."""

from __future__ import annotations

PEAK_BF16_FLOPS = 989.4e12      # NVIDIA data sheet, dense, 700 W
PEAK_HBM_BYTES = 3.35e12        # bytes per second


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)



def swin_stages(s: dict):
    """(resolution, width, heads, blocks, windows per image) of each stage."""
    r = s["img_size"] // s["patch_size"]
    out = []
    for i, depth in enumerate(s["depths"]):
        res = r // 2 ** i
        ws = min(s["window_size"], res)
        out.append((res, s["embed_dim"] * 2 ** i, s["num_heads"][i], depth,
                    (res // ws) ** 2, ws * ws))
    return out
