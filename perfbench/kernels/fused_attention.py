"""Kernel 1 (csrc/attention.cu): the text tower's attention at eval, one
launch a layer over (rows, heads, seq, head_dim) bf16 q, k, v with an fp32
key bias.  Training runs the plain path (attention dropout)."""

DEVICE_KERNELS = ("attention_kernel", "attention_f32_kernel")
COUNTERS = ("fused_attention",)
MARKER = "attention_kernel"


def launches(c, step):
    if step["kind"] != "serve":
        return []
    t = c["text"]
    b, s = step["rows"], step["seq"]
    h, d = t["num_heads"], t["hidden_size"] // t["num_heads"]
    flops = 4.0 * b * h * s * s * d
    nbytes = 4 * b * h * s * d * 2 + b * s * 4
    return [(flops, nbytes)] * t["num_layers"]
