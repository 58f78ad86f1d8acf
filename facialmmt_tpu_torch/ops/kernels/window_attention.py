"""Swin window attention core: softmax(q k^T + bias[w % nW]) v per window and
head.

Counterpart of facialmmt_tpu/ops/pallas/window_attention.py and its three
entry points, `fused_window_attention`, `paired_window_attention` and
`fused_window_attention_v2`; the CUDA kernel is csrc/window_attention.cu.
q, k, v are (W, h, N, hd) with q PRE-SCALED; bias (nW, h, N, N) is additive
(relative-position bias plus shifted-window mask), W % nW == 0, and window w
reads bias row w % nW (windows arrive faces-major).  Returns (W, h, N, hd).

The three TPU kernels compute one function and differ in how windows are
tiled onto the matrix unit.  On Hopper they share one device kernel and
differ in the windows a block holds side by side (1, the 2 of a pair, the G of
a group), each window slot on 4 warps of its own; no block-diagonal product
is formed, since its off-diagonal -1e9 blocks have probability exactly 0.
A block owns one head and `conc` consecutive bias rows, holds their bias in
registers, and walks over a chunk of faces with its q, k, v arriving through
the TMA into a ring in shared memory; `launch_plan` is the grid and ring the
kernel gets.  Of the JAX tilings arguments, v2's `group` still sets the
windows side by side and `fused_window_attention`'s `group` the windows a
block takes one after another (0: the plan's); `pairs` selects nothing.

All three store the bias in bf16 (the shift mask's -100 survives that, the
relative-position values are rounded), so the plain version rounds it through
bf16 too; the wrappers cast it, as JAX does, in a device kernel of their own
before the launch.  q, k, v come in bf16 or fp32 (the model's compute dtype):
as the JAX kernels keep q, k, v, the probabilities and out in q's dtype, the
kernel has an instantiation for each (fp32: fp32 tiles, both products on
TF32, fp32 out), and the Functions hand the tokens over in their own dtype
(`kernel_operands`).  Each public function is a torch.autograd.Function whose
forward is the kernel on a CUDA tensor and the plain version on a CPU tensor,
and whose backward differentiates the exact formulation (`_reference`,
unrounded bias) recomputed from the saved q, k, v, bias, as the JAX package
does: neither package has a backward kernel for these.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from facialmmt_tpu_torch.ops import kernels
from facialmmt_tpu_torch.ops.kernels.block_mlp import kernel_operand

MAX_SIDE_BY_SIDE = 4    # windows one block of csrc/window_attention.cu holds
HEAD_DIMS = (16, 32, 64)
ROWS = 64               # window rows, padded
MAX_STAGES = 3          # ring slots a window slot cycles through
SMEM_ALIGN = 1024       # slack that aligns the tiles to the swizzle's repeat
SMEM_LIMIT = 232448     # opt-in shared memory of a Hopper block
MIN_BLOCKS_PER_SM = 2   # the face chunk leaves at least this many blocks a SM
SLOTS_PER_SM = 8        # and, where the shape has the units, window slots
MAX_CHUNK = 5           # faces a block walks at most: longer walks leave a
                        # tail of long blocks (experiments/torch_window_plan.py)


def smem_bytes(hd: int, conc: int, stages: int, elem: int = 2) -> int:
    """csrc/window_attention.cu's smem_bytes: per window slot and ring slot
    three 64-row tiles (q, k, v) of dense hd * elem-byte rows (bf16: 2, fp32:
    4) under the TMA's swizzle and one 8-byte mbarrier, after the slack that
    aligns the tiles to 1024 bytes."""
    return SMEM_ALIGN + conc * stages * (3 * ROWS * elem * hd + 8)


def ring_stages(hd: int, conc: int, elem: int = 2) -> int:
    """The most ring slots, MAX_STAGES at most, that fit a block's shared
    memory: bf16 takes 3, or 2 at hd 64 with 4 windows side by side; fp32
    tiles are twice as large and take down to 1 (hd 64, 3 or 4 windows)."""
    for stages in range(MAX_STAGES, 1, -1):
        if smem_bytes(hd, conc, stages, elem) <= SMEM_LIMIT:
            return stages
    return 1


@dataclasses.dataclass(frozen=True)
class Plan:
    """The grid of one launch.  Windows are read as `faces` rows of
    `per_face` = lcm(nW, conc) windows; block b takes head b % heads, the
    `conc` consecutive windows of row group (b // heads) % row_groups of each
    face, and faces chunk_index * chunk onwards (the last chunk may be
    short), b // (heads * row_groups) being chunk_index.  Unit i of a block's
    walk goes to ring slot i % stages."""
    conc: int
    heads: int
    per_face: int
    faces: int
    chunk: int
    stages: int
    smem: int

    @property
    def row_groups(self) -> int:
        return self.per_face // self.conc

    @property
    def chunks(self) -> int:
        return -(-self.faces // self.chunk)

    @property
    def blocks(self) -> int:
        return self.heads * self.row_groups * self.chunks


def launch_plan(w: int, h: int, hd: int, nw: int, conc: int, sms: int,
                chunk: int = 0, elem: int = 2) -> Plan:
    """The grid and ring of csrc/window_attention.cu for `conc` windows side
    by side.  `chunk` is how many faces a block walks; 0 takes the largest
    that leaves MIN_BLOCKS_PER_SM blocks and SLOTS_PER_SM window slots a SM
    (or one face a block where the shape has fewer units), at most
    MAX_CHUNK, evened out over the chunks.  A longer walk reads a block's
    bias rows for more windows and hides more of a block's start; more
    slots keep more of the card's warps busy, and shorter walks end
    together (experiments/torch_window_plan.py times the choice).  `elem`:
    the tokens' bytes an element, which sets the ring."""
    per_face = math.lcm(nw, conc)
    faces = w // per_face
    if chunk <= 0:
        base = h * (per_face // conc)
        blocks = max(MIN_BLOCKS_PER_SM * sms, -(-SLOTS_PER_SM * sms // conc))
        chunk = min(MAX_CHUNK, max(1, faces // -(-blocks // base)))
        chunk = -(-faces // -(-faces // chunk))
    stages = ring_stages(hd, conc, elem)
    return Plan(conc=conc, heads=h, per_face=per_face, faces=faces,
                chunk=chunk, stages=stages,
                smem=smem_bytes(hd, conc, stages, elem))


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _reference(q, k, v, bias):
    """fp32 scores and softmax, probabilities in v's dtype."""
    w, nw = q.shape[0], bias.shape[0]
    s = torch.einsum("whnd,whmd->whnm", q.float(), k.float())
    s = (s.reshape(w // nw, nw, *s.shape[1:]) + bias.float()[None]).reshape(
        s.shape)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("whnm,whmd->whnd", p, v)


def window_attention_plain(q, k, v, bias):
    """Plain PyTorch version of all three kernels: `_reference` on the bias
    rounded through bf16, as the kernels store it."""
    return _reference(q, k, v, bias.to(torch.bfloat16).float())


def _launch(wrapper, q, k, v, bias, conc: int, chunk: int = 0):
    """Check the operands and launch csrc/window_attention.cu with `conc`
    windows side by side in a block, each block walking `chunk` faces (0:
    the launch plan's): q/k/v all bf16 or all fp32 (out of the same dtype),
    N <= 64, head dim in HEAD_DIMS, 16-byte aligned pointers (the TMA's
    rule); raises on anything else.  The bias is cast to bf16 here, outside
    the kernel."""
    kernels.require(q.is_cuda,
                    f"{q.device} tensor: the kernel takes CUDA tensors")
    kernels.require(q.dim() == 4 and bias.dim() == 4,
                    f"q (W, h, N, hd) / bias (nW, h, N, N) expected, got "
                    f"{tuple(q.shape)} / {tuple(bias.shape)}")
    w, h, n, hd = q.shape
    nw = bias.shape[0]
    dev = q.device
    kernels.require(0 < n <= ROWS and hd in HEAD_DIMS,
                    f"unsupported window shape N={n}, hd={hd}")
    kernels.require(w % nw == 0, f"W={w} is not a multiple of nW={nw}")
    kernels.require(w % math.lcm(nw, conc) == 0 and (nw == 1 or nw % conc == 0),
                    f"W={w}, nW={nw}: {conc} windows side by side need "
                    f"conc | nW (or nW = 1) and conc | W")
    kernels.check_token_dtype("q", q)
    for name, t in (("q", q), ("k", k), ("v", v)):
        kernels.check_cuda_tensor(name, t, q.dtype, (w, h, n, hd), dev)
    kernels.require(tuple(bias.shape) == (nw, h, n, n) and bias.device == dev,
                    f"bias: shape {tuple(bias.shape)} on {bias.device}, "
                    f"expected {(nw, h, n, n)} on {dev}")
    plan = launch_plan(w, h, hd, nw, conc, _sm_count(dev), chunk,
                       q.element_size())
    kernels.require(plan.smem <= kernels.max_shared_memory(dev),
                    f"needs {plan.smem} B of shared memory per block")
    bias = bias.detach().to(torch.bfloat16).contiguous()
    out = torch.empty_like(q)
    kernels.require(out.data_ptr() % 16 == 0, "out: must be 16-byte aligned")
    err = kernels.library().fmmt_window_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        out.data_ptr(), w, h, n, hd, nw, conc, plan.chunk, kernels.is_f32(q),
        kernels.stream_ptr(dev))
    kernels.check_launch(wrapper.__name__, err)
    wrapper.launches += 1
    return out


def fused_window_attention_cuda(q, k, v, bias, group: int = 0):
    """One window slot a block.  `group` keeps the JAX meaning, the windows
    a block takes one after another: here the faces of the block's walk (its
    bias row's window in each), or windows where nW = 1; 0 takes the launch
    plan's chunk.  It need not divide W: the last chunk may be short."""
    return _launch(fused_window_attention_cuda, q, k, v, bias, 1, group)


def _check_pairs(w: int, nw: int) -> None:
    kernels.require(w % 2 == 0 and (nw == 1 or nw % 2 == 0),
                    f"paired windows need an even W and an even (or single) "
                    f"bias group count, got W={w}, nW={nw}")


def paired_window_attention_cuda(q, k, v, bias, pairs: int = 8):
    """The two windows of a pair (2c, 2c+1) side by side in one block, each
    with its own bias row.  W must be even and, when nW > 1, nW even, so a
    pair never straddles a face.  `pairs`, the TPU kernel's pairs per grid
    cell, is accepted and unused: the launch plan sets how many pairs a block
    walks."""
    _check_pairs(q.shape[0], bias.shape[0])
    return _launch(paired_window_attention_cuda, q, k, v, bias, 2)


def _group_size(w: int, nw: int, group: int) -> int:
    """The JAX rule: lower `group` until it divides W and, when nW > 1, nW."""
    g = max(1, min(group, MAX_SIDE_BY_SIDE))
    while w % g or (nw > 1 and nw % g):
        g -= 1
    return g


def fused_window_attention_v2_cuda(q, k, v, bias, group: int = 4):
    """`group` windows (at most 4) side by side in one block, lowered until it
    divides W and, when nW > 1, nW (the JAX rule); the launch plan sets how
    many groups a block walks."""
    g = _group_size(q.shape[0], bias.shape[0], group)
    return _launch(fused_window_attention_v2_cuda, q, k, v, bias, g)


fused_window_attention_cuda.launches = 0
paired_window_attention_cuda.launches = 0
fused_window_attention_v2_cuda.launches = 0


def kernel_operands(q, k, v, bias):
    """What the Functions hand the kernel for CUDA tensors: q, k, v in their
    own dtype (kernels.token_operand; the kernel takes them all of one), the
    bias rounded to bf16 as the kernel stores it."""
    return (*[kernels.token_operand(t) for t in (q, k, v)],
            kernel_operand(bias))


class _WindowAttention(torch.autograd.Function):
    """Forward: `cuda_fn` on CUDA tensors (`kernel_operands`), the plain
    version on CPU tensors.  Backward: torch autograd of `_reference`
    recomputed from the saved inputs, in fp32 outside autocast."""

    @staticmethod
    def forward(ctx, q, k, v, bias, cuda_fn, tiling):
        ctx.save_for_backward(q, k, v, bias)
        if q.is_cuda:
            out = cuda_fn(*kernel_operands(q, k, v, bias), tiling)
        else:
            out = window_attention_plain(q, k, v, bias)
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        return (*kernels.grads_of_recomputed(
            _reference, ctx.saved_tensors, ctx.needs_input_grad, dout),
            None, None)


def fused_window_attention(q, k, v, bias, group: int = 0):
    """CPU tensors -> plain version; CUDA tensors -> the kernel, or raise."""
    return _WindowAttention.apply(q, k, v, bias, fused_window_attention_cuda,
                                  group)


def paired_window_attention(q, k, v, bias, pairs: int = 8):
    """CPU tensors -> plain version; CUDA tensors -> the kernel, or raise.
    Raises on an odd W, or an odd nW > 1 (ops/swin.py sends those shapes to
    fused_window_attention)."""
    _check_pairs(q.shape[0], bias.shape[0])
    return _WindowAttention.apply(q, k, v, bias, paired_window_attention_cuda,
                                  pairs)


def fused_window_attention_v2(q, k, v, bias, group: int = 4):
    """CPU tensors -> plain version; CUDA tensors -> the kernel, or raise."""
    return _WindowAttention.apply(q, k, v, bias,
                                  fused_window_attention_v2_cuda, group)
