"""Swin block attention half: x + keep_w * proj(MHA(LN1(x)) + bias[w % nW]).

Counterpart of facialmmt_tpu/ops/pallas/fused_block.py: fused_attention_block
(CUDA kernel csrc/attention_block.cu) and its two backwards, _bwd_impl_pallas
(csrc/attention_block_bwd.cu) and _bwd_impl_spill (csrc/fused_block_bwd.cu).
x (W, N, C) is window-resident (faces-major windows, so window w reads bias
row w % nW).
Weights are in torch Linear layout: wqkv (3C, C) with q|k|v on the output
axis, wproj (C, C).  q is scaled by hd^-0.5 inside.  bias (nW, h, N, N) is the
relative-position bias plus the shifted-window mask; keep (W,) is an optional
per-window stochastic-depth multiplier, which gets no gradient.

`fused_attention_block` is what the model calls: a torch.autograd.Function
that saves only its inputs and recomputes LN1 / qkv / softmax in the
backward.  Forward and backward each take the plain version for CPU tensors
and the kernel for CUDA tensors (operands cast to bf16 at the kernel
boundary, gradients returned in their parameter's dtype).  Which backward
serves a shape is decided in one place, `backward_variant`.

`fused_whole_block` is the WHOLE block, the attention half followed by the
MLP half y + fc2(GELU(fc1(LN2(y)))), in one kernel (csrc/fused_block.cu;
JAX's fused_whole_block).  Its backward differentiates
the plain version recomputed from the saved inputs, as JAX's does: neither
package has a backward kernel for it.  As in the JAX package, SwinBlock keeps
the two halves; nothing in the model calls it.

Bias cotangent: as in the JAX package, ds is summed over ALL windows and
returned in group 0 of an (nW, h, N, N) tensor whose other groups are zero.
The only trainable tensor behind `bias` is the relative-position table, which
is broadcast over the nW groups, so the sum over groups that autograd takes is
exact; the per-group split is lost where nothing reads it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from facialmmt_tpu_torch.ops import kernels


def fused_attention_block_plain(x, gamma, beta, wqkv, bqkv, wproj, bproj,
                                bias, keep=None, eps: float = 1e-5):
    """Plain PyTorch version (the JAX _reference): fp32 LN statistics and
    softmax, matmuls in x's dtype, fp32 residual."""
    w, n, c = x.shape
    nw, h = bias.shape[0], bias.shape[1]
    hd = c // h
    xf = x.float()
    xn = F.layer_norm(xf, (c,), gamma.float(), beta.float(), eps).to(x.dtype)
    qkv = F.linear(xn, wqkv.to(x.dtype), bqkv.to(x.dtype))     # (W, N, 3C)
    qkv = qkv.reshape(w, n, 3, h, hd).permute(2, 0, 3, 1, 4)    # 3, W, h, N, hd
    q, k, v = qkv[0] * hd ** -0.5, qkv[1], qkv[2]
    s = torch.einsum("whnd,whmd->whnm", q.float(), k.float())
    s = s.reshape(w // nw, nw, h, n, n) + bias.float()[None]
    p = torch.softmax(s.reshape(w, h, n, n), dim=-1).to(x.dtype)
    attn = torch.einsum("whnm,whmd->wnhd", p, v).reshape(w, n, c)
    y = F.linear(attn, wproj.to(x.dtype), bproj.to(x.dtype)).float()
    if keep is not None:
        y = y * keep.float().reshape(w, 1, 1)
    return (xf + y).to(x.dtype)


def fused_attention_block_cuda(x, gamma, beta, wqkv, bqkv, wproj, bproj,
                               bias, keep=None, eps: float = 1e-5):
    """Launch csrc/attention_block.cu (four device kernels: LN1 statistics,
    qkv, the windows' attention, proj + residual): bf16 tokens and weights, fp32
    bias/keep, N <= 64, C and the head dim multiples of 16; raises on
    anything else."""
    kernels.require(x.is_cuda,
                    f"{x.device} tensor: the kernel takes CUDA tensors")
    kernels.require(x.dim() == 3 and bias.dim() == 4,
                    f"x (W, N, C) / bias (nW, h, N, N) expected, got "
                    f"{tuple(x.shape)} / {tuple(bias.shape)}")
    w, n, c = x.shape
    nw, h = bias.shape[0], bias.shape[1]
    dev = x.device
    kernels.require(0 < n <= 64 and c % h == 0 and (c // h) % 16 == 0,
                    f"unsupported window shape N={n}, C={c}, heads={h}")
    kernels.require(w % nw == 0, f"W={w} is not a multiple of nW={nw}")
    bf16 = torch.bfloat16
    for name, t, shape in (("x", x, (w, n, c)), ("gamma", gamma, (c,)),
                           ("beta", beta, (c,)), ("wqkv", wqkv, (3 * c, c)),
                           ("bqkv", bqkv, (3 * c,)), ("wproj", wproj, (c, c)),
                           ("bproj", bproj, (c,))):
        kernels.check_cuda_tensor(name, t, bf16, shape, dev)
    kernels.check_cuda_tensor("bias", bias, torch.float32, (nw, h, n, n), dev)
    if keep is not None:
        kernels.check_cuda_tensor("keep", keep, torch.float32, (w,), dev)
    lib = kernels.library()
    smem = lib.fmmt_fused_attention_block_smem(n, c, h)
    kernels.require(smem <= kernels.max_shared_memory(dev),
                    f"needs {smem} B of shared memory per block")
    out = torch.empty_like(x)
    # the kernel's scratch: LN1 statistics per token row, the (W N, 3C) qkv
    # rows and the (W N, C) head outputs
    stats = torch.empty((w * n, 2), dtype=torch.float32, device=dev)
    qkv = torch.empty((w * n, 3 * c), dtype=bf16, device=dev)
    heads = torch.empty((w * n, c), dtype=bf16, device=dev)
    err = lib.fmmt_fused_attention_block(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), wqkv.data_ptr(),
        bqkv.data_ptr(), wproj.data_ptr(), bproj.data_ptr(), bias.data_ptr(),
        None if keep is None else keep.data_ptr(), stats.data_ptr(),
        qkv.data_ptr(), heads.data_ptr(), out.data_ptr(), w, n, c, h, nw, eps,
        kernels.stream_ptr(dev))
    kernels.check_launch("fused_attention_block", err)
    fused_attention_block_cuda.launches += 1
    return out


fused_attention_block_cuda.launches = 0

RESIDENT_MAX_C = 384   # widest C the resident backward serves: the JAX
                       # kernel's VMEM budget (_pick_pairs_bwd) ends there


def backward_variant(c: int) -> str:
    """Which backward serves width C: 'resident' (weight gradients inside the
    kernel; Swin-tiny stages 0-2) or 'spill' (the kernel emits xn / dqkv /
    attn and the weight gradients are K = T products outside; stage 3)."""
    return "resident" if c <= RESIDENT_MAX_C else "spill"


def _attention_chain_bwd(x, dy, gamma, beta, wqkv, bqkv, wproj, bias, keep,
                         eps):
    """The per-window chain both plain backwards share, step by step with
    the kernels' roundings.  Returns fp32/bf16 pieces:
    dx, dgamma, dbeta, dbias_sum (h, N, N), xn, dqkv (W, N, 3C), attn, dyk,
    and the fp32 dq|dk|dv and dy*keep for the bias sums."""
    from facialmmt_tpu_torch.ops.kernels.block_mlp import (_layer_norm_parts,
                                                           layer_norm_backward)

    dt = x.dtype
    w, n, c = x.shape
    nw, h = bias.shape[0], bias.shape[1]
    hd = c // h
    scale = hd ** -0.5
    xh, rstd, xn = _layer_norm_parts(x, gamma, beta, eps)
    xn_b = xn.to(dt)
    qkv = F.linear(xn_b, wqkv.to(dt)).float() + bqkv.float()     # (W, N, 3C)
    heads = lambda t: t.reshape(w, n, h, hd).permute(0, 2, 1, 3)  # W, h, N, hd
    q = heads(qkv[..., :c] * scale).to(dt)
    k = heads(qkv[..., c:2 * c]).to(dt)
    v = heads(qkv[..., 2 * c:]).to(dt)
    s = torch.einsum("whnd,whmd->whnm", q.float(), k.float())
    s = (s.reshape(w // nw, nw, h, n, n) + bias.float()[None]).reshape(
        w, h, n, n)
    pr = torch.softmax(s, dim=-1)                                 # fp32
    pr_b = pr.to(dt)
    attn = torch.einsum("whnm,whmd->whnd", pr_b.float(), v.float())
    attn_b = attn.permute(0, 2, 1, 3).reshape(w, n, c).to(dt)
    dyf = dy.float()
    dyk = dyf if keep is None else dyf * keep.float().reshape(w, 1, 1)
    dyk_b = dyk.to(dt)
    dattn = heads((dyk_b @ wproj.to(dt)).float().to(dt))          # W, h, N, hd
    dpr = torch.einsum("whnd,whmd->whnm", dattn.float(), v.float())
    dv = torch.einsum("whnm,whnd->whmd", pr_b.float(), dattn.float())
    ds = pr * (dpr - (dpr * pr).sum(-1, keepdim=True))
    ds_b = ds.to(dt).float()
    dq = torch.einsum("whnm,whmd->whnd", ds_b, k.float()) * scale
    dk = torch.einsum("whnm,whnd->whmd", ds_b, q.float())
    unheads = lambda t: t.permute(0, 2, 1, 3).reshape(w, n, c)
    dqkv = torch.cat([unheads(dq), unheads(dk), unheads(dv)], dim=-1)  # fp32
    dqkv_b = dqkv.to(dt)
    dxn = (dqkv_b @ wqkv.to(dt)).float()                          # (W, N, C)
    dx_ln, dgamma, dbeta = layer_norm_backward(dxn, xh, rstd, gamma)
    dx = (dyf + dx_ln).to(dt)
    return (dx, dgamma, dbeta, ds.sum(0), xn_b, dqkv_b, attn_b, dyk_b, dqkv,
            dyk)


def _group0(dbias_sum, nw: int):
    """(h, N, N) window-summed bias cotangent -> (nW, h, N, N), group 0."""
    out = dbias_sum.new_zeros((nw,) + tuple(dbias_sum.shape))
    out[0] = dbias_sum
    return out


def _outside_weight_grads(xn_b, dqkv_b, attn_b, dyk_b):
    """The spill variant's weight gradients: K = T products over all rows,
    operands as emitted, fp32 accumulation.  dbqkv sums the rounded dqkv."""
    c = xn_b.shape[-1]
    xn2, dqkv2 = xn_b.reshape(-1, c).float(), dqkv_b.reshape(-1, 3 * c).float()
    dwqkv = dqkv2.t() @ xn2                                       # (3C, C)
    dwproj = dyk_b.reshape(-1, c).float().t() @ attn_b.reshape(-1, c).float()
    return dwqkv, dqkv2.sum(0), dwproj


def fused_attention_block_bwd_plain(x, dy, gamma, beta, wqkv, bqkv, wproj,
                                    bias, keep=None, eps: float = 1e-5):
    """Plain PyTorch version of the resident backward.  Returns (dx in x's
    dtype; fp32 dgamma, dbeta, dwqkv (3C, C), dbqkv, dwproj (C, C), dbproj,
    dbias (nW, h, N, N) in group 0).  The bias sums take the unrounded fp32
    dq|dk|dv and dy*keep, as the kernel does."""
    c = x.shape[-1]
    (dx, dgamma, dbeta, dbias, xn_b, dqkv_b, attn_b, dyk_b, dqkv,
     dyk) = _attention_chain_bwd(x, dy, gamma, beta, wqkv, bqkv, wproj, bias,
                                 keep, eps)
    dwqkv, _, dwproj = _outside_weight_grads(xn_b, dqkv_b, attn_b, dyk_b)
    return (dx, dgamma, dbeta, dwqkv, dqkv.reshape(-1, 3 * c).sum(0), dwproj,
            dyk.reshape(-1, c).sum(0), _group0(dbias, bias.shape[0]))


def fused_attention_block_bwd_spill_plain(x, dy, gamma, beta, wqkv, bqkv,
                                          wproj, bias, keep=None,
                                          eps: float = 1e-5):
    """Plain PyTorch version of the spill backward: the chain emits xn, dqkv
    and attn in x's dtype and the weight gradients are formed from those
    (dbqkv from the rounded dqkv).  Same returns as the resident version."""
    c = x.shape[-1]
    (dx, dgamma, dbeta, dbias, xn_b, dqkv_b, attn_b, dyk_b, _,
     dyk) = _attention_chain_bwd(x, dy, gamma, beta, wqkv, bqkv, wproj, bias,
                                 keep, eps)
    dwqkv, dbqkv, dwproj = _outside_weight_grads(xn_b, dqkv_b, attn_b, dyk_b)
    return (dx, dgamma, dbeta, dwqkv, dbqkv, dwproj,
            dyk.reshape(-1, c).sum(0), _group0(dbias, bias.shape[0]))


def _check_bwd_operands(x, dy, gamma, beta, wqkv, bqkv, wproj, bias, keep):
    kernels.require(x.is_cuda,
                    f"{x.device} tensor: the kernel takes CUDA tensors")
    kernels.require(x.dim() == 3 and bias.dim() == 4,
                    f"x (W, N, C) / bias (nW, h, N, N) expected, got "
                    f"{tuple(x.shape)} / {tuple(bias.shape)}")
    w, n, c = x.shape
    nw, h = bias.shape[0], bias.shape[1]
    dev = x.device
    kernels.require(0 < n <= 64 and c % h == 0 and (c // h) % 16 == 0
                    and c <= 768,
                    f"unsupported window shape N={n}, C={c}, heads={h}")
    kernels.require(w % nw == 0, f"W={w} is not a multiple of nW={nw}")
    bf16 = torch.bfloat16
    for name, t, shape in (("x", x, (w, n, c)), ("dy", dy, (w, n, c)),
                           ("gamma", gamma, (c,)), ("beta", beta, (c,)),
                           ("wqkv", wqkv, (3 * c, c)), ("bqkv", bqkv, (3 * c,)),
                           ("wproj", wproj, (c, c))):
        kernels.check_cuda_tensor(name, t, bf16, shape, dev)
    kernels.check_cuda_tensor("bias", bias, torch.float32, (nw, h, n, n), dev)
    if keep is not None:
        kernels.check_cuda_tensor("keep", keep, torch.float32, (w,), dev)
    return w, n, c, nw, h, dev


def fused_attention_block_bwd_cuda(x, dy, gamma, beta, wqkv, bqkv, wproj,
                                   bias, keep=None, eps: float = 1e-5):
    """Launch csrc/attention_block_bwd.cu (the LN1 statistics, xn and dy *
    keep, the qkv and dattn products, the window pass, dxn, the LN backward,
    the split-T weight-gradient products and their fixed-order sums): bf16
    tokens, gradient and weights, fp32 bias/keep, N <= 64, C <= 384, C and
    the head dim multiples of 16; raises on anything else.  Returns as the
    plain version; two launches give the same bits."""
    w, n, c, nw, h, dev = _check_bwd_operands(x, dy, gamma, beta, wqkv, bqkv,
                                              wproj, bias, keep)
    kernels.require(c <= RESIDENT_MAX_C,
                    f"C={c}: the resident backward takes C <= {RESIDENT_MAX_C}")
    lib = kernels.library()
    smem = lib.fmmt_fused_attention_block_bwd_smem(c, h)
    kernels.require(smem <= kernels.max_shared_memory(dev),
                    f"needs {smem} B of shared memory per block")
    # the products read both weights transposed too (B operands K-major)
    wqkvt, wprojt = wqkv.t().contiguous(), wproj.t().contiguous()
    scratch = torch.empty(
        lib.fmmt_fused_attention_block_bwd_scratch(w, n, c, h, nw),
        dtype=torch.uint8, device=dev)
    dx = torch.empty_like(x)
    f32 = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    dvec, dwqkv, dbqkv = f32(3, c), f32(3 * c, c), f32(3 * c)
    dwproj, dbias = f32(c, c), f32(nw, h, n, n)
    dbias[1:].zero_()
    err = lib.fmmt_fused_attention_block_bwd(
        x.data_ptr(), dy.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        wqkv.data_ptr(), bqkv.data_ptr(), wqkvt.data_ptr(), wprojt.data_ptr(),
        bias.data_ptr(), None if keep is None else keep.data_ptr(),
        scratch.data_ptr(), dx.data_ptr(), dvec.data_ptr(), dwqkv.data_ptr(),
        dbqkv.data_ptr(), dwproj.data_ptr(),
        dbias.data_ptr(),           # group 0 of (nW, h, N, N) is its head
        w, n, c, h, nw, eps, kernels.stream_ptr(dev))
    kernels.check_launch("fused_attention_block_bwd", err)
    fused_attention_block_bwd_cuda.launches += 1
    dgamma, dbeta, dbproj = dvec
    return dx, dgamma, dbeta, dwqkv, dbqkv, dwproj, dbproj, dbias


fused_attention_block_bwd_cuda.launches = 0


def fused_attention_block_bwd_spill_cuda(x, dy, gamma, beta, wqkv, bqkv,
                                         wproj, bias, keep=None,
                                         eps: float = 1e-5):
    """Launch the spill kernel of csrc/fused_block_bwd.cu (same operands, C up
    to 768), then form dwqkv, dbqkv, dwproj and dbproj from what it emitted
    with K = T matmuls and sums over all rows.  The emitted tensors hold 64
    rows per window, rows N..63 zero, so they enter the products as they
    are.  Returns as the plain version."""
    w, n, c, nw, h, dev = _check_bwd_operands(x, dy, gamma, beta, wqkv, bqkv,
                                              wproj, bias, keep)
    lib = kernels.library()
    smem = lib.fmmt_fused_attention_block_bwd_spill_smem(c, h)
    kernels.require(smem <= kernels.max_shared_memory(dev),
                    f"needs {smem} B of shared memory per block")
    dx = torch.empty_like(x)
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=dev)
    dgamma, dbeta, dbias = zeros(c), zeros(c), zeros(nw, h, n, n)
    emit = lambda width: torch.empty((w, 64, width), dtype=torch.bfloat16,
                                     device=dev)
    xn, dqkv, attn = emit(c), emit(3 * c), emit(c)
    err = lib.fmmt_fused_attention_block_bwd_spill(
        x.data_ptr(), dy.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        wqkv.data_ptr(), bqkv.data_ptr(), wproj.data_ptr(), bias.data_ptr(),
        None if keep is None else keep.data_ptr(), dx.data_ptr(),
        dgamma.data_ptr(), dbeta.data_ptr(), dbias.data_ptr(),
        xn.data_ptr(), dqkv.data_ptr(), attn.data_ptr(),
        w, n, c, h, nw, eps, kernels.stream_ptr(dev))
    kernels.check_launch("fused_attention_block_bwd_spill", err)
    fused_attention_block_bwd_spill_cuda.launches += 1
    dyk = dy.float()
    if keep is not None:
        dyk = dyk * keep.reshape(w, 1, 1)
    dwqkv, dbqkv, dwproj = _outside_weight_grads(
        xn, dqkv, attn[:, :n], dyk.to(torch.bfloat16))
    return dx, dgamma, dbeta, dwqkv, dbqkv, dwproj, dyk.sum((0, 1)), dbias


fused_attention_block_bwd_spill_cuda.launches = 0


class FusedAttentionBlock(torch.autograd.Function):
    """x + keep * proj(MHA(LN1(x)) + bias) with a recomputing backward: only
    the inputs are saved."""

    @staticmethod
    def forward(ctx, x, gamma, beta, wqkv, bqkv, wproj, bproj, bias, keep, eps):
        from facialmmt_tpu_torch.ops.kernels.block_mlp import kernel_operand

        params = (gamma, beta, wqkv, bqkv, wproj, bproj)
        if x.is_cuda:
            xk = kernel_operand(x)
            keep = None if keep is None else kernel_operand(keep, torch.float32)
            bias_k = kernel_operand(bias, torch.float32)
            out = fused_attention_block_cuda(
                xk, *[kernel_operand(p) for p in params], bias_k, keep, eps)
        else:
            xk, bias_k = x.detach(), bias.detach()
            out = fused_attention_block_plain(xk, *params, bias_k, keep, eps)
        ctx.save_for_backward(xk, *params, bias_k, keep)
        ctx.eps = eps
        ctx.dtypes = (x.dtype, bias.dtype)
        return out.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        from facialmmt_tpu_torch.ops.kernels.block_mlp import kernel_operand

        xk, gamma, beta, wqkv, bqkv, wproj, bproj, bias, keep = \
            ctx.saved_tensors
        spill = backward_variant(xk.shape[-1]) == "spill"
        if xk.is_cuda:
            fn = (fused_attention_block_bwd_spill_cuda if spill
                  else fused_attention_block_bwd_cuda)
            grads = fn(xk, kernel_operand(dy),
                       *[kernel_operand(p)
                         for p in (gamma, beta, wqkv, bqkv, wproj)],
                       bias, keep, ctx.eps)
        else:
            fn = (fused_attention_block_bwd_spill_plain if spill
                  else fused_attention_block_bwd_plain)
            grads = fn(xk, dy.to(xk.dtype), gamma, beta, wqkv, bqkv, wproj,
                       bias, keep, ctx.eps)
        dx, *dparams, dbias = grads
        dparams = [g.to(p.dtype) for g, p in
                   zip(dparams, (gamma, beta, wqkv, bqkv, wproj, bproj))]
        x_dtype, bias_dtype = ctx.dtypes
        return (dx.to(x_dtype), *dparams, dbias.to(bias_dtype), None, None)


def fused_attention_block(x, gamma, beta, wqkv, bqkv, wproj, bproj, bias,
                          keep=None, eps: float = 1e-5):
    """CPU tensors -> plain versions; CUDA tensors -> the kernels, or raise."""
    return FusedAttentionBlock.apply(x, gamma, beta, wqkv, bqkv, wproj, bproj,
                                     bias, keep, eps)


def fused_whole_block_plain(x, gamma, beta, wqkv, bqkv, wproj, bproj, bias,
                            gamma2, beta2, w1, b1, w2, b2, eps: float = 1e-5):
    """Plain PyTorch version (JAX _whole_reference): the attention half's
    plain version, its output y rounded to x's dtype, then the MLP half's
    plain version on y.  w1 (HID, C) and w2 (C, HID) in torch Linear layout."""
    from facialmmt_tpu_torch.ops.kernels.block_mlp import \
        fused_ln_mlp_residual_plain

    w, n, c = x.shape
    y = fused_attention_block_plain(x, gamma, beta, wqkv, bqkv, wproj, bproj,
                                    bias, None, eps)
    return fused_ln_mlp_residual_plain(y.reshape(w * n, c), gamma2, beta2, w1,
                                       b1, w2, b2, None, eps).reshape(w, n, c)


def fused_whole_block_cuda(x, gamma, beta, wqkv, bqkv, wproj, bproj, bias,
                           gamma2, beta2, w1, b1, w2, b2, eps: float = 1e-5):
    """Launch the whole-block kernel of csrc/fused_block.cu: bf16 tokens and
    weights (w1 (HID, C), w2 (C, HID): what SwinBlock's fc1 / fc2 Linears
    hold), fp32 bias, N <= 64, C and the head dim multiples of 16, HID a
    multiple of 64; raises on anything else."""
    kernels.require(x.is_cuda,
                    f"{x.device} tensor: the kernel takes CUDA tensors")
    kernels.require(x.dim() == 3 and bias.dim() == 4 and w1.dim() == 2,
                    f"x (W, N, C) / bias (nW, h, N, N) / w1 (HID, C) expected, "
                    f"got {tuple(x.shape)} / {tuple(bias.shape)} / "
                    f"{tuple(w1.shape)}")
    w, n, c = x.shape
    nw, h = bias.shape[0], bias.shape[1]
    hid = w1.shape[0]
    dev = x.device
    kernels.require(0 < n <= 64 and c % h == 0 and (c // h) % 16 == 0
                    and hid % 64 == 0,
                    f"unsupported block shape N={n}, C={c}, heads={h}, "
                    f"HID={hid}")
    kernels.require(w % nw == 0, f"W={w} is not a multiple of nW={nw}")
    bf16 = torch.bfloat16
    for name, t, shape in (("x", x, (w, n, c)), ("gamma", gamma, (c,)),
                           ("beta", beta, (c,)), ("wqkv", wqkv, (3 * c, c)),
                           ("bqkv", bqkv, (3 * c,)), ("wproj", wproj, (c, c)),
                           ("bproj", bproj, (c,)), ("gamma2", gamma2, (c,)),
                           ("beta2", beta2, (c,)), ("w1", w1, (hid, c)),
                           ("b1", b1, (hid,)), ("w2", w2, (c, hid)),
                           ("b2", b2, (c,))):
        kernels.check_cuda_tensor(name, t, bf16, shape, dev)
    kernels.check_cuda_tensor("bias", bias, torch.float32, (nw, h, n, n), dev)
    lib = kernels.library()
    smem = lib.fmmt_fused_whole_block_smem(n, c, h)
    kernels.require(smem <= kernels.max_shared_memory(dev),
                    f"needs {smem} B of shared memory per block")
    out = torch.empty_like(x)
    err = lib.fmmt_fused_whole_block(
        *[t.data_ptr() for t in (x, gamma, beta, wqkv, bqkv, wproj, bproj,
                                 bias, gamma2, beta2, w1, b1, w2, b2, out)],
        w, n, c, h, nw, hid, eps, kernels.stream_ptr(dev))
    kernels.check_launch("fused_whole_block", err)
    fused_whole_block_cuda.launches += 1
    return out


fused_whole_block_cuda.launches = 0


class FusedWholeBlock(torch.autograd.Function):
    """The whole Swin block.  Forward: the kernel on CUDA tensors (operands
    cast to bf16, the bias to fp32, at the kernel boundary), the plain version
    on CPU tensors.  Backward: torch autograd of the plain version recomputed
    from the saved inputs, in fp32 outside autocast (JAX's _whole_bwd)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, wqkv, bqkv, wproj, bproj, bias, gamma2,
                beta2, w1, b1, w2, b2, eps):
        from facialmmt_tpu_torch.ops.kernels.block_mlp import kernel_operand

        inputs = (x, gamma, beta, wqkv, bqkv, wproj, bproj, bias, gamma2,
                  beta2, w1, b1, w2, b2)
        ctx.save_for_backward(*inputs)
        ctx.eps = eps
        if x.is_cuda:
            out = fused_whole_block_cuda(
                *[kernel_operand(t, torch.float32 if t is bias
                                 else torch.bfloat16) for t in inputs], eps)
        else:
            out = fused_whole_block_plain(*[t.detach() for t in inputs], eps)
        return out.to(x.dtype)

    @staticmethod
    def backward(ctx, dout):
        grads = kernels.grads_of_recomputed(
            lambda *a: fused_whole_block_plain(*a, ctx.eps),
            ctx.saved_tensors, ctx.needs_input_grad[:14], dout)
        return (*grads, None)


def fused_whole_block(x, gamma, beta, wqkv, bqkv, wproj, bproj, bias, gamma2,
                      beta2, w1, b1, w2, b2, eps: float = 1e-5):
    """CPU tensors -> plain version; CUDA tensors -> the kernel, or raise."""
    return FusedWholeBlock.apply(x, gamma, beta, wqkv, bqkv, wproj, bproj,
                                 bias, gamma2, beta2, w1, b1, w2, b2, eps)
