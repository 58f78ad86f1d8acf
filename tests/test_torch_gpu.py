"""The port's CUDA kernels on the card, and the wrappers' input checks.

This file imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

The `gpu` tests skip without a CUDA device.  Each holds a kernel against its
plain PyTorch version on the same bf16 inputs at max|d| <= 2e-2 * max|out|
per output (both round to bf16 at different points; the JAX suite's kernel
bound).  No kernel adds with atomics: the backwards (kernels 4-6) sum across
blocks in a fixed order, so two launches of any kernel give the same bits.
"""

import dataclasses

import numpy as np
import pytest
import torch

from facialmmt_tpu_torch.ops import kernels
from facialmmt_tpu_torch.ops.kernels import (add_layernorm, attention,
                                             block_mlp, fused_block,
                                             merge_kernel, shift_permute,
                                             window_attention)

BOUND = 2e-2


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


def _rel(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def _attention_inputs(rng, dev, b, h, sq, sk, d):
    q = torch.tensor(rng.normal(size=(b, h, sq, d)) * 0.125)
    k = torch.tensor(rng.normal(size=(b, h, sk, d)))
    v = torch.tensor(rng.normal(size=(b, h, sk, d)))
    bias = np.where(rng.random((b, sk)) > 0.2, 0.0, -1e30)
    bias[-1] = -1e30                  # a fully padded row
    return ([t.to(dev, torch.bfloat16).contiguous() for t in (q, k, v)]
            + [torch.tensor(bias, dtype=torch.float32, device=dev)])


def _block_inputs(rng, dev, w, n, c, h, nw):
    bf = lambda a: torch.tensor(a).to(dev, torch.bfloat16).contiguous()
    bias = rng.normal(size=(nw, h, n, n)) * 0.5
    if nw > 1:
        bias += np.where(rng.random((nw, 1, n, n)) > 0.7, -100.0, 0.0)
    return (bf(rng.normal(size=(w, n, c))),
            bf(rng.normal(size=(c,)) * 0.1 + 1), bf(rng.normal(size=(c,)) * 0.1),
            bf(rng.normal(size=(3 * c, c)) / np.sqrt(c)),
            bf(rng.normal(size=(3 * c,)) * 0.1),
            bf(rng.normal(size=(c, c)) / np.sqrt(c)),
            bf(rng.normal(size=(c,)) * 0.1),
            torch.tensor(bias, dtype=torch.float32, device=dev))


def _mlp_inputs(rng, dev, t, c):
    bf = lambda a: torch.tensor(a).to(dev, torch.bfloat16).contiguous()
    return (bf(rng.normal(size=(t, c))), bf(rng.normal(size=(c,)) * 0.1 + 1),
            bf(rng.normal(size=(c,)) * 0.1),
            bf(rng.normal(size=(4 * c, c)) / np.sqrt(c)),
            bf(rng.normal(size=(4 * c,)) * 0.1),
            bf(rng.normal(size=(c, 4 * c)) / np.sqrt(4 * c)),
            bf(rng.normal(size=(c,)) * 0.1))


def _whole_inputs(rng, dev, w, n, c, h, nw):
    """The attention half's inputs, then gamma2, beta2, w1 (4C, C), b1, w2
    (C, 4C), b2: the whole block's, bf16 (bias fp32)."""
    bf = lambda a: torch.tensor(a).to(dev, torch.bfloat16).contiguous()
    return (*_block_inputs(rng, dev, w, n, c, h, nw),
            bf(rng.normal(size=(c,)) * 0.1 + 1), bf(rng.normal(size=(c,)) * 0.1),
            *_mlp_inputs(rng, dev, 1, c)[3:])


def test_wrappers_refuse_cpu_tensors(rng):
    """A wrapper never quietly runs its plain version: a CPU tensor raises."""
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="CUDA"):
        attention.fused_attention_cuda(*_attention_inputs(rng, cpu, 1, 2, 8,
                                                          8, 16))
    with pytest.raises(ValueError, match="CUDA"):
        fused_block.fused_attention_block_cuda(*_block_inputs(rng, cpu, 2, 16,
                                                              8, 2, 1))
    with pytest.raises(ValueError, match="CUDA"):
        block_mlp.fused_ln_mlp_residual_cuda(*_mlp_inputs(rng, cpu, 5, 8))
    with pytest.raises(ValueError, match="CUDA"):
        fused_block.fused_whole_block_cuda(*_whole_inputs(rng, cpu, 2, 16, 16,
                                                          1, 1))
    with pytest.raises(ValueError, match="CUDA"):
        shift_permute.shift_permute_cuda(torch.zeros(1, 196, 8), 14, 14, 7, 3)
    with pytest.raises(ValueError, match="CUDA"):
        add_layernorm.fused_add_layernorm_cuda(
            torch.zeros(2, 64), torch.zeros(2, 64), torch.ones(64),
            torch.zeros(64), 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("sq,sk,d", [(512, 512, 64), (100, 130, 64),
                                     (38, 157, 32), (20, 20, 16)])
def test_fused_attention_kernel(rng, cuda_device, sq, sk, d):
    args = _attention_inputs(rng, cuda_device, 2, 4, sq, sk, d)
    got = attention.fused_attention_cuda(*args)
    want = attention.fused_attention_plain(*args)
    torch.cuda.synchronize()
    assert _rel(got, want) <= BOUND
    assert torch.isfinite(got).all()   # the fully padded row stays finite


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,sq,sk,d", [
    (2, 4, 1, 512, 64), (2, 4, 1, 1, 16), (2, 4, 100, 130, 32),
    (8, 16, 300, 200, 64), (8, 16, 512, 157, 64)])
def test_fused_attention_kernel_tiles(rng, cuda_device, b, h, sq, sk, d):
    """Sq = 1, Sk not a multiple of the 64-key tile (one key, 130, 200, 157),
    both row tilings (the last two shapes give the grid of 128-row blocks
    that takes 32 rows a warp), a random non-contiguous -1e30 mask and a
    fully padded row: finite, and the uniform softmax, i.e. the mean of v."""
    q, k, v, bias = _attention_inputs(rng, cuda_device, b, h, sq, sk, d)
    got = attention.fused_attention_cuda(q, k, v, bias)
    want = attention.fused_attention_plain(q, k, v, bias)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= BOUND
    mean_v = v[-1].float().mean(dim=1, keepdim=True).expand(h, sq, d)
    torch.testing.assert_close(got[-1].float(), mean_v, atol=1e-3, rtol=1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("n,c,h,nw,keep", [(49, 96, 3, 4, True),
                                           (49, 768, 24, 1, False),
                                           (16, 32, 2, 4, False)])
def test_fused_attention_block_kernel(rng, cuda_device, n, c, h, nw, keep):
    w = 8
    args = _block_inputs(rng, cuda_device, w, n, c, h, nw)
    k = (torch.tensor([0.0, 1.25] * (w // 2), device=cuda_device)
         if keep else None)
    got = fused_block.fused_attention_block_cuda(*args, k)
    want = fused_block.fused_attention_block_plain(*args, k)
    torch.cuda.synchronize()
    assert _rel(got, want) <= BOUND
    if keep:
        assert torch.equal(got[0], args[0][0])   # keep = 0: x passes through


@pytest.mark.gpu
@pytest.mark.parametrize("t,c", [(1000, 96), (3136, 768), (50, 16)])
def test_fused_ln_mlp_residual_kernel(rng, cuda_device, t, c):
    args = _mlp_inputs(rng, cuda_device, t, c)
    got = block_mlp.fused_ln_mlp_residual_cuda(*args)
    want = block_mlp.fused_ln_mlp_residual_plain(*args)
    torch.cuda.synchronize()
    assert _rel(got, want) <= BOUND


@pytest.mark.gpu
@pytest.mark.parametrize("half", ["attention", "mlp"])
def test_stage3_plans_are_right_and_bitwise_repeatable(rng, cuda_device, half):
    """Swin-tiny's last stage at 64 faces, the shapes whose plans split the
    work most (kernel 2: W = 64 windows, C = 768 in 24 heads, 768 attention
    blocks; kernel 3: T = 3136 tokens, C = 768, 24.5 row tiles), with keep:
    within the bound of the plain version, and two launches give the same
    bits (no atomics in either forward)."""
    if half == "attention":
        args = _block_inputs(rng, cuda_device, 64, 49, 768, 24, 1)
        keep = torch.tensor((rng.random(64) > 0.3) / 0.7, dtype=torch.float32,
                            device=cuda_device)
        kernel = fused_block.fused_attention_block_cuda
        plain = fused_block.fused_attention_block_plain
    else:
        args = _mlp_inputs(rng, cuda_device, 3136, 768)
        keep = torch.tensor((rng.random(3136) > 0.3) / 0.7,
                            dtype=torch.float32, device=cuda_device)
        kernel = block_mlp.fused_ln_mlp_residual_cuda
        plain = block_mlp.fused_ln_mlp_residual_plain
    got = kernel(*args, keep)
    again = kernel(*args, keep)
    want = plain(*args, keep)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= BOUND
    assert torch.equal(got, again)


@pytest.mark.gpu
def test_text_layer_gets_gradients_through_kernel_1(cuda_device, monkeypatch):
    """A train-mode text layer with attention dropout 0 sends attention to
    kernel 1; its output carries a gradient to every weight, and the weight
    gradients are within 2e-2 x max of the same layer's with the plain
    attention (autograd through it, autocast off inside it, as in the
    Function's backward: under autocast its fp32 scores would be computed in
    bf16), both layers under bf16 autocast.  The loss is
    linear in the output (a fixed random cotangent), so the two forwards'
    bf16 rounding reaches the gradients only through the saved activations.
    The key bias's gradient is 0 in exact arithmetic (it shifts a query's
    scores by one constant, which the softmax ignores): it is held to the
    bound against the key weight's gradient instead of against its own
    rounding noise."""
    from facialmmt_tpu_torch.config import TextEncoderConfig
    from facialmmt_tpu_torch.models import text_encoder

    cfg = dataclasses.replace(TextEncoderConfig(), hidden_size=256,
                              num_heads=4, intermediate_size=512,
                              hidden_dropout_prob=0.0,
                              attention_probs_dropout_prob=0.0)
    torch.manual_seed(0)
    layer = text_encoder.TextEncoderLayer(cfg).to(cuda_device).train()
    x = torch.randn(2, 100, 256, device=cuda_device)
    cot = torch.randn(2, 100, 256, device=cuda_device)
    bias = torch.zeros(2, 100, device=cuda_device)
    bias[1, 60:] = -1e30

    def weight_grads():
        layer.zero_grad()
        with torch.autocast("cuda", dtype=torch.bfloat16):
            out = layer(x, bias)
        assert out.grad_fn is not None
        (out.float() * cot).sum().backward()
        return {n: p.grad.clone() for n, p in layer.named_parameters()}

    kernels.reset_launch_counts()
    got = weight_grads()
    assert kernels.launch_counts()["fused_attention"] == 1
    def plain(q, k, v, b):
        with torch.autocast("cuda", enabled=False):
            return attention.fused_attention_plain(q, k, v, b)

    monkeypatch.setattr(text_encoder, "fused_attention", plain)
    want = weight_grads()
    assert kernels.launch_counts()["fused_attention"] == 1
    key_bias = "attention.self.key.bias"
    for name, g in got.items():
        assert torch.isfinite(g).all(), name
        if name != key_bias:
            assert _rel(g, want[name]) <= BOUND, (name, _rel(g, want[name]))
    scale = float(want["attention.self.key.weight"].abs().max())
    assert float((got[key_bias] - want[key_bias]).abs().max()) <= BOUND * scale


BWD_NAMES = ("dx", "dgamma", "dbeta", "dwqkv", "dbqkv", "dwproj", "dbproj",
             "dbias")


def _hold_grads(names, got, want, bound=BOUND):
    """Every output within bound * max|want|; a bias cotangent by its group
    sum (only that sum is defined, ops/kernels/fused_block.py)."""
    for name, g, w in zip(names, got, want):
        if name == "dbias":
            g, w = g.sum(0), w.sum(0)
        assert torch.isfinite(g).all(), name
        assert _rel(g, w) <= bound, (name, _rel(g, w))


@pytest.mark.gpu
@pytest.mark.parametrize("w,n,c,h,nw,keep", [
    (16, 49, 96, 3, 4, True), (8, 49, 192, 6, 1, False),
    (8, 49, 384, 12, 4, True), (6, 16, 32, 2, 1, True)],
    ids=["stage0-shifted-keep", "stage1", "stage2-shifted-keep", "tiny-keep"])
def test_fused_attention_block_bwd_kernel(rng, cuda_device, w, n, c, h, nw,
                                          keep):
    args = _block_inputs(rng, cuda_device, w, n, c, h, nw)
    args = (args[0], torch.randn_like(args[0]), *args[1:6], args[7])
    k = (torch.tensor([0.0, 1.25] * (w // 2), device=cuda_device)
         if keep else None)
    got = fused_block.fused_attention_block_bwd_cuda(*args, k)
    want = fused_block.fused_attention_block_bwd_plain(*args, k)
    torch.cuda.synchronize()
    _hold_grads(BWD_NAMES, got, want)
    again = fused_block.fused_attention_block_bwd_cuda(*args, k)
    assert all(torch.equal(a, b) for a, b in zip(again, got))
    assert not got[-1][1:].any()          # everything in bias group 0


@pytest.mark.gpu
@pytest.mark.parametrize("w,n,c,h,nw,keep", [
    (6, 49, 768, 24, 1, True), (8, 49, 384, 12, 4, False),
    (4, 16, 64, 4, 1, False)], ids=["stage3-keep", "stage2-shifted", "tiny"])
def test_fused_attention_block_bwd_spill_kernel(rng, cuda_device, w, n, c, h,
                                                nw, keep):
    """The stage-3 backward, and at the narrower widths it also takes; two
    launches give the same bits."""
    args = _block_inputs(rng, cuda_device, w, n, c, h, nw)
    args = (args[0], torch.randn_like(args[0]), *args[1:6], args[7])
    k = (torch.tensor([0.0, 1.25] * (w // 2), device=cuda_device)
         if keep else None)
    got = fused_block.fused_attention_block_bwd_spill_cuda(*args, k)
    want = fused_block.fused_attention_block_bwd_spill_plain(*args, k)
    torch.cuda.synchronize()
    _hold_grads(BWD_NAMES, got, want)
    again = fused_block.fused_attention_block_bwd_spill_cuda(*args, k)
    assert all(torch.equal(a, b) for a, b in zip(again, got))
    assert not got[-1][1:].any()          # everything in bias group 0


@pytest.mark.gpu
@pytest.mark.parametrize("t,c,keep", [(1000, 96, True), (3136, 768, True),
                                      (6272, 192, False), (1568, 384, False),
                                      (50, 16, True)])
def test_fused_ln_mlp_residual_bwd_kernel(rng, cuda_device, t, c, keep):
    """T = 1000 and 50 are not multiples of the 128-row tile; two
    launches give the same bits."""
    args = _mlp_inputs(rng, cuda_device, t, c)
    args = (args[0], torch.randn_like(args[0]), *args[1:6])
    k = (torch.tensor((rng.random(t) > 0.3) / 0.7, dtype=torch.float32,
                      device=cuda_device) if keep else None)
    names = ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2")
    got = block_mlp.fused_ln_mlp_residual_bwd_cuda(*args, k)
    want = block_mlp.fused_ln_mlp_residual_bwd_plain(*args, k)
    torch.cuda.synchronize()
    _hold_grads(names, got, want)
    again = block_mlp.fused_ln_mlp_residual_bwd_cuda(*args, k)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


SWIN_STAGES = ((56, 96, 3), (28, 192, 6), (14, 384, 12), (7, 768, 24))
MLP_BWD_NAMES = ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2")


def _stage_bwd_args(rng, dev, half, stage, keep, images=150):
    """Kernel 4 ('mlp') or the attention-half backward ('attention': kernel 5
    at stages 0-2, kernel 6 at stage 3, as backward_variant sends them)
    operands at Swin-tiny stage `stage` of an `images`-image batch (the
    shifted blocks' bias), with a per-image stochastic-depth keep or none."""
    res, c, heads = SWIN_STAGES[stage]
    nw = (res // 7) ** 2
    per_image = torch.tensor((rng.random(images) > 0.3) / 0.7,
                             dtype=torch.float32, device=dev)
    if half == "mlp":
        t = images * res * res
        args = _mlp_inputs(rng, dev, t, c)
        args = (args[0], torch.randn_like(args[0]), *args[1:6])
        k = per_image.repeat_interleave(res * res) if keep else None
        return (block_mlp.fused_ln_mlp_residual_bwd_cuda,
                block_mlp.fused_ln_mlp_residual_bwd_plain, MLP_BWD_NAMES,
                (*args, k))
    w = images * nw
    args = _block_inputs(rng, dev, w, 49, c, heads, nw)
    args = (args[0], torch.randn_like(args[0]), *args[1:6], args[7])
    k = per_image.repeat_interleave(nw) if keep else None
    if fused_block.backward_variant(c) == "spill":
        return (fused_block.fused_attention_block_bwd_spill_cuda,
                fused_block.fused_attention_block_bwd_spill_plain, BWD_NAMES,
                (*args, k))
    return (fused_block.fused_attention_block_bwd_cuda,
            fused_block.fused_attention_block_bwd_plain, BWD_NAMES,
            (*args, k))


@pytest.mark.gpu
@pytest.mark.parametrize("keep", [False, True], ids=["nokeep", "keep"])
@pytest.mark.parametrize("half,stage", [("mlp", 0), ("mlp", 1), ("mlp", 2),
                                        ("mlp", 3), ("attention", 0),
                                        ("attention", 1), ("attention", 2),
                                        ("attention", 3)])
def test_backward_kernels_bit_for_bit_at_every_stage(rng, cuda_device, half,
                                                     stage, keep):
    """Kernels 4-6 at every stage shape they serve in a 150-image auxiliary
    step, with and without keep: two launches give the same bits (every
    cross-block sum in a fixed order, no atomics)."""
    kernel, _, _, args = _stage_bwd_args(rng, cuda_device, half, stage, keep)
    got = kernel(*args)
    again = kernel(*args)
    torch.cuda.synchronize()
    assert all(torch.isfinite(g).all() for g in got)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("half,stage", [("mlp", 0), ("attention", 0),
                                        ("attention", 3)],
                         ids=["mlp", "attention", "attention-stage3"])
def test_backward_kernels_write_every_output(rng, cuda_device, monkeypatch,
                                             half, stage):
    """Stage 0 (and stage 3, kernel 6) of a 150-image batch, with keep: every
    tensor the wrapper allocates (outputs and scratch) starts as NaN, so an
    element that no block writes, or a scratch element read before it is
    written, shows as a non-finite output or a miss against the plain
    version."""
    kernel, plain, names, args = _stage_bwd_args(rng, cuda_device, half,
                                                 stage, True)
    want = plain(*args)
    empty, empty_like = torch.empty, torch.empty_like

    def nan_filled(t):
        return t.fill_(255) if not t.is_floating_point() else t.fill_(
            float("nan"))

    monkeypatch.setattr(torch, "empty",
                        lambda *a, **k: nan_filled(empty(*a, **k)))
    monkeypatch.setattr(torch, "empty_like",
                        lambda *a, **k: nan_filled(empty_like(*a, **k)))
    got = kernel(*args)
    torch.cuda.synchronize()
    monkeypatch.undo()
    _hold_grads(names, got, want)


@pytest.mark.gpu
def test_autograd_functions_launch_the_backward_kernels(rng, cuda_device):
    """fp32 parameters, bf16 kernels: backward goes through kernels 4-6 and
    returns every gradient in its parameter's dtype."""
    kernels.reset_launch_counts()
    for c, h, name in ((96, 3, "fused_attention_block_bwd"),
                       (768, 24, "fused_attention_block_bwd_spill")):
        args = [a.float().requires_grad_() for a in
                _block_inputs(rng, cuda_device, 4, 49, c, h, 1)]
        out = fused_block.fused_attention_block(*args)
        out.square().mean().backward()
        assert all(a.grad is not None and a.grad.dtype == torch.float32
                   and torch.isfinite(a.grad).all() for a in args)
        assert kernels.launch_counts()[name] == 1
    args = [a.float().requires_grad_() for a in
            _mlp_inputs(rng, cuda_device, 100, 96)]
    block_mlp.fused_ln_mlp_residual(*args).square().mean().backward()
    assert all(a.grad is not None and a.grad.dtype == torch.float32
               for a in args)
    assert kernels.launch_counts()["fused_ln_mlp_residual_bwd"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("w,c,h,nw", [(32, 96, 3, 16), (16, 192, 6, 1),
                                      (8, 384, 12, 4), (6, 768, 24, 1),
                                      (6, 32, 2, 1)],
                         ids=["stage0-shifted", "stage1", "stage2-shifted",
                              "stage3", "tiny"])
def test_fused_whole_block_kernel(rng, cuda_device, w, c, h, nw, dtype):
    """Every Swin-tiny stage width (LN2's partials: one a row at C = 96, six
    at C = 768; at C = 32 one, over half a 64-column tile): the kernel
    against its plain version and against the split (kernels 2 and 3) on the
    same inputs; two launches give the same bits.  fp32 tokens: out in
    fp32, bit for bit the split (the two halves' fp32 paths in sequence)."""
    args = _whole_inputs(rng, cuda_device, w, 49, c, h, nw)
    if dtype == torch.float32:
        args = _as_f32_tokens(args)
    got = fused_block.fused_whole_block_cuda(*args)
    want = fused_block.fused_whole_block_plain(*args)
    y = fused_block.fused_attention_block_cuda(*args[:8])
    split = block_mlp.fused_ln_mlp_residual_cuda(y.reshape(-1, c), *args[8:])
    again = fused_block.fused_whole_block_cuda(*args)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.isfinite(got).all()
    assert _rel(got, want) <= BOUND
    assert _rel(got, split.reshape(got.shape)) <= BOUND
    if dtype == torch.float32:
        assert torch.equal(got, split.reshape(got.shape))
    assert torch.equal(got, again)


@pytest.mark.gpu
def test_fused_whole_block_backward_is_the_plain_versions(rng, cuda_device):
    """fp32 inputs: the forward launches the kernel once, the backward
    launches nothing and equals autograd of the plain version."""
    args = [a.float().requires_grad_() for a in
            _whole_inputs(rng, cuda_device, 8, 49, 96, 3, 4)]
    dout = torch.randn(8, 49, 96, device=cuda_device)
    kernels.reset_launch_counts()
    out = fused_block.fused_whole_block(*args)
    assert kernels.launch_counts()["fused_whole_block"] == 1
    got = torch.autograd.grad(out, args, dout)
    assert sum(kernels.launch_counts().values()) == 1
    want = torch.autograd.grad(fused_block.fused_whole_block_plain(*args),
                               args, dout)
    for g, w_ in zip(got, want):
        assert g.dtype == torch.float32
        assert _rel(g, w_) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("h,w,c,shift", [(56, 56, 96, 3), (28, 28, 192, 3),
                                         (14, 14, 384, 3), (21, 14, 8, 2),
                                         (14, 21, 5, 4)])
def test_shift_permute_kernel_is_bitwise(rng, cuda_device, dtype, h, w, c,
                                         shift):
    """Both directions and the round trip equal the index gather bit for bit;
    C = 5 takes the element-wise copy (rows of 10 or 20 bytes)."""
    x = torch.tensor(rng.normal(size=(3, h * w, c))).to(cuda_device, dtype)
    fwd = shift_permute.shift_permute_cuda(x, h, w, 7, shift)
    inv = shift_permute.shift_permute_cuda(x, h, w, 7, shift, inverse=True)
    assert torch.equal(fwd, shift_permute.shift_permute_plain(x, h, w, 7,
                                                              shift))
    assert torch.equal(inv, shift_permute.shift_permute_plain(x, h, w, 7,
                                                              shift, True))
    assert torch.equal(
        shift_permute.shift_permute_cuda(fwd, h, w, 7, shift, True), x)


@pytest.mark.gpu
def test_shift_permute_backward_launches_the_inverse_kernel(rng, cuda_device):
    x = torch.tensor(rng.normal(size=(2, 784, 192)), dtype=torch.float32,
                     device=cuda_device, requires_grad=True)
    g = torch.randn(2, 784, 192, device=cuda_device)
    kernels.reset_launch_counts()
    out = shift_permute.shift_permute(x, 28, 28, 7, 3)
    (dx,) = torch.autograd.grad(out, x, g)
    assert kernels.launch_counts()["shift_permute"] == 2
    assert torch.equal(dx, shift_permute.shift_permute_plain(g, 28, 28, 7, 3,
                                                             inverse=True))
    with pytest.raises(ValueError, match="shift"):
        shift_permute.shift_permute(x.detach(), 28, 28, 7, 7)


WINDOW_KERNELS = {
    "fused": window_attention.fused_window_attention_cuda,
    "paired": window_attention.paired_window_attention_cuda,
    "v2": window_attention.fused_window_attention_v2_cuda}


def _window_inputs(rng, dev, w, h, n, hd, nw, dtype=torch.bfloat16):
    """q, k, v in `dtype` (fp32: values bf16 cannot hold) and the fp32
    bias."""
    bf = lambda a: torch.tensor(a).to(dev, dtype).contiguous()
    bias = rng.normal(size=(nw, h, n, n))
    if nw > 1:
        bias += np.where(rng.random((nw, 1, n, n)) > 0.7, -100.0, 0.0)
    return (bf(rng.normal(size=(w, h, n, hd)) * hd ** -0.5),
            bf(rng.normal(size=(w, h, n, hd))),
            bf(rng.normal(size=(w, h, n, hd))),
            torch.tensor(bias, dtype=torch.float32, device=dev))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("w,h,n,hd,nw", [(128, 3, 49, 32, 64),
                                         (12, 24, 49, 32, 1),
                                         (8, 2, 16, 16, 4),
                                         (6, 1, 64, 64, 1)])
@pytest.mark.parametrize("variant", sorted(WINDOW_KERNELS))
def test_window_attention_kernels(rng, cuda_device, variant, w, h, n, hd, nw,
                                  dtype):
    """Every entry point at stage shapes, a tiny one and the largest tile;
    W = 12 and 6 make v2 shrink its group to 4 and 3.  fp32 q, k, v (the
    TF32 instantiation): fp32 out within a quarter of the bound, nearer
    the fp32 plain version than the same call through the former bf16
    boundary, two launches bit for bit."""
    args = _window_inputs(rng, cuda_device, w, h, n, hd, nw, dtype)
    kernel = WINDOW_KERNELS[variant]
    got = kernel(*args)
    want = window_attention.window_attention_plain(*args)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.isfinite(got).all()
    assert _rel(got, want) <= BOUND
    if dtype == torch.float32:
        before = kernel(*(t.bfloat16() for t in args[:3]), args[3])
        assert _rel(got, want) <= BOUND / 4
        assert _rel(got, want) < _rel(before, want)
        assert torch.equal(got, kernel(*args))


@pytest.mark.gpu
def test_window_attention_tilings_agree_bit_for_bit(rng, cuda_device):
    """Windows per block (side by side or one after another) change no
    arithmetic: every tiling of every entry point gives the same bits."""
    args = _window_inputs(rng, cuda_device, 24, 3, 49, 32, 4)
    base = window_attention.fused_window_attention_cuda(*args)
    for out in (window_attention.fused_window_attention_cuda(*args, 4),
                window_attention.fused_window_attention_cuda(*args, 5),
                window_attention.paired_window_attention_cuda(*args),
                window_attention.fused_window_attention_v2_cuda(*args, 4),
                window_attention.fused_window_attention_v2_cuda(*args, 3)):
        assert torch.equal(out, base)
    with pytest.raises(ValueError, match="even W"):
        window_attention.paired_window_attention_cuda(
            *_window_inputs(rng, cuda_device, 3, 1, 16, 16, 1))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("hd,n", [(16, 49), (32, 49), (64, 64), (16, 16)])
@pytest.mark.parametrize("conc", [1, 2, 4])
def test_window_attention_walks_write_every_unit(rng, cuda_device,
                                                 monkeypatch, conc, hd, n,
                                                 dtype):
    """7 faces of 4 windows walked 3 faces a block (a short last chunk), the
    output memory filled with NaN first: every unit is written, two launches
    give the same bits, and so does the plan's own chunk.  fp32 tiles take
    every ring the plan gives them (hd 64 with 4 windows side by side: one
    slot)."""
    args = _window_inputs(rng, cuda_device, 28, 3, n, hd, 4, dtype)
    empty_like = torch.empty_like
    monkeypatch.setattr(torch, "empty_like", lambda *a, **kw: empty_like(
        *a, **kw).fill_(float("nan")))
    launch = lambda chunk: window_attention._launch(
        window_attention.fused_window_attention_cuda, *args, conc, chunk)
    got = launch(3)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.isfinite(got).all()
    assert _rel(got, window_attention.window_attention_plain(*args)) <= BOUND
    for chunk in (3, 0):
        assert torch.equal(launch(chunk), got)


@pytest.mark.gpu
def test_window_attention_checks_alignment_and_shared_memory(rng, cuda_device):
    """A q, k or v that is not 16-byte aligned raises (the bulk copies need
    it); the C side's shared-memory count is the launch plan's, for bf16
    and fp32 tiles."""
    q, k, v, bias = _window_inputs(rng, cuda_device, 8, 2, 49, 32, 4)
    for i in range(3):
        args = [q, k, v]
        flat = torch.empty(q.numel() + 8, dtype=q.dtype, device=cuda_device)
        args[i] = flat[1:1 + q.numel()].view(q.shape).copy_(q)
        with pytest.raises(ValueError, match="aligned"):
            window_attention.fused_window_attention_cuda(*args, bias)
    lib = kernels.library()
    for f32, elem in ((0, 2), (1, 4)):
        for hd in window_attention.HEAD_DIMS:
            for conc in range(1, window_attention.MAX_SIDE_BY_SIDE + 1):
                assert lib.fmmt_window_attention_smem(hd, conc, f32) == \
                    window_attention.launch_plan(4 * conc, 1, hd, 1, conc,
                                                 132, elem=elem).smem


@pytest.mark.gpu
@pytest.mark.parametrize("t,c4", [(1568, 384), (1000, 768), (196, 1536),
                                  (50, 32)])
def test_fused_merge_kernel(rng, cuda_device, t, c4):
    """T = 1000 and 50 are not multiples of the 64-row tile."""
    bf = lambda a: torch.tensor(a).to(cuda_device, torch.bfloat16).contiguous()
    args = (bf(rng.normal(size=(2, t // 2, c4))),
            bf(1 + 0.1 * rng.normal(size=c4)), bf(0.1 * rng.normal(size=c4)),
            bf(rng.normal(size=(c4, c4 // 2)) / np.sqrt(c4)))
    got = merge_kernel.fused_merge_cuda(*args)
    want = merge_kernel.fused_merge_plain(*args)
    torch.cuda.synchronize()
    assert got.shape == (2, t // 2, c4 // 2)
    assert _rel(got, want) <= BOUND


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("t,c4,c2", [(1, 384, 192), (1024, 1536, 768),
                                     (1000, 768, 384), (130, 48, 208)])
def test_fused_merge_kernel_tiles(rng, cuda_device, t, c4, c2, dtype):
    """T = 1; transition 2's widths (K = 1536, M = 768) at T = 1024; T not a
    multiple of the 64-row tile; K under one 64-wide chunk and M not a
    multiple of the 192-column tile (a second tile of 16 columns).  fp32
    rows (the statistics and row pass, the fp32 store): out in fp32, nearer
    the fp32 plain version than through the former bf16 boundary, two
    launches bit for bit."""
    bf = lambda a: torch.tensor(a).to(cuda_device, torch.bfloat16).contiguous()
    args = (torch.tensor(rng.normal(size=(1, t, c4))).to(cuda_device, dtype),
            bf(1 + 0.1 * rng.normal(size=c4)), bf(0.1 * rng.normal(size=c4)),
            bf(rng.normal(size=(c4, c2)) / np.sqrt(c4)))
    got = merge_kernel.fused_merge_cuda(*args)
    want = merge_kernel.fused_merge_plain(*args)
    torch.cuda.synchronize()
    assert got.shape == (1, t, c2) and got.dtype == dtype
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= BOUND
    if dtype == torch.float32:
        before = merge_kernel.fused_merge_cuda(args[0].bfloat16(), *args[1:])
        assert _rel(got, want) < _rel(before, want)
        assert torch.equal(got, merge_kernel.fused_merge_cuda(*args))
    # the tile plan's shared memory at K = 1536, as
    # tests/test_torch_kernels_redesign.py::merge_smem_bytes counts it
    assert kernels.library().fmmt_fused_merge_smem(1536) == 111104


@pytest.mark.gpu
def test_window_and_merge_functions_differentiate_their_plain_versions(
        rng, cuda_device):
    """fp32 leaves, bf16 kernels forward, torch autograd of the plain version
    backward: gradients in the leaves' dtype, close to the plain version's
    own gradients."""
    kernels.reset_launch_counts()
    for fn, name in ((window_attention.fused_window_attention,
                      "fused_window_attention"),
                     (window_attention.paired_window_attention,
                      "paired_window_attention"),
                     (window_attention.fused_window_attention_v2,
                      "fused_window_attention_v2")):
        args = [a.float().requires_grad_() for a in
                _window_inputs(rng, cuda_device, 8, 3, 49, 32, 4)]
        fn(*args).square().mean().backward()
        got = [a.grad.clone() for a in args]
        assert kernels.launch_counts()[name] == 1
        for a in args:
            a.grad = None
        window_attention.window_attention_plain(*args).square().mean().backward()
        for g, a in zip(got, args):
            assert g.dtype == torch.float32 and _rel(g, a.grad) <= BOUND
    bf = lambda a: torch.tensor(a, dtype=torch.float32, device=cuda_device)
    args = [bf(rng.normal(size=(2, 98, 384))).requires_grad_(),
            bf(1 + 0.1 * rng.normal(size=384)).requires_grad_(),
            bf(0.1 * rng.normal(size=384)).requires_grad_(),
            bf(rng.normal(size=(384, 192)) / 20).requires_grad_()]
    merge_kernel.fused_merge(*args).square().mean().backward()
    assert kernels.launch_counts()["fused_merge"] == 1
    assert all(a.grad is not None and torch.isfinite(a.grad).all()
               for a in args)


@pytest.mark.gpu
@pytest.mark.parametrize("route", [("pallas", "xla", "window"),
                                   ("pair", "auto", "raster"),
                                   ("xla", "xla", "window")])
def test_swin_routes_on_the_card(rng, cuda_device, route):
    """A narrow two-stage Swin in bf16 on the card under each route against
    the default route with the same weights; the routes launch their own
    kernels and not the fused block's."""
    from facialmmt_tpu_torch.config import SwinConfig
    from facialmmt_tpu_torch.ops.swin import SwinTransformer

    cfg = SwinConfig(img_size=32, patch_size=4, embed_dim=32, depths=(2, 2),
                     num_heads=(2, 4), window_size=4, drop_path_rate=0.0,
                     out_feature_dim=16)
    torch.manual_seed(0)
    base = SwinTransformer(cfg).to(cuda_device, torch.bfloat16).eval()
    attention_impl, mlp_impl, merge_impl = route
    routed = SwinTransformer(dataclasses.replace(
        cfg, attention_impl=attention_impl, mlp_impl=mlp_impl,
        merge_impl=merge_impl)).to(cuda_device, torch.bfloat16).eval()
    routed.load_state_dict(base.state_dict(), strict=True)
    x = torch.tensor(rng.normal(size=(4, 32, 32, 3))).to(cuda_device,
                                                         torch.bfloat16)
    with torch.no_grad():
        want = base(x)
        kernels.reset_launch_counts()
        got = routed(x)
    counts = kernels.launch_counts()
    assert counts["fused_attention_block"] == 0
    assert counts["fused_window_attention"] == (4 if attention_impl == "pallas"
                                                else 0)
    assert counts["paired_window_attention"] == (4 if attention_impl == "pair"
                                                 else 0)
    assert counts["fused_ln_mlp_residual"] == (0 if mlp_impl == "xla" else 4)
    assert _rel(got, want) <= 5e-2      # bf16 through four blocks


@pytest.mark.gpu
def test_pair_route_at_an_odd_face_count_stays_on_the_kernels(rng,
                                                              cuda_device):
    """3 faces under 'pair': stage 0 has 12 windows and 4 mask groups
    (paired), stage 1 one window a face, an odd count, which goes one to a
    block through fused_window_attention; the plain core never runs on the
    card."""
    from unittest import mock

    from facialmmt_tpu_torch.config import SwinConfig
    from facialmmt_tpu_torch.ops.swin import SwinTransformer

    cfg = SwinConfig(img_size=32, patch_size=4, embed_dim=32, depths=(2, 2),
                     num_heads=(2, 4), window_size=4, drop_path_rate=0.0,
                     out_feature_dim=16, mlp_impl="xla")
    torch.manual_seed(0)
    base = SwinTransformer(dataclasses.replace(cfg, attention_impl="xla"))
    base.to(cuda_device, torch.bfloat16).eval()
    pair = SwinTransformer(dataclasses.replace(cfg, attention_impl="pair"))
    pair.to(cuda_device, torch.bfloat16).eval()
    pair.load_state_dict(base.state_dict(), strict=True)
    x = torch.tensor(rng.normal(size=(3, 32, 32, 3))).to(cuda_device,
                                                         torch.bfloat16)
    with torch.no_grad():
        want = base(x)
        kernels.reset_launch_counts()
        with mock.patch.object(torch, "bmm", side_effect=AssertionError(
                "the plain attention core ran on a CUDA tensor")):
            got = pair(x)
    counts = kernels.launch_counts()
    assert counts["paired_window_attention"] == 2
    assert counts["fused_window_attention"] == 2
    assert counts["fused_attention_block"] == 0
    assert _rel(got, want) <= 5e-2      # bf16 through four blocks


@pytest.mark.gpu
def test_tiny_server_runs_every_kernel(cuda_device):
    """A tiny serving path on the card goes through all three kernels and
    agrees with the same weights on the CPU in fp32 (bound 2e-2 on the
    probabilities: bf16 rounding through the tiny stack)."""
    from facialmmt_tpu_torch.config import FacialMMTConfig, RuntimeConfig
    from facialmmt_tpu_torch.serving import EmotionServer

    cfg = FacialMMTConfig.tiny()
    # Swin widths the kernels take (channels and head dims multiples of 16)
    cfg = cfg.replace(runtime=RuntimeConfig(deterministic_gumbel=True),
                      swin=dataclasses.replace(cfg.swin, embed_dim=32))
    gpu = EmotionServer(cfg, max_batch=2, face_capacity=4, device=cuda_device)
    sd = {k: v.float().cpu() if v.is_floating_point() else v.cpu()
          for k, v in gpu.model.state_dict().items()}
    cpu = EmotionServer(cfg, sd, max_batch=2, face_capacity=4,
                        dtype=torch.float32, transfer_dtype=np.float32,
                        device="cpu")
    req = [{"input_ids": np.arange(2, 40), "sep_mask": np.eye(38)[20],
            "faces": np.full((3, 160, 160, 3), 90, np.uint8),
            "audio": np.ones((4, cfg.data.audio_feat_dim))}]
    kernels.reset_launch_counts()
    out = gpu.predict(req)
    counts = kernels.launch_counts()
    assert all(counts[k] > 0 for k in ("fused_attention",
                                       "fused_attention_block",
                                       "fused_ln_mlp_residual")), counts
    np.testing.assert_allclose(out[0], cpu.predict(req)[0], atol=2e-2)


@pytest.mark.gpu
def test_full_width_aux_step(cuda_device):
    """One auxiliary step of Swin-tiny at 224 px on the card (48 images, the
    text tower cut to its tiny config: the auxiliary pass never runs it):
    finite loss, every backward kernel launched once per block half it
    serves, Swin moved and the multimodal branch did not, and the step is
    repeatable from the same weights."""
    from facialmmt_tpu_torch.config import FacialMMTConfig, TextEncoderConfig
    from facialmmt_tpu_torch.models.pipeline import (FacialMMTPipeline,
                                                     init_random_)
    from facialmmt_tpu_torch.train.optim import MultiTaskState
    from facialmmt_tpu_torch.train.steps import make_aux_train_step

    cfg = FacialMMTConfig().replace(text=TextEncoderConfig.tiny())
    gen = torch.Generator(cuda_device)
    images = torch.randn(48, 224, 224, 3, device=cuda_device,
                         generator=gen.manual_seed(5))
    labels = torch.randint(0, 7, (48,), device=cuda_device,
                           generator=gen.manual_seed(6))
    results = []
    for _ in range(2):
        model = FacialMMTPipeline(cfg).to(cuda_device)
        init_random_(model, gen.manual_seed(7))
        mm_before = {k: v.clone() for k, v in
                     model.multimodal.state_dict().items()}
        state = MultiTaskState.create(model, cfg.optim, 10, 10)
        state.swin_opt.set_count(5)         # past warm-up: a non-zero lr
        kernels.reset_launch_counts()
        loss = make_aux_train_step(model)(state, images, labels,
                                          gen.manual_seed(8))
        torch.cuda.synchronize()
        assert torch.isfinite(loss)
        counts = kernels.launch_counts()
        assert counts["fused_attention_block"] == 12
        assert counts["fused_ln_mlp_residual"] == 12
        assert counts["fused_ln_mlp_residual_bwd"] == 12
        assert counts["fused_attention_block_bwd"] == 10
        assert counts["fused_attention_block_bwd_spill"] == 2
        assert all(torch.equal(v, mm_before[k]) for k, v in
                   model.multimodal.state_dict().items())
        results.append((float(loss), {k: v.clone() for k, v in
                                      model.swin_model.state_dict().items()}))
    (loss_a, sd_a), (loss_b, sd_b) = results
    # no kernel adds with atomics: the two steps give the same bits, the
    # BatchNorm statistics included
    assert loss_a == loss_b
    assert all(torch.equal(sd_a[k], sd_b[k]) for k in sd_a)
    moved = 0
    for k, p in model.swin_model.named_parameters():
        moved += 1
    assert moved > 100


@pytest.mark.gpu
def test_tiny_trainer_on_the_card(cuda_device, tmp_path):
    """Trainer defaults to the card and runs the whole loop there."""
    from facialmmt_tpu_torch.config import FacialMMTConfig
    from facialmmt_tpu_torch.data.meld import (SyntheticFerDataset,
                                               SyntheticMeldDataset)
    from facialmmt_tpu_torch.train.trainer import Trainer

    cfg = FacialMMTConfig.tiny()
    # Swin widths the kernels take (channels and head dims multiples of 16)
    cfg = cfg.replace(optim=dataclasses.replace(
        cfg.optim, aux_batch_size=6, trg_batch_size=2,
        trg_accumulation_steps=2), swin_from_target=True,
        swin=dataclasses.replace(cfg.swin, embed_dim=32),
        runtime=dataclasses.replace(cfg.runtime,
                                    save_model_path=str(tmp_path)))
    trainer = Trainer(cfg)
    assert trainer.device.type == "cuda"
    ds = SyntheticMeldDataset(cfg, 8, 2, 3, seed=2)
    f1 = trainer.run_multimodal(SyntheticFerDataset(12, 24, seed=1), ds, ds, ds)
    assert np.isfinite(f1)
    assert (trainer.state.swin_step, trainer.state.mm_step) == (4, 2)
    counts = kernels.launch_counts()
    # fused_add_layernorm: the evaluations' LayerNorms (grad off)
    default_route = ("fused_attention", "fused_attention_block",
                     "fused_ln_mlp_residual", "fused_ln_mlp_residual_bwd",
                     "fused_attention_block_bwd",
                     "fused_attention_block_bwd_spill", "fused_add_layernorm")
    assert all(counts[k] > 0 for k in default_route), counts
    # the window-attention and merge kernels are on other routes only
    assert all(n == 0 for k, n in counts.items()
               if k not in default_route), counts


@pytest.mark.gpu
def test_swin_remat_is_bit_for_bit_on_the_card(cuda_device):
    """Swin with every block checkpointed (SwinConfig.remat=True) on the
    default route: the same loss, gradients, BatchNorm statistics and
    generator state as without, bit for bit, stochastic depth on; the
    recompute launches kernels 2 and 3 once more per block, the backward
    kernels as often as without."""
    from facialmmt_tpu_torch.config import FacialMMTConfig
    from facialmmt_tpu_torch.models.swin_fer import \
        SwinForAffwildClassification
    from facialmmt_tpu_torch.train.steps import compute_context, cross_entropy

    cfg = FacialMMTConfig.tiny()
    cfg = cfg.replace(swin=dataclasses.replace(cfg.swin, embed_dim=32,
                                               drop_path_rate=0.3))
    torch.manual_seed(0)
    model = SwinForAffwildClassification(cfg).to(cuda_device).train()
    images = torch.randn(24, 32, 32, 3, device=cuda_device)
    labels = torch.arange(24, device=cuda_device) % 7
    start = {k: v.clone() for k, v in model.state_dict().items()}
    seen = []
    for remat in (False, True):
        model.load_state_dict(start)
        model.swin.cfg = dataclasses.replace(model.swin.cfg, remat=remat)
        model.zero_grad(set_to_none=True)
        gen = torch.Generator(cuda_device).manual_seed(5)
        kernels.reset_launch_counts()
        with compute_context(cuda_device):
            loss = cross_entropy(model(images, generator=gen), labels)
        loss.backward()
        torch.cuda.synchronize()
        seen.append((loss.detach(), {n: p.grad.clone() for n, p in
                                     model.named_parameters()},
                     {k: v.clone() for k, v in model.state_dict().items()},
                     gen.get_state(), kernels.launch_counts()))
    (l0, g0, s0, r0, c0), (l1, g1, s1, r1, c1) = seen
    assert torch.equal(l0, l1)
    assert all(torch.equal(g0[k], g1[k]) for k in g0)
    assert all(torch.equal(s0[k], s1[k]) for k in s0)
    assert torch.equal(r0, r1)
    blocks = sum(cfg.swin.depths)
    doubled = ("fused_attention_block", "fused_ln_mlp_residual")
    assert all((c0[k], c1[k]) == (blocks, 2 * blocks) for k in doubled), \
        (c0, c1)
    assert all(c1[k] == c0[k] for k in c0 if k not in doubled), (c0, c1)


@pytest.mark.gpu
def test_text_tower_local_heads_take_kernel_1(cuda_device, tmp_path):
    """Two ranks on the one card (gloo) run the text tower at tp=2, eval:
    each rank's attention is kernel 1 on num_heads / 2 heads, once per
    layer, and both return the one-process tower's output within 2e-2 x
    max (bf16 autocast on both sides)."""
    import os
    import subprocess
    import sys

    from facialmmt_tpu_torch.config import TextEncoderConfig
    from facialmmt_tpu_torch.models.text_encoder import TextEncoder

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = dataclasses.replace(TextEncoderConfig(), hidden_size=256,
                              num_heads=4, intermediate_size=512,
                              num_layers=2)
    torch.manual_seed(0)
    enc = TextEncoder(cfg).eval()
    ids = torch.randint(3, 1000, (2, 300))
    mask = torch.ones_like(ids)
    mask[1, 200:] = 0
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        want = enc.to(cuda_device)(ids.to(cuda_device),
                                   mask.to(cuda_device)).float().cpu()
    torch.save({"scenarios": {2: ["text_tp2"]}, "device": "cuda:0",
                "text_cfg": dataclasses.asdict(cfg),
                "text_sd": {k: v.cpu().numpy() for k, v in
                            enc.state_dict().items()},
                "ids": ids.numpy(), "mask": mask.numpy()},
               tmp_path / "case.pt")
    env = dict(os.environ, PYTHONPATH=repo)
    procs = [subprocess.Popen([sys.executable,
                               os.path.join(repo, "tests", "torch_dist_worker.py"),
                               str(r), "2", str(tmp_path)], cwd=repo, env=env)
             for r in range(2)]
    assert [p.wait(timeout=300) for p in procs] == [0, 0]
    for r in range(2):
        got = torch.load(tmp_path / f"out_2_{r}.pt",
                         weights_only=False)["text_tp2"]
        assert got["heads"] == [cfg.num_heads // 2] * cfg.num_layers
        assert got["launches"] == cfg.num_layers
        assert _rel(torch.tensor(got["out"]), want) <= BOUND


def _as_f32_tokens(args, which=(0,)):
    """The same operands with the tokens (positions `which`) in fp32: the
    model's tensors under --compute_dtype float32."""
    return tuple(a.float() if i in which else a for i, a in enumerate(args))


@pytest.mark.gpu
@pytest.mark.parametrize("sq,sk,d", [(512, 512, 64), (100, 130, 64),
                                     (38, 157, 32), (20, 20, 16)])
def test_fused_attention_kernel_fp32(rng, cuda_device, sq, sk, d):
    """The TF32 instantiation of kernel 1: fp32 out, within the bound of the
    fp32 plain version (finer than the bf16 kernel's), the fully padded
    row's uniform softmax, two launches bit for bit."""
    q, k, v, bias = _attention_inputs(rng, cuda_device, 2, 4, sq, sk, d)
    q, k, v = (t.float() for t in (q, k, v))
    got = attention.fused_attention_cuda(q, k, v, bias)
    want = attention.fused_attention_plain(q, k, v, bias)
    again = attention.fused_attention_cuda(q, k, v, bias)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= BOUND / 4
    assert torch.equal(got, again)
    mean_v = v[-1].mean(dim=1, keepdim=True).expand(4, sq, d)
    torch.testing.assert_close(got[-1], mean_v, atol=1e-3, rtol=1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("half", ["attention", "mlp"])
@pytest.mark.parametrize("stage", [0, 3])
def test_forward_halves_take_fp32_tokens(rng, cuda_device, half, stage):
    """Kernels 2 and 3 on fp32 tokens at Swin-tiny stages 0 and 3 (8 faces),
    with keep: fp32 out within the bound of the fp32 plain version, two
    launches bit for bit, and a keep of 0 passes the fp32 row through
    unrounded."""
    res, c, heads = SWIN_STAGES[stage]
    nw = (res // 7) ** 2
    if half == "attention":
        w = 8 * nw
        args = _as_f32_tokens(_block_inputs(rng, cuda_device, w, 49, c, heads,
                                            nw if res > 7 else 1))
        keep = torch.tensor([0.0, 1.25] * (w // 2), device=cuda_device)
        kernel = fused_block.fused_attention_block_cuda
        plain = fused_block.fused_attention_block_plain
    else:
        t = 8 * res * res
        args = _as_f32_tokens(_mlp_inputs(rng, cuda_device, t, c))
        keep = torch.tensor([0.0, 1.25] * (t // 2), device=cuda_device)
        kernel = block_mlp.fused_ln_mlp_residual_cuda
        plain = block_mlp.fused_ln_mlp_residual_plain
    x = args[0] + 1e-3 * torch.randn_like(args[0])    # not bf16-representable
    args = (x, *args[1:])
    got = kernel(*args, keep)
    again = kernel(*args, keep)
    want = plain(*args, keep)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    assert _rel(got, want) <= BOUND
    assert torch.equal(got, again)
    assert torch.equal(got[0], x[0])


@pytest.mark.gpu
@pytest.mark.parametrize("half,stage", [("mlp", 0), ("mlp", 3),
                                        ("attention", 0), ("attention", 3)])
def test_backward_kernels_take_fp32_tokens(rng, cuda_device, half, stage):
    """Kernels 4-6 on fp32 x and dy (8 images): fp32 dx, every output within
    the bound of the fp32 plain backward, two launches bit for bit."""
    kernel, plain, names, args = _stage_bwd_args(rng, cuda_device, half,
                                                 stage, True, images=8)
    args = _as_f32_tokens(args, (0, 1))
    got = kernel(*args)
    again = kernel(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    assert got[0].dtype == torch.float32
    _hold_grads(names, got, want)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


@pytest.mark.gpu
def test_kernels_refuse_other_token_dtypes(rng, cuda_device):
    """No quiet cast: fp16 tokens, a gradient of another dtype than x, or
    k and v of another dtype than q, raise at every kernel that takes
    tokens (1-11)."""
    args = _mlp_inputs(rng, cuda_device, 64, 16)
    with pytest.raises(ValueError, match="dtype"):
        block_mlp.fused_ln_mlp_residual_cuda(args[0].half(), *args[1:])
    with pytest.raises(ValueError, match="dtype"):
        block_mlp.fused_ln_mlp_residual_bwd_cuda(
            args[0].float(), args[0], *args[1:6])
    q, k, v, bias = _attention_inputs(rng, cuda_device, 1, 2, 8, 8, 16)
    with pytest.raises(ValueError, match="dtype"):
        attention.fused_attention_cuda(q.float(), k, v, bias)
    q, k, v, bias = _window_inputs(rng, cuda_device, 8, 2, 49, 32, 4)
    for fn in WINDOW_KERNELS.values():
        with pytest.raises(ValueError, match="dtype"):
            fn(q.half(), k.half(), v.half(), bias)
    with pytest.raises(ValueError, match="dtype"):
        window_attention.fused_window_attention_cuda(q.float(), k, v, bias)
    bf = lambda a: torch.tensor(a).to(cuda_device, torch.bfloat16).contiguous()
    with pytest.raises(ValueError, match="dtype"):
        merge_kernel.fused_merge_cuda(
            torch.zeros(1, 4, 32, device=cuda_device, dtype=torch.float16),
            bf(np.ones(32)), bf(np.zeros(32)), bf(np.zeros((32, 16))))
    args = _whole_inputs(rng, cuda_device, 2, 49, 32, 2, 1)
    with pytest.raises(ValueError, match="dtype"):
        fused_block.fused_whole_block_cuda(args[0].half(), *args[1:])


def _bf16_ulps(got, want, scale):
    """|got - want| in units of the bf16 spacing at the largest of |got|,
    |want| and `scale`."""
    g, w = got.float(), want.float()
    _, e = torch.frexp(torch.maximum(torch.maximum(g.abs(), w.abs()), scale))
    return (g - w).abs() / torch.ldexp(torch.ones_like(g), e - 8)


def _affine_terms(x, residual, weight, bias, eps):
    """|gamma * y| + |beta| of the plain chain in fp32, per element: the
    magnitude each output is summed from."""
    s = (x if residual is None else x + residual).float()
    c = s - s.mean(-1, keepdim=True)
    y = c * torch.rsqrt(c.square().mean(-1, keepdim=True) + eps)
    return (weight.float() * y).abs() + bias.float().abs()


def _add_ln_inputs(rng, dev, rows, h, dtype, pdtype=None):
    """x, residual, weight, bias on `dev`: rows of a large mean and spread
    (the statistics' cancellation shows), parameters near (1, 0)."""
    pdtype = pdtype or dtype
    t = lambda a, dt: torch.tensor(a).to(dev, dt).contiguous()
    return (t(rng.normal(size=(rows, h)) * 3.0 + 1.5, dtype),
            t(rng.normal(size=(rows, h)), dtype),
            t(rng.normal(size=(h,)) * 0.1 + 1.0, pdtype),
            t(rng.normal(size=(h,)) * 0.1, pdtype))


def _hold_add_ln(got, want, args):
    """bf16: at most one ulp apart, on at most 0.1 % of the elements (the
    statistics are summed in another order).  The ulp is taken at the
    magnitude of gamma * y and beta, the two terms each output is the sum
    of: where they cancel, a last-bit difference in y is many ulps of the
    small result in both versions' arithmetic.  fp32: within 1e-5
    relative."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == torch.bfloat16:
        ulps = _bf16_ulps(got, want, _affine_terms(*args))
        assert float(ulps.max()) <= 1.0
        assert float((got != want).float().mean()) <= 1e-3
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("residual", [True, False], ids=["res", "nores"])
@pytest.mark.parametrize("eps", [1e-5, 1e-12])
@pytest.mark.parametrize("rows,h", [(4097, 1024), (1003, 768), (257, 64),
                                    (5, 8), (33, 4096), (6, 2056)])
def test_fused_add_layernorm_kernel(rng, cuda_device, rows, h, eps, residual,
                                    dtype):
    """The kernel against its plain chain on the card: the main path's
    widths (1024 text, 768 fusion), tiny()'s 64 and 8, rows split over two
    warps (2056, 4096), row counts that leave the last block part empty;
    two launches give the same bits."""
    x, r, w, b = _add_ln_inputs(rng, cuda_device, rows, h, dtype)
    r = r if residual else None
    got = add_layernorm.fused_add_layernorm_cuda(x, r, w, b, eps)
    again = add_layernorm.fused_add_layernorm_cuda(x, r, w, b, eps)
    want = add_layernorm.fused_add_layernorm_plain(x, r, w, b, eps)
    torch.cuda.synchronize()
    _hold_add_ln(got, want, (x, r, w, b, eps))
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,pdtype", [(torch.float32, torch.bfloat16),
                                          (torch.bfloat16, torch.float32)])
def test_fused_add_layernorm_mixed_parameters(rng, cuda_device, dtype,
                                              pdtype):
    """Rows and parameters of different dtypes: the embeddings' LayerNorm
    (fp32 sums, bf16 parameters), and bf16 rows under fp32 parameters."""
    x, r, w, b = _add_ln_inputs(rng, cuda_device, 2 * 512, 1024, dtype,
                                pdtype)
    args = (x, None, w, b, 1e-5)
    _hold_add_ln(add_layernorm.fused_add_layernorm_cuda(*args),
                 add_layernorm.fused_add_layernorm_plain(*args), args)


@pytest.mark.gpu
def test_fused_add_layernorm_refusals(rng, cuda_device):
    """The wrapper raises on a non-contiguous operand, another dtype and an
    unsupported width; the dispatch adds a residual of another dtype first,
    as the plain version's add promotes it."""
    x, r, w, b = _add_ln_inputs(rng, cuda_device, 64, 128, torch.bfloat16)
    fn = add_layernorm.fused_add_layernorm_cuda
    with pytest.raises(ValueError, match="contiguous"):
        fn(x.t().contiguous().t(), None, w, b, 1e-5)
    with pytest.raises(ValueError, match="contiguous"):
        fn(x, r[:, :].t().contiguous().t(), w, b, 1e-5)
    with pytest.raises(ValueError, match="dtype"):
        fn(x.half(), None, w, b, 1e-5)
    with pytest.raises(ValueError, match="dtype"):
        fn(x, r.float(), w, b, 1e-5)
    with pytest.raises(ValueError, match="dtype"):
        fn(x, None, w.half(), b.half(), 1e-5)
    with pytest.raises(ValueError, match="dtype"):
        fn(x, None, w, b.float(), 1e-5)
    for h in (12, 4, 4104):
        xh = torch.zeros(3, h, device=cuda_device, dtype=torch.bfloat16)
        wh = torch.ones(h, device=cuda_device, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="width"):
            fn(xh, None, wh, wh, 1e-5)
    with pytest.raises(ValueError, match="shape"):
        fn(x, r[:32], w, b, 1e-5)
    with torch.no_grad():
        got = add_layernorm.fused_add_layernorm(x, r.float(), w, b, 1e-5)
    assert got.dtype == torch.float32
    args = (x, r.float(), w, b, 1e-5)
    _hold_add_ln(got, add_layernorm.fused_add_layernorm_plain(*args), args)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_gelu_route_gives_the_chain_bits(cuda_device, dtype):
    """gelu_erf with grad off on the card is F.gelu in x's own dtype: the
    same bits as the fp32 chain it replaces, over every bf16 value of
    magnitude up to 16 and a sweep of random ones."""
    from facialmmt_tpu_torch.ops.layers import gelu_erf

    bits = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(torch.int16)
    every = bits.view(torch.bfloat16).float()
    every = every[torch.isfinite(every) & (every.abs() <= 16)]
    x = torch.cat([every, torch.randn(1 << 22) * 4]).to(cuda_device, dtype)
    with torch.no_grad():
        got = gelu_erf(x)
    want = torch.nn.functional.gelu(x.float()).to(dtype)
    assert got.dtype == dtype
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_served_pack_launches_add_layernorm_and_a_training_step_does_not(
        cuda_device):
    """A tiny() EmotionServer pack launches the kernel once a LayerNorm
    (47 at tiny(): 5 text, 6 encoders, 36 crossmodal;
    chip_smoke.add_ln_launches) and kernels 1-3 as before; a train-mode text
    layer under grad launches it 0 times."""
    import chip_smoke
    from facialmmt_tpu_torch.config import (FacialMMTConfig, RuntimeConfig,
                                            TextEncoderConfig)
    from facialmmt_tpu_torch.models.text_encoder import TextEncoderLayer
    from facialmmt_tpu_torch.serving import EmotionServer

    cfg = FacialMMTConfig.tiny()
    cfg = cfg.replace(runtime=RuntimeConfig(deterministic_gumbel=True),
                      swin=dataclasses.replace(cfg.swin, embed_dim=32))
    assert chip_smoke.add_ln_launches(cfg) == 47
    gpu = EmotionServer(cfg, max_batch=2, face_capacity=4, device=cuda_device)
    req = [{"input_ids": np.arange(2, 40), "sep_mask": np.eye(38)[20],
            "faces": np.full((3, 160, 160, 3), 90, np.uint8),
            "audio": np.ones((4, cfg.data.audio_feat_dim))}]
    kernels.reset_launch_counts()
    gpu.predict(req)
    counts = kernels.launch_counts()
    assert counts["fused_add_layernorm"] == 47, counts
    assert counts["fused_attention"] == cfg.text.num_layers
    assert counts["fused_attention_block"] == sum(cfg.swin.depths)
    assert counts["fused_ln_mlp_residual"] == sum(cfg.swin.depths)

    layer = TextEncoderLayer(TextEncoderConfig.tiny()).to(cuda_device).train()
    x = torch.randn(2, 16, 64, device=cuda_device, requires_grad=True)
    kernels.reset_launch_counts()
    layer(x, torch.zeros(2, 16, device=cuda_device),
          torch.Generator(cuda_device).manual_seed(0)).sum().backward()
    torch.cuda.synchronize()
    assert kernels.launch_counts()["fused_add_layernorm"] == 0
