"""The port's CUDA kernels on the card, and the wrappers' input checks.

This file imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

The `gpu` tests skip without a CUDA device.  Each holds a kernel against its
plain PyTorch version on the same bf16 inputs at max|d| <= 2e-2 * max|out|
per output (both round to bf16 at different points; the JAX suite's kernel
bound).  Kernels 4 and 5 (the MLP-half and resident attention-half
backwards) sum across blocks in a fixed order, so two launches give the same
bits; kernel 6 (the spill backward) still sums dgamma, dbeta and dbias with
fp32 atomics, so its two runs agree to rounding, not bit for bit:
REPEAT_BOUND.
"""

import dataclasses

import numpy as np
import pytest
import torch

from facialmmt_tpu_torch.ops import kernels
from facialmmt_tpu_torch.ops.kernels import (attention, block_mlp,
                                             fused_block, merge_kernel,
                                             shift_permute, window_attention)

BOUND = 2e-2
REPEAT_BOUND = 1e-3   # kernel 6 run to run, relative to max|out|: fp32
                      # atomic order


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
    args = _block_inputs(rng, cuda_device, w, n, c, h, nw)
    args = (args[0], torch.randn_like(args[0]), *args[1:6], args[7])
    k = (torch.tensor([0.0, 1.25] * (w // 2), device=cuda_device)
         if keep else None)
    got = fused_block.fused_attention_block_bwd_spill_cuda(*args, k)
    want = fused_block.fused_attention_block_bwd_spill_plain(*args, k)
    torch.cuda.synchronize()
    _hold_grads(BWD_NAMES, got, want)
    again = fused_block.fused_attention_block_bwd_spill_cuda(*args, k)
    _hold_grads(BWD_NAMES, again, got, REPEAT_BOUND)


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
    """Kernel 4 ('mlp') or 5 ('attention') operands at Swin-tiny stage
    `stage` of an `images`-image batch (the shifted blocks' bias), with a
    per-image stochastic-depth keep or none."""
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
    return (fused_block.fused_attention_block_bwd_cuda,
            fused_block.fused_attention_block_bwd_plain, BWD_NAMES,
            (*args, k))


@pytest.mark.gpu
@pytest.mark.parametrize("keep", [False, True], ids=["nokeep", "keep"])
@pytest.mark.parametrize("half,stage", [("mlp", 0), ("mlp", 1), ("mlp", 2),
                                        ("mlp", 3), ("attention", 0),
                                        ("attention", 1), ("attention", 2)])
def test_backward_kernels_bit_for_bit_at_every_stage(rng, cuda_device, half,
                                                     stage, keep):
    """Kernels 4 and 5 at every stage shape they serve in a 150-image
    auxiliary step, with and without keep: two launches give the same bits
    (every cross-block sum in a fixed order, no atomics)."""
    kernel, _, _, args = _stage_bwd_args(rng, cuda_device, half, stage, keep)
    got = kernel(*args)
    again = kernel(*args)
    torch.cuda.synchronize()
    assert all(torch.isfinite(g).all() for g in got)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("half", ["mlp", "attention"])
def test_backward_kernels_write_every_output(rng, cuda_device, monkeypatch,
                                             half):
    """Stage 0 of a 150-image batch, with keep: every tensor the wrapper
    allocates (outputs and scratch) starts as NaN, so an element that no
    block writes, or a scratch element read before it is written, shows as
    a non-finite output or a miss against the plain version."""
    kernel, plain, names, args = _stage_bwd_args(rng, cuda_device, half, 0,
                                                 True)
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
@pytest.mark.parametrize("w,c,h,nw", [(32, 96, 3, 16), (16, 192, 6, 1),
                                      (8, 384, 12, 4), (6, 768, 24, 1)],
                         ids=["stage0-shifted", "stage1", "stage2-shifted",
                              "stage3"])
def test_fused_whole_block_kernel(rng, cuda_device, w, c, h, nw):
    """Every Swin-tiny stage width, stage 3 in two column passes: the kernel
    against its plain version, and against the split (kernels 2 and 3)."""
    args = _whole_inputs(rng, cuda_device, w, 49, c, h, nw)
    got = fused_block.fused_whole_block_cuda(*args)
    want = fused_block.fused_whole_block_plain(*args)
    y = fused_block.fused_attention_block_cuda(*args[:8])
    split = block_mlp.fused_ln_mlp_residual_cuda(y.reshape(-1, c), *args[8:])
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= BOUND
    assert _rel(got, split.reshape(got.shape)) <= BOUND


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


def _window_inputs(rng, dev, w, h, n, hd, nw):
    bf = lambda a: torch.tensor(a).to(dev, torch.bfloat16).contiguous()
    bias = rng.normal(size=(nw, h, n, n))
    if nw > 1:
        bias += np.where(rng.random((nw, 1, n, n)) > 0.7, -100.0, 0.0)
    return (bf(rng.normal(size=(w, h, n, hd)) * hd ** -0.5),
            bf(rng.normal(size=(w, h, n, hd))),
            bf(rng.normal(size=(w, h, n, hd))),
            torch.tensor(bias, dtype=torch.float32, device=dev))


@pytest.mark.gpu
@pytest.mark.parametrize("w,h,n,hd,nw", [(128, 3, 49, 32, 64),
                                         (12, 24, 49, 32, 1),
                                         (8, 2, 16, 16, 4),
                                         (6, 1, 64, 64, 1)])
@pytest.mark.parametrize("variant", sorted(WINDOW_KERNELS))
def test_window_attention_kernels(rng, cuda_device, variant, w, h, n, hd, nw):
    """Every entry point at stage shapes, a tiny one and the largest tile;
    W = 12 and 6 make v2 shrink its group to 4 and 3."""
    args = _window_inputs(rng, cuda_device, w, h, n, hd, nw)
    got = WINDOW_KERNELS[variant](*args)
    want = window_attention.window_attention_plain(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= BOUND


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
@pytest.mark.parametrize("t,c4,c2", [(1, 384, 192), (1024, 1536, 768),
                                     (1000, 768, 384), (130, 48, 208)])
def test_fused_merge_kernel_tiles(rng, cuda_device, t, c4, c2):
    """T = 1; transition 2's widths (K = 1536, M = 768) at T = 1024; T not a
    multiple of the 64-row tile; K under one 64-wide chunk and M not a
    multiple of the 192-column tile (a second tile of 16 columns)."""
    bf = lambda a: torch.tensor(a).to(cuda_device, torch.bfloat16).contiguous()
    args = (bf(rng.normal(size=(1, t, c4))),
            bf(1 + 0.1 * rng.normal(size=c4)), bf(0.1 * rng.normal(size=c4)),
            bf(rng.normal(size=(c4, c2)) / np.sqrt(c4)))
    got = merge_kernel.fused_merge_cuda(*args)
    want = merge_kernel.fused_merge_plain(*args)
    torch.cuda.synchronize()
    assert got.shape == (1, t, c2)
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= BOUND
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
    repeatable from the same weights to the fp32-atomics tolerance."""
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
    assert abs(loss_a - loss_b) <= 1e-3 * abs(loss_a)
    moved = 0
    for k, p in model.swin_model.named_parameters():
        # one AdamW step moves an element by at most lr, whatever its gradient
        assert float((sd_a[k] - sd_b[k]).abs().max()) <= 2.1 * cfg.optim.aux_lr
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
    default_route = ("fused_attention", "fused_attention_block",
                     "fused_ln_mlp_residual", "fused_ln_mlp_residual_bwd",
                     "fused_attention_block_bwd",
                     "fused_attention_block_bwd_spill")
    assert all(counts[k] > 0 for k in default_route), counts
    # the window-attention and merge kernels are on other routes only
    assert all(n == 0 for k, n in counts.items()
               if k not in default_route), counts
