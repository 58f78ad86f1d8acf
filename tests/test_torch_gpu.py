"""The port's CUDA kernels on the card, and the wrappers' input checks.

This file imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

The `gpu` tests skip without a CUDA device.  Each holds a kernel against its
plain PyTorch version on the same bf16 inputs at max|d| <= 2e-2 * max|out|
per output (both round to bf16 at different points; the JAX suite's kernel
bound).  The backward kernels sum across blocks with fp32 atomics, so two
runs agree to rounding, not bit for bit: REPEAT_BOUND.
"""

import numpy as np
import pytest
import torch

from facialmmt_tpu_torch.ops import kernels
from facialmmt_tpu_torch.ops.kernels import attention, block_mlp, fused_block

BOUND = 2e-2
REPEAT_BOUND = 1e-3   # run-to-run, relative to max|out|: fp32 atomic order


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
    _hold_grads(BWD_NAMES, again, got, REPEAT_BOUND)
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
    """T = 1000 and 50 are not multiples of the 32-token tile."""
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
    _hold_grads(names, again, got, REPEAT_BOUND)


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
def test_tiny_server_runs_every_kernel(cuda_device):
    """A tiny serving path on the card goes through all three kernels and
    agrees with the same weights on the CPU in fp32 (bound 2e-2 on the
    probabilities: bf16 rounding through the tiny stack)."""
    import dataclasses

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
def test_tiny_trainer_on_the_card(cuda_device):
    """Trainer defaults to the card and runs the whole loop there."""
    import dataclasses

    from facialmmt_tpu_torch.config import FacialMMTConfig
    from facialmmt_tpu_torch.data.meld import (SyntheticFerDataset,
                                               SyntheticMeldDataset)
    from facialmmt_tpu_torch.train.trainer import Trainer

    cfg = FacialMMTConfig.tiny()
    # Swin widths the kernels take (channels and head dims multiples of 16)
    cfg = cfg.replace(optim=dataclasses.replace(
        cfg.optim, aux_batch_size=6, trg_batch_size=2,
        trg_accumulation_steps=2), swin_from_target=True,
        swin=dataclasses.replace(cfg.swin, embed_dim=32))
    trainer = Trainer(cfg)
    assert trainer.device.type == "cuda"
    ds = SyntheticMeldDataset(cfg, 8, 2, 3, seed=2)
    f1 = trainer.run_multimodal(SyntheticFerDataset(12, 24, seed=1), ds, ds, ds)
    assert np.isfinite(f1)
    assert (trainer.state.swin_step, trainer.state.mm_step) == (4, 2)
    counts = kernels.launch_counts()
    assert all(n > 0 for n in counts.values()), counts
