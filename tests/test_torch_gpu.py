"""The port's CUDA kernels on the card, and the wrappers' input checks.

This file imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

The `gpu` tests skip without a CUDA device.  Each holds a kernel against its
plain PyTorch version on the same bf16 inputs at max|d| <= 2e-2 * max|out|
(both round to bf16 at different points; the JAX suite's kernel bound).
"""

import numpy as np
import pytest
import torch

from facialmmt_tpu_torch.ops import kernels
from facialmmt_tpu_torch.ops.kernels import attention, block_mlp, fused_block

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
                        dtype=torch.float32, transfer_dtype=np.float32)
    req = [{"input_ids": np.arange(2, 40), "sep_mask": np.eye(38)[20],
            "faces": np.full((3, 160, 160, 3), 90, np.uint8),
            "audio": np.ones((4, cfg.data.audio_feat_dim))}]
    kernels.reset_launch_counts()
    out = gpu.predict(req)
    counts = kernels.launch_counts()
    assert all(n > 0 for n in counts.values()), counts
    np.testing.assert_allclose(out[0], cpu.predict(req)[0], atol=2e-2)
