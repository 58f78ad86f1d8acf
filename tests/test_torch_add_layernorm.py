"""The residual add + TF-style LayerNorm route (ops/kernels/add_layernorm.py)
and the GELU beside it, on the CPU at tiny() widths.

The kernel runs only on the card (tests/test_torch_gpu.py); here: its plain
version is the chain LayerNormTF computed before the route existed, bit for
bit; the modules that now hand their residual to LayerNormTF give the
outputs and gradients of the former `LayerNorm(out + x)` under grad; and a
CPU tensor never reaches the kernel's wrapper, with or without grad.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from facialmmt_tpu_torch.config import EncoderConfig, TextEncoderConfig
from facialmmt_tpu_torch.models.text_encoder import TextEncoder
from facialmmt_tpu_torch.ops import kernels, layers
from facialmmt_tpu_torch.ops.crossmodal import CrossModalTransformerEncoder
from facialmmt_tpu_torch.ops.encoder import UttTransEncoder
from facialmmt_tpu_torch.ops.kernels import add_layernorm
from tests import torch_bridge  # noqa: F401  (one intra-op thread)


def seed_chain(x, weight, bias, eps):
    """LayerNormTF.forward as it was before the route: fp32 statistics and
    affine map, the input's dtype out."""
    xf = x.float()
    u = xf.mean(-1, keepdim=True)
    s = (xf - u).square().mean(-1, keepdim=True)
    y = (xf - u) * torch.rsqrt(s + eps)
    y = weight.float() * y + bias.float()
    return y.to(x.dtype)


def _seed_forward(self, x, residual=None):
    return seed_chain(x if residual is None else x + residual, self.weight,
                      self.bias, self.eps)


def _rows(rng, shape, dtype, scale=1.0, shift=0.0):
    return torch.tensor(rng.normal(size=shape) * scale + shift).to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("residual", [True, False], ids=["res", "nores"])
@pytest.mark.parametrize("h,eps", [(64, 1e-5), (8, 1e-12), (24, 1e-12)])
def test_plain_version_is_the_seed_chain_bit_for_bit(dtype, residual, h, eps):
    """fused_add_layernorm_plain and LayerNormTF(x, residual) on the CPU give
    the bits of the former LayerNormTF(x + residual), parameters in bf16 and
    fp32 (the embeddings' LayerNorm takes fp32 rows with bf16 parameters)."""
    rng = np.random.default_rng(h)
    x = _rows(rng, (3, 5, h), dtype, 2.0, 0.5)
    r = _rows(rng, (3, 5, h), dtype) if residual else None
    for pdtype in (torch.bfloat16, torch.float32):
        ln = layers.LayerNormTF(h, eps).to(pdtype)
        with torch.no_grad():
            ln.weight.copy_(_rows(rng, (h,), pdtype, 0.1, 1.0))
            ln.bias.copy_(_rows(rng, (h,), pdtype, 0.1))
        want = seed_chain(x if r is None else x + r, ln.weight, ln.bias, eps)
        got = add_layernorm.fused_add_layernorm_plain(x, r, ln.weight,
                                                      ln.bias, eps)
        assert got.dtype == dtype
        assert torch.equal(got, want)
        for grad in (True, False):
            with torch.set_grad_enabled(grad):
                assert torch.equal(ln(x, r), want)


def test_residual_of_another_dtype_promotes_as_the_add_does():
    """x + residual promotes bf16 + fp32 to fp32 in both versions."""
    rng = np.random.default_rng(1)
    x = _rows(rng, (4, 16), torch.bfloat16)
    r = _rows(rng, (4, 16), torch.float32)
    ln = layers.LayerNormTF(16, 1e-5)
    got = ln(x, r)
    assert got.dtype == torch.float32
    assert torch.equal(got, seed_chain(x + r, ln.weight, ln.bias, 1e-5))


def _text_and_fusion(dtype):
    """A tiny text tower, a 2-layer utterance encoder and a crossmodal stack,
    with non-trivial LayerNorm parameters, in `dtype`."""
    torch.manual_seed(0)
    text = TextEncoder(TextEncoderConfig.tiny())
    enc = UttTransEncoder(EncoderConfig(hidden_size=64, num_attention_heads=4,
                                        intermediate_size=128), 2, 12)
    cm = CrossModalTransformerEncoder(64, 4, 2, max_positions=16)
    with torch.no_grad():
        for mod in (text, enc, cm):
            for m in mod.modules():
                if isinstance(m, layers.LayerNormTF):
                    m.weight.normal_(1.0, 0.1)
                    m.bias.normal_(0.0, 0.1)
    return [m.to(dtype) for m in (text, enc, cm)]


def _run(mods, dtype):
    """Outputs of the three modules on fixed inputs, and the gradients of
    their parameters and inputs under a fixed cotangent (eval mode: no
    dropout draws)."""
    text, enc, cm = mods
    rng = np.random.default_rng(7)
    ids = torch.tensor(rng.integers(3, 500, size=(2, 12)))
    mask = torch.ones(2, 12, dtype=torch.int64)
    mask[1, 9:] = 0
    feats = _rows(rng, (2, 12, 64), dtype).requires_grad_(True)
    other = _rows(rng, (2, 7, 64), dtype).requires_grad_(True)
    outs = [text(ids, mask), enc(feats, mask), cm(feats, other, other)]
    loss = sum((o.float() * torch.linspace(-1, 1, o.shape[-1])).sum()
               for o in outs)
    loss.backward()
    grads = [p.grad for m in mods for p in m.parameters()]
    return outs + grads + [feats.grad, other.grad]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_modules_under_grad_are_unchanged(dtype, monkeypatch):
    """The text tower, the utterance encoder and the crossmodal stack give
    the bits, and the gradients, of LayerNormTF's former forward on the
    sum."""
    mods = _text_and_fusion(dtype)
    for m in mods:
        m.eval()
    got = _run(mods, dtype)
    for m in mods:
        m.zero_grad(set_to_none=True)
    monkeypatch.setattr(layers.LayerNormTF, "forward", _seed_forward)
    want = _run(mods, dtype)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a is not None and torch.equal(a, b)


def test_cpu_tensors_never_launch_the_kernel():
    """With grad and without, a CPU pass through the modules leaves every
    launch counter at 0, and the wrapper refuses a CPU tensor."""
    mods = _text_and_fusion(torch.float32)
    kernels.reset_launch_counts()
    for grad in (True, False):
        with torch.set_grad_enabled(grad):
            _run_forward(mods)
    assert set(kernels.launch_counts().values()) == {0}
    assert kernels.launch_counts()["fused_add_layernorm"] == 0
    w = torch.ones(64)
    with pytest.raises(ValueError, match="CUDA"):
        add_layernorm.fused_add_layernorm_cuda(torch.zeros(2, 64), None, w,
                                               torch.zeros(64), 1e-5)


def _run_forward(mods):
    text, enc, cm = mods
    ids = torch.full((2, 12), 5)
    mask = torch.ones(2, 12, dtype=torch.int64)
    feats = torch.ones(2, 12, 64)
    return text(ids, mask), enc(feats, mask), cm(feats, feats, feats)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_gelu_on_the_cpu_is_the_fp32_chain(dtype):
    """gelu_erf on a CPU tensor keeps the fp32 chain, with and without grad."""
    x = torch.linspace(-6, 6, 4097).to(dtype)
    want = F.gelu(x.float()).to(dtype)
    for grad in (True, False):
        with torch.set_grad_enabled(grad):
            assert torch.equal(layers.gelu_erf(x), want)


def test_a_pack_runs_one_layernorm_a_launch_of_the_formula(monkeypatch):
    """chip_smoke.add_ln_launches, which pins kernel 13's launches a pack on
    the card, counts every LayerNormTF call of a tiny() pack (47) and of
    the default model's depths (99: 49 text, 14 encoders, 36 crossmodal)."""
    import dataclasses

    import chip_smoke
    from facialmmt_tpu_torch.config import FacialMMTConfig
    from facialmmt_tpu_torch.serving import EmotionServer

    calls = []
    forward = layers.LayerNormTF.forward

    def counted(self, x, residual=None):
        calls.append(residual is not None)
        return forward(self, x, residual)

    monkeypatch.setattr(layers.LayerNormTF, "forward", counted)
    tiny, full = FacialMMTConfig.tiny(), FacialMMTConfig()
    deep = tiny.replace(
        text=dataclasses.replace(tiny.text, num_layers=full.text.num_layers),
        audio_utt_transformer_num=full.audio_utt_transformer_num,
        vision_utt_transformer_num=full.vision_utt_transformer_num,
        crossmodal_ta=dataclasses.replace(
            tiny.crossmodal_ta, layers=full.crossmodal_ta.layers),
        crossmodal_ta_v=dataclasses.replace(
            tiny.crossmodal_ta_v, layers=full.crossmodal_ta_v.layers))
    assert chip_smoke.add_ln_launches(full) == 99
    for cfg, want in ((tiny, 47), (deep, 99)):
        server = EmotionServer(cfg, max_batch=1, face_capacity=2,
                               device="cpu", dtype=torch.float32,
                               transfer_dtype=np.float32)
        calls.clear()
        server.predict([{"input_ids": np.arange(2, 20),
                         "sep_mask": np.eye(18)[9],
                         "faces": np.full((1, 160, 160, 3), 90, np.uint8),
                         "audio": np.ones((3, cfg.data.audio_feat_dim))}])
        assert len(calls) == chip_smoke.add_ln_launches(cfg) == want
        # the residual handed over in the text tower's and the encoders'
        # post-LN layers, none in the pre-LN crossmodal stacks
        assert sum(calls) == 2 * (cfg.text.num_layers
                                  + cfg.audio_utt_transformer_num
                                  + cfg.vision_utt_transformer_num)
