"""Activation checkpointing of the port (SwinConfig.remat,
TextEncoderConfig.remat) on the CPU.

With remat on, every Swin block / text layer runs under
torch.utils.checkpoint and is recomputed in the backward.  It must change
nothing: the same loss, gradients, BatchNorm statistics and generator state
after the step as without it, bit for bit (the CPU recompute runs the same
kernels in the same order), with dropout ON in the text tower and in the
Swin 'xla' route (their masks come from an explicit generator, which
torch's checkpoint does not replay: ops/layers.py::checkpointed does).  The
remat paths also hold against JAX's with nn.remat at
tests/test_torch_train.py's and tests/test_torch_models.py's tolerances,
and 'auto' switches on above JAX's thresholds (512 images, 4096 tokens).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from facialmmt_tpu.config import FacialMMTConfig, TextEncoderConfig
from facialmmt_tpu.models.pipeline import FacialMMTPipeline as JaxPipeline
from facialmmt_tpu.train import steps as jsteps
from facialmmt_tpu_torch.checkpoint import from_jax
from facialmmt_tpu_torch.models.pipeline import FacialMMTPipeline
from facialmmt_tpu_torch.ops import swin as port_swin
from facialmmt_tpu_torch.train import steps as psteps
from tests.test_models import make_multimodal_batch
from tests.test_torch_ops import TOL, T, bridged, random_params
from tests.test_torch_train import _hold_tree, _np_tree, nodrop_config
from tests.torch_bridge import port_config

rep = dataclasses.replace


def _with_remat(cfg, swin=None, text=None):
    return cfg.replace(
        swin=cfg.swin if swin is None else rep(cfg.swin, remat=swin),
        text=cfg.text if text is None else rep(cfg.text, remat=text))


def _twins(cfg, sd):
    """The port pipeline without and with remat, the same weights, in
    train mode."""
    out = []
    for on in (False, True):
        m = FacialMMTPipeline(_with_remat(cfg, swin=on, text=on))
        m.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})
        out.append(m.train())
    return out


def _grads(model):
    return {k: p.grad.clone() for k, p in model.named_parameters()
            if p.grad is not None}


def _assert_same(a, b, what):
    assert a.keys() == b.keys(), what
    for k in a:
        assert torch.equal(a[k], b[k]), (what, k)


@pytest.fixture(scope="module")
def weights():
    rng = np.random.default_rng(5)
    cfg = FacialMMTConfig.tiny()
    batch = make_multimodal_batch(rng, cfg, b=2)
    v = random_params(JaxPipeline(cfg), rng, batch)
    return from_jax.pipeline_state_dict(_np_tree(v)), batch


def test_aux_step_remat_equals_plain(weights):
    """Swin remat with stochastic depth on: the drop-path multipliers are
    drawn before each block and passed in, so the recompute uses them."""
    sd, batch = weights
    cfg = port_config(FacialMMTConfig.tiny())
    cfg = cfg.replace(swin=rep(cfg.swin, drop_path_rate=0.3))
    images = torch.tensor(np.asarray(batch["faces"]))
    labels = torch.tensor([0, 3, 6, 1, 2, 5, 4, 0])
    seen = []
    for model in _twins(cfg, sd):
        g = torch.Generator().manual_seed(7)
        loss = psteps.cross_entropy(model.aux_logits(images, generator=g),
                                    labels)
        loss.backward()
        seen.append((loss.detach(), _grads(model), model.state_dict(),
                     g.get_state()))
    (l0, g0, s0, r0), (l1, g1, s1, r1) = seen
    assert torch.equal(l0, l1)
    _assert_same(g0, g1, "aux gradients")
    _assert_same(s0, s1, "BatchNorm statistics")
    assert torch.equal(r0, r1)


def test_target_step_text_remat_with_dropout_equals_plain(weights):
    """Joint target steps with every dropout on and sampled gumbel: the
    text layers' masks come from the step's generator; the recompute
    replays them and leaves the generator where the plain step does."""
    sd, batch = weights
    cfg = port_config(FacialMMTConfig.tiny())
    assert cfg.text.hidden_dropout_prob > 0
    tb = {k: torch.tensor(np.asarray(v)) for k, v in batch.items()}
    seen = []
    for model in _twins(cfg, sd):
        g = torch.Generator().manual_seed(11)
        logits = model(tb, generator=g, stop_swin_gradient=False)
        loss = psteps.cross_entropy(logits, tb["labels"])
        loss.backward()
        seen.append((loss.detach(), _grads(model), g.get_state()))
    (l0, g0, r0), (l1, g1, r1) = seen
    assert torch.equal(l0, l1)
    _assert_same(g0, g1, "target gradients")
    assert torch.equal(r0, r1)
    # the generator moved on from its seed (the dropouts drew from it)
    assert not torch.equal(r0, torch.Generator().manual_seed(11).get_state())


def test_swin_xla_route_dropout_remat_equals_plain():
    """Swin's own dropouts (drop_rate, attn_drop_rate: 'xla' halves only)
    draw inside the checkpointed blocks."""
    from facialmmt_tpu_torch.ops.swin import SwinTransformer

    base = port_config(FacialMMTConfig.tiny()).swin
    base = rep(base, attention_impl="xla", mlp_impl="xla", drop_rate=0.1,
               attn_drop_rate=0.1, drop_path_rate=0.2)
    x = torch.randn(4, base.img_size, base.img_size, 3,
                    generator=torch.Generator().manual_seed(0))
    seen = []
    for on in (False, True):
        torch.manual_seed(0)
        m = SwinTransformer(rep(base, remat=on)).train()
        g = torch.Generator().manual_seed(3)
        y = m(x, generator=g)
        y.square().sum().backward()
        seen.append((y.detach(), _grads(m), g.get_state()))
    assert torch.equal(seen[0][0], seen[1][0])
    _assert_same(seen[0][1], seen[1][1], "Swin gradients")
    assert torch.equal(seen[0][2], seen[1][2])



def test_swin_auto_route_dropout_remat_equals_plain():
    """The default route with Swin's dropouts on: the training forward sends
    both halves to the plain 'xla' composition (JAX's rule), whose draws the
    checkpointed blocks replay."""
    from facialmmt_tpu_torch.ops.swin import SwinTransformer

    base = port_config(FacialMMTConfig.tiny()).swin
    base = rep(base, attention_impl="auto", mlp_impl="auto", drop_rate=0.1,
               attn_drop_rate=0.1, drop_path_rate=0.2)
    x = torch.randn(4, base.img_size, base.img_size, 3,
                    generator=torch.Generator().manual_seed(0))
    seen = []
    for on in (False, True):
        torch.manual_seed(0)
        m = SwinTransformer(rep(base, remat=on)).train()
        g = torch.Generator().manual_seed(3)
        y = m(x, generator=g)
        y.square().sum().backward()
        seen.append((y.detach(), _grads(m), g.get_state()))
    assert torch.equal(seen[0][0], seen[1][0])
    _assert_same(seen[0][1], seen[1][1], "Swin gradients")
    assert torch.equal(seen[0][2], seen[1][2])

def test_aux_gradients_with_remat_match_jax(weights):
    """The remat aux gradients against JAX's aux gradients with
    SwinConfig.remat=True (nn.remat on each block)."""
    sd, batch = weights
    jcfg = nodrop_config()
    jcfg = jcfg.replace(swin=rep(jcfg.swin, remat=True))
    jmodel = JaxPipeline(jcfg)
    rng = np.random.default_rng(6)
    v = random_params(jmodel, rng, batch)
    images = np.asarray(batch["faces"])
    labels = rng.integers(0, 7, size=images.shape[0]).astype(np.int32)

    def loss_fn(swin_params):
        params = {"swin_model": swin_params,
                  "multimodal": v["params"]["multimodal"]}
        logits, _ = jmodel.apply(
            {"params": params, "batch_stats": v["batch_stats"]}, images,
            deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)},
            method=JaxPipeline.aux_logits, mutable=["batch_stats"])
        return jsteps.cross_entropy(logits, labels)

    want = {"params": {"swin_model": _np_tree(jax.jit(jax.grad(loss_fn))(
        v["params"]["swin_model"]))}}
    model = FacialMMTPipeline(port_config(jcfg)).train()
    model.load_state_dict({k: torch.tensor(x) for k, x in
                           from_jax.pipeline_state_dict(_np_tree(v)).items()})
    psteps.cross_entropy(model.aux_logits(torch.tensor(images)),
                         torch.tensor(labels)).backward()
    got = from_jax.to_jax_tree(
        {k: g.numpy() for k, g in _grads(model).items()},
        like=_np_tree(v))
    _hold_tree(got, want, "aux gradients under remat")


def test_text_encoder_gradients_with_remat_match_jax(rng):
    from facialmmt_tpu.models.text_encoder import TextEncoder as J
    from facialmmt_tpu_torch.models.text_encoder import TextEncoder as P

    cfg = rep(TextEncoderConfig.tiny(), remat=True,
              hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    ids = rng.integers(2, cfg.vocab_size, size=(3, 20)).astype(np.int32)
    mask = np.ones((3, 20), np.int32)
    mask[1, 12:] = 0
    jm = J(cfg)
    v = random_params(jm, rng, ids, mask)
    w = rng.normal(size=(3, 20, cfg.hidden_size)).astype(np.float32)

    def loss(params):
        out = jm.apply({"params": params}, ids, mask, deterministic=False,
                       rngs={"dropout": jax.random.PRNGKey(0)})
        return (out * w).sum()

    want_loss, want = jax.jit(jax.value_and_grad(loss))(v["params"])
    tm = P(port_config(cfg)).train()
    tm.load_state_dict(bridged(from_jax._text_encoder, v["params"]),
                       strict=True)
    got_loss = (tm(T(ids), T(mask)) * T(w)).sum()
    got_loss.backward()
    np.testing.assert_allclose(got_loss.item(), float(want_loss), **TOL)
    want_sd = bridged(from_jax._text_encoder, _np_tree(want))
    floor = 1e-2 * max(float(t.abs().max()) for t in want_sd.values())
    for k, p in tm.named_parameters():
        g, ref = p.grad.numpy(), want_sd[k].numpy()
        scale = max(np.abs(ref).max(), floor)
        assert np.abs(g - ref).max() <= 1e-4 * scale, k


@pytest.mark.parametrize("which,batch,expect", [
    ("swin", 512, False), ("swin", 513, True),
    ("text", 32, False), ("text", 33, True)])
def test_auto_remat_thresholds(monkeypatch, which, batch, expect):
    """'auto': Swin above 512 packed images, the text tower above 4096
    tokens (batch x 128 here), and only where a graph is built."""
    from facialmmt_tpu_torch.models import text_encoder

    calls = []
    module = port_swin if which == "swin" else text_encoder
    real = module.checkpointed
    monkeypatch.setattr(module, "checkpointed",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    cfg = port_config(FacialMMTConfig.tiny())
    assert cfg.swin.remat == cfg.text.remat == "auto"
    if which == "swin":
        from facialmmt_tpu_torch.ops.swin import SwinTransformer

        m = SwinTransformer(cfg.swin).train()
        x = torch.zeros(batch, cfg.swin.img_size, cfg.swin.img_size, 3,
                        requires_grad=True)
        run = lambda: m(x)          # noqa: E731
    else:
        m = text_encoder.TextEncoder(cfg.text).train()
        ids = torch.full((batch, 128), 5)
        run = lambda: m(ids, torch.ones_like(ids))   # noqa: E731
    with torch.no_grad():
        run()
    assert not calls                # no graph, nothing to recompute
    run()
    assert bool(calls) == expect
