"""The port's op modules against their JAX counterparts on the CPU.

Same inputs, made from a numpy seed, go through the JAX module (XLA path,
float32, conftest's 'highest' matmul precision) and the port module; JAX
parameters are drawn at random from the seed and carried over by the weight
bridge.  Tolerance atol 1e-4 / rtol 1e-4 unless a line says otherwise.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facialmmt_tpu.config import EncoderConfig
from facialmmt_tpu_torch.checkpoint import from_jax
from tests.torch_bridge import port_config

def T(a):
    return torch.tensor(np.asarray(a))


TOL = dict(atol=1e-4, rtol=1e-4)


def random_params(module, rng, *args, **kwargs):
    """JAX variables of `module` with every leaf drawn from `rng` (shapes from
    jax.eval_shape, so nothing is compiled): matrices ~ N(0, 1/fan_in), norm
    scales ~ 1 + N(0, 0.1), other vectors ~ N(0, 0.1), BatchNorm running
    variances ~ U(0.5, 1.5)."""
    shapes = jax.eval_shape(module.init, {"params": jax.random.PRNGKey(0),
                                          "gumbel": jax.random.PRNGKey(1)},
                            *args, **kwargs)

    def fill(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "var":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if len(s.shape) >= 2:
            fan_in = math.prod(s.shape[:-1])
            return (rng.normal(size=s.shape) / math.sqrt(fan_in)).astype(
                np.float32)
        base = 1.0 if name in ("scale", "weight") else 0.0
        return (base + 0.1 * rng.normal(size=s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def bridged(fn, tree):
    """Run a from_jax helper with a throwaway prefix; return torch tensors."""
    out = {}
    fn(tree, out, "m")
    return {k[2:]: torch.as_tensor(v) for k, v in out.items()}


# ------------------------------------------------------------------ layers --

def test_layers_match_jax(rng):
    from facialmmt_tpu.ops import layers as jl
    from facialmmt_tpu_torch.ops import layers as tl

    x = rng.normal(size=(3, 5, 12)).astype(np.float32)
    mask = np.ones((3, 5), np.int32)
    mask[1, 3:] = 0
    mask[2, :] = 0

    ln = jl.LayerNormTF(1e-12)
    v = random_params(ln, rng, x)
    t_ln = tl.LayerNormTF(12, 1e-12)
    t_ln.load_state_dict({k: T(np.asarray(a)) for k, a in
                          v["params"].items()}, strict=True)
    np.testing.assert_allclose(t_ln(T(x)).detach().numpy(),
                               np.asarray(ln.apply(v, x)), **TOL)

    lin = jl.TorchLinear(7)
    v = random_params(lin, rng, x)
    t_lin = tl.TorchLinear(12, 7)
    t_lin.load_state_dict({"weight": T(np.asarray(v["params"]["kernel"]).T.copy()),
                           "bias": T(np.asarray(v["params"]["bias"]))})
    np.testing.assert_allclose(t_lin(T(x)).detach().numpy(),
                               np.asarray(lin.apply(v, x)), **TOL)

    att = jl.AdditiveAttention(12, 12)
    v = random_params(att, rng, x, mask)
    t_att = tl.AdditiveAttention(12, 12)
    sd = {}
    p = v["params"]
    sd["query_vector"] = T(np.asarray(p["query_vector"]))
    for name in ("P", "Q", "value"):
        sd[f"{name}.weight"] = T(np.asarray(p[name]["kernel"]).T.copy())
        sd[f"{name}.bias"] = T(np.asarray(p[name]["bias"]))
    t_att.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got, alpha = t_att(T(x), T(mask))
    want, want_alpha = att.apply(v, x, mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(want_alpha), **TOL)
    # seq_len == 1: the squeezed input comes back unchanged
    got1, _ = t_att(T(x[:, :1]), T(mask[:, :1]))
    np.testing.assert_array_equal(got1.numpy(), x[:, 0])


# ------------------------------------------------------------------ gumbel --

def test_gumbel_matches_jax(rng):
    from facialmmt_tpu.ops.gumbel import gumbel_softmax as jg
    from facialmmt_tpu_torch.ops.gumbel import gumbel_noise, gumbel_softmax

    logits = rng.normal(size=(6, 7)).astype(np.float32)
    np.testing.assert_allclose(
        gumbel_softmax(T(logits), 0.7, deterministic=True).numpy(),
        np.asarray(jg(None, logits, 0.7, deterministic=True)), **TOL)
    # sampled mode with the noise handed in: JAX's own draw, fed to the port
    key = jax.random.PRNGKey(3)
    u = jax.random.uniform(key, logits.shape, dtype=jnp.float32,
                           minval=jnp.finfo(jnp.float32).tiny, maxval=1.0)
    noise = np.asarray(-jnp.log(-jnp.log(u)))
    np.testing.assert_allclose(
        gumbel_softmax(T(logits), 0.7, noise=T(noise)).numpy(),
        np.asarray(jg(key, logits, 0.7)), **TOL)
    # a generator draw is reproducible from its seed and sums to one
    draw = lambda: gumbel_softmax(T(logits), 1.0, generator=torch.Generator()
                                  .manual_seed(5))
    np.testing.assert_array_equal(draw().numpy(), draw().numpy())
    np.testing.assert_allclose(draw().sum(-1).numpy(), 1.0, atol=1e-6)
    assert gumbel_noise((4,), torch.Generator().manual_seed(0), "cpu").isfinite().all()
    with pytest.raises(ValueError):
        gumbel_softmax(T(logits), 1.0)


# ----------------------------------------------------------- span extract --

@pytest.mark.parametrize("is_roberta", [True, False], ids=["roberta", "bert"])
def test_span_extract_matches_jax(rng, is_roberta):
    from facialmmt_tpu.ops import span_extract as js
    from facialmmt_tpu_torch.ops import span_extract as ts

    b, l, h = 6, 40, 5
    sep = np.zeros((b, l), np.int32)
    for i in range(b):
        pos = np.sort(rng.choice(np.arange(3, l), size=rng.integers(1, 5),
                                 replace=False))
        sep[i, pos] = 1
    utt = rng.integers(0, 5, size=b).astype(np.int32)   # some past the last sep
    feats = rng.normal(size=(b, l, h)).astype(np.float32)
    for a, w in zip(ts.spans_from_sep_mask(T(sep), T(utt), is_roberta),
                    js.spans_from_sep_mask(jnp.asarray(sep), jnp.asarray(utt),
                                           is_roberta)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(w))
    got, gmask = ts.extract_utt_spans(T(feats), T(sep), T(utt), max_utt_len=6,
                                      is_roberta=is_roberta)
    want, wmask = js.extract_utt_spans(feats, sep, utt, max_utt_len=6,
                                       is_roberta=is_roberta)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(gmask.numpy(), np.asarray(wmask))


# ------------------------------------------------------------ frame filter --

def test_frame_filter_matches_jax(rng):
    from facialmmt_tpu.ops import frame_filter as jf
    from facialmmt_tpu_torch.ops import frame_filter as tf

    b, f, c, d, n = 4, 6, 7, 5, 20
    logits = rng.normal(size=(n, c)) * rng.uniform(0.1, 4.0, size=(n, 1))
    flat = np.asarray(jax.nn.softmax(logits.astype(np.float32), -1))
    utt_id = np.repeat(np.arange(b), 5).astype(np.int32)
    utt_id[-3:] = -1                                  # pad slots
    pos = np.tile(np.arange(5), b).astype(np.int32)
    n_faces = np.asarray([5, 5, 5, 2], np.int32)
    probs_t = tf.scatter_face_probs(T(flat), T(utt_id), T(pos), b, f)
    probs_j = jf.scatter_face_probs(flat, utt_id, pos, b, f)
    np.testing.assert_allclose(probs_t.numpy(), np.asarray(probs_j), atol=1e-7)
    probs = np.array(probs_j)
    probs[0] = np.full((f, c), 1.0 / c)               # all filtered -> fallback
    feats = rng.normal(size=(b, f, d)).astype(np.float32)
    mask = (np.arange(f)[None, :] < n_faces[:, None]).astype(np.int32)
    got, gmask = tf.frame_importance_filter(T(feats), T(probs), T(mask), 0.2)
    want, wmask = jf.frame_importance_filter(feats, probs, mask, 0.2)
    # the threshold is a hard cut: the masks must be equal, not close
    np.testing.assert_array_equal(gmask.numpy(), np.asarray(wmask))
    conf = np.sum(probs ** 2, -1)
    keep = (conf > 0.2) & mask.astype(bool)
    keep = np.where(keep.any(1, keepdims=True), keep, mask.astype(bool))
    np.testing.assert_array_equal(
        tf.frame_keep_mask(T(probs), T(mask), 0.2).numpy(), keep)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7)
    assert gmask.numpy()[0].sum() == 5                # fallback kept all real


# --------------------------------------------------------------- encoders --

def test_utt_encoder_matches_jax(rng):
    from facialmmt_tpu.ops.encoder import UttTransEncoder as J
    from facialmmt_tpu_torch.ops.encoder import UttTransEncoder as P

    cfg = EncoderConfig(hidden_size=32, num_attention_heads=4,
                        intermediate_size=64)
    x = rng.normal(size=(3, 9, 32)).astype(np.float32)
    mask = np.ones((3, 9), np.int32)
    mask[1, 5:] = 0
    mask[2, :] = 0
    jm = J(cfg, num_layers=2, max_len=12)
    v = random_params(jm, rng, x, mask)
    tm = P(port_config(cfg), num_layers=2, max_len=12).eval()
    tm.load_state_dict(bridged(from_jax._utt_encoder, v["params"]), strict=True)
    with torch.no_grad():
        got = tm(T(x), T(mask)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(v, x, mask)), **TOL)


@pytest.mark.parametrize("cross,band", [(False, False), (True, False),
                                        (True, True)],
                         ids=["self", "cross", "cross-banded"])
def test_crossmodal_matches_jax(rng, cross, band):
    from facialmmt_tpu.ops.crossmodal import CrossModalTransformerEncoder as J
    from facialmmt_tpu_torch.ops.crossmodal import \
        CrossModalTransformerEncoder as P

    x = rng.normal(size=(2, 7, 16)).astype(np.float32)
    x[0, 5:] = 0.0                          # zero rows take the zero position
    y = rng.normal(size=(2, 11, 16)).astype(np.float32)
    args = (x, y, y) if cross else (x,)
    jm = J(16, 4, 2, attn_mask=band, max_positions=32)
    v = random_params(jm, rng, *args)
    tm = P(16, 4, 2, attn_mask=band, max_positions=32)
    tm.load_state_dict(bridged(from_jax._crossmodal, v["params"]), strict=True)
    with torch.no_grad():
        got = tm(*[T(a) for a in args]).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(v, *args)), **TOL)


# --------------------------------------------------------- image transform --

@pytest.mark.parametrize("size", [224, 32], ids=["cubic-up", "linear-aa-down"])
def test_eval_transform_matches_jax(rng, size):
    """resize_batch reproduces jax.image.resize in both modes: atol 5e-3 on
    the [0, 255] scale, i.e. 1/50 of one 8-bit level (fp32 sums over taps of
    both signs, contracted in another order than JAX's einsum)."""
    from facialmmt_tpu.data import image_pipeline as jp
    from facialmmt_tpu_torch.data import image_pipeline as tp

    imgs = rng.integers(0, 256, size=(2, 160, 160, 3)).astype(np.uint8)
    got = tp.resize_batch(T(imgs), size).numpy()
    want = np.asarray(jp.resize_batch(jnp.asarray(imgs), size))
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=0)
    np.testing.assert_allclose(
        tp.meld_face_eval_transform(T(imgs).float(), size).numpy(),
        np.asarray(jp.meld_face_eval_transform(imgs.astype(np.float32),
                                               img_size=size)),
        atol=5e-3 / 127.5, rtol=0)


# --------------------------------------------------------------- drop path --

@pytest.mark.parametrize("shift", [0, 2], ids=["unshifted", "shifted"])
def test_swin_block_with_injected_keep_matches_jax_references(rng, shift):
    """A SwinBlock in window layout with an injected per-image `keep`: output
    and every gradient against the JAX kernels' `_reference` functions (the
    attention half, then the MLP half) given the same keep, repeated per
    window and per token.  2e-2 of each output's max: the JAX references round
    their matmul operands to bf16, the port runs fp32 here."""
    from facialmmt_tpu.ops.pallas import block_mlp as jm
    from facialmmt_tpu.ops.pallas import fused_block as jb
    from facialmmt_tpu_torch.ops.swin import SwinBlock

    b, res, c, heads, ws = 3, 8, 16, 2, 4
    n, l = ws * ws, res * res
    block = SwinBlock(c, (res, res), heads, ws, shift)
    with torch.no_grad():
        for name, prm in block.named_parameters():
            noise = rng.normal(size=tuple(prm.shape)).astype(np.float32)
            if prm.dim() > 1:
                prm.copy_(T(0.2 * noise))
            else:      # norm scales around 1, biases around 0
                prm.copy_(T(0.1 * noise + (1.0 if name in (
                    "norm1.weight", "norm2.weight") else 0.0)))
    keep_a = np.asarray([0.0, 1 / 0.7, 1 / 0.7], np.float32)
    keep_m = np.asarray([1 / 0.7, 0.0, 1 / 0.7], np.float32)
    x = rng.normal(size=(b, l, c)).astype(np.float32)

    xt = T(x).requires_grad_()
    out = block(xt, T(keep_a), T(keep_m))
    out.square().sum().backward()

    a = block.attn
    names = ["norm1.weight", "norm1.bias", "attn.qkv.weight", "attn.qkv.bias",
             "attn.proj.weight", "attn.proj.bias", "norm2.weight", "norm2.bias",
             "mlp.fc1.weight", "mlp.fc1.bias", "mlp.fc2.weight", "mlp.fc2.bias"]
    sd = dict(block.named_parameters())
    jparams = [jnp.asarray(sd[k].detach().numpy().T if sd[k].dim() == 2
                           else sd[k].detach().numpy()) for k in names]
    bias = jnp.asarray(block.window_bias().detach().numpy())
    perm = None if shift == 0 else block.perm.numpy()
    inv = None if shift == 0 else block.inv.numpy()

    def reference(xj, *prm):
        xp = xj if perm is None else xj[:, perm]
        y = jb._reference(xp.reshape(b * (l // n), n, c), *prm[:6], bias,
                          jnp.repeat(jnp.asarray(keep_a), l // n), 1e-5)
        y = y.reshape(b, l, c)
        y = y if inv is None else y[:, inv]
        z = jm._reference(y.reshape(b * l, c), *prm[6:],
                          jnp.repeat(jnp.asarray(keep_m), l), 1e-5)
        return z.reshape(b, l, c)

    want = reference(jnp.asarray(x), *jparams)
    grads = jax.grad(lambda *args: jnp.sum(reference(*args) ** 2),
                     argnums=tuple(range(13)))(jnp.asarray(x), *jparams)

    def hold(got, ref, what):
        ref = np.asarray(ref)
        assert np.abs(got - ref).max() <= 2e-2 * np.abs(ref).max(), what

    hold(out.detach().numpy(), want, "output")
    # image 0 lost its attention branch, image 1 its MLP branch
    hold(xt.grad.numpy(), grads[0], "dx")
    for k, g in zip(names, grads[1:]):
        got = sd[k].grad.numpy()
        hold(got.T if got.ndim == 2 else got, g, k)
    assert a.relative_position_bias_table.grad is not None


def test_sampled_keep_is_zero_or_inverse_keep_prob_per_image():
    from facialmmt_tpu_torch.config import SwinConfig
    from facialmmt_tpu_torch.ops import swin as pswin

    g = torch.Generator().manual_seed(0)
    keep = pswin.sample_drop_path_keep(4000, 0.3, g, "cpu")
    np.testing.assert_allclose(keep.unique().numpy(), [0.0, 1 / 0.7],
                               rtol=1e-6)
    # 4,000 Bernoulli(0.7) draws: 4 sigma is under 0.03
    assert abs(float((keep > 0).float().mean()) - 0.7) < 0.03

    cfg = SwinConfig(img_size=32, patch_size=4, embed_dim=8, depths=(2, 2),
                     num_heads=(2, 4), window_size=4, drop_path_rate=0.5,
                     out_feature_dim=16)
    model = pswin.SwinTransformer(cfg)
    assert [blk.drop_path for layer in model.layers for blk in layer.blocks] \
        == pytest.approx([0.0, 1 / 6, 1 / 3, 0.5])
    seen = []
    orig = pswin.SwinBlock.forward

    def spy(self, x, keep_attn=None, keep_mlp=None):
        seen.append((x.shape[0], keep_attn, keep_mlp))
        return orig(self, x, keep_attn, keep_mlp)

    pswin.SwinBlock.forward = spy
    try:
        x = torch.randn(5, 32, 32, 3)
        model.train()
        a = model(x, generator=torch.Generator().manual_seed(1))
        model.eval()
        model(x)
    finally:
        pswin.SwinBlock.forward = orig
    train, evalm = seen[:4], seen[4:]
    assert train[0][1] is None and train[0][2] is None      # rate 0: no draw
    for bsz, ka, km in train[1:]:
        assert ka.shape == km.shape == (bsz,)                # one per image
    assert all(ka is None and km is None for _, ka, km in evalm)
    model.train()
    again = model(x, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, again)                  # same seed, same draw
