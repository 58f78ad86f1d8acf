"""The port's Swin under its implementation selectors (attention_impl,
mlp_impl, merge_impl) against the JAX package with the same config (CPU).

JAX parameters come from a numpy seed and cross the weight bridge; one
state_dict loads (strict) under every route.  On the CPU the JAX module's
routes to a Pallas window-attention kernel run in interpret mode (the
monkeypatch of test_pallas.py::test_swin_block_pair_impl_matches_xla), and the
port's kernel routes take their plain versions.  Tolerances, relative to
max|out|: 1e-4 between formulations that differ only in summation order, 5e-3
where a kernel that stores the bias in bf16 is on one side only (the JAX
suite's bound for 'pair' against 'xla').
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facialmmt_tpu.config import FacialMMTConfig, RuntimeConfig, SwinConfig
from facialmmt_tpu.models.pipeline import FacialMMTPipeline as JaxPipeline
from facialmmt_tpu.ops import swin as jswin
from facialmmt_tpu.train import steps as jsteps
from facialmmt_tpu_torch.checkpoint import from_jax
from facialmmt_tpu_torch.ops import kernels
from facialmmt_tpu_torch.ops import swin as pswin
from facialmmt_tpu_torch.train import steps as psteps
from tests.test_models import make_multimodal_batch
from tests.test_torch_ops import T, random_params
from tests.test_torch_train import (Pair, _np_tree, _port_grads,
                                    nodrop_config)
from tests.torch_bridge import port_config

SAME_MATH = 1e-4     # another summation order
BF16_BIAS = 5e-3     # a bf16-bias kernel on one side only


@pytest.fixture
def interpret_window_kernels(monkeypatch):
    """Route the JAX module's Pallas window-attention calls through interpret
    mode; nothing in the JAX package changes."""
    import facialmmt_tpu.ops.pallas.window_attention as wa

    fused, paired = wa.fused_window_attention, wa.paired_window_attention
    monkeypatch.setattr(
        wa, "fused_window_attention",
        lambda q, k, v, b, group=0, interpret=False: fused(q, k, v, b, group,
                                                           True))
    monkeypatch.setattr(
        wa, "paired_window_attention",
        lambda q, k, v, b, pairs=8, interpret=False: paired(q, k, v, b, pairs,
                                                            True))


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _swin_config(**kw):
    """Two stages; stage 0 (8x8 tokens, 4x4 windows, nW = 4) has a shifted
    block, stage 1 is the whole-input window."""
    return SwinConfig(img_size=32, patch_size=4, embed_dim=8, depths=(2, 2),
                      num_heads=(2, 4), window_size=4, drop_path_rate=0.0,
                      out_feature_dim=16, **kw)


def _load(module, sd):
    module.load_state_dict({k: torch.tensor(np.asarray(v))
                            for k, v in sd.items()}, strict=True)
    return module.eval()


def _swin_variables(cfg, rng, imgs):
    return random_params(jswin.SwinTransformer(cfg), rng, imgs)


def _swin_state_dict(variables):
    """The backbone's state_dict (no prefix) from SwinTransformer variables."""
    sd = from_jax.swin_fer_state_dict({
        "params": {"swin": variables["params"], "linear": _LINEAR,
                   "classifier": _LINEAR},
        "batch_stats": {"swin": variables["batch_stats"]}})
    return {k[len("swin."):]: v for k, v in sd.items()
            if k.startswith("swin.")}


_LINEAR = {"kernel": np.zeros((1, 1), np.float32),
           "bias": np.zeros((1,), np.float32)}


@pytest.mark.parametrize("sh,ws_s,ws_n", [(56, 7, 7), (28, 7, 7), (14, 7, 7),
                                          (8, 4, 4)])
def test_merge_gather_index_matches_jax(sh, ws_s, ws_n):
    np.testing.assert_array_equal(
        pswin.merge_gather_index(sh, sh, ws_s, ws_n),
        jswin.merge_gather_index(sh, sh, ws_s, ws_n))


@pytest.mark.parametrize("sh,ws_s,ws_n", [(14, 7, 7), (8, 4, 4), (8, 4, 2)])
def test_patch_merging_window_equals_raster_up_to_row_order(rng, sh, ws_s,
                                                            ws_n):
    """The window-layout merge is the raster merge between window_reverse and
    window_partition, bit for bit."""
    b, c = 2, 8
    torch.manual_seed(0)
    raster = pswin.PatchMerging((sh, sh), c)
    window = pswin.PatchMerging((sh, sh), c, "window", ws_s, ws_n)
    assert sorted(window.state_dict()) == sorted(raster.state_dict())
    window.load_state_dict(raster.state_dict(), strict=True)
    x_win = T(rng.normal(size=(b, sh * sh, c)).astype(np.float32))
    grid = pswin.window_reverse(x_win.reshape(-1, ws_s * ws_s, c), ws_s, sh, sh)
    with torch.no_grad():
        want = raster(grid.reshape(b, sh * sh, c))
        got = window(x_win)
    want = pswin.window_partition(
        want.reshape(b, sh // 2, sh // 2, 2 * c), ws_n).reshape(got.shape)
    assert torch.equal(got, want)


@pytest.mark.parametrize("merge_impl", ["raster", "window"])
@pytest.mark.parametrize("mlp_impl", ["xla", "auto"])
@pytest.mark.parametrize("attention_impl", ["xla", "pallas", "pair"])
def test_backbone_routes_match_jax(rng, interpret_window_kernels,
                                   attention_impl, mlp_impl, merge_impl):
    cfg = _swin_config(attention_impl=attention_impl, mlp_impl=mlp_impl,
                       merge_impl=merge_impl)
    imgs = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    variables = _swin_variables(cfg, rng, imgs)
    sd = _swin_state_dict(variables)
    want = np.asarray(jax.jit(jswin.SwinTransformer(cfg).apply)(variables,
                                                                 imgs))
    port = _load(pswin.SwinTransformer(port_config(cfg)), sd)
    assert port.merge_layout == merge_impl
    kernels.reset_launch_counts()
    with torch.no_grad():
        got = port(T(imgs)).numpy()
    assert not any(kernels.launch_counts().values())    # CPU: plain versions
    # same route on both sides: the bf16 bias is in both or in neither
    assert _rel(got, want) <= SAME_MATH
    # ... and against the port's default route from the same state_dict
    auto = _load(pswin.SwinTransformer(port_config(_swin_config())), sd)
    with torch.no_grad():
        base = auto(T(imgs)).numpy()
    assert _rel(got, base) <= (SAME_MATH if attention_impl == "xla"
                               else BF16_BIAS)
    if attention_impl != "xla":
        assert _rel(got, base) > 0      # the bias really was rounded


def test_per_call_attention_impl_overrides_the_config(rng):
    """SwinTransformer / SwinForAffwildClassification / the pipeline take
    attention_impl per call, as the JAX modules do."""
    from facialmmt_tpu_torch.models.pipeline import FacialMMTPipeline

    cfg = port_config(FacialMMTConfig.tiny().replace(
        runtime=RuntimeConfig(deterministic_gumbel=True)))
    torch.manual_seed(0)
    model = FacialMMTPipeline(cfg).eval()
    pallas = FacialMMTPipeline(cfg.replace(swin=dataclasses.replace(
        cfg.swin, attention_impl="pallas"))).eval()
    pallas.load_state_dict(model.state_dict(), strict=True)
    faces = T(rng.normal(size=(4, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        for got, want in (
                (model.aux_logits(faces, attention_impl="pallas"),
                 pallas.aux_logits(faces)),
                (model.fer_probs(faces, attention_impl="pallas"),
                 pallas.fer_probs(faces)),
                (model.swin_model(faces, attention_impl="pallas"),
                 pallas.swin_model(faces)),
                (pallas.swin_model.swin(faces, attention_impl="auto"),
                 model.swin_model.swin(faces))):
            assert torch.equal(got, want)
        assert not torch.equal(model.aux_logits(faces),
                               pallas.aux_logits(faces))
        with pytest.raises(ValueError, match="attention_impl"):
            model.aux_logits(faces, attention_impl="flash")


@pytest.mark.parametrize("field", ["attention_impl", "mlp_impl",
                                   "merge_impl"])
def test_unknown_impl_raises_when_the_module_is_built(field):
    cfg = port_config(_swin_config(**{field: "mosaic"}))
    with pytest.raises(ValueError, match=field):
        pswin.SwinTransformer(cfg)


def test_pair_takes_the_single_window_kernel_at_an_odd_window_count(
        rng, monkeypatch):
    """'pair' needs an even window count (and an even or single mask group
    count); windows that do not pair go through fused_window_attention, never
    through the plain per-head core.  3 images: stage 0 has 12 windows
    (paired), stage 1 has 3 (one to a block)."""
    calls = {"pair": [], "single": []}
    for key, name in (("pair", "paired_window_attention"),
                      ("single", "fused_window_attention")):
        real = getattr(pswin, name)
        monkeypatch.setattr(
            pswin, name, lambda q, k, v, b, key=key, real=real:
            calls[key].append(q.shape[0]) or real(q, k, v, b))
    cfg = _swin_config(attention_impl="pair")
    imgs = rng.normal(size=(3, 32, 32, 3)).astype(np.float32)
    variables = _swin_variables(cfg, rng, imgs)
    port = _load(pswin.SwinTransformer(port_config(cfg)),
                 _swin_state_dict(variables))
    with torch.no_grad():
        got = port(T(imgs)).numpy()
    assert calls == {"pair": [12, 12], "single": [3, 3]}
    xla = dataclasses.replace(cfg, attention_impl="xla")
    want = np.asarray(jswin.SwinTransformer(xla).apply(variables, imgs))
    assert _rel(got, want) <= BF16_BIAS


DROPOUT_ROUTES = {"xla-xla": dict(attention_impl="xla", mlp_impl="xla"),
                  "pallas-xla": dict(attention_impl="pallas", mlp_impl="xla"),
                  "xla-auto": dict(attention_impl="xla", mlp_impl="auto"),
                  "auto-auto": dict(attention_impl="auto", mlp_impl="auto")}


@pytest.mark.parametrize("route", list(DROPOUT_ROUTES))
def test_dropouts_run_on_the_xla_routes_only(rng, interpret_window_kernels,
                                             route):
    """drop_rate / attn_drop_rate > 0 on every route: in eval dropout is the
    identity, the halves keep their routes and the port equals JAX's
    SwinTransformer with the same rates and route (the 'pallas' core in
    interpret mode on the JAX side) and the port's rate-0 model; in a
    training forward the dropouts draw from the generator (same seed, same
    output; the RNG streams differ from JAX's, so no parity) on the 'xla'
    halves that JAX's rule sends them to."""
    rates = dict(drop_rate=0.2, attn_drop_rate=0.2)
    jcfg = _swin_config(**DROPOUT_ROUTES[route], **rates)
    imgs = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    variables = _swin_variables(jcfg, rng, imgs)
    sd = _swin_state_dict(variables)
    dropped = _load(pswin.SwinTransformer(port_config(jcfg)), sd)
    plain = _load(pswin.SwinTransformer(port_config(
        dataclasses.replace(jcfg, drop_rate=0.0, attn_drop_rate=0.0))), sd)
    x = T(imgs)
    with torch.no_grad():
        got = dropped(x)
        assert torch.equal(got, plain(x))
    want = np.asarray(jax.jit(jswin.SwinTransformer(jcfg).apply)(variables,
                                                                  imgs))
    assert _rel(got.numpy(), want) <= SAME_MATH
    gen = lambda seed: torch.Generator().manual_seed(seed)
    dropped.train()
    with torch.no_grad():
        a = dropped(x, generator=gen(3), use_running_average=True)
        b = dropped(x, generator=gen(3), use_running_average=True)
        c = dropped(x, generator=gen(4), use_running_average=True)
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, got)


def _deep_config(**kw):
    """Four stages of depths (2, 2, 6, 2): Swin-tiny's twelve blocks at a
    width the CPU runs in a second; 32 x 32 tokens keep the 4 x 4 windows
    (and the relative-position table) at every stage."""
    return SwinConfig(img_size=64, patch_size=2, embed_dim=8,
                      depths=(2, 2, 6, 2), num_heads=(1, 2, 4, 8),
                      window_size=4, out_feature_dim=16, **kw)


def _count_halves(monkeypatch):
    """Calls of the block halves' kernel entry points (and the window core
    of the 'pallas' route), counted by monkeypatching ops/swin.py."""
    calls = {"attention": 0, "mlp": 0, "core": 0}
    for key, name in (("attention", "fused_attention_block"),
                      ("mlp", "fused_ln_mlp_residual"),
                      ("core", "fused_window_attention")):
        real = getattr(pswin, name)

        def counted(*a, key=key, real=real, **k):
            calls[key] += 1
            return real(*a, **k)

        monkeypatch.setattr(pswin, name, counted)
    return calls


# (attention_impl, drop_rate, attn_drop_rate) -> the calls of a training
# forward under JAX's per-half rule (facialmmt_tpu/ops/swin.py: the fused
# attention half needs both rates at 0, the window core attn_drop at 0, the
# fused MLP half drop at 0)
TRAIN_RULE = {
    ("auto", 0.0, 0.0): dict(attention=12, mlp=12, core=0),
    ("auto", 0.0, 0.1): dict(attention=0, mlp=12, core=0),
    ("auto", 0.1, 0.0): dict(attention=0, mlp=0, core=0),
    ("auto", 0.1, 0.1): dict(attention=0, mlp=0, core=0),
    ("pallas", 0.1, 0.0): dict(attention=0, mlp=0, core=12),
    ("pallas", 0.0, 0.1): dict(attention=0, mlp=12, core=0),
}


@pytest.mark.parametrize("impl,drop,attn_drop", list(TRAIN_RULE))
def test_drop_rates_route_each_half_as_jax_does(rng, monkeypatch, impl, drop,
                                                attn_drop):
    """Eval launches both halves' kernel entry points 12 / 12 times (the
    window core 12 on 'pallas') whatever the rates; a training forward (with
    drop-path on) takes the kernel of a half exactly where JAX's rule does."""
    calls = _count_halves(monkeypatch)
    cfg = port_config(_deep_config(attention_impl=impl, drop_rate=drop,
                                   attn_drop_rate=attn_drop,
                                   drop_path_rate=0.2))
    torch.manual_seed(0)
    model = pswin.SwinTransformer(cfg).eval()
    x = T(rng.normal(size=(2, 64, 64, 3)).astype(np.float32))
    with torch.no_grad():
        model(x)
    assert calls == (dict(attention=12, mlp=12, core=0) if impl == "auto"
                     else dict(attention=0, mlp=12, core=12))
    calls.update(attention=0, mlp=0, core=0)
    model.train()
    y = model(x, generator=torch.Generator().manual_seed(1))
    assert calls == TRAIN_RULE[impl, drop, attn_drop]
    y.square().sum().backward()
    assert all(torch.isfinite(p.grad).all() for p in model.parameters()
               if p.grad is not None)


def test_drop_rate_eval_on_the_default_route_matches_jax(rng):
    """Swin-tiny's depths with drop_rate 0.1 on 'auto': eval equals JAX's
    SwinTransformer eval with the same rates (both dropouts the identity)."""
    jcfg = _deep_config(drop_rate=0.1, attn_drop_rate=0.1)
    imgs = rng.normal(size=(3, 64, 64, 3)).astype(np.float32)
    variables = _swin_variables(jcfg, rng, imgs)
    port = _load(pswin.SwinTransformer(port_config(jcfg)),
                 _swin_state_dict(variables))
    with torch.no_grad():
        got = port(T(imgs)).numpy()
    want = np.asarray(jax.jit(jswin.SwinTransformer(jcfg).apply)(variables,
                                                                  imgs))
    assert _rel(got, want) <= SAME_MATH


def _hold_leaves(got, want, what, tol):
    """Every leaf within tol of its own max, floored at 1e-2 of the tree's
    largest leaf max (the leaves in front of the batch-statistics BatchNorm
    have gradients that are zero in exact arithmetic)."""
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_got) == len(flat_want), what
    floor = 1e-2 * max(np.abs(w).max() for _, w in flat_want)
    for path, w in flat_want:
        scale = max(np.abs(w).max(), floor)
        err = np.abs(flat_got[path] - w).max()
        assert err <= tol * scale, (what, jax.tree_util.keystr(path), err,
                                    scale)


def test_aux_step_under_pallas_xla_window_matches_jax(
        rng, interpret_window_kernels):
    """One auxiliary batch's gradients and one optimizer step under
    (attention_impl, mlp_impl, merge_impl) = ('pallas', 'xla', 'window'):
    forward through the window-attention kernel's arithmetic, backward through
    the exact formulation, on both sides.  1e-3 of each leaf's max."""
    cfg = nodrop_config()
    cfg = cfg.replace(swin=dataclasses.replace(
        cfg.swin, depths=(2, 2), attention_impl="pallas", mlp_impl="xla",
        merge_impl="window"))
    batch = make_multimodal_batch(rng, cfg, b=2)
    pair = Pair(rng, cfg, batch)
    assert pair.pmodel.swin_model.swin.merge_layout == "window"
    images = np.asarray(batch["faces"][:6])
    labels = rng.integers(0, 7, size=6).astype(np.int32)

    def loss_fn(swin_params):
        params = {"swin_model": swin_params,
                  "multimodal": pair.jstate.params["multimodal"]}
        logits, _ = pair.jmodel.apply(
            {"params": params, "batch_stats": pair.jstate.batch_stats},
            images, deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)},
            method=JaxPipeline.aux_logits, mutable=["batch_stats"])
        return jsteps.cross_entropy(logits, labels)

    want = {"params": {"swin_model": _np_tree(jax.jit(jax.grad(loss_fn))(
        pair.jstate.params["swin_model"]))}}
    pair.pmodel.train()
    stats = {k: v.clone() for k, v in pair.pmodel.state_dict().items()}
    logits = pair.pmodel.aux_logits(torch.tensor(images))
    psteps.cross_entropy(logits, torch.tensor(labels)).backward()
    got = from_jax.to_jax_tree(_port_grads(pair.pmodel), like=pair.variables())
    _hold_leaves(got, want, "aux gradients", 1e-3)
    pair.pmodel.zero_grad(set_to_none=True)
    pair.pmodel.load_state_dict(stats)      # undo the BatchNorm update

    # one step each from the state after JAX's first step (non-zero moments)
    jstep = jax.jit(jsteps.make_aux_train_step(pair.jmodel, pair.swin_tx))
    pstep = psteps.make_aux_train_step(pair.pmodel, compute_dtype="float32")
    pair.jstate, _ = jstep(pair.jstate, images, labels, jax.random.PRNGKey(0))
    pair.carry_over()
    pair.jstate, jloss = jstep(pair.jstate, images, labels,
                               jax.random.PRNGKey(1))
    ploss = pstep(pair.pstate, torch.tensor(images), torch.tensor(labels))
    assert abs(float(ploss) - float(jloss)) <= 1e-4
    want = _np_tree(pair.variables())
    got = from_jax.to_jax_tree(
        {k: v.detach().numpy() for k, v in pair.pmodel.state_dict().items()},
        like=want)
    _hold_leaves(got, want, "state after the step", 1e-3)


def test_aux_step_with_drop_path_only_matches_jax(rng, monkeypatch):
    """A training step whose only stochastic part is drop-path (rate 0.2,
    dropout 0, deterministic gumbel) keeps the default route's kernels (their
    plain versions here) and equals JAX's auxiliary step: both sides take the
    same per-image multipliers, fed to JAX's DropPath and to the port's
    sample_drop_path_keep in the order the blocks draw them.  1e-3 of each
    leaf's max, the loss within 1e-4."""
    cfg = nodrop_config()
    cfg = cfg.replace(swin=dataclasses.replace(cfg.swin, depths=(2, 2),
                                               drop_path_rate=0.2))
    batch = make_multimodal_batch(rng, cfg, b=2)
    pair = Pair(rng, cfg, batch)
    images = np.asarray(batch["faces"][:6])
    labels = rng.integers(0, 7, size=6).astype(np.int32)
    draws = [((rng.random(6) > 0.2) / 0.8).astype(np.float32)
             for _ in range(6)]
    jax_draws, port_draws = list(draws), list(draws)

    def jax_drop_path(self, x, *, deterministic=True):
        if deterministic or self.rate == 0.0:
            return x
        keep = jnp.asarray(jax_draws.pop(0))
        return x * keep.reshape((-1,) + (1,) * (x.ndim - 1)).astype(x.dtype)

    monkeypatch.setattr(jswin.DropPath, "__call__", jax_drop_path)
    monkeypatch.setattr(pswin, "sample_drop_path_keep",
                        lambda b, rate, gen, dev: torch.tensor(
                            port_draws.pop(0)))
    calls = _count_halves(monkeypatch)
    jstep = jax.jit(jsteps.make_aux_train_step(pair.jmodel, pair.swin_tx))
    pstep = psteps.make_aux_train_step(pair.pmodel, compute_dtype="float32")
    pair.jstate, jloss = jstep(pair.jstate, images, labels,
                               jax.random.PRNGKey(0))
    ploss = pstep(pair.pstate, torch.tensor(images), torch.tensor(labels))
    # the blocks of rate > 0 (the first block's is 0): 3 blocks x 2 halves
    assert not jax_draws and not port_draws
    assert calls == dict(attention=4, mlp=4, core=0)
    assert abs(float(ploss) - float(jloss)) <= 1e-4
    want = _np_tree(pair.variables())
    got = from_jax.to_jax_tree(
        {k: v.detach().numpy() for k, v in pair.pmodel.state_dict().items()},
        like=want)
    _hold_leaves(got, want, "state after the step", 1e-3)


def test_emotion_server_routes_agree(rng):
    """The slice as a whole: a server under ('pair', 'xla', 'window') answers
    the same requests as the default server and as the JAX server built with
    attention_impl='xla', within 5e-3 on the probabilities."""
    from facialmmt_tpu.serving import EmotionServer as JaxServer
    from facialmmt_tpu_torch.serving import EmotionServer
    from tests.test_torch_serving import _requests

    cfg = FacialMMTConfig.tiny().replace(
        runtime=RuntimeConfig(deterministic_gumbel=True))
    route = lambda c, **kw: c.replace(swin=dataclasses.replace(c.swin, **kw))
    variables = random_params(JaxPipeline(cfg), rng,
                              make_multimodal_batch(rng, cfg, b=2))
    sd = from_jax.pipeline_state_dict(variables)
    kw = dict(max_batch=4, face_capacity=8, transfer_dtype=np.float32)
    ref = JaxServer(route(cfg, attention_impl="xla"), variables,
                    dtype=jnp.float32, **kw)
    auto = EmotionServer(port_config(cfg), sd, dtype=torch.float32,
                         device="cpu", **kw)
    routed = EmotionServer(
        port_config(route(cfg, attention_impl="pair", mlp_impl="xla",
                          merge_impl="window")),
        sd, dtype=torch.float32, device="cpu", **kw)
    reqs = _requests(rng, cfg.data, cfg.text.vocab_size)
    for got, base, want in zip(routed.predict(reqs), auto.predict(reqs),
                               ref.predict(reqs)):
        np.testing.assert_allclose(got, base, atol=5e-3, rtol=0)
        np.testing.assert_allclose(got, want, atol=5e-3, rtol=0)
        np.testing.assert_allclose(got.sum(), 1.0, atol=1e-5)
