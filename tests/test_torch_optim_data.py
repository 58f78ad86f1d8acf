"""The port's optimizer, schedule, metrics, loader and image ops against the
JAX package on the CPU.  Inputs come from numpy seeds; tolerances are stated
where they are used.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from facialmmt_tpu.config import OptimConfig
from facialmmt_tpu.data import image_pipeline as jip
from facialmmt_tpu.data import loader as jloader
from facialmmt_tpu.train import metrics as jmetrics
from facialmmt_tpu.train import optim as joptim
from facialmmt_tpu_torch.data import image_pipeline as pip
from facialmmt_tpu_torch.data import loader as ploader
from facialmmt_tpu_torch.train import metrics as pmetrics
from facialmmt_tpu_torch.train import optim as poptim
from tests.torch_bridge import port_config


# ---------------------------------------------------------------- schedule --

@pytest.mark.parametrize("total,warm_up", [(100, 0.1), (7, 0.3), (4, 0.0),
                                           (1, 0.1)])
def test_schedule_matches_jax(total, warm_up):
    """1e-6 relative at every step up to and past the end."""
    want = joptim.make_schedule(5e-5, total, warm_up)
    got = poptim.make_schedule(5e-5, total, warm_up)
    for step in range(total + 3):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   atol=1e-12)


@pytest.mark.parametrize("weight_decay,grad_scale", [(0.01, 10.0), (0.0, 0.01)],
                         ids=["decay-clipped", "nodecay-unclipped"])
def test_three_clipped_adamw_steps_match_optax(rng, weight_decay, grad_scale):
    """Three consecutive updates under warm-up (the first runs at lr 0: optax
    reads the schedule at the count before the update), with the global-norm
    clip active (norm > 0.8) and inactive; 1e-6 relative to each leaf's max."""
    cfg = OptimConfig(warm_up=0.5)
    total = 4
    params = {"a": rng.normal(size=(5, 3)).astype(np.float32),
              "b": rng.normal(size=(7,)).astype(np.float32)}
    grads = [{k: (grad_scale * rng.normal(size=v.shape)).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]

    tx = joptim.make_optimizer(cfg, 1e-2, total, weight_decay)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in params.items()}
    opt = poptim.make_optimizer(tp.values(), port_config(cfg), 1e-2, total,
                                weight_decay)
    for step, g in enumerate(grads):
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                       opt_state, jp)
        new_jp = optax.apply_updates(jp, updates)
        if step == 0:    # lr 0 under warm-up: nothing moves
            assert all(np.array_equal(new_jp[k], jp[k]) for k in jp)
        jp = new_jp
        for k, p in tp.items():
            p.grad = torch.tensor(g[k])
        opt.step()
        for k in jp:
            want = np.asarray(jp[k])
            np.testing.assert_allclose(tp[k].detach().numpy(), want, rtol=0,
                                       atol=1e-6 * np.abs(want).max())
        assert all(p.grad is None for p in tp.values())


def test_clip_is_the_optax_form(rng):
    """clip / max(norm, clip): a gradient below the clip norm is untouched
    (torch's clip_grad_norm_ would scale it by clip / (norm + 1e-6))."""
    g = [torch.tensor(rng.normal(size=(4, 4)).astype(np.float32)) * 0.01]
    before = g[0].clone()
    norm = poptim.clip_by_global_norm_(g, 0.8)
    assert torch.equal(g[0], before) and float(norm) < 0.8
    big = [before.clone() * 1e3, before.clone() * 1e3]
    norm = float(poptim.clip_by_global_norm_(big, 0.8))
    got = float(torch.sqrt(sum(b.square().sum() for b in big)))
    np.testing.assert_allclose(got, 0.8, rtol=1e-5)
    assert norm > 0.8


def test_parameter_without_gradient_still_decays():
    """A parameter no loss reached counts as a zero gradient (as in the JAX
    tree, where every leaf has one): weight decay still applies."""
    cfg = port_config(OptimConfig(warm_up=0.0))
    p = torch.nn.Parameter(torch.ones(3))
    opt = poptim.make_optimizer([p], cfg, 0.1, 10, weight_decay=0.5)
    opt.step()
    np.testing.assert_allclose(p.detach().numpy(), 1 - 0.1 * 0.5, rtol=1e-6)


# ----------------------------------------------------------------- metrics --

def test_eval_meld_matches_jax(rng):
    logits = rng.normal(size=(200, 7))
    truths = rng.integers(0, 7, size=200)
    assert pmetrics.eval_meld(logits, truths, verbose=False) == \
        jmetrics.eval_meld(logits, truths, verbose=False)
    preds = logits.argmax(-1)
    assert pmetrics.macro_f1(truths, preds) == jmetrics.macro_f1(truths, preds)
    np.testing.assert_array_equal(pmetrics.per_class_f1(truths, preds),
                                  jmetrics.per_class_f1(truths, preds))


# ------------------------------------------------------------------ loader --

@pytest.mark.parametrize("n,batch,shuffle,epoch", [(10, 4, True, 0),
                                                   (10, 4, True, 3),
                                                   (9, 3, False, 1),
                                                   (5, 8, True, 2)])
def test_epoch_batches_match_jax(n, batch, shuffle, epoch):
    want = jloader.epoch_batches(n, batch, shuffle=shuffle, seed=1111,
                                 epoch=epoch)
    got = ploader.epoch_batches(n, batch, shuffle=shuffle, seed=1111,
                                epoch=epoch)
    assert len(got) == len(want)
    for (gi, gv), (wi, wv) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        assert gv == wv


def test_prefetch_loader_matches_jax():
    make = lambda idx: {"idx": np.asarray(idx)}
    kw = dict(shuffle=True, seed=7, prefetch=2)
    want = list(jloader.PrefetchLoader(make, 11, 4, **kw).epoch(2))
    got = list(ploader.PrefetchLoader(make, 11, 4, **kw).epoch(2))
    assert len(got) == len(want) == 3
    for (gb, gv), (wb, wv) in zip(got, want):
        np.testing.assert_array_equal(gb["idx"], wb["idx"])
        assert gv == wv
    resumed = list(ploader.PrefetchLoader(make, 11, 4, **kw).epoch(
        2, start_batch=1))
    np.testing.assert_array_equal(resumed[0][0]["idx"], want[1][0]["idx"])


def test_prefetch_loader_surfaces_worker_errors():
    def make(idx):
        raise KeyError("boom")

    with pytest.raises(KeyError):
        list(ploader.PrefetchLoader(make, 4, 2, shuffle=False).epoch(0))


# --------------------------------------------------------------- image ops --

IMG_TOL = dict(rtol=1e-5, atol=1e-5 * 255)     # images live in [0, 255]


def _images(rng, n=3, size=12):
    return (rng.random(size=(n, size, size, 3)) * 255).astype(np.float32)


def test_grayscale_and_normalize_match_jax(rng):
    x = _images(rng)
    np.testing.assert_allclose(pip.grayscale(torch.tensor(x)).numpy(),
                               np.asarray(jip.grayscale(jnp.asarray(x))),
                               **IMG_TOL)
    np.testing.assert_allclose(
        pip.normalize_images(torch.tensor(x)).numpy(),
        np.asarray(jip.normalize_images(jnp.asarray(x))), rtol=1e-5, atol=1e-5)


def test_hsv_round_trip_matches_jax(rng):
    x = _images(rng) / 255.0
    x[0, :2] = 0.5                      # grey pixels: delta == 0
    x[1, 0, 0] = 0.0                    # a black pixel: maxc == 0
    hsv_j = np.asarray(jip._rgb_to_hsv(jnp.asarray(x)))
    hsv_p = pip._rgb_to_hsv(torch.tensor(x))
    np.testing.assert_allclose(hsv_p.numpy(), hsv_j, rtol=1e-5, atol=1e-5)
    back = pip._hsv_to_rgb(hsv_p).numpy()
    np.testing.assert_allclose(
        back, np.asarray(jip._hsv_to_rgb(jnp.asarray(hsv_j))), rtol=1e-5,
        atol=1e-5)
    np.testing.assert_allclose(back, x, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("op,factor", [("_adjust_brightness", 1.3),
                                       ("_adjust_contrast", 0.6),
                                       ("_adjust_saturation", 1.4),
                                       ("_adjust_hue", -0.2),
                                       ("_adjust_hue", 0.35)])
def test_adjust_ops_match_jax(rng, op, factor):
    """One image at a time on the JAX side (its ops are written per image and
    vmapped), the whole batch at once in the port."""
    x = _images(rng)
    want = np.stack([np.asarray(getattr(jip, op)(jnp.asarray(im), factor))
                     for im in x])
    got = getattr(pip, op)(torch.tensor(x),
                           torch.full((len(x), 1, 1, 1), factor)).numpy()
    np.testing.assert_allclose(got, want, **IMG_TOL)


def test_random_apply_fires_at_one_minus_p():
    """The reference's quirk, kept: applies when random() > p."""
    g = torch.Generator().manual_seed(0)
    x = torch.zeros(2000, 1, 1, 3)
    for p in (0.2, 0.8):
        out = pip._random_apply(g, x, lambda im: im + 1.0, p)
        rate = float(out[:, 0, 0, 0].mean())
        # 2,000 Bernoulli draws: 4 sigma of sqrt(p (1 - p) / 2000) < 0.04
        assert abs(rate - (1 - p)) < 0.04, (p, rate)


def test_color_jitter_draws_per_image_and_stays_in_range(rng):
    g = torch.Generator().manual_seed(1)
    x = torch.tensor(_images(rng, n=1)).repeat(6, 1, 1, 1)
    out = pip.color_jitter(g, x, 0.4, 0.4, 0.4, 0.4)
    assert out.shape == x.shape and torch.isfinite(out).all()
    assert float(out.min()) >= 0.0 and float(out.max()) <= 255.0
    # identical inputs, different draws: the images differ from each other
    assert len({round(float(o.sum()), 1) for o in out}) == 6
    same = pip.color_jitter(g, x, 0.0, 0.0, 0.0, 0.0)
    np.testing.assert_allclose(same.numpy(), x.numpy(), rtol=1e-4, atol=1e-2)


def test_gaussian_blur_keeps_shape_range_and_flat_images(rng):
    g = torch.Generator().manual_seed(2)
    x = torch.tensor(_images(rng, n=4, size=20))
    out = pip.gaussian_blur(g, x)
    assert out.shape == x.shape
    assert float(out.min()) >= float(x.min()) - 1e-3
    assert float(out.max()) <= float(x.max()) + 1e-3
    # a blur is an average: the per-image variance never grows
    assert (out.var(dim=(1, 2, 3)) <= x.var(dim=(1, 2, 3))).all()
    flat = torch.full((2, 9, 9, 3), 77.0)
    np.testing.assert_allclose(pip.gaussian_blur(g, flat).numpy(), 77.0,
                               rtol=1e-5)


def test_gaussian_blur_matches_jax_at_a_fixed_sigma(rng):
    """sigma_min == sigma_max pins the only random draw."""
    x = _images(rng, n=2, size=16)
    want = np.asarray(jip.gaussian_blur(jax.random.PRNGKey(0), jnp.asarray(x),
                                        1.2, 1.2))
    got = pip.gaussian_blur(torch.Generator().manual_seed(0), torch.tensor(x),
                            1.2, 1.2).numpy()
    np.testing.assert_allclose(got, want, **IMG_TOL)


def test_random_erasing_touches_one_rectangle_or_nothing(rng):
    g = torch.Generator().manual_seed(3)
    x = torch.tensor(rng.normal(size=(64, 16, 16, 3)).astype(np.float32))
    out = pip.random_erasing(g, x, prob=0.5)
    assert out.shape == x.shape and torch.isfinite(out).all()
    changed = (out != x).any(-1)                      # (N, H, W)
    erased = changed.flatten(1).any(1)
    assert 10 < int(erased.sum()) < 54               # about half of 64
    for m in changed[erased]:
        rows, cols = m.any(1).nonzero()[:, 0], m.any(0).nonzero()[:, 0]
        box = m[rows[0]:rows[-1] + 1, cols[0]:cols[-1] + 1]
        assert box.all()                              # a filled rectangle
        area = box.numel() / m.numel()
        assert area <= 1 / 3 + 0.1
    none = pip.random_erasing(g, x, prob=0.0)
    assert torch.equal(none, x)


@pytest.mark.parametrize("fn", ["affwild2_train_augment",
                                "meld_face_train_augment"])
def test_train_augment_shape_and_range(rng, fn):
    g = torch.Generator().manual_seed(4)
    x = torch.tensor(rng.integers(0, 256, size=(5, 20, 20, 3), dtype=np.uint8))
    out = getattr(pip, fn)(g, x, img_size=32)
    assert out.shape == (5, 32, 32, 3) and out.dtype == torch.float32
    assert torch.isfinite(out).all()
    if fn == "meld_face_train_augment":               # no erasing noise
        assert float(out.min()) >= -1.0 - 1e-5
        assert float(out.max()) <= 1.0 + 1e-5
    again = getattr(pip, fn)(torch.Generator().manual_seed(4), x, img_size=32)
    assert torch.equal(out, again)                    # same seed, same draw
