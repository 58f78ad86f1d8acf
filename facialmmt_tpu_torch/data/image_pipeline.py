"""Batched image preprocessing and augmentation on the device (counterpart of
facialmmt_tpu/data/image_pipeline.py; reference utils/dataset.py:35-69,
utils/util.py:22-60, utils/random_erasing.py:9-81).

Every op works on (N, H, W, C) float batches in [0, 255] with per-image random
draws taken from an explicit torch.Generator, so the whole stack runs on the
device between the loader and the step.

The resize reproduces jax.image.resize: a Keys cubic kernel (a = -0.5) when
enlarging, an antialiased triangle kernel when shrinking, each 1-D weight
matrix renormalised over the taps that fall inside the image.
torch.nn.functional.interpolate does not match (its bicubic uses a = -0.75),
so the weights are built in numpy and applied as two matmuls.

Semantics per op, as the JAX package keeps them:
  * ColorJitter: torchvision semantics, factors drawn uniformly and the four
    adjustments applied in a random order per image;
  * Grayscale(3): ITU-R 601 luma replicated to 3 channels;
  * GaussianBlur: sigma ~ U[min, max] per image, separable, edge-replicated;
  * RandomErasing: timm 'pixel' mode, first geometrically valid of 10
    area/aspect attempts, filled with per-pixel normal noise, after Normalize;
  * RandomApply keeps the reference's quirk: it applies when random() > p,
    that is with probability 1 - p (reference utils/util.py:22-30).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from facialmmt_tpu_torch.ops.kernels import to_device_async
from facialmmt_tpu_torch.utils.observability import trace_span


def _keys_cubic(x):
    f = np.float32
    out = ((f(1.5) * x - f(2.5)) * x) * x + f(1.0)
    out = np.where(x >= 1.0, ((f(-0.5) * x + f(2.5)) * x - f(4.0)) * x + f(2.0),
                   out)
    return np.where(x >= 2.0, f(0.0), out)


def _triangle(x):
    return np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))


@functools.lru_cache(maxsize=16)
def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) float32 interpolation matrix, as
    jax.image.scale's compute_weight_mat builds it for a plain resize, in the
    same float32 arithmetic (sample positions rounded as JAX rounds them)."""
    f32 = np.float32
    scale = f32(out_size) / f32(in_size)
    antialias = out_size < in_size
    kernel = _triangle if antialias else _keys_cubic
    inv_scale = f32(1.0) / scale
    kernel_scale = max(inv_scale, f32(1.0)) if antialias else f32(1.0)
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) \
        / kernel_scale
    w = kernel(x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, 0.0).T.astype(np.float32)


def resize_batch(images, size: int):
    """(N, H, W, C) -> (N, size, size, C) float32."""
    x = images.float()
    n, h, w, c = x.shape
    if h == size and w == size:
        return x
    wh = to_device_async(torch.from_numpy(resize_weights(h, size)),
                         x.device)
    ww = to_device_async(torch.from_numpy(resize_weights(w, size)),
                         x.device)
    x = torch.einsum("oh,nhwc->nowc", wh, x)
    return torch.einsum("pw,nowc->nopc", ww, x)


def normalize_images(images, mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5)):
    """[0, 255] floats -> ((x / 255) - mean) / std."""
    m = to_device_async(torch.tensor(mean, dtype=images.dtype),
                        images.device)
    s = to_device_async(torch.tensor(std, dtype=images.dtype),
                        images.device)
    return (images / 255.0 - m) / s


def _uniform(shape, lo: float, hi: float, generator, device):
    return lo + (hi - lo) * torch.rand(shape, generator=generator,
                                       device=device)


# ------------------------------------------------------------- color space --

_LUMA = (0.299, 0.587, 0.114)


def grayscale(images):
    """ITU-R 601 luma replicated to 3 channels.  images float in [0, 255]."""
    luma = to_device_async(torch.tensor(_LUMA, dtype=images.dtype),
                           images.device)
    return (images * luma).sum(-1, keepdim=True).expand(images.shape)


def _rgb_to_hsv(rgb):
    r, g, b = rgb.unbind(-1)
    maxc = rgb.amax(-1)
    minc = rgb.amin(-1)
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / maxc.clamp_min(1e-12),
                    torch.zeros_like(maxc))
    safe = delta.clamp_min(1e-12)
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    h = torch.where(r == maxc, bc - gc,
                    torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.remainder(h / 6.0, 1.0)
    h = torch.where(delta == 0, torch.zeros_like(h), h)
    return torch.stack([h, s, maxc], dim=-1)


def _hsv_to_rgb(hsv):
    h, s, v = hsv.unbind(-1)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.long() % 6

    def pick(*by_sector):
        return torch.stack(by_sector, dim=-1).gather(-1, i[..., None])[..., 0]

    return torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p),
                        pick(p, p, t, v, v, q)], dim=-1)


# ------------------------------------------------------------ color jitter --
# factor / shift: one value per image, shaped (N, 1, 1, 1)

def _adjust_brightness(img, factor):
    return img * factor


def _adjust_contrast(img, factor):
    mean = grayscale(img)[..., :1].mean(dim=(-3, -2), keepdim=True)
    return (img - mean) * factor + mean


def _adjust_saturation(img, factor):
    gray = grayscale(img)
    return (img - gray) * factor + gray


def _adjust_hue(img, shift):
    """img in [0, 255]; hue shift in turns (torchvision's hue factor)."""
    hsv = _rgb_to_hsv(img / 255.0)
    h = torch.remainder(hsv[..., 0] + shift[..., 0], 1.0)
    return _hsv_to_rgb(torch.stack([h, hsv[..., 1], hsv[..., 2]], -1)) * 255.0


def color_jitter(generator, images, brightness: float, contrast: float,
                 saturation: float, hue: float):
    """torchvision ColorJitter over a batch: per-image factors and per-image
    random application order.  images float (N, H, W, 3) in [0, 255]."""
    n, dev = images.shape[0], images.device
    draw = lambda lo, hi: _uniform((n, 1, 1, 1), lo, hi, generator, dev)
    factors = (draw(max(0.0, 1 - brightness), 1 + brightness),
               draw(max(0.0, 1 - contrast), 1 + contrast),
               draw(max(0.0, 1 - saturation), 1 + saturation),
               draw(-hue, hue))
    ops = (_adjust_brightness, _adjust_contrast, _adjust_saturation,
           _adjust_hue)
    # a uniform random permutation of the four ops per image
    order = torch.rand((n, 4), generator=generator, device=dev).argsort(-1)
    x = images
    for step in range(4):
        which = order[:, step].reshape(n, 1, 1, 1)
        out = x
        for k, (op, factor) in enumerate(zip(ops, factors)):
            out = torch.where(which == k, op(x, factor), out)
        x = out
    return x.clamp(0.0, 255.0)


# ------------------------------------------------------------ gaussian blur --

def gaussian_blur(generator, images, sigma_min: float = 0.1,
                  sigma_max: float = 2.0, kernel_size: int = 13):
    """Separable gaussian blur with per-image sigma ~ U[min, max] and
    edge-replicated borders."""
    n, h, w, c = images.shape
    half = kernel_size // 2
    sigma = _uniform((n, 1), sigma_min, sigma_max, generator, images.device)
    offsets = torch.arange(-half, half + 1, dtype=torch.float32,
                           device=images.device)
    k = torch.exp(-0.5 * (offsets[None] / sigma) ** 2)
    k = (k / k.sum(-1, keepdim=True)).to(images.dtype)          # (N, K)
    x = images.permute(0, 3, 1, 2).reshape(n * c, 1, h, w)
    x = torch.nn.functional.pad(x, (half,) * 4, mode="replicate")
    # one depthwise pass per axis: every (image, channel) plane is a group
    x = x.reshape(1, n * c, h + 2 * half, w + 2 * half)
    kc = k.repeat_interleave(c, dim=0)                           # (N*C, K)
    x = torch.nn.functional.conv2d(x, kc[:, None, None, :], groups=n * c)
    x = torch.nn.functional.conv2d(x, kc[:, None, :, None], groups=n * c)
    return x.reshape(n, c, h, w).permute(0, 2, 3, 1)


# ----------------------------------------------------------- random erasing --

def random_erasing(generator, images, prob: float = 0.25,
                   min_area: float = 0.02, max_area: float = 1 / 3,
                   min_aspect: float = 0.3, attempts: int = 10):
    """timm-style RandomErasing, 'pixel' mode: with probability `prob`, erase
    one region (the first geometrically valid of `attempts` area/aspect draws)
    with per-pixel standard-normal noise.  Operates on NORMALISED images (the
    reference applies it after Normalize)."""
    n, h, w, _ = images.shape
    dev = images.device
    lo, hi = math.log(min_aspect), math.log(1 / min_aspect)
    do_erase = torch.rand(n, generator=generator, device=dev) < prob
    areas = _uniform((n, attempts), min_area, max_area, generator, dev) * (h * w)
    ratios = torch.exp(_uniform((n, attempts), lo, hi, generator, dev))
    eh = torch.round(torch.sqrt(areas * ratios)).long()
    ew = torch.round(torch.sqrt(areas / ratios)).long()
    valid = (eh < h) & (ew < w)
    idx = valid.int().argmax(-1, keepdim=True)       # first valid attempt
    ok = valid.gather(-1, idx)[:, 0] & do_erase
    eh_i = eh.gather(-1, idx)[:, 0].clamp(1, h - 1)
    ew_i = ew.gather(-1, idx)[:, 0].clamp(1, w - 1)
    top = torch.randint(0, h, (n,), generator=generator, device=dev)
    left = torch.randint(0, w, (n,), generator=generator, device=dev)
    top = torch.minimum(top, h - eh_i)
    left = torch.minimum(left, w - ew_i)
    rows = torch.arange(h, device=dev)[None, :, None]
    cols = torch.arange(w, device=dev)[None, None, :]
    at = lambda v: v[:, None, None]
    inside = ((rows >= at(top)) & (rows < at(top + eh_i))
              & (cols >= at(left)) & (cols < at(left + ew_i)) & at(ok))
    noise = torch.randn(images.shape, generator=generator, device=dev,
                        dtype=images.dtype)
    return torch.where(inside[..., None], noise, images)


# ------------------------------------------------------------- composition --

def _random_apply(generator, images, fn, prob: float):
    """Reference RandomApply quirk, preserved: applies when random() > prob,
    that is with probability 1 - prob (reference utils/util.py:22-30)."""
    n = images.shape[0]
    apply_mask = torch.rand(n, generator=generator, device=images.device) > prob
    return torch.where(apply_mask[:, None, None, None], fn(images), images)


def affwild2_train_augment(generator, images, img_size: int = 224):
    """Aff-Wild2 train transform stack (reference utils/util.py:43-60):
    Resize -> RandomApply(Grayscale, .2) -> RandomApply(ColorJitter(.4), .8)
    -> RandomApply(GaussianBlur, .5) -> Normalize -> RandomErasing(pixel, .25).
    images (N, H, W, 3) uint8 or float in [0, 255] -> normalised float32."""
    with trace_span("fmmt.data.augment"):
        g = generator
        x = resize_batch(images, img_size)
        x = _random_apply(g, x, grayscale, prob=0.2)
        x = _random_apply(
            g, x, lambda im: color_jitter(g, im, 0.4, 0.4, 0.4, 0.4),
            prob=0.8)
        x = _random_apply(g, x, lambda im: gaussian_blur(g, im), prob=0.5)
        x = normalize_images(x)
        return random_erasing(g, x, prob=0.25)


def meld_face_train_augment(generator, images, img_size: int = 224):
    """MELD face train transform (reference utils/dataset.py:35-39):
    resize -> ColorJitter(0.5, 0.5, 0.5, 0.5) -> Normalize."""
    with trace_span("fmmt.data.augment"):
        x = resize_batch(images, img_size)
        return normalize_images(color_jitter(generator, x, 0.5, 0.5, 0.5,
                                             0.5))


def meld_face_eval_transform(images, img_size: int = 224):
    """MELD face eval transform (reference utils/dataset.py:41-44)."""
    return normalize_images(resize_batch(images, img_size))
