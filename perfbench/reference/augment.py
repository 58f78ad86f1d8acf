"""The training transforms of the reference, on the device, every random
draw taken from an explicit torch.Generator: Aff-Wild2's (utils/util.py:
43-60: Resize -> RandomApply(Grayscale, .2) -> RandomApply(ColorJitter(.4),
.8) -> RandomApply(GaussianBlur, .5) -> Normalize -> RandomErasing(pixel,
.25)) and MELD's faces' (utils/dataset.py:35-39: Resize -> ColorJitter(.5)
-> Normalize).

A frozen copy of the program's data/image_pipeline.py at the time the
benchmark was written, made independent of the program: the draws are
taken in the same order, so a generator in the same state gives the same
augmentation, and the check repeats the augmentation the timed path ran
from the benchmark's own generator.  (RandomApply keeps the reference's
quirk: it applies when random() > p, with probability 1 - p.)"""

from __future__ import annotations

import math

import torch

from perfbench.reference.facialmmt import resize_weights


def resize_batch(images, size: int):
    """(N, H, W, C) -> (N, size, size, C) float32."""
    x = images.float()
    n, h, w, c = x.shape
    if h == size and w == size:
        return x
    wh = torch.from_numpy(resize_weights(h, size)).to(x.device)
    ww = torch.from_numpy(resize_weights(w, size)).to(x.device)
    x = torch.einsum("oh,nhwc->nowc", wh, x)
    return torch.einsum("pw,nowc->nopc", ww, x)


def normalize_images(images, mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5)):
    """[0, 255] floats -> ((x / 255) - mean) / std."""
    m = torch.tensor(mean, dtype=images.dtype).to(images.device)
    s = torch.tensor(std, dtype=images.dtype).to(images.device)
    return (images / 255.0 - m) / s


def _uniform(shape, lo: float, hi: float, generator, device):
    return lo + (hi - lo) * torch.rand(shape, generator=generator,
                                       device=device)


# ------------------------------------------------------------- color space --

_LUMA = (0.299, 0.587, 0.114)


def grayscale(images):
    """ITU-R 601 luma replicated to 3 channels.  images float in [0, 255]."""
    luma = torch.tensor(_LUMA, dtype=images.dtype).to(images.device)
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
    g = generator
    x = resize_batch(images, img_size)
    x = _random_apply(g, x, grayscale, prob=0.2)
    x = _random_apply(g, x, lambda im: color_jitter(g, im, 0.4, 0.4, 0.4, 0.4),
                      prob=0.8)
    x = _random_apply(g, x, lambda im: gaussian_blur(g, im), prob=0.5)
    x = normalize_images(x)
    return random_erasing(g, x, prob=0.25)


def meld_face_train_augment(generator, images, img_size: int = 224):
    """MELD face train transform (reference utils/dataset.py:35-39):
    resize -> ColorJitter(0.5, 0.5, 0.5, 0.5) -> Normalize."""
    x = resize_batch(images, img_size)
    return normalize_images(color_jitter(generator, x, 0.5, 0.5, 0.5, 0.5))
