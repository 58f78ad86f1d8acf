"""MELD face eval transform (counterpart of the eval part of
facialmmt_tpu/data/image_pipeline.py): resize, then normalise.

The resize reproduces jax.image.resize: a Keys cubic kernel (a = -0.5) when
enlarging, an antialiased triangle kernel when shrinking, each 1-D weight
matrix renormalised over the taps that fall inside the image.
torch.nn.functional.interpolate does not match (its bicubic uses a = -0.75),
so the weights are built in numpy and applied as two matmuls.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


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
    wh = torch.from_numpy(resize_weights(h, size)).to(x.device)
    ww = torch.from_numpy(resize_weights(w, size)).to(x.device)
    x = torch.einsum("oh,nhwc->nowc", wh, x)
    return torch.einsum("pw,nowc->nopc", ww, x)


def normalize_images(images, mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5)):
    """[0, 255] floats -> ((x / 255) - mean) / std."""
    m = torch.tensor(mean, dtype=images.dtype, device=images.device)
    s = torch.tensor(std, dtype=images.dtype, device=images.device)
    return (images / 255.0 - m) / s


def meld_face_eval_transform(images, img_size: int = 224):
    """MELD face eval transform (reference utils/dataset.py:41-44)."""
    return normalize_images(resize_batch(images, img_size))
