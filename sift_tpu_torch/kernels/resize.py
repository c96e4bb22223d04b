"""Image resizing (counterpart of `sift_tpu/kernels/resize.py`).

Nearest resize follows Vigra's `resizeImageNoInterpolation` as the
reference uses it (`alg::reduceToNextLevel` / `increaseToNextLevel`):
destination index i reads source index `int(i * (s-1)/(d-1) + 0.5)`.
Bilinear resize follows `jax.image.resize(..., "bilinear")`: half-pixel
centres, a triangle kernel (widened when downsampling) and weights
renormalised where they fall off the edge, applied a spatial axis at a
time as a sum of taps (an index and a weight an output per tap). Index
tables and weights are host constants, built once per size and placed on
each device once.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from sift_tpu_torch.utils.device import constant


def _nearest_indices(ssize: int, dsize: int) -> np.ndarray:
    if dsize == 1:
        return np.zeros((1,), np.int32)
    ratio = (ssize - 1) / (dsize - 1)
    idx = (np.arange(dsize) * ratio + 0.5).astype(np.int64)
    return np.clip(idx, 0, ssize - 1).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _nearest_indices_t(ssize: int, dsize: int, device: str) -> torch.Tensor:
    return constant(_nearest_indices(ssize, dsize), device, torch.int64)


def resize_nearest(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Nearest resize of a (..., H, W) stack to (..., out_h, out_w)."""
    h, w = img.shape[-2], img.shape[-1]
    dev = str(img.device)
    return (img.index_select(-2, _nearest_indices_t(h, out_h, dev))
            .index_select(-1, _nearest_indices_t(w, out_w, dev)))


def downsample_half(img: torch.Tensor) -> torch.Tensor:
    """Reference octave step: resize to ((H+1)//2, (W+1)//2)."""
    h, w = img.shape[-2], img.shape[-1]
    return resize_nearest(img, (h + 1) // 2, (w + 1) // 2)


def upsample_double(img: torch.Tensor) -> torch.Tensor:
    """Reference subpixel step: resize to (2H, 2W)."""
    h, w = img.shape[-2], img.shape[-1]
    return resize_nearest(img, 2 * h, 2 * w)


@functools.lru_cache(maxsize=None)
def bilinear_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) f32 weights of `jax.image.resize`'s bilinear
    kernel along one axis (`compute_weight_mat` with antialiasing), in its
    operation order."""
    f32 = np.float32
    scale = f32(out_size) / f32(in_size)
    inv_scale = f32(1.0) / scale
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = ((np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale
                - f32(0.5))
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) \
        / kernel_scale
    weights = np.maximum(f32(0.0), f32(1.0) - x)
    total = weights.sum(axis=0, keepdims=True, dtype=f32)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                       weights / np.where(total != 0, total, f32(1.0)),
                       f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], weights, f32(0.0)).astype(f32)


@functools.lru_cache(maxsize=None)
def bilinear_taps(in_size: int, out_size: int):
    """`bilinear_weights` as taps: (T, out_size) int64 source indices and
    f32 weights, T the widest support of an output. Output j reads sources
    lo_j + t for t < T in ascending order (the order of the matrix
    product); a tap past its support has weight 0 and a clamped index."""
    wm = bilinear_weights(in_size, out_size)
    nz = wm != 0
    any_nz = nz.any(axis=0)
    lo = np.where(any_nz, nz.argmax(axis=0), 0)
    hi = np.where(any_nz, in_size - 1 - nz[::-1].argmax(axis=0), 0)
    t = np.arange(int((hi - lo).max()) + 1)[:, None]
    idx = lo[None, :] + t
    inside = idx <= hi[None, :]
    idx = np.minimum(idx, in_size - 1)
    w = np.where(inside, wm[idx, np.arange(out_size)[None, :]], 0.0)
    return idx.astype(np.int64), w.astype(np.float32)


def _resize_axis(img: torch.Tensor, out_size: int, dim: int) -> torch.Tensor:
    """Bilinear resize along `dim` (-1 or -2) as a tap sum: gather each
    tap's sources, multiply by its weights, add in tap order."""
    idx, w = bilinear_taps(img.shape[dim], out_size)
    dev = img.device
    shape = (out_size,) if dim == -1 else (out_size, 1)
    out = None
    for t in range(idx.shape[0]):
        term = (img.index_select(dim, constant(idx[t], dev, torch.int64))
                * constant(w[t], dev).reshape(shape))
        out = term if out is None else out + term
    return out


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize of a (..., H, W) float32 stack, along W, then along
    H (an axis whose size does not change is left alone, as in JAX). Each
    output is the sum of its few taps in a fixed order, one elementwise
    multiply and add a tap: it rounds alike at every batch size and on
    every device."""
    out = img
    if out_w != img.shape[-1]:
        out = _resize_axis(out, out_w, -1)
    if out_h != img.shape[-2]:
        out = _resize_axis(out, out_h, -2)
    return out
