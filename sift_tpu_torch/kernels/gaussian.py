"""Separable Gaussian blur (counterpart of `sift_tpu/kernels/gaussian.py`).

Vigra `initGaussian(sigma)` semantics: a sampled Gaussian of radius
round(3*sigma), normalized to unit sum, applied in X then Y with mirror
(edge-not-repeated) borders. The blur is a shifted-add stencil: the hand
kernel `csrc/blur.cu` on the card, its plain version on the CPU, bit for
bit alike. `blur_matrix` is the same blur as a banded operator (the JAX
package's matrix form), kept for comparison with it.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from sift_tpu_torch.kernels.cuda import blur as blur_kernel
from sift_tpu_torch.kernels.cuda.blur import (  # noqa: F401
    stencil_1d as _stencil_1d)


def gaussian_radius(sigma: float) -> int:
    """Vigra's kernel radius: round(3*sigma)."""
    return max(1, int(3.0 * float(sigma) + 0.5))


def gaussian_kernel_1d(sigma: float, radius: int | None = None,
                       dtype=np.float32) -> np.ndarray:
    """Sampled, sum-normalized 1-D Gaussian taps at integer offsets."""
    if radius is None:
        radius = gaussian_radius(sigma)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    taps = np.exp(-0.5 * (x / float(sigma)) ** 2)
    taps /= taps.sum()
    return taps.astype(dtype)


def _mirror_index(j: int, n: int) -> int:
    """scipy 'mirror' (reflect-without-edge-duplication) index folding."""
    if n == 1:
        return 0
    period = 2 * n - 2
    j = j % period
    return j if j < n else period - j


@functools.lru_cache(maxsize=None)
def blur_matrix(n: int, sigma: float, radius: int | None = None) -> np.ndarray:
    """(n, n) banded blur operator with the mirror border folded into the
    band: `A @ v` is exactly the mirror-padded 1-D convolution of v."""
    taps = gaussian_kernel_1d(sigma, radius=radius, dtype=np.float64)
    r = (len(taps) - 1) // 2
    A = np.zeros((n, n), np.float64)
    for i in range(n):
        for k, t in enumerate(taps):
            A[i, _mirror_index(i + k - r, n)] += t
    return A.astype(np.float32)


def gaussian_blur(img: torch.Tensor, sigma: float,
                  radius: int | None = None) -> torch.Tensor:
    """Separable Gaussian blur of a (..., H, W) float32 stack: the blur
    kernel on the card, its plain stencil on the CPU (`kernels/cuda/
    blur.py`). Each output sums its own line's taps in tap order, so it
    rounds alike at every batch size and on both devices."""
    taps = gaussian_kernel_1d(sigma, radius=radius)
    return blur_kernel.blur(img.contiguous(), taps)


def incremental_sigma(sigma_prev: float, sigma_target: float) -> float:
    """Blur increment so blur(blur(I, s_prev), delta) == blur(I, s_target)."""
    d2 = sigma_target * sigma_target - sigma_prev * sigma_prev
    assert d2 > 0, (sigma_prev, sigma_target)
    return math.sqrt(d2)
