"""Separable Gaussian blur (counterpart of `sift_tpu/kernels/gaussian.py`).

Vigra `initGaussian(sigma)` semantics: a sampled Gaussian of radius
round(3*sigma), normalized to unit sum, applied in X then Y with mirror
(edge-not-repeated) borders. Up to `_MATMUL_MAX_DIM` the blur is two f32
matrix products with the mirror border folded into a banded operator;
above it, and wherever the result must round alike on every device, an
explicit shifted-add stencil over a mirror-padded copy.

The JAX package runs these products at `Precision.HIGHEST`, so the port
refuses to run them in TF32 on the card.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from sift_tpu_torch.utils.device import check_f32_matmul


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


@functools.lru_cache(maxsize=None)
def _blur_matrix_t(n: int, sigma: float, radius, device: str) -> torch.Tensor:
    return torch.from_numpy(blur_matrix(n, sigma, radius)).to(device)


# Above this size the O(n) stencil beats the dense banded product.
_MATMUL_MAX_DIM = 2048


def _mirror_indices(n: int, r: int, device) -> torch.Tensor:
    """`_mirror_index(j - r, n)` for j in [0, n + 2r), computed on `device`
    (no host table to copy there)."""
    j = torch.arange(-r, n + r, device=device)
    if n == 1:
        return torch.zeros_like(j)
    period = 2 * n - 2
    j = torch.remainder(j, period)
    return torch.where(j < n, j, period - j)


def _stencil_1d(img: torch.Tensor, taps: np.ndarray, dim: int) -> torch.Tensor:
    """Mirror-padded 1-D convolution along `dim` as a shifted-add stencil."""
    n = img.shape[dim]
    r = (len(taps) - 1) // 2
    padded = img.index_select(dim, _mirror_indices(n, r, img.device))
    out = None
    for k, t in enumerate(taps.tolist()):
        term = padded.narrow(dim, k, n) * t
        out = term if out is None else out + term
    return out


def gaussian_blur(img: torch.Tensor, sigma: float,
                  radius: int | None = None,
                  same_on_every_device: bool = False) -> torch.Tensor:
    """Separable Gaussian blur of a (..., H, W) float32 stack.

    `same_on_every_device` takes the shifted-add stencil at every size:
    one elementwise multiply and one add a tap, in tap order, which round
    alike on the CPU and the card (matrix products do not: cuBLAS and the
    CPU's BLAS sum in other orders). Parity mode needs it: its
    ties-allowed extrema and hard thresholds keep or drop a keypoint on
    the last bit of a DoG value."""
    h, w = img.shape[-2], img.shape[-1]
    if not same_on_every_device:
        check_f32_matmul(img, "gaussian_blur")
        if max(h, w) <= _MATMUL_MAX_DIM:
            dev = str(img.device)
            Ah = _blur_matrix_t(h, float(sigma), radius, dev)
            Aw = _blur_matrix_t(w, float(sigma), radius, dev)
            out = torch.matmul(img, Aw.T)          # along W first, then H
            return torch.matmul(Ah, out)
    taps = gaussian_kernel_1d(sigma, radius=radius)
    out = _stencil_1d(img, taps, img.dim() - 1)
    return _stencil_1d(out, taps, img.dim() - 2)


def incremental_sigma(sigma_prev: float, sigma_target: float) -> float:
    """Blur increment so blur(blur(I, s_prev), delta) == blur(I, s_target)."""
    d2 = sigma_target * sigma_target - sigma_prev * sigma_prev
    assert d2 > 0, (sigma_prev, sigma_target)
    return math.sqrt(d2)
