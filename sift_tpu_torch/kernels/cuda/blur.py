"""Separable Gaussian blur: hand CUDA kernel (`csrc/blur.cu`) and its plain
version.

Replaces no TPU kernel (the JAX package blurs with XLA's convolution or
an einsum); it makes the blur round alike at every batch size and on
every device. The plain version is a shifted-add stencil over a
mirror-padded copy, along W, then along H: per tap one elementwise
multiply and one add, in tap order. Each pixel's sum therefore depends
on its own line only, never on how many images share the stack, and the
kernel repeats it term for term without fused multiply-adds, so kernel
and plain version are bit-identical.

On a CUDA tensor `blur` launches the kernel (or raises); on a CPU tensor
it runs `blur_plain`. `LAUNCHES` counts calls: each is two launches of
the kernel, one a pass.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from sift_tpu_torch.kernels import build
from sift_tpu_torch.utils.device import constant

LAUNCHES = 0


def mirror_indices(n: int, r: int, device) -> torch.Tensor:
    """scipy 'mirror' (reflect-without-edge-duplication) index of j - r for
    j in [0, n + 2r), for any radius r (folded by the period 2n - 2; 0 for
    n == 1)."""
    j = torch.arange(-r, n + r, device=device)
    if n == 1:
        return torch.zeros_like(j)
    period = 2 * n - 2
    j = torch.remainder(j, period)
    return torch.where(j < n, j, period - j)


def stencil_1d(img: torch.Tensor, taps: np.ndarray, dim: int) -> torch.Tensor:
    """Mirror-padded 1-D convolution along `dim` as a shifted-add stencil."""
    n = img.shape[dim]
    r = (len(taps) - 1) // 2
    padded = img.index_select(dim, mirror_indices(n, r, img.device))
    out = None
    for k, t in enumerate(taps.tolist()):
        term = padded.narrow(dim, k, n) * t
        out = term if out is None else out + term
    return out


def blur_plain(img: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """img: (..., H, W) f32; taps: (2r + 1,) f32. The separable blur, along
    W, then along H."""
    out = stencil_1d(img, taps, img.dim() - 1)
    return stencil_1d(out, taps, img.dim() - 2)


@functools.cache
def _fn():
    fn = build.library("blur").sift_blur
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, p, p, i, ll, i, i, p]
    fn.restype = i
    return fn


def blur(img: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """See `blur_plain`. `img` must be float32 with at least two dims and
    contiguous; `taps` an odd-length 1-D array."""
    taps = np.asarray(taps, dtype=np.float32)
    if img.dtype != torch.float32 or img.dim() < 2 or not img.is_contiguous():
        raise ValueError("blur: img must be a contiguous (..., H, W) float32 "
                         f"tensor, got {img.dtype} {tuple(img.shape)} "
                         f"strides {img.stride()}")
    if taps.ndim != 1 or taps.size % 2 != 1:
        raise ValueError(f"blur: taps must be 1-D of odd length, got "
                         f"shape {taps.shape}")
    if not img.is_cuda:
        return blur_plain(img, taps)
    global LAUNCHES
    out = torch.empty_like(img)
    H, W = img.shape[-2], img.shape[-1]
    if img.numel() == 0:
        return out
    scratch = torch.empty_like(img)
    t = constant(taps, img.device)
    rc = _fn()(img.data_ptr(), scratch.data_ptr(), out.data_ptr(),
               t.data_ptr(), taps.size, img.numel() // (H * W), H, W,
               torch.cuda.current_stream(img.device).cuda_stream)
    build.check(rc, "blur")
    LAUNCHES += 1
    return out
