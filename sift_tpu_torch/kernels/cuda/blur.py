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
it runs `blur_plain`. Every radius the stencil takes, the kernel takes.
`LAUNCHES` counts launches: one a call, both passes fused in tiles that
`tile_plan` shapes, except on the line path of radii past MAX_TAPS
(`tile_plan` gives TH == 0), two a call.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from sift_tpu_torch.kernels import build

LAUNCHES = 0

# The kernel's constants (csrc/blur.cu): outputs a thread computes along a
# line (tile sides are multiples of it), most taps a launch can pass by
# value (more take the line path), and the H100's opt-in shared memory a
# block.
P = 8
MAX_TAPS = 1001
SMEM_MAX = 232448
# Shared memory a plan aims under, so that four blocks of 256 threads fit
# on an SM; only radii whose smallest tile exceeds it take more. A tile
# sweep on the H100 (tools/blur_tile_sweep.py, PERF.md): at r = 27 on a
# 2400x3200 plane, 64 x 64 tiles ran faster in two strips under it than in
# one strip of 87 KB.
SMEM_TARGET = 64 * 1024
# Tile shapes, largest first: a call takes the first that still gives it
# BLOCKS blocks, else the last. With fewer blocks the card cannot hide one
# block's staging behind another's arithmetic, and smaller tiles win
# despite their wider halo. In the sweep this rule's plans were within 1%
# of the fastest single shape on a 2400x3200 pair (64 x 64) and faster
# than any single shape on a B=8 488x600 batch (32 x 64 and 32 x 32).
TILES = ((64, 64), (32, 64), (32, 32))
BLOCKS = 1000
# `tile_plan`'s plan past MAX_TAPS (r > 500, which no path reaches): the
# kernel's line path, which reads each folded line from global memory and
# its taps from a device buffer.
LINE_PATH = (0, 0, 0, 0)

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


def smem_bytes(TH: int, TW: int, S: int, r: int) -> int:
    """Dynamic shared memory of a block (csrc/blur.cu): the W-pass buffer,
    TH + 2r rows of pitch TW + 1, and S staged rows of TW + 2r columns at
    an odd pitch."""
    return 4 * ((TH + 2 * r) * (TW + 1) + S * ((TW + 2 * r) | 1))


def _blocks(H: int, W: int, TH: int, TW: int, planes: int) -> int:
    return planes * math.ceil(H / TH) * math.ceil(W / TW)


def tile_plan(H: int, W: int, r: int, planes: int = 1) -> tuple:
    """(TH, TW, S, smem): the output tile of one block, the staged rows a
    strip and the block's shared memory, for `planes` (H, W) planes at
    radius r. The tile is the first of TILES that gives BLOCKS blocks,
    else the last; a side shorter than the tile takes the side rounded up
    to P. All
    TH + 2r staged rows go in one strip while the block stays under
    SMEM_TARGET; past it the tile shrinks (rows first, to P) while a strip
    would hold fewer than 8 rows, then the strip shortens. Only where the
    smallest tile's W-pass buffer alone exceeds SMEM_TARGET does the block
    take up to SMEM_MAX. Past MAX_TAPS the plan is LINE_PATH."""
    if H < 1 or W < 1 or r < 0 or planes < 1:
        raise ValueError(f"blur: no plan for {planes} {H}x{W} planes at "
                         f"radius {r}")
    if 2 * r + 1 > MAX_TAPS:
        return LINE_PATH
    TH, TW = next((t for t in TILES if _blocks(H, W, *t, planes) >= BLOCKS),
                  TILES[-1])
    TW = min(TW, P * math.ceil(W / P))
    TH = min(TH, P * math.ceil(H / P))

    def strip(budget):
        row = 4 * ((TW + 2 * r) | 1)
        return min(TH + 2 * r, (budget - smem_bytes(TH, TW, 0, r)) // row)

    while strip(SMEM_TARGET) < min(TH + 2 * r, 8) and (TH > P or TW > 32):
        if TH > P:
            TH = max(P, TH // 2 // P * P)
        else:
            TW //= 2
    S = strip(SMEM_TARGET)
    if S < 1:
        S = strip(SMEM_MAX)
    return TH, TW, S, smem_bytes(TH, TW, S, r)


@functools.cache
def _fn():
    fn = build.library("blur").sift_blur
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, p, p, p, i, ll, i, i, i, i, i, i, p]
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
    planes = img.numel() // (H * W)
    TH, TW, S, smem = tile_plan(H, W, (taps.size - 1) // 2, planes)
    taps = np.ascontiguousarray(taps)
    # the line path takes its taps from a device buffer and a scratch
    # stack for its W pass
    line = TH == 0
    dev_taps = torch.from_numpy(taps).to(img.device) if line else None
    scratch = torch.empty_like(img) if line else None
    rc = _fn()(img.data_ptr(), out.data_ptr(), taps.ctypes.data,
               None if dev_taps is None else dev_taps.data_ptr(),
               None if scratch is None else scratch.data_ptr(), taps.size,
               planes, H, W, TH, TW, S, smem,
               torch.cuda.current_stream(img.device).cuda_stream)
    build.check(rc, "blur")
    LAUNCHES += 2 if line else 1
    return out
