"""Work counted from the problem, never from a kernel's arguments, and the
card's published peaks.

Peaks: NVIDIA's H100 SXM data sheet, dense rates at the full 700 W power
limit; a result names the card's limit beside it. The hand kernels run in
float32 outside the tensor cores, so their operations are held to the
f32 rate. (A later benchmark PR that moves top-2 onto an f32-accurate
tensor-core path would re-base that metric's peak.)
"""

from __future__ import annotations

import math
from typing import Iterable, Tuple

H100_F32_FLOPS = 67e12          # float32, outside the tensor cores
H100_HBM_BYTES_S = 3.35e12      # HBM3

DESC_WINDOW = 48                # side of a keypoint's gradient windows
DESC_OPS_WINDOW_PIXEL = 20      # magnitude and angle of one window pixel
DESC_OPS_PEAK_PIXEL = 62        # one orientation's votes at one pixel


def bound_s(nbytes: float, nops: float, peak_flops: float = H100_F32_FLOPS,
            peak_bytes_s: float = H100_HBM_BYTES_S) -> float:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the peak rate."""
    return max(nbytes / peak_bytes_s, nops / peak_flops)


def gaussian_taps(sigma: float) -> int:
    """Taps of a sampled Gaussian of radius round(3 sigma), at least 1."""
    return 2 * max(1, int(3.0 * float(sigma) + 0.5)) + 1


def blur_sigmas(sift: dict) -> Tuple[float, Iterable[float]]:
    """(base blur, the incremental blurs of one octave) of a lowe
    pyramid; its input is taken as blurred by 0.5, or by 1.0 where
    `subpixel` doubles it."""
    d, s, k = sift["dogs_per_epoch"], sift["sigma"], sift["k"]
    within = [s * k ** j for j in range(d + 1)]
    n = 1.0 if sift.get("subpixel") else 0.5
    base = math.sqrt(s * s - n * n) if s > n else 0.0
    steps = [math.sqrt(within[j] ** 2 - within[j - 1] ** 2)
             for j in range(1, d + 1)]
    return base, steps


def octave_sizes(height: int, width: int, octaves: int):
    sizes, h, w = [], height, width
    for _ in range(octaves):
        sizes.append((h, w))
        h, w = (h + 1) // 2, (w + 1) // 2
    return sizes


def blur_work(sift: dict, height: int, width: int, batch: int):
    """(bytes, ops) of every Gaussian blur of one extraction of `batch`
    images of `height` x `width` (twice each where `subpixel` doubles
    them): each level's pixels read once and written once (f32), and per
    pass a product a tap and a sum a tap after the first."""
    base, steps = blur_sigmas(sift)
    calls = []
    f = 2 if sift.get("subpixel") else 1
    sizes = octave_sizes(f * height, f * width, sift["octaves"])
    if base > 0:
        calls.append((sizes[0], base))
    for hw in sizes:
        calls += [(hw, s) for s in steps]
    nbytes = nops = 0.0
    for (h, w), sigma in calls:
        n = batch * h * w
        nbytes += n * 4 * 2
        nops += n * 2.0 * (2 * gaussian_taps(sigma) - 1)
    return nbytes, nops


def descriptor_work(windows: float, orientations: float):
    """(bytes, ops) of descriptors for `windows` keypoints with
    `orientations` valid orientations among them: each keypoint's two
    48x48 gradient windows read once as f32 at 20 operations a pixel,
    each orientation 62 operations a pixel and 128 floats written."""
    px = DESC_WINDOW * DESC_WINDOW
    nbytes = windows * 2 * px * 4 + orientations * 128 * 4
    nops = windows * px * DESC_OPS_WINDOW_PIXEL + \
        orientations * px * DESC_OPS_PEAK_PIXEL
    return nbytes, nops


def top2_work(na: float, nb: float, dim: int = 128):
    """(bytes, ops) of the best and second distances between `na` and `nb`
    valid descriptors: every product of the distance matrix once (it
    gives both directions' minima), each descriptor read once."""
    return (na + nb) * dim * 4.0, 2.0 * na * nb * dim
