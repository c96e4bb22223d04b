"""Orientation assignment (counterpart of `sift_tpu/frontend/orientation.py`).

lowe: histogram smoothing and peak selection for the window stages.

parity (the reference's `_orientationAssignment`, `_findNearestGaussian`):
the parabola vertex is always NaN, so every orientation is NaN and no
keypoint is duplicated. What remains is the nearest-Gaussian lookup, the
first argmin over all recorded sigmas in octave-major order (a keypoint's
coordinates stay in its own octave's frame), and the `>=`-form bounds test
in that Gaussian's frame.
"""

from __future__ import annotations

import numpy as np
import torch

from sift_tpu_torch.frontend.extrema import top_k_stable
from sift_tpu_torch.kernels.cuda import windows as window_kernel
from sift_tpu_torch.kernels.histogram import parabola_vertex
from sift_tpu_torch.utils.device import constant

R = 8  # parity window radius: 16x16 windows, the reference's `region`


def nearest_gaussian_index(scale: torch.Tensor, gauss_sigmas: np.ndarray):
    """(octave, level) of the first recorded sigma nearest `scale`; a
    difference of 100 or more never wins (the reference's initial
    `lowest_diff`)."""
    flat = constant(gauss_sigmas.reshape(-1), scale.device)
    diffs = (flat - scale[..., None]).abs()
    diffs = torch.where(diffs < 100.0, diffs, float("inf"))
    idx = torch.argmin(diffs, dim=-1)        # first occurrence wins
    n_levels = gauss_sigmas.shape[1]
    return idx // n_levels, idx % n_levels


def gather_window(stack_2d: torch.Tensor, y: torch.Tensor, x: torch.Tensor,
                  radius: int = R) -> torch.Tensor:
    """The (2r, 2r) windows [y-r, y+r) x [x-r, x+r) of a float32 or
    bfloat16 (H, W) map at integer positions y, x of any shape, as float32
    (..., 2r, 2r).

    The starts follow `lax.dynamic_slice`: a negative start counts from
    the far end (start + H), then every start is clamped into [0, H-2r]
    (columns alike). So a window past the far edge moves inside the map,
    and one past the near edge by less than the map's size moves to the
    far edge. A window wider than the map raises. On the card one launch
    of the window gather kernel (C = 1, one level) takes every window;
    its zeros past the edge are never read."""
    H, W = stack_2d.shape
    d = 2 * radius
    if d > H or d > W:
        raise ValueError(f"gather_window: a {d}x{d} window does not fit "
                         f"a {H}x{W} map")
    if stack_2d.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gather_window: map dtype {stack_2d.dtype}")
    if y.is_floating_point() or x.is_floating_point():
        raise TypeError("gather_window: y and x must be integer tensors")
    shape = y.shape

    def starts(c, n):
        s = c.reshape(-1).to(torch.int32) - radius
        return torch.where(s < 0, s + n, s).clamp(0, n - d)
    y0, x0 = starts(y, H), starts(x, W)
    gl = torch.zeros_like(y0)
    wins = window_kernel.gather_windows(stack_2d.contiguous()[None, None],
                                        gl, y0, x0, d)
    return wins.reshape(*shape, d, d)


def parity_bounds_ok(x, y, widths, heights):
    """`>=`-form bounds test of a 16x16 window."""
    return (x >= R) & (x < widths - R) & (y >= R) & (y < heights - R)


def assign_orientation_parity(kp: dict, gauss_sigmas: np.ndarray,
                              shapes: np.ndarray) -> dict:
    """kp: keypoint buffers of any shape, (B, N) for a batch (the lookup
    is elementwise); shapes: (O, 2) numpy (H_o, W_o). Returns kp with
    `gauss_o`, `gauss_l`, a NaN `orientation` and bounds-filtered
    `valid`."""
    go, gl = nearest_gaussian_index(kp["scale"], gauss_sigmas)
    dev = kp["scale"].device
    hs = constant(shapes[:, 0], dev, torch.int32)[go]
    ws = constant(shapes[:, 1], dev, torch.int32)[go]
    ok = parity_bounds_ok(kp["x"].to(torch.int32), kp["y"].to(torch.int32),
                          ws, hs)
    out = dict(kp)
    out["gauss_o"] = go.to(torch.int32)
    out["gauss_l"] = gl.to(torch.int32)
    out["valid"] = kp["valid"] & ok
    out["orientation"] = torch.full_like(kp["scale"], float("nan"))
    return out


def _circular_smooth(hist: torch.Tensor, passes: int = 1) -> torch.Tensor:
    """[1,4,6,4,1]/16 circular smoothing along the last axis."""
    for _ in range(passes):
        hm2 = torch.roll(hist, 2, dims=-1)
        hm1 = torch.roll(hist, 1, dims=-1)
        hp1 = torch.roll(hist, -1, dims=-1)
        hp2 = torch.roll(hist, -2, dims=-1)
        hist = (hm2 + hp2 + 4.0 * (hm1 + hp1) + 6.0 * hist) / 16.0
    return hist


def peaks_from_histogram(hist: torch.Tensor, max_peaks: int, rel: float = 0.8):
    """Top `max_peaks` circular local maxima >= rel*max, parabola-refined.

    hist: (K, 36). Returns (orientations_deg (K, P), peak_valid (K, P))."""
    left = torch.roll(hist, 1, dims=-1)
    right = torch.roll(hist, -1, dims=-1)
    hmax = hist.max(dim=-1, keepdim=True).values
    is_peak = (hist >= left) & (hist > right) & (hist >= rel * hmax) & (hmax > 0)
    score = torch.where(is_peak, hist, float("-inf"))
    top_vals, top_idx = top_k_stable(score, max_peaks)
    pvalid = torch.isfinite(top_vals)

    centers = top_idx.to(torch.float32) * 10.0 + 5.0
    yl = torch.gather(left, -1, top_idx)
    yp = torch.gather(hist, -1, top_idx)
    yr = torch.gather(right, -1, top_idx)
    v = parabola_vertex(centers - 10.0, yl, centers, yp, centers + 10.0, yr)
    return torch.remainder(v, 360.0), pvalid
