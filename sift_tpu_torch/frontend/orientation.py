"""Orientation histogram smoothing and peak selection (counterpart of
`sift_tpu/frontend/orientation.py`, lowe mode)."""

from __future__ import annotations

import torch

from sift_tpu_torch.frontend.extrema import top_k_stable
from sift_tpu_torch.kernels.histogram import parabola_vertex


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
