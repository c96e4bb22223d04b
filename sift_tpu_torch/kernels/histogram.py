"""Fixed-bin weighted histograms and parabola vertex refinement of
histogram peaks (counterpart of `sift_tpu/kernels/histogram.py`).

A histogram is a contraction of the weights with a one-hot of the bins, so
it sums in a fixed order on every device (no float atomics). Parity mode
folds bins by `nbins - 1` (the reference's `% 35` / `% 7`) and sends NaN
values to bin 0, as the reference binary's x86 float-to-int conversion
does; its parabola vertex is always NaN (the reference solves a singular
system and divides zero by zero).
"""

from __future__ import annotations

import torch


def weighted_histogram(values: torch.Tensor, weights: torch.Tensor,
                       nbins: int, bin_width: float,
                       parity_fold: bool = False) -> torch.Tensor:
    """Histogram over the last axis: values and weights (..., K) ->
    (..., nbins) float32."""
    fold = (nbins - 1) if parity_fold else nbins
    idx = torch.floor(values / bin_width)
    # Non-finite -> 0 before the cast: casting NaN to an integer is
    # undefined, and differs between the CPU and the card.
    idx = torch.where(torch.isfinite(idx), idx, torch.zeros_like(idx))
    idx = torch.remainder(idx.to(torch.int32), fold)
    onehot = idx[..., None] == torch.arange(nbins, dtype=torch.int32,
                                            device=idx.device)
    return torch.einsum("...k,...kb->...b", weights, onehot.to(weights.dtype))


def parabola_vertex(x_left, y_left, x_peak, y_peak, x_right, y_right,
                    parity: bool = False):
    """Vertex abscissa of the parabola through three points."""
    if parity:
        return torch.full_like(x_peak, float("nan"), dtype=torch.float32)
    denom = (x_left - x_peak) * (x_left - x_right) * (x_peak - x_right)
    a = (x_right * (y_peak - y_left) + x_peak * (y_left - y_right)
         + x_left * (y_right - y_peak)) / denom
    b = (x_right * x_right * (y_left - y_peak)
         + x_peak * x_peak * (y_right - y_left)
         + x_left * x_left * (y_peak - y_right)) / denom
    safe = a.abs() > 1e-12
    return torch.where(safe, -b / (2.0 * torch.where(safe, a, torch.ones_like(a))),
                       x_peak)
