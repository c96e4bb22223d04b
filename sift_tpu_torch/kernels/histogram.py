"""Parabola vertex refinement of histogram peaks (lowe mode)."""

from __future__ import annotations

import torch


def parabola_vertex(x_left, y_left, x_peak, y_peak, x_right, y_right):
    """Vertex abscissa of the parabola through three points."""
    denom = (x_left - x_peak) * (x_left - x_right) * (x_peak - x_right)
    a = (x_right * (y_peak - y_left) + x_peak * (y_left - y_right)
         + x_left * (y_right - y_peak)) / denom
    b = (x_right * x_right * (y_left - y_peak)
         + x_peak * x_peak * (y_right - y_left)
         + x_left * x_left * (y_peak - y_right)) / denom
    safe = a.abs() > 1e-12
    return torch.where(safe, -b / (2.0 * torch.where(safe, a, torch.ones_like(a))),
                       x_peak)
