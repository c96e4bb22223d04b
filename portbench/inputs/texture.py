"""Dense synthetic texture: uniform noise in [0, 255) smoothed by a 5x5 box
and stretched to [0, 255], drawn on the device in one call."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def textured(h: int, w: int, gen: torch.Generator, device) -> torch.Tensor:
    """(h, w) float32 on `device` from `gen` (a generator on `device`)."""
    noise = torch.rand((1, 1, h + 4, w + 4), generator=gen, device=device,
                       dtype=torch.float32) * 255.0
    img = F.avg_pool2d(noise, 5, stride=1)[0, 0]
    lo, hi = img.min(), img.max()
    return (img - lo) / (hi - lo) * 255.0
