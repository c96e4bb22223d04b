"""Dense gradient magnitude / orientation maps (counterpart of
`sift_tpu/kernels/gradients.py`).

Undivided central differences, `dx = I(x+1) - I(x-1)`, magnitude
`sqrt(dx^2 + dy^2)`, orientation `mod(atan2(dy, dx) + 360, 360)`. Parity
mode keeps the reference's quirk of wrapping atan2's radians as if they
were degrees (values in [0, pi] and [360 - pi, 360)); lowe mode converts
to degrees first. The 1-pixel border is 0 in both maps.
"""

from __future__ import annotations

import math

import torch


def gradient_magnitude_orientation(img: torch.Tensor, parity: bool = False):
    """Returns (magnitude, orientation_degrees) maps shaped like the
    (..., H, W) input."""
    dx = torch.zeros_like(img)
    dy = torch.zeros_like(img)
    dx[..., 1:-1] = img[..., 2:] - img[..., :-2]
    dy[..., 1:-1, :] = img[..., 2:, :] - img[..., :-2, :]

    mag = torch.sqrt(dx * dx + dy * dy)
    theta = torch.atan2(dy, dx)
    if not parity:
        theta = theta * (180.0 / math.pi)
    ori = torch.remainder(theta + 360.0, 360.0)

    interior = torch.zeros(img.shape[-2:], dtype=torch.bool, device=img.device)
    interior[1:-1, 1:-1] = True
    zero = torch.zeros((), dtype=img.dtype, device=img.device)
    return torch.where(interior, mag, zero), torch.where(interior, ori, zero)
