"""Difference-of-Gaussians: `higher - lower`, plus the reference's +128
offset in parity mode (`alg::dog`)."""

from __future__ import annotations

import torch


def dog(lower: torch.Tensor, higher: torch.Tensor,
        parity_offset: bool = False) -> torch.Tensor:
    d = higher - lower
    if parity_offset:
        d = d + 128.0
    return d
