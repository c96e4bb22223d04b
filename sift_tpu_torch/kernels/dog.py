"""Difference-of-Gaussians (lowe mode: a plain difference, no +128 offset)."""

from __future__ import annotations

import torch


def dog(lower: torch.Tensor, higher: torch.Tensor) -> torch.Tensor:
    return higher - lower
