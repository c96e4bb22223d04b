"""Keypoint buffers of the PyTorch port (counterpart of `sift_tpu.types`).

A `Keypoints` batch has fixed-capacity tensors plus a validity mask;
invalid slots carry padding values. Positions are (x, y) in the
coordinate frame of the keypoint's (octave, level): x indexes width,
y indexes height.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class Keypoints:
    """Fixed-capacity keypoints; all tensors share the leading shape.

    x, y: float32 level coordinates; octave, level: int32; scale: float32
    absolute sigma; score: float32 |DoG|; orientation: float32 degrees in
    [0, 360); valid: bool; desc: optional (..., N, 128) float32.
    n_dropped: refined valid keypoints cut by the global top-K.
    n_cand_pruned: raw extrema candidates beyond the per-octave caps.
    """

    x: torch.Tensor
    y: torch.Tensor
    octave: torch.Tensor
    level: torch.Tensor
    scale: torch.Tensor
    score: torch.Tensor
    orientation: torch.Tensor
    valid: torch.Tensor
    desc: Optional[torch.Tensor] = None
    n_dropped: Optional[torch.Tensor] = None
    n_cand_pruned: Optional[torch.Tensor] = None

    def map(self, fn) -> "Keypoints":
        """Apply `fn` to every tensor field (None fields stay None)."""
        return Keypoints(**{f.name: (None if getattr(self, f.name) is None
                                     else fn(getattr(self, f.name)))
                            for f in dataclasses.fields(self)})

    def to_numpy(self) -> "Keypoints":
        """The same keypoints with every field as a numpy array."""
        return self.map(lambda t: t.detach().cpu().numpy())
