"""What a scene generator hands the harness."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class Scene:
    """frames: (N, H, W) float32 in [0, 255] on the run's device; pairs:
    index pairs (a, b) into frames; truth: per pair the homography with
    b = H(a) in pixels (float64), or None where the scene has none."""

    frames: torch.Tensor
    pairs: List[Tuple[int, int]]
    truth: List[Optional[np.ndarray]]
