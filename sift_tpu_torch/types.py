"""Fixed-capacity buffers of the PyTorch port (counterpart of
`sift_tpu.types`).

A `Keypoints` batch has fixed-capacity tensors plus a validity mask;
invalid slots carry padding values. Positions are (x, y) in the
coordinate frame of the keypoint's (octave, level): x indexes width,
y indexes height. `to_image_xy` maps them to original-image pixels by the
reference's rule `loc * 2**octave / (2 if subpixel else 1)`.
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

    @property
    def capacity(self) -> int:
        return self.x.shape[-1]

    def count(self) -> torch.Tensor:
        return self.valid.to(torch.int32).sum(dim=-1)

    def to_image_xy(self, subpixel: bool = False):
        """Positions in original-image pixels."""
        factor = torch.exp2(self.octave.to(torch.float32))
        div = 2.0 if subpixel else 1.0
        return self.x * factor / div, self.y * factor / div

    def filtered(self, keep: torch.Tensor) -> "Keypoints":
        """A copy with `valid &= keep` (no compaction, so masks compose)."""
        return dataclasses.replace(self, valid=self.valid & keep)


def empty_keypoints(capacity: int, with_desc: bool = False,
                    device="cuda") -> Keypoints:
    """`capacity` zeroed, invalid slots on `device` (the card unless the
    caller passes "cpu"): float32 positions, scale, score and orientation,
    int32 octave and level, and a (capacity, 128) float32 `desc` or None."""
    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)
    return Keypoints(
        x=zeros(capacity), y=zeros(capacity),
        octave=zeros(capacity, dtype=torch.int32),
        level=zeros(capacity, dtype=torch.int32),
        scale=zeros(capacity), score=zeros(capacity),
        orientation=zeros(capacity),
        valid=zeros(capacity, dtype=torch.bool),
        desc=zeros(capacity, 128) if with_desc else None)


def _to_numpy(obj):
    return type(obj)(**{f.name: getattr(obj, f.name).detach().cpu().numpy()
                        for f in dataclasses.fields(obj)})


@dataclasses.dataclass
class Matches:
    """Fixed-capacity correspondences between two keypoint sets."""

    idx_a: torch.Tensor     # (M,) int32 into set A
    idx_b: torch.Tensor     # (M,) int32 into set B
    distance: torch.Tensor  # (M,) float32
    valid: torch.Tensor     # (M,) bool

    def count(self) -> torch.Tensor:
        return self.valid.to(torch.int32).sum(dim=-1)

    def to_numpy(self) -> "Matches":
        return _to_numpy(self)


@dataclasses.dataclass
class TwoViewEstimate:
    """Output of two-view RANSAC geometry."""

    model: torch.Tensor        # (3, 3) E/F/H matrix
    inliers: torch.Tensor      # (M,) bool over the input matches
    num_inliers: torch.Tensor  # () int32
    success: torch.Tensor      # () bool

    def to_numpy(self) -> "TwoViewEstimate":
        return _to_numpy(self)


@dataclasses.dataclass
class MapState:
    """SLAM/SfM map: fixed-capacity cameras, landmarks, observation graph.

    poses:      (C, 6)  se(3) tangent (world-from-camera as (rot, trans) log).
    intrinsics: (4,)    fx, fy, cx, cy (shared pinhole).
    landmarks:  (L, 3)  world points.
    obs_cam:    (O,)    int32 camera index per observation.
    obs_lm:     (O,)    int32 landmark index per observation.
    obs_uv:     (O, 2)  measured pixel coordinates.
    *_valid:    masks for each capacity axis.
    """

    poses: torch.Tensor
    intrinsics: torch.Tensor
    landmarks: torch.Tensor
    obs_cam: torch.Tensor
    obs_lm: torch.Tensor
    obs_uv: torch.Tensor
    pose_valid: torch.Tensor
    landmark_valid: torch.Tensor
    obs_valid: torch.Tensor

    def replace(self, **kw) -> "MapState":
        return dataclasses.replace(self, **kw)
