"""Pinhole camera model (counterpart of `sift_tpu/geometry/camera.py`).

Poses are world-from-camera (R, t): x_w = R x_c + t. Projection therefore
first inverts the pose. Intrinsics are (fx, fy, cx, cy) pinhole, no
distortion.
"""

from __future__ import annotations

import torch

from sift_tpu_torch.geometry import lie

_EPS = 1e-9


def world_to_camera(pose_wc: torch.Tensor, x_w: torch.Tensor) -> torch.Tensor:
    """pose_wc: (..., 6) se3 world-from-camera; x_w: (..., 3) world points."""
    R, t = lie.se3_exp(pose_wc)
    Rt, tt = lie.se3_inverse(R, t)
    return lie.transform(Rt, tt, x_w)


def project(pose_wc: torch.Tensor, intrinsics: torch.Tensor,
            x_w: torch.Tensor):
    """Project world points into pixels. Returns (uv (..., 2), depth (...,)),
    depth being the camera-frame z."""
    x_c = world_to_camera(pose_wc, x_w)
    z = x_c[..., 2]
    inv_z = 1.0 / torch.where(z.abs() < _EPS, _EPS, z)
    fx, fy, cx, cy = (intrinsics[..., 0], intrinsics[..., 1],
                      intrinsics[..., 2], intrinsics[..., 3])
    u = fx * x_c[..., 0] * inv_z + cx
    v = fy * x_c[..., 1] * inv_z + cy
    return torch.stack([u, v], dim=-1), z


def backproject(intrinsics: torch.Tensor, uv: torch.Tensor,
                depth: torch.Tensor) -> torch.Tensor:
    """Pixels + depth -> camera-frame 3D points."""
    fx, fy, cx, cy = (intrinsics[..., 0], intrinsics[..., 1],
                      intrinsics[..., 2], intrinsics[..., 3])
    x = (uv[..., 0] - cx) / fx * depth
    y = (uv[..., 1] - cy) / fy * depth
    return torch.stack([x, y, depth], dim=-1)


def normalize_points(intrinsics: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Pixels -> normalized image coordinates (K^{-1} [u, v, 1])_{xy}."""
    fx, fy, cx, cy = (intrinsics[..., 0], intrinsics[..., 1],
                      intrinsics[..., 2], intrinsics[..., 3])
    return torch.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], dim=-1)


def intrinsics_matrix(intrinsics: torch.Tensor) -> torch.Tensor:
    """(fx, fy, cx, cy) -> 3x3 K."""
    fx, fy, cx, cy = intrinsics.unbind(-1)
    zero, one = torch.zeros_like(fx), torch.ones_like(fx)
    return torch.stack([torch.stack([fx, zero, cx], -1),
                        torch.stack([zero, fy, cy], -1),
                        torch.stack([zero, zero, one], -1)], -2)
