"""Pose-only optimization: refine cameras against fixed landmarks
(counterpart of `sift_tpu/ba/pose_only.py`).

The tracking step of incremental SfM (frame-to-map localization): given
2D-3D correspondences, Gauss-Newton on the 6-dof pose with Cauchy IRLS
weights, a fixed number of steps and right-perturbation updates. Poses may
carry leading batch axes (one 6x6 solve each), which is how
`pose_ransac_refine` runs its hypotheses together. Jacobians are in
closed form (`ba.residuals.project_with_jacobians`), where the JAX package
takes them by `jax.jacfwd`.

Both run in float64 and return the inputs' dtype. Once Gauss-Newton has
converged, the accept test (`c_new < c_old`) is decided by rounding, and
in f32 each accepted step still moves the pose by up to about 1e-4; the
card and the CPU round their sums differently, so their poses parted by
3.6e-4 on one chunk. In float64 those steps are about 1e-12, below f32's
resolution of the result.
"""

from __future__ import annotations

import torch

from sift_tpu_torch.ba.residuals import project_with_jacobians
from sift_tpu_torch.geometry import lie
from sift_tpu_torch.geometry.ransac import Noise, sample_minimal_sets

_EPS = 1e-12


def _project_rt(R, t, intrinsics, X):
    """World-from-camera (R, t) (..., 3, 3), (..., 3); X (K, 3) world ->
    pixel uv (..., K, 2), depth (..., K)."""
    x_c = (X - t[..., None, :]) @ R          # == R^T (X - t) per point
    z = x_c[..., 2]
    inv_z = 1.0 / torch.where(z.abs() < _EPS, _EPS, z)
    fx, fy, cx, cy = intrinsics[0], intrinsics[1], intrinsics[2], intrinsics[3]
    uv = torch.stack([fx * x_c[..., 0] * inv_z + cx,
                      fy * x_c[..., 1] * inv_z + cy], -1)
    return uv, z


def _residuals(pose, intrinsics, landmarks, uv, valid):
    R, t = lie.se3_exp(pose)
    pred, z = _project_rt(R, t, intrinsics, landmarks)
    return pred - uv, valid & (z > 1e-6)


def pose_only_refine(pose: torch.Tensor, intrinsics: torch.Tensor,
                     landmarks: torch.Tensor, uv: torch.Tensor,
                     valid: torch.Tensor, iters: int = 10,
                     delta: float = 2.0, damping: float = 1e-4):
    """Refine (..., 6) se(3) poses on K fixed 2D-3D correspondences
    (landmarks (K, 3), uv (K, 2), valid (..., K)).

    Returns (pose, inlier_mask, rmse), inliers being residuals < 3 delta,
    in the pose's dtype (the solve runs in float64)."""
    dtype = pose.dtype
    pose, intrinsics, landmarks, uv = (
        t.to(torch.float64) for t in (pose, intrinsics, landmarks, uv))
    lam = torch.full(pose.shape[:-1], damping, dtype=pose.dtype,
                     device=pose.device)
    eye = torch.eye(6, dtype=pose.dtype, device=pose.device)
    for _ in range(iters):
        R0, t0 = lie.se3_exp(pose)
        pred, z, J, _ = project_with_jacobians(
            R0[..., None, :, :], t0[..., None, :], intrinsics, landmarks)
        r = pred - uv
        ok = valid & (z > 1e-6)
        n2 = (r * r).sum(dim=-1)
        w = torch.where(ok, 1.0 / (1.0 + n2 / (delta * delta)), 0.0)
        Jw = J * w[..., None, None]                         # (..., K, 2, 6)
        H = (Jw[..., :, :, None] * J[..., :, None, :]).sum(dim=(-4, -3)) \
            + lam[..., None, None] * eye
        g = (Jw * r[..., None]).sum(dim=(-3, -2))
        d = -torch.linalg.solve_ex(H, g)[0]
        pose_new = lie.boxplus(pose, d)
        # Accept only if the weighted cost decreases. Points that lose
        # cheirality at the new pose keep their old residual in c_new, so
        # pushing points behind the camera earns no spurious decrease.
        r2, ok2 = _residuals(pose_new, intrinsics, landmarks, uv, valid)
        c_old = (w * n2).sum(dim=-1)
        c_new = (w * torch.where(ok2, (r2 * r2).sum(dim=-1), n2)).sum(dim=-1)
        accept = c_new < c_old
        pose = torch.where(accept[..., None], pose_new, pose)
        lam = torch.where(accept, lam * 0.5, lam * 4.0)

    r, ok = _residuals(pose, intrinsics, landmarks, uv, valid)
    n2 = (r * r).sum(dim=-1)
    inliers = ok & (n2 < (3.0 * delta) ** 2)
    cnt = torch.clamp_min(inliers.sum(dim=-1), 1)
    rmse = torch.sqrt(torch.where(inliers, n2, 0.0).sum(dim=-1) / cnt)
    return pose.to(dtype), inliers, rmse.to(dtype)


def pose_ransac_refine(noise: Noise, pose_init: torch.Tensor,
                       intrinsics: torch.Tensor, landmarks: torch.Tensor,
                       uv: torch.Tensor, valid: torch.Tensor,
                       num_hypotheses: int = 8, subset: int = 8,
                       iters: int = 8, delta: float = 2.0):
    """Robust localization: Gauss-Newton from the init plus H hypotheses
    fitted on random subsets (drawn from `noise`, a (H, K) Gumbel tensor
    or a `torch.Generator`), scored by inlier count; the winner is
    re-refined on all correspondences (in float64, as
    `pose_only_refine`)."""
    dtype = pose_init.dtype
    pose_init, intrinsics, landmarks, uv = (
        t.to(torch.float64) for t in (pose_init, intrinsics, landmarks, uv))
    idx = sample_minimal_sets(noise, valid, num_hypotheses, subset)  # (H, S)
    sub_valid = torch.zeros((num_hypotheses,) + valid.shape, dtype=torch.bool,
                            device=valid.device).scatter(1, idx, True) & valid
    poses, _, _ = pose_only_refine(
        pose_init.expand(num_hypotheses, 6), intrinsics, landmarks, uv,
        sub_valid, iters=iters, delta=delta)
    poses = torch.cat([pose_init[None], poses], dim=0)

    R, t = lie.se3_exp(poses)
    pred, z = _project_rt(R, t, intrinsics, landmarks)
    n2 = ((pred - uv) ** 2).sum(dim=-1)
    counts = (valid & (z > 1e-6) & (n2 < (3.0 * delta) ** 2)).sum(dim=-1)
    best = poses.index_select(0, torch.argmax(counts).reshape(1))[0]
    pose, inliers, rmse = pose_only_refine(best, intrinsics, landmarks, uv,
                                           valid, iters=iters, delta=delta)
    return pose.to(dtype), inliers, rmse.to(dtype)
