"""Intrinsics refinement, self-calibration (counterpart of
`sift_tpu/ba/intrinsics.py`).

The pinhole (fx, fy, cx, cy) block couples every observation, so it is
refined by outer-loop coordinate descent: Gauss-Newton on the 4 intrinsic
parameters with poses and landmarks held fixed (one 4x4 solve over all
observations), alternated with bundle adjustment. The projection is
linear in the intrinsics, so the Jacobian is in closed form.
"""

from __future__ import annotations

import torch

from sift_tpu_torch.dist.mesh import psum_many
from sift_tpu_torch.geometry import lie


def _camera_points(poses, landmarks, obs_cam, obs_lm):
    """Camera-frame x/z, y/z (with the guarded 1/z) and z per observation."""
    R, t = lie.se3_exp(poses[obs_cam])
    Rt, tt = lie.se3_inverse(R, t)
    x_c = lie.transform(Rt, tt, landmarks[obs_lm])
    z = x_c[..., 2]
    inv_z = 1.0 / torch.where(z.abs() < 1e-9, 1e-9, z)
    return x_c[..., 0] * inv_z, x_c[..., 1] * inv_z, z


def _residuals(K, xn, yn, obs_uv):
    pred = torch.stack([K[0] * xn + K[2], K[1] * yn + K[3]], dim=-1)
    return pred - obs_uv


def refine_intrinsics(intrinsics, poses, landmarks, obs_cam, obs_lm, obs_uv,
                      obs_valid, iters: int = 10, huber_delta: float = 3.0,
                      damping: float = 1e-4, axis_name=None):
    """Gauss-Newton on (fx, fy, cx, cy) with structure fixed. Returns
    (intrinsics (4,), rmse). Distributed, the observation arrays are this
    rank's shard and `axis_name` (a process group) all-reduces the 4x4
    normal equations, the cost and the final RMSE's sums."""
    xn, yn, z = _camera_points(poses, landmarks, obs_cam, obs_lm)
    ok = obs_valid & (z > 1e-6)
    zero, one = torch.zeros_like(xn), torch.ones_like(xn)
    J = torch.stack([torch.stack([xn, zero, one, zero], -1),
                     torch.stack([zero, yn, zero, one], -1)], -2)  # (O, 2, 4)
    eye = torch.eye(4, dtype=intrinsics.dtype, device=intrinsics.device)

    def weighted_system(K):
        r = _residuals(K, xn, yn, obs_uv)
        n2 = (r * r).sum(dim=-1)
        w = torch.where(ok, torch.clamp_max(
            huber_delta / torch.sqrt(torch.clamp_min(n2, 1e-12)), 1.0), 0.0)
        Jw = J * w[:, None, None]
        H = (Jw[:, :, :, None] * J[:, :, None, :]).sum(dim=(0, 1))
        g = (Jw * r[:, :, None]).sum(dim=(0, 1))
        return psum_many(axis_name, H, g, (w * n2).sum())

    K = intrinsics
    lam = torch.full((), damping, dtype=intrinsics.dtype,
                     device=intrinsics.device)
    for _ in range(iters):
        H, g, cost = weighted_system(K)
        K_new = K - torch.linalg.solve_ex(H + lam * eye, g)[0]
        accept = weighted_system(K_new)[2] < cost
        K = torch.where(accept, K_new, K)
        lam = torch.where(accept, lam * 0.5, lam * 4.0)

    r = _residuals(K, xn, yn, obs_uv)
    n2 = torch.where(ok, (r * r).sum(dim=-1), 0.0)
    n2s, cnt = n2.sum(), ok.sum()
    if axis_name is not None:
        n2s, cnt = psum_many(axis_name, n2s, cnt.to(n2s.dtype))
    rmse = torch.sqrt(n2s / torch.clamp_min(cnt, 1))
    return K, rmse


def self_calibrate(intrinsics, poses, landmarks, obs_cam, obs_lm, obs_uv,
                   obs_valid, cfg, fixed_cam_mask, rounds: int = 3):
    """Alternate intrinsics refinement with bundle adjustment."""
    from sift_tpu_torch.ba.solver import run_ba

    K = intrinsics
    st = None
    for _ in range(rounds):
        st = run_ba(poses, K, landmarks, obs_cam, obs_lm, obs_uv, obs_valid,
                    cfg, fixed_cam_mask)
        poses, landmarks = st.poses, st.landmarks
        K, _ = refine_intrinsics(K, poses, landmarks, obs_cam, obs_lm,
                                 obs_uv, obs_valid,
                                 huber_delta=cfg.huber_delta)
    return K, poses, landmarks, st
