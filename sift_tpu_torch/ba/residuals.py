"""Reprojection residuals and per-observation Jacobians (counterpart of
`sift_tpu/ba/residuals.py`).

The parameters are poses (C, 6), se(3) world-from-camera, and landmarks
(L, 3); observation o contributes the 2-vector residual
``r_o = project(pose[cam_o], K, X[lm_o]) - uv_o``.

`linearize` returns the per-observation Jacobian blocks, (O, 2, 6) with
respect to a right perturbation of the observed camera and (O, 2, 3) with
respect to the observed landmark. The JAX package takes them by
`jax.vmap(jax.jacfwd(...))`; here they are in closed form. At delta = 0
the camera-frame point x_c = R^T (X - t) of the pose T exp(delta), delta =
(w, v), moves as d x_c = [x_c]x dw - dv, and d x_c / dX = R^T; the pinhole
projection's Jacobian maps these to pixels. Both are exact derivatives of
the same function, so the two packages agree to f32 rounding.

Robustness: IRLS weights on the residual norm, applied as square roots to
residuals and Jacobian blocks.
"""

from __future__ import annotations

import torch

from sift_tpu_torch.geometry import lie

_EPS = 1e-12


def reprojection_residuals(poses, intrinsics, landmarks,
                           obs_cam, obs_lm, obs_uv):
    """(O, 2) residuals and (O,) depths for all observations: the pinhole
    projection of `geometry/camera.py::project`, with each camera's
    inverse pose computed once and gathered per observation."""
    Rt, tt = lie.se3_inverse(*lie.se3_exp(poses))
    x_c = lie.transform(Rt[obs_cam], tt[obs_cam], landmarks[obs_lm])
    z = x_c[..., 2]
    inv_z = 1.0 / torch.where(z.abs() < 1e-9, 1e-9, z)
    pred = torch.stack([intrinsics[0] * x_c[..., 0] * inv_z + intrinsics[2],
                        intrinsics[1] * x_c[..., 1] * inv_z + intrinsics[3]],
                       dim=-1)
    return pred - obs_uv, z


def robust_weights(r: torch.Tensor, delta, obs_valid: torch.Tensor,
                   depths=None, loss: str = "huber") -> torch.Tensor:
    """IRLS weights (O,) for the robust loss.

    huber:  1 inside the delta region, delta/|r| outside.
    cauchy: 1 / (1 + (|r|/delta)^2).
    Invalid (masked) observations and those behind the camera weigh 0."""
    n2 = torch.clamp_min((r * r).sum(dim=-1), _EPS)
    if loss == "cauchy":
        w = 1.0 / (1.0 + n2 / (delta * delta))
    elif loss == "huber":
        w = torch.clamp_max(delta / torch.sqrt(n2), 1.0)
    elif loss == "none":
        w = torch.ones_like(n2)
    else:
        raise ValueError(f"unknown robust loss {loss!r}")
    w = torch.where(obs_valid, w, 0.0)
    if depths is not None:
        w = torch.where(depths > 1e-6, w, 0.0)
    return w


def project_with_jacobians(R0, t0, intrinsics, X, inv_z_eps: float = _EPS):
    """Project points X (..., 3) into world-from-camera poses (R0, t0)
    (..., 3, 3), (..., 3) and differentiate with respect to a right
    perturbation (w, v) of the pose and to X.

    Returns (pred (..., 2), depth (...), J_pose (..., 2, 6), J_point
    (..., 2, 3))."""
    Rt = R0.transpose(-1, -2)
    x_c = (Rt @ X[..., None])[..., 0] - (Rt @ t0[..., None])[..., 0]
    z = x_c[..., 2]
    tiny = z.abs() < inv_z_eps
    inv_z = 1.0 / torch.where(tiny, inv_z_eps, z)
    fx, fy, cx, cy = (intrinsics[..., 0], intrinsics[..., 1],
                      intrinsics[..., 2], intrinsics[..., 3])
    pred = torch.stack([fx * x_c[..., 0] * inv_z + cx,
                        fy * x_c[..., 1] * inv_z + cy], dim=-1)
    # d pred / d x_c; the guarded 1/z is constant where |z| < eps.
    dz = torch.where(tiny, 0.0, -inv_z * inv_z)
    zero = torch.zeros_like(z)
    P = torch.stack([
        torch.stack([fx * inv_z, zero, fx * x_c[..., 0] * dz], dim=-1),
        torch.stack([zero, fy * inv_z, fy * x_c[..., 1] * dz], dim=-1),
    ], dim=-2)                                               # (..., 2, 3)
    J_pose = torch.cat([P @ lie.hat(x_c), -P], dim=-1)
    J_point = P @ Rt
    return pred, z, J_pose, J_point


def linearize(poses, intrinsics, landmarks, obs_cam, obs_lm, obs_uv,
              obs_valid, huber_delta, loss: str = "huber"):
    """Weighted residuals and Jacobian blocks at the current estimate.

    Returns r (O, 2) sqrt-weighted residuals, Jc (O, 2, 6) and Jl (O, 2, 3)
    sqrt-weighted Jacobian blocks, and w (O,) the IRLS weights."""
    R0, t0 = lie.se3_exp(poses)
    pred, depth, Jc, Jl = project_with_jacobians(R0[obs_cam], t0[obs_cam],
                                                 intrinsics, landmarks[obs_lm])
    r = pred - obs_uv
    w = robust_weights(r, huber_delta, obs_valid, depth, loss)
    sw = torch.sqrt(w)[:, None]
    return r * sw, Jc * sw[..., None], Jl * sw[..., None], w


def cost_parts(poses, intrinsics, landmarks, obs_cam, obs_lm, obs_uv,
               obs_valid, huber_delta, loss: str = "huber"):
    """Robust cost pieces over valid, in-front observations: (total rho,
    sum of squared residuals, count)."""
    r, depths = reprojection_residuals(poses, intrinsics, landmarks,
                                       obs_cam, obs_lm, obs_uv)
    valid = obs_valid & (depths > 1e-6)
    n2 = (r * r).sum(dim=-1)
    norm = torch.sqrt(torch.clamp_min(n2, _EPS))
    d2 = huber_delta * huber_delta
    if loss == "cauchy":
        rho = 0.5 * d2 * torch.log1p(n2 / d2)
    elif loss == "huber":
        # Huber rho: 0.5 r^2 inside, delta (|r| - 0.5 delta) outside.
        rho = torch.where(norm <= huber_delta, 0.5 * n2,
                          huber_delta * (norm - 0.5 * huber_delta))
    elif loss == "none":
        rho = 0.5 * n2
    else:
        raise ValueError(f"unknown robust loss {loss!r}")
    total = torch.where(valid, rho, 0.0).sum()
    sq_sum = torch.where(valid, n2, 0.0).sum()
    return total, sq_sum, valid.sum()


def cost(poses, intrinsics, landmarks, obs_cam, obs_lm, obs_uv, obs_valid,
         huber_delta, loss: str = "huber"):
    """Robust total cost and RMSE over valid, in-front observations."""
    total, sq_sum, cnt = cost_parts(poses, intrinsics, landmarks, obs_cam,
                                    obs_lm, obs_uv, obs_valid, huber_delta,
                                    loss)
    return total, torch.sqrt(sq_sum / torch.clamp_min(cnt, 1))
