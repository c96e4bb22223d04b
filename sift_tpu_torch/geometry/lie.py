"""SO(3) / SE(3) Lie group operations (counterpart of
`sift_tpu/geometry/lie.py`).

All functions broadcast over leading axes and are branch-free (small-angle
handling by `torch.where` on Taylor expansions), so they run the same on
the CPU and the card, under `torch.func.jacfwd`, and without a host sync.

Conventions:
  * rotations act on column vectors: x_world = R @ x_cam + t for a
    world-from-camera pose.
  * se(3) tangent vectors are (omega, v), rotation first, with the left
    trivialization: exp([w, v]) = [exp(w^), V(w) v].
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat map: (..., 3) -> (..., 3, 3) skew-symmetric."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], -1),
        torch.stack([wz, z, -wx], -1),
        torch.stack([-wy, wx, z], -1),
    ], -2)


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of `hat`: (..., 3, 3) -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], -1)


def _eye_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def _sinc_cos_terms(theta2: torch.Tensor):
    """Branch-free (sin t/t, (1-cos t)/t^2, (t - sin t)/t^3) with Taylor
    fallbacks."""
    theta = torch.sqrt(torch.clamp_min(theta2, _EPS * _EPS))
    small = theta2 < _EPS
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - a) / theta2)
    return a, b, c


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) axis-angle -> (..., 3, 3) rotation."""
    theta2 = (w * w).sum(dim=-1)[..., None, None]
    W = hat(w)
    W2 = W @ W
    a, b, _ = _sinc_cos_terms(theta2)
    return _eye_like(W) + a * W + b * W2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation -> (..., 3) axis-angle (theta in [0, pi]).

    theta comes from atan2(|skew|, cos), never arccos, whose derivative
    blows up at theta = 0; each `torch.where` branch is computed from
    guarded inputs, so no branch's value or tangent is NaN at another
    branch's operating point (safe under `torch.func.jacfwd`)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    w_skew = vee(R - R.transpose(-1, -2)) * 0.5        # = sin(theta) * axis

    s2 = (w_skew * w_skew).sum(dim=-1)                 # sin(theta)^2
    small = (s2 < 1e-10) & (cos_t > 0.0)
    safe_s2 = torch.where(small, 1.0, s2)
    sin_t = torch.sqrt(safe_s2)
    theta = torch.atan2(sin_t, cos_t)
    generic = (theta / sin_t)[..., None] * w_skew
    # theta/sin(theta) ~ 1 + theta^2/6, theta^2 ~ s2 for small angles.
    small_branch = (1.0 + s2 / 6.0)[..., None] * w_skew
    generic = torch.where(small[..., None], small_branch, generic)

    # Near theta = pi the axis comes from the symmetric part:
    # (R + R^T)/2 - cos t I = (1 - cos t) n n^T; the row with the largest
    # diagonal entry is the best conditioned.
    near_pi = theta > 3.0
    S = (R + R.transpose(-1, -2)) * 0.5
    nnT = (S - cos_t[..., None, None] * _eye_like(R)) / \
        torch.clamp_min(1.0 - cos_t[..., None, None], _EPS)
    diag = torch.diagonal(nnT, dim1=-2, dim2=-1)
    k = torch.argmax(diag, dim=-1)
    row = torch.gather(nnT, -2, k[..., None, None].expand(
        k.shape + (1, 3)))[..., 0, :]
    axis = row / torch.sqrt(torch.clamp_min(
        (row * row).sum(dim=-1, keepdim=True), _EPS * _EPS))
    # Align the sign with the skew part (sin t > 0 for t < pi).
    dot = (axis * w_skew).sum(dim=-1, keepdim=True)
    axis = axis * torch.where(dot < 0, -1.0, 1.0)
    theta_pi = torch.atan2(torch.sqrt(s2 + 1e-20), cos_t)
    pi_branch = theta_pi[..., None] * axis

    return torch.where(near_pi[..., None], pi_branch, generic)


def _left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """SO(3) left Jacobian V(w): exp([w, v]) translation = V(w) v."""
    theta2 = (w * w).sum(dim=-1)[..., None, None]
    W = hat(w)
    W2 = W @ W
    _, b, c = _sinc_cos_terms(theta2)
    return _eye_like(W) + b * W + c * W2


def _left_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    theta2 = (w * w).sum(dim=-1)[..., None, None]
    theta = torch.sqrt(torch.clamp_min(theta2, _EPS * _EPS))
    W = hat(w)
    W2 = W @ W
    small = theta2 < _EPS
    half_theta = 0.5 * theta
    cot_term = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half_theta * torch.cos(half_theta) / torch.sin(half_theta))
        / theta2,
    )
    return _eye_like(W) - 0.5 * W + cot_term * W2


def se3_exp(xi: torch.Tensor):
    """(..., 6) tangent (omega, v) -> (R (..., 3, 3), t (..., 3))."""
    w, v = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    t = (_left_jacobian(w) @ v[..., None])[..., 0]
    return R, t


def se3_log(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(R, t) -> (..., 6) tangent (omega, v)."""
    w = so3_log(R)
    v = (_left_jacobian_inv(w) @ t[..., None])[..., 0]
    return torch.cat([w, v], dim=-1)


def se3_matrix(xi: torch.Tensor) -> torch.Tensor:
    """(..., 6) -> (..., 4, 4) homogeneous transform."""
    R, t = se3_exp(xi)
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.zeros(top.shape[:-2] + (1, 4), dtype=xi.dtype,
                         device=xi.device)
    bottom[..., 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def se3_inverse(R: torch.Tensor, t: torch.Tensor):
    """Inverse of (R, t): (R^T, -R^T t)."""
    Rt = R.transpose(-1, -2)
    return Rt, -(Rt @ t[..., None])[..., 0]


def se3_compose(Ra, ta, Rb, tb):
    """(Ra, ta) o (Rb, tb): first apply b, then a."""
    return Ra @ Rb, (Ra @ tb[..., None])[..., 0] + ta


def transform(R: torch.Tensor, t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Apply (R, t) to points x (..., 3)."""
    return (R @ x[..., None])[..., 0] + t


def boxplus(xi: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Right-perturbation retraction: log(exp(xi) o exp(delta))."""
    R1, t1 = se3_exp(xi)
    R2, t2 = se3_exp(delta)
    R, t = se3_compose(R1, t1, R2, t2)
    return se3_log(R, t)
