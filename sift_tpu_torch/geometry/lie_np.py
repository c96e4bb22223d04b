"""NumPy mirrors of the SE(3) operations in `sift_tpu_torch.geometry.lie`
(a verbatim copy of `sift_tpu/geometry/lie_np.py`, kept in the port so
that it never imports the JAX package).

The SLAM host loop does a lot of tiny 6-dof pose arithmetic (constant-
velocity prediction, odometry-edge refresh, two-pose relative logs); these
numpy versions run on the host in microseconds, with no device dispatch.

Single-pose (6,) or batched (..., 6) inputs; float64 internally for the
trig, cast back to the input dtype.
"""
from __future__ import annotations

import numpy as np

_EPS = 1e-8


def _hat(w):
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = np.zeros_like(wx)
    return np.stack([
        np.stack([z, -wz, wy], -1),
        np.stack([wz, z, -wx], -1),
        np.stack([-wy, wx, z], -1),
    ], -2)


def _sinc_cos_terms(theta2):
    theta = np.sqrt(np.maximum(theta2, _EPS * _EPS))
    small = theta2 < _EPS
    with np.errstate(invalid="ignore", divide="ignore"):
        a = np.where(small, 1.0 - theta2 / 6.0, np.sin(theta) / theta)
        b = np.where(small, 0.5 - theta2 / 24.0,
                     (1.0 - np.cos(theta)) / theta2)
        c = np.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - a) / theta2)
    return a, b, c


def so3_exp(w):
    w = np.asarray(w, np.float64)
    theta2 = np.sum(w * w, -1)[..., None, None]
    W = _hat(w)
    W2 = W @ W
    a, b, _ = _sinc_cos_terms(theta2)
    return np.broadcast_to(np.eye(3), W.shape) + a * W + b * W2


def so3_log(R):
    R = np.asarray(R, np.float64)
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = np.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    skew = np.stack([R[..., 2, 1] - R[..., 1, 2],
                     R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1) * 0.5
    s2 = np.sum(skew * skew, -1)
    small = (s2 < 1e-10) & (cos_t > 0.0)
    sin_t = np.sqrt(np.where(small, 1.0, s2))
    theta = np.arctan2(sin_t, cos_t)
    generic = (theta / sin_t)[..., None] * skew
    small_branch = (1.0 + s2 / 6.0)[..., None] * skew
    out = np.where(small[..., None], small_branch, generic)

    near_pi = theta > 3.0
    if np.any(near_pi):
        S = (R + np.swapaxes(R, -1, -2)) * 0.5
        nnT = (S - cos_t[..., None, None] * np.eye(3)) / \
            np.maximum(1.0 - cos_t[..., None, None], _EPS)
        diag = np.stack([nnT[..., 0, 0], nnT[..., 1, 1], nnT[..., 2, 2]], -1)
        k = np.argmax(diag, -1)
        row = np.take_along_axis(nnT, k[..., None, None], -2)[..., 0, :]
        axis = row / np.sqrt(np.maximum(
            np.sum(row * row, -1, keepdims=True), _EPS * _EPS))
        dot = np.sum(axis * skew, -1, keepdims=True)
        axis = axis * np.where(dot < 0, -1.0, 1.0)
        theta_pi = np.arctan2(np.sqrt(s2 + 1e-20), cos_t)
        out = np.where(near_pi[..., None], theta_pi[..., None] * axis, out)
    return out


def _left_jacobian(w):
    theta2 = np.sum(w * w, -1)[..., None, None]
    W = _hat(w)
    W2 = W @ W
    _, b, c = _sinc_cos_terms(theta2)
    return np.broadcast_to(np.eye(3), W.shape) + b * W + c * W2


def _left_jacobian_inv(w):
    theta2 = np.sum(w * w, -1)[..., None, None]
    theta = np.sqrt(np.maximum(theta2, _EPS * _EPS))
    W = _hat(w)
    W2 = W @ W
    small = theta2 < _EPS
    half = 0.5 * theta
    with np.errstate(invalid="ignore", divide="ignore"):
        cot_term = np.where(
            small, 1.0 / 12.0 + theta2 / 720.0,
            (1.0 - half * np.cos(half) / np.sin(half)) / theta2)
    return np.broadcast_to(np.eye(3), W.shape) - 0.5 * W + cot_term * W2


def se3_exp(xi):
    xi = np.asarray(xi)
    dtype = xi.dtype
    xi = xi.astype(np.float64)
    w, v = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    t = (_left_jacobian(w) @ v[..., None])[..., 0]
    return R.astype(dtype), t.astype(dtype)


def se3_log(R, t):
    R = np.asarray(R)
    dtype = R.dtype
    w = so3_log(R)
    v = (_left_jacobian_inv(w) @ np.asarray(t, np.float64)[..., None])[..., 0]
    return np.concatenate([w, v], -1).astype(dtype)


def se3_inverse(R, t):
    Rt = np.swapaxes(R, -1, -2)
    return Rt, -(Rt @ np.asarray(t)[..., None])[..., 0]


def se3_compose(Ra, ta, Rb, tb):
    return Ra @ Rb, (Ra @ np.asarray(tb)[..., None])[..., 0] + ta


def boxplus(xi, delta):
    R1, t1 = se3_exp(np.asarray(xi, np.float64))
    R2, t2 = se3_exp(np.asarray(delta, np.float64))
    R, t = se3_compose(R1, t1, R2, t2)
    return se3_log(R, t).astype(np.asarray(xi).dtype)


def rel_pose(xi_i, xi_j):
    """log(T_i^-1 T_j) for two (..., 6) poses."""
    Ri, ti = se3_exp(np.asarray(xi_i, np.float64))
    Rj, tj = se3_exp(np.asarray(xi_j, np.float64))
    Rii, tii = se3_inverse(Ri, ti)
    R, t = se3_compose(Rii, tii, Rj, tj)
    return se3_log(R, t).astype(np.asarray(xi_i).dtype)


def pose_deltas(old, new):
    """Batched rigid corrections T_new T_old^-1: (N,6),(N,6) -> (N,3,3),(N,3)."""
    Ro, to = se3_exp(np.asarray(old, np.float64))
    Rn, tn = se3_exp(np.asarray(new, np.float64))
    Roi, toi = se3_inverse(Ro, to)
    R, t = se3_compose(Rn, tn, Roi, toi)
    return R.astype(np.float32), t.astype(np.float32)
