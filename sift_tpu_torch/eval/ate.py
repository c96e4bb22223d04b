"""Absolute trajectory error (ATE) and relative pose error (RPE) (a
verbatim copy of `sift_tpu/eval/ate.py`, kept in the port so that it never
imports the JAX package).

The standard TUM-RGBD evaluation protocol (Sturm et al., IROS 2012):
align the estimated trajectory to ground truth with a similarity (or rigid)
transform — the closed-form Umeyama solution — then report the RMSE of
translational residuals. Monocular pipelines estimate scale-free
trajectories, so `with_scale=True` is the monocular default.

Host-side numpy: evaluation is offline, not on the device hot path.
"""

from __future__ import annotations

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray,
                      with_scale: bool = False):
    """Least-squares similarity transform mapping src -> dst.

    Args:
      src, dst: (N, 3) corresponding points.
      with_scale: solve for scale (monocular) or fix s=1 (stereo/RGB-D).

    Returns (s, R, t) with dst ~ s * R @ src + t.
    """
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    assert src.shape == dst.shape and src.shape[1] == 3

    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d

    cov = xd.T @ xs / src.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs ** 2).sum() / src.shape[0]
        s = float(np.trace(np.diag(D) @ S) / max(var_s, 1e-12))
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(est_xyz: np.ndarray, gt_xyz: np.ndarray,
             align: bool = True, with_scale: bool = False) -> float:
    """RMSE of translational ATE after optional alignment (meters)."""
    est = np.asarray(est_xyz, np.float64)
    gt = np.asarray(gt_xyz, np.float64)
    if align:
        s, R, t = umeyama_alignment(est, gt, with_scale)
        est = (s * (R @ est.T)).T + t
    err = est - gt
    return float(np.sqrt((err ** 2).sum(axis=1).mean()))


def rpe_rmse(est_xyz: np.ndarray, gt_xyz: np.ndarray, delta: int = 1) -> float:
    """RMSE of translational *position-delta* RPE over a frame delta.

    NOTE: this is a position-only drift proxy (||Δest − Δgt|| in the
    aligned world frame), NOT the TUM/evo RPE, which expresses the
    relative pose in the earlier frame's local coordinates. Use
    `rpe_rmse_poses` when full poses are available — its numbers match
    `evo_rpe` on the same trajectory.
    """
    est = np.asarray(est_xyz, np.float64)
    gt = np.asarray(gt_xyz, np.float64)
    d_est = est[delta:] - est[:-delta]
    d_gt = gt[delta:] - gt[:-delta]
    err = d_est - d_gt
    return float(np.sqrt((err ** 2).sum(axis=1).mean()))


def rpe_rmse_poses(est_T: np.ndarray, gt_T: np.ndarray, delta: int = 1,
                   scale: float = 1.0) -> float:
    """TUM/evo-compatible translational RPE from full 4x4 poses.

    E_i = (Q_i^-1 Q_{i+d})^-1 (P_i^-1 P_{i+d}); reports RMSE of ||trans(E)||
    (Sturm et al., IROS 2012, eq. 2-4). Relative poses are invariant to a
    global rigid alignment, so only `scale` (monocular Umeyama scale applied
    to estimated translations) affects the result.

    est_T, gt_T: (F, 4, 4) camera-to-world poses.
    """
    est = np.asarray(est_T, np.float64).copy()
    gt = np.asarray(gt_T, np.float64)
    assert est.shape == gt.shape and est.shape[1:] == (4, 4), \
        (est.shape, gt.shape)
    est[:, :3, 3] *= scale
    rel_est = np.linalg.inv(est[:-delta]) @ est[delta:]
    rel_gt = np.linalg.inv(gt[:-delta]) @ gt[delta:]
    err = np.linalg.inv(rel_gt) @ rel_est
    t = err[:, :3, 3]
    return float(np.sqrt((t ** 2).sum(axis=1).mean()))


def poses_from_Rt(Rs: np.ndarray, ts: np.ndarray) -> np.ndarray:
    """Stack (F, 3, 3) rotations + (F, 3) centers into (F, 4, 4) poses."""
    Rs = np.asarray(Rs, np.float64)
    ts = np.asarray(ts, np.float64)
    F = Rs.shape[0]
    T = np.tile(np.eye(4), (F, 1, 1))
    T[:, :3, :3] = Rs
    T[:, :3, 3] = ts
    return T
