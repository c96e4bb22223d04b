"""Trajectory export in standard dialects (a verbatim copy of
`sift_tpu/io/trajectory.py`, kept in the port so that it never imports
the JAX package).

The reference dumps per-image keypoints only (`interstpoints.txt`); a SLAM system's headline artifact is the
camera trajectory. `save_tum` writes the TUM-RGBD trajectory grammar
(`timestamp tx ty tz qx qy qz qw`, camera-to-world) so estimates are
directly consumable by the standard external evaluation tools (evo,
TUM's own scripts) against `groundtruth.txt`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def rotmat_to_quat(R: np.ndarray) -> np.ndarray:
    """(..., 3, 3) rotation matrices -> (..., 4) quaternions [qx qy qz qw].

    Shepperd's method: pick the largest of {trace, R00, R11, R22} per
    matrix so the divisor is always well-conditioned (a single-branch
    trace formula degrades near 180-degree rotations). Vectorized, sign
    fixed to qw >= 0.
    """
    R = np.asarray(R, np.float64)
    b = R.shape[:-2]
    Rf = R.reshape((-1, 3, 3))
    n = Rf.shape[0]
    q = np.empty((n, 4))
    tr = np.trace(Rf, axis1=-2, axis2=-1)
    # candidate "pivot" per matrix: 3 -> trace, else diagonal index
    diag = np.stack([Rf[:, 0, 0], Rf[:, 1, 1], Rf[:, 2, 2], tr], -1)
    pivot = np.argmax(diag, axis=-1)
    for k in range(n):
        m = Rf[k]
        p = pivot[k]
        if p == 3:
            s = np.sqrt(max(tr[k] + 1.0, 0.0)) * 2.0      # s = 4*qw
            q[k] = [(m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
                    (m[1, 0] - m[0, 1]) / s, 0.25 * s]
        elif p == 0:
            s = np.sqrt(max(1.0 + m[0, 0] - m[1, 1] - m[2, 2], 0.0)) * 2.0
            q[k] = [0.25 * s, (m[0, 1] + m[1, 0]) / s,
                    (m[0, 2] + m[2, 0]) / s, (m[2, 1] - m[1, 2]) / s]
        elif p == 1:
            s = np.sqrt(max(1.0 - m[0, 0] + m[1, 1] - m[2, 2], 0.0)) * 2.0
            q[k] = [(m[0, 1] + m[1, 0]) / s, 0.25 * s,
                    (m[1, 2] + m[2, 1]) / s, (m[0, 2] - m[2, 0]) / s]
        else:
            s = np.sqrt(max(1.0 - m[0, 0] - m[1, 1] + m[2, 2], 0.0)) * 2.0
            q[k] = [(m[0, 2] + m[2, 0]) / s, (m[1, 2] + m[2, 1]) / s,
                    0.25 * s, (m[1, 0] - m[0, 1]) / s]
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q[q[:, 3] < 0] *= -1.0
    return q.reshape(b + (4,))


def save_tum(path: str, Rs: np.ndarray, ts: np.ndarray,
             timestamps: Optional[Sequence[float]] = None) -> None:
    """Write a TUM-format trajectory: `ts tx ty tz qx qy qz qw` per row.

    Rs (F, 3, 3) / ts (F, 3) are camera-to-world (the TUM groundtruth
    convention — the inverse of `_read_tum_groundtruth`'s parse in
    io/datasets.py). Missing timestamps fall back to the frame index.
    """
    Rs = np.asarray(Rs)
    ts = np.asarray(ts)
    F = ts.shape[0]
    if timestamps is None:
        stamps = np.arange(F, dtype=np.float64)
    else:
        stamps = np.asarray(timestamps, np.float64)
        assert stamps.shape[0] == F, (stamps.shape, F)
    quat = rotmat_to_quat(Rs)
    rows = np.concatenate([stamps[:, None], ts, quat], axis=1)
    header = "timestamp tx ty tz qx qy qz qw"
    np.savetxt(path, rows, fmt="%.9f", header=header)


def save_ply(path: str, points: np.ndarray,
             colors: Optional[np.ndarray] = None) -> None:
    """Write an ASCII PLY point cloud (the standard sparse-map artifact;
    opens in MeshLab/CloudCompare/Open3D).

    points (N, 3) float; colors optional (N, 3) uint8 RGB."""
    pts = np.asarray(points, np.float32).reshape(-1, 3)
    n = pts.shape[0]
    with open(path, "w") as fh:
        fh.write("ply\nformat ascii 1.0\n")
        fh.write(f"element vertex {n}\n")
        fh.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            fh.write("property uchar red\nproperty uchar green\n"
                     "property uchar blue\n")
        fh.write("end_header\n")
        if colors is None:
            # Vectorized: per-line Python formatting costs seconds at
            # 100k+ landmarks on the CLI exit path.
            np.savetxt(fh, pts, fmt="%.6f")
        else:
            cols = np.asarray(colors, np.uint8).reshape(-1, 3)
            assert cols.shape[0] == n, (cols.shape, n)
            for p, c in zip(pts, cols):
                fh.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                         f"{int(c[0])} {int(c[1])} {int(c[2])}\n")
