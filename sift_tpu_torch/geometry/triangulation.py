"""Linear (DLT) two-view triangulation, batched over correspondences
(counterpart of `sift_tpu/geometry/triangulation.py`).

Each point solves a 4x4 homogeneous system; the batch is one `eigh` over
(..., N, 4, 4).
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def triangulate_dlt(P1: torch.Tensor, P2: torch.Tensor,
                    x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Triangulate N correspondences.

    P1, P2: (..., 3, 4) projection matrices (with K for pixel inputs, or
    [R|t] for normalized coordinates); x1, x2: (N, 2) observations. Leading
    axes of P1/P2 broadcast (e.g. a batch of candidate poses). Returns
    (..., N, 3) points in the frame P1/P2 project from."""
    def rows(P, x):
        P = P[..., None, :, :]                       # (..., 1, 3, 4)
        return (x[..., 0:1] * P[..., 2, :] - P[..., 0, :],
                x[..., 1:2] * P[..., 2, :] - P[..., 1, :])

    a0, a1 = rows(P1, x1)
    a2, a3 = rows(P2, x2)
    A = torch.stack(torch.broadcast_tensors(a0, a1, a2, a3), dim=-2)  # (..., N, 4, 4)
    M = A.transpose(-1, -2) @ A                      # normal equations
    _, vecs = torch.linalg.eigh(M)
    Xh = vecs[..., 0]                                # (..., N, 4)
    w = Xh[..., 3:]
    return Xh[..., :3] / torch.where(w.abs() < _EPS, _EPS, w)


def reprojection_depths(R: torch.Tensor, t: torch.Tensor, X: torch.Tensor):
    """Depths of camera-A-frame points X in cameras A and B
    (x_b = R x_a + t)."""
    za = X[..., 2]
    zb = (X @ R.transpose(-1, -2) + t[..., None, :])[..., 2]
    return za, zb


def count_in_front(Rs, ts, na, nb, weights) -> torch.Tensor:
    """Per candidate (R, t) of (C, 3, 3), (C, 3): weighted correspondences
    that triangulate in front of both cameras (camera A at identity,
    camera B projecting x_b = R x_a + t). Returns (C,) counts."""
    eye = torch.eye(3, 4, dtype=Rs.dtype, device=Rs.device)
    P2 = torch.cat([Rs, ts[:, :, None]], dim=-1)
    X = triangulate_dlt(eye, P2, na, nb)           # (C, N, 3), camera-A frame
    za = X[..., 2]
    zb = (X @ Rs.transpose(-1, -2) + ts[:, None, :])[..., 2]
    good = (za > 0) & (zb > 0) & (weights > 0)
    return good.sum(dim=-1)
