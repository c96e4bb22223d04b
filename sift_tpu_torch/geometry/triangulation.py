"""Linear (DLT) two-view triangulation, batched over correspondences
(counterpart of `sift_tpu/geometry/triangulation.py`).

Each point solves a 4x4 homogeneous system: the eigenvector of the
smallest eigenvalue of its normal matrix, found for the whole batch by a
fixed number of Jacobi sweeps (`_smallest_eigvec`). `torch.linalg.eigh`
would read its error codes on the host, a sync per call, and raises
where the JAX package's `eigh` returns NaN: on non-finite input, and on
the card (cuSOLVER's batched solver) on degenerate systems such as a
zero baseline, which a relocalization probe triangulates.
"""

from __future__ import annotations

import torch

_EPS = 1e-12
# Cyclic Jacobi on 4x4 matrices, two disjoint pairs rotated at a time;
# five sweeps reach f32 precision on random, rank-2 and rank-3 systems.
_JACOBI_ROUNDS = (((0, 1), (2, 3)), ((0, 2), (1, 3)), ((0, 3), (1, 2)))
_JACOBI_SWEEPS = 6


def _smallest_eigvec(M: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector (..., 4) of the smallest eigenvalue of symmetric
    (..., 4, 4) M, by `_JACOBI_SWEEPS` cyclic Jacobi sweeps. No convergence
    test: no host sync and no error; non-finite input gives NaN. Built
    out of place, so `torch.func.vmap` can batch it."""
    V = torch.eye(4, dtype=M.dtype, device=M.device).expand(M.shape)
    zero = torch.zeros_like(M[..., 0, 0])
    for _ in range(_JACOBI_SWEEPS):
        for pairs in _JACOBI_ROUNDS:
            G = [[zero] * 4 for _ in range(4)]
            for p, q in pairs:
                # The angle that zeroes M[p, q] in G^T M G.
                theta = 0.5 * torch.atan2(2.0 * M[..., p, q],
                                          M[..., q, q] - M[..., p, p])
                c, s = torch.cos(theta), torch.sin(theta)
                G[p][p], G[q][q], G[p][q], G[q][p] = c, c, s, -s
            G = torch.stack([torch.stack(row, -1) for row in G], -2)
            M = G.transpose(-1, -2) @ M @ G
            V = V @ G
    i = torch.argmin(M.diagonal(dim1=-2, dim2=-1), dim=-1)
    return torch.gather(V, -1, i[..., None, None].expand(
        V.shape[:-1] + (1,)))[..., 0]


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
    Xh = _smallest_eigvec(M)                         # (..., N, 4)
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
