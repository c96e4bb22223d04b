"""Homography estimation: weighted DLT + batched RANSAC (counterpart of
`sift_tpu/geometry/homography.py`).

One fit routine serves both the minimal solver (4-point samples, unit
weights) and the inlier refit (weights = inlier mask): the weighted normal
matrix A^T W A is a fixed 9x9 however many points take part, and its
smallest eigenvector is the model. Every function takes leading batch
dimensions, so a batch of hypotheses is one call. The eigenvector's sign is
arbitrary; it cancels when H is divided by H[2, 2].
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from sift_tpu_torch.config import RansacConfig
from sift_tpu_torch.geometry.ransac import Noise, ransac
from sift_tpu_torch.types import TwoViewEstimate
from sift_tpu_torch.utils.linalg import (eigh_or_nan, inv_or_nan,
                                         solve_or_nan, svd_or_nan)

_EPS = 1e-12


def _safe_div(x: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    return x / torch.where(den.abs() < _EPS, _EPS, den)


def _normalization(pts: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Hartley normalization transforms (..., 3, 3) of weighted points
    pts (..., N, 2), w (..., N)."""
    wsum = torch.clamp_min(w.sum(dim=-1), _EPS)
    mean = (pts * w[..., None]).sum(dim=-2) / wsum[..., None]
    d = torch.sqrt(((pts - mean[..., None, :]) ** 2).sum(dim=-1))
    mean_d = (d * w).sum(dim=-1) / wsum
    s = math.sqrt(2.0) / torch.clamp_min(mean_d, _EPS)
    T = torch.zeros(pts.shape[:-2] + (3, 3), dtype=pts.dtype, device=pts.device)
    T[..., 0, 0] = s
    T[..., 0, 2] = -s * mean[..., 0]
    T[..., 1, 1] = s
    T[..., 1, 2] = -s * mean[..., 1]
    T[..., 2, 2] = 1.0
    return T


def _apply_h(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Map (..., N, 2) points by (..., 3, 3) transforms, broadcasting."""
    ph = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
    q = ph @ T.transpose(-1, -2)
    return _safe_div(q[..., :2], q[..., 2:])


def fit_homography(pa: torch.Tensor, pb: torch.Tensor,
                   weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Weighted DLT: H with pb ~ H pa. pa, pb: (..., N, 2); weights:
    (..., N) or None. Returns (..., 3, 3) with H[2, 2] = 1.

    The fit runs in float64 and returns the input's dtype, as
    `epipolar.fit_fundamental_8pt` does. The normal matrix A^T A squares
    the DLT system's conditioning: formed in f32, its smallest eigenvector
    followed the summation order, and on the bootstrap pairs of a
    two-plane sequence (430 matches) the RANSAC models of an NVIDIA H100
    80GB HBM3 (700 W) and of the CPU parted by 1.2e-3 of H's largest
    entry, with 256 against 263 inliers."""
    dtype = pa.dtype
    pa, pb = pa.to(torch.float64), pb.to(torch.float64)
    w = torch.ones(pa.shape[:-1], dtype=pa.dtype, device=pa.device) \
        if weights is None else weights.to(torch.float64)
    Ta = _normalization(pa, w)
    Tb = _normalization(pb, w)
    na = _apply_h(Ta, pa)
    nb = _apply_h(Tb, pb)

    x, y = na[..., 0], na[..., 1]
    u, v = nb[..., 0], nb[..., 1]
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    # Two DLT rows per correspondence.
    r1 = torch.stack([x, y, one, zero, zero, zero, -u * x, -u * y, -u], -1)
    r2 = torch.stack([zero, zero, zero, x, y, one, -v * x, -v * y, -v], -1)
    A = torch.cat([r1 * w[..., None], r2 * w[..., None]], dim=-2)  # (..., 2N, 9)

    M = A.transpose(-1, -2) @ A                       # 9x9 normal matrix
    _, vecs = eigh_or_nan(M)
    Hn = vecs[..., :, 0].reshape(vecs.shape[:-2] + (3, 3))   # smallest
    H = solve_or_nan(Tb, Hn @ Ta)               # Tb^-1 Hn Ta
    return _safe_div(H, H[..., 2:3, 2:3]).to(dtype)


def symmetric_transfer_error(H: torch.Tensor, pa: torch.Tensor,
                             pb: torch.Tensor) -> torch.Tensor:
    """Squared symmetric transfer error |H pa - pb|^2 + |H^-1 pb - pa|^2.
    H: (..., 3, 3); pa, pb: (N, 2). Returns (..., N)."""
    Hinv = inv_or_nan(H)
    fwd = ((_apply_h(H, pa) - pb) ** 2).sum(dim=-1)
    bwd = ((_apply_h(Hinv, pb) - pa) ** 2).sum(dim=-1)
    return fwd + bwd


def ransac_homography(noise: Noise, pa: torch.Tensor, pb: torch.Tensor,
                      valid: torch.Tensor, cfg: RansacConfig) -> TwoViewEstimate:
    """Batched-hypothesis RANSAC homography (4-point minimal samples). Runs
    where the points lie; `noise` is a (num_hypotheses, N) Gumbel tensor
    or a `torch.Generator` (`geometry/ransac.py`)."""
    return ransac(
        noise, pa, pb, valid,
        solve_fn=fit_homography,
        error_fn=symmetric_transfer_error,
        sample_size=4,
        cfg=cfg,
        refit_fn=fit_homography,
    )


def decompose_homography(H: torch.Tensor, na: torch.Tensor, nb: torch.Tensor,
                         weights: torch.Tensor):
    """Faugeras decomposition of a calibrated homography into (R, t, n).

    H relates normalized coordinates, x_b ~ H x_a, for points on a plane
    n^T X = d (camera-A frame): H = R + t n^T / d. The SVD construction
    gives eight (R, t, n) candidates; cheirality (triangulated points in
    front of both cameras) picks one, as in `decompose_essential`.

    Returns (R (3, 3), t (3,) with |t| = 1 (or 0 for pure rotation),
    n (3,), num_good int32)."""
    from sift_tpu_torch.geometry.triangulation import count_in_front

    U, D, Vt = svd_or_nan(H)
    V = Vt.T
    s = torch.linalg.det(U) * torch.linalg.det(V)
    d1, d2, d3 = D[0], D[1], D[2]

    eps = 1e-9
    spread = torch.clamp_min(d1 * d1 - d3 * d3, eps)
    x1 = torch.sqrt(torch.clamp_min((d1 * d1 - d2 * d2) / spread, 0.0))
    x3 = torch.sqrt(torch.clamp_min((d2 * d2 - d3 * d3) / spread, 0.0))
    root = torch.sqrt(torch.clamp_min((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3),
                                      0.0))
    # Case d'2 > 0 (translation "across" the plane normal).
    sin_t = root / torch.clamp_min((d1 + d3) * d2, eps)
    cos_t = (d2 * d2 + d1 * d3) / torch.clamp_min((d1 + d3) * d2, eps)
    # Case d'2 < 0 (reflection branch).
    sin_p = root / torch.clamp_min((d1 - d3).abs() * d2, eps)
    cos_p = (d1 * d3 - d2 * d2) / torch.clamp_min((d1 - d3).abs() * d2, eps)

    zero, one = torch.zeros_like(d1), torch.ones_like(d1)

    def mat(rows):
        return torch.stack([torch.stack(r) for r in rows])

    Rs, ts, ns = [], [], []
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            st = e1 * e3 * sin_t
            Rp = mat([[cos_t, zero, -st], [zero, one, zero], [st, zero, cos_t]])
            tp = (d1 - d3) * torch.stack([e1 * x1, zero, -e3 * x3])
            n_p = torch.stack([e1 * x1, zero, e3 * x3])
            Rs.append(s * U @ Rp @ Vt)
            ts.append(U @ tp)
            ns.append(V @ n_p)

            sp = e1 * e3 * sin_p
            Rn = mat([[cos_p, zero, sp], [zero, -one, zero], [sp, zero, -cos_p]])
            tn = (d1 + d3) * torch.stack([e1 * x1, zero, e3 * x3])
            Rs.append(s * U @ Rn @ Vt)
            ts.append(U @ tn)
            ns.append(V @ n_p)

    Rs = torch.stack(Rs)
    ts = torch.stack(ts)
    ns = torch.stack(ns)
    ts = ts / torch.clamp_min(torch.linalg.vector_norm(ts, dim=-1, keepdim=True),
                              eps)
    counts = count_in_front(Rs, ts, na, nb, weights)
    best = torch.argmax(counts).reshape(1)
    return (Rs.index_select(0, best)[0], ts.index_select(0, best)[0],
            ns.index_select(0, best)[0],
            counts.index_select(0, best)[0].to(torch.int32))
