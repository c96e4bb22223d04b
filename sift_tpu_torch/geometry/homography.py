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
    (..., N) or None. Returns (..., 3, 3) with H[2, 2] = 1."""
    w = torch.ones(pa.shape[:-1], dtype=pa.dtype, device=pa.device) \
        if weights is None else weights
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
    _, vecs = torch.linalg.eigh(M)
    Hn = vecs[..., :, 0].reshape(vecs.shape[:-2] + (3, 3))   # smallest
    H = torch.linalg.solve(Tb, Hn @ Ta)               # Tb^-1 Hn Ta
    return _safe_div(H, H[..., 2:3, 2:3])


def symmetric_transfer_error(H: torch.Tensor, pa: torch.Tensor,
                             pb: torch.Tensor) -> torch.Tensor:
    """Squared symmetric transfer error |H pa - pb|^2 + |H^-1 pb - pa|^2.
    H: (..., 3, 3); pa, pb: (N, 2). Returns (..., N)."""
    Hinv = torch.linalg.inv(H)
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
