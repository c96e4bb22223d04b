"""Plain PyTorch reference of batched-hypothesis RANSAC for a homography.

Per hypothesis, the four matches with the largest Gumbel noise among the
valid ones (ties to the lower index); a Hartley-normalised weighted DLT
whose 9x9 normal matrix gives the model as its smallest eigenvector;
squared symmetric transfer errors of every match under every model; the
hypothesis with most inliers (ties to the smaller summed inlier error);
and one weighted refit on its inliers, kept if it has at least as many.
The fits run in `Precision.fit` (float64 as stated; the control takes
float32); points, errors and models are float32.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.sift_lowe import EXACT, Precision, top_k_stable

_EPS = 1e-12


def _div(x, den):
    return x / torch.where(den.abs() < _EPS, _EPS, den)


def _finite(A):
    return torch.isfinite(A).all(dim=-1).all(dim=-1)


def _safe(A, ok):
    eye = torch.eye(A.shape[-2], A.shape[-1], dtype=A.dtype, device=A.device)
    return torch.where(ok[..., None, None], A, eye)


def _normalization(pts, w):
    wsum = torch.clamp_min(w.sum(dim=-1), _EPS)
    mean = (pts * w[..., None]).sum(dim=-2) / wsum[..., None]
    d = torch.sqrt(((pts - mean[..., None, :]) ** 2).sum(dim=-1))
    s = math.sqrt(2.0) / torch.clamp_min((d * w).sum(dim=-1) / wsum, _EPS)
    T = torch.zeros(pts.shape[:-2] + (3, 3), dtype=pts.dtype, device=pts.device)
    T[..., 0, 0] = s
    T[..., 0, 2] = -s * mean[..., 0]
    T[..., 1, 1] = s
    T[..., 1, 2] = -s * mean[..., 1]
    T[..., 2, 2] = 1.0
    return T


def apply_h(T, pts):
    ph = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
    q = ph @ T.transpose(-1, -2)
    return _div(q[..., :2], q[..., 2:])


def fit(pa, pb, weights=None, dtype=torch.float64):
    """Weighted DLT, pb ~ H pa, computed in `dtype`; H[2, 2] = 1."""
    out = pa.dtype
    pa, pb = pa.to(dtype), pb.to(dtype)
    w = torch.ones(pa.shape[:-1], dtype=dtype, device=pa.device) \
        if weights is None else weights.to(dtype)
    Ta, Tb = _normalization(pa, w), _normalization(pb, w)
    na, nb = apply_h(Ta, pa), apply_h(Tb, pb)
    x, y, u, v = na[..., 0], na[..., 1], nb[..., 0], nb[..., 1]
    z, one = torch.zeros_like(x), torch.ones_like(x)
    r1 = torch.stack([x, y, one, z, z, z, -u * x, -u * y, -u], -1)
    r2 = torch.stack([z, z, z, x, y, one, -v * x, -v * y, -v], -1)
    A = torch.cat([r1 * w[..., None], r2 * w[..., None]], dim=-2)
    M = A.transpose(-1, -2) @ A
    ok = _finite(M)
    _, vecs = torch.linalg.eigh(_safe(M, ok))
    vecs = torch.where(ok[..., None, None], vecs, float("nan"))
    Hn = vecs[..., :, 0].reshape(vecs.shape[:-2] + (3, 3))
    okb = _finite(Tb)
    X, info = torch.linalg.solve_ex(_safe(Tb, okb), Hn @ Ta)
    H = torch.where((okb & (info == 0))[..., None, None], X, float("nan"))
    return _div(H, H[..., 2:3, 2:3]).to(out)


def transfer_error(H, pa, pb):
    """|H pa - pb|^2 + |H^-1 pb - pa|^2, (..., N)."""
    ok = _finite(H)
    inv, info = torch.linalg.inv_ex(_safe(H, ok))
    Hinv = torch.where((ok & (info == 0))[..., None, None], inv, float("nan"))
    return (((apply_h(H, pa) - pb) ** 2).sum(dim=-1)
            + ((apply_h(Hinv, pb) - pa) ** 2).sum(dim=-1))


def ransac(noise, pa, pb, valid, cfg: dict, prec: Precision = EXACT):
    """RansacConfig fields `cfg`; noise (num_hypotheses, N) Gumbel values.
    Returns (H (3, 3) float32, number of inliers)."""
    scores = torch.where(valid[None, :], noise.to(valid.device), -1e30)
    _, idx = top_k_stable(scores, 4)
    models = fit(pa[idx], pb[idx], dtype=prec.fit)
    errors = transfer_error(models, pa, pb)
    t2 = cfg["inlier_threshold"] ** 2
    inl = (errors < t2) & valid[None, :]
    counts = inl.sum(dim=-1)
    err_sum = torch.where(inl, errors, 0.0).sum(dim=-1)
    best = torch.argmax(counts.to(torch.float32) - err_sum / (err_sum.max() + 1.0))
    model, n = models[best], counts[best]
    if cfg["refit"]:
        refit = fit(pa, pb, inl[best].to(pa.dtype), dtype=prec.fit)
        n2 = ((transfer_error(refit, pa, pb) < t2) & valid).sum()
        better = n2 >= n
        model = torch.where(better, refit, model)
        n = torch.where(better, n2, n)
    return model, n
