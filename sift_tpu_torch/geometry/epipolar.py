"""Epipolar geometry: 8-point and 5-point essential/fundamental fits,
RANSAC, decomposition and a Gauss-Newton polish (counterpart of
`sift_tpu/geometry/epipolar.py`).

Conventions: for a correspondence (xa in view A, xb in view B),
``xb_h^T F xa_h = 0``. The essential matrix relates normalized coordinates
(pixels premultiplied by K^-1) the same way: E = [t]x R with
``x_b = R x_a + t`` mapping camera-A-frame points into camera B's frame,
i.e. (R, t) is the camera-B-from-camera-A rigid transform.

Every solver takes leading batch axes, so the hypotheses of a RANSAC batch
are one call. RANSAC takes a Gumbel noise tensor or a `torch.Generator`
(`geometry/ransac.py`).
"""

from __future__ import annotations

import itertools
import math
from typing import Optional

import numpy as np
import torch

from sift_tpu_torch.config import RansacConfig
from sift_tpu_torch.frontend.extrema import top_k_stable
from sift_tpu_torch.geometry import lie
from sift_tpu_torch.geometry.homography import _apply_h, _normalization
from sift_tpu_torch.geometry.ransac import Noise, ransac, sample_minimal_sets
from sift_tpu_torch.geometry.triangulation import count_in_front
from sift_tpu_torch.types import TwoViewEstimate
from sift_tpu_torch.utils.device import constant
from sift_tpu_torch.utils.linalg import eigh_or_nan, svd_or_nan

_EPS = 1e-12


def _take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] for a 0-d index tensor, without reading i on the host."""
    return x.index_select(0, i.reshape(1))[0]


def _epipolar_rows(na: torch.Tensor, nb: torch.Tensor) -> torch.Tensor:
    """DLT rows for xb^T F xa = 0: (..., N, 9)."""
    x, y = na[..., 0], na[..., 1]
    u, v = nb[..., 0], nb[..., 1]
    return torch.stack([u * x, u * y, u, v * x, v * y, v, x, y,
                        torch.ones_like(x)], -1)


def fit_fundamental_8pt(pa: torch.Tensor, pb: torch.Tensor,
                        weights: Optional[torch.Tensor] = None,
                        essential: bool = False) -> torch.Tensor:
    """Weighted normalized 8-point fit of F (or E if `essential`).

    pa, pb: (..., N, 2) (pixels for F, normalized coordinates for E);
    weights: (..., N) or None. Returns (..., 3, 3), unit Frobenius norm.

    The fit runs in float64 and returns the input's dtype. The normal
    matrix A^T A squares the DLT system's conditioning: formed in f32 it
    carries rounding of eps * |M| (2.5e-4 on a refit over 424 matches of a
    two-plane scene), the size of its two smallest eigenvalues there
    (3.3e-5 and 1.5e-3), so its f32 null vector follows the summation
    order: the card's and the CPU's refit of one such pair recovered
    translations 42 degrees apart."""
    dtype = pa.dtype
    pa, pb = pa.to(torch.float64), pb.to(torch.float64)
    w = torch.ones(pa.shape[:-1], dtype=pa.dtype, device=pa.device) \
        if weights is None else weights.to(torch.float64)
    Ta = _normalization(pa, w)
    Tb = _normalization(pb, w)
    na = _apply_h(Ta, pa)
    nb = _apply_h(Tb, pb)

    A = _epipolar_rows(na, nb) * w[..., None]
    M = A.transpose(-1, -2) @ A
    _, vecs = eigh_or_nan(M)
    F = vecs[..., :, 0].reshape(vecs.shape[:-2] + (3, 3))

    # Project to the model manifold: rank 2 (F), or (s, s, 0) (E).
    U, S, Vt = svd_or_nan(F)
    if essential:
        s = (S[..., 0] + S[..., 1]) * 0.5
        S_proj = torch.stack([s, s, torch.zeros_like(s)], -1)
    else:
        S_proj = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], -1)
    F = U @ (S_proj[..., :, None] * Vt)

    F = Tb.transpose(-1, -2) @ F @ Ta              # denormalize
    norm = torch.linalg.matrix_norm(F)[..., None, None]
    return (F / torch.where(norm < _EPS, _EPS, norm)).to(dtype)


def sampson_error(F: torch.Tensor, pa: torch.Tensor,
                  pb: torch.Tensor) -> torch.Tensor:
    """First-order geometric (Sampson) squared error per correspondence.
    F: (..., 3, 3); pa, pb: (N, 2). Returns (..., N)."""
    pa_h = torch.cat([pa, torch.ones_like(pa[..., :1])], -1)
    pb_h = torch.cat([pb, torch.ones_like(pb[..., :1])], -1)
    Fa = pa_h @ F.transpose(-1, -2)     # (..., N, 3) = F xa
    Ftb = pb_h @ F                      # (..., N, 3) = F^T xb
    num = (pb_h * Fa).sum(dim=-1) ** 2
    den = Fa[..., 0] ** 2 + Fa[..., 1] ** 2 + Ftb[..., 0] ** 2 + Ftb[..., 1] ** 2
    return num / torch.clamp_min(den, _EPS)


def ransac_fundamental(noise: Noise, pa: torch.Tensor, pb: torch.Tensor,
                       valid: torch.Tensor, cfg: RansacConfig) -> TwoViewEstimate:
    """RANSAC fundamental matrix from pixel correspondences."""
    return ransac(noise, pa, pb, valid,
                  solve_fn=fit_fundamental_8pt,
                  error_fn=sampson_error,
                  sample_size=8, cfg=cfg,
                  refit_fn=fit_fundamental_8pt)


def ransac_essential(noise: Noise, na: torch.Tensor, nb: torch.Tensor,
                     valid: torch.Tensor, cfg: RansacConfig,
                     focal: float = 1.0) -> TwoViewEstimate:
    """RANSAC essential matrix (8-point) from normalized correspondences.
    `cfg.inlier_threshold` is in pixels; `focal` converts it to the
    normalized scale."""
    cfg_norm = cfg.replace(inlier_threshold=cfg.inlier_threshold / focal)
    return ransac(
        noise, na, nb, valid,
        solve_fn=lambda a, b: fit_fundamental_8pt(a, b, essential=True),
        error_fn=sampson_error,
        sample_size=8, cfg=cfg_norm,
        refit_fn=lambda a, b, w: fit_fundamental_8pt(a, b, w, essential=True))


# ----------------------------------------------------------- 5-point solver
#
# Hidden-variable resultant, as in the JAX package: E = x E1 + y E2 + z E3
# + E4 spans the null space of the 5 epipolar constraints; det(E) = 0 and
# 2 E E^T E - tr(E E^T) E = 0 give 10 cubics, grouped by the 10
# (x, y)-monomials into A(z) m(x, y) = 0 with A(z) a 10x10 matrix
# polynomial in z. Real roots of det A(z) are isolated by sign changes on a
# fixed tan-spaced grid and refined by fixed-count bisection; (x, y) come
# from the null vector of A(z*).
#
# Every E entry is linear in the homogeneous vector (x, y, z, 1), so each
# cubic is a sum over ordered triples of basis indices (a, b, c) in
# {x, y, z, 1}^3. The JAX package expands the polynomials term by term at
# trace time; here the triples come from four einsums, and one fixed 0/1
# matrix (`_TRIPLE_TO_MONOMIAL`) collects them into the (x, y)-monomial and
# z-power slots.

_XY_MONOMIALS = [(3, 0), (2, 1), (1, 2), (0, 3), (2, 0), (1, 1), (0, 2),
                 (1, 0), (0, 1), (0, 0)]


def _triple_to_monomial() -> np.ndarray:
    """(64, 40) 0/1 matrix: ordered triple (a, b, c) of basis indices
    (0 = x, 1 = y, 2 = z, 3 = 1) -> slot m * 4 + z-power."""
    out = np.zeros((64, 40), np.float32)
    for n, triple in enumerate(itertools.product(range(4), repeat=3)):
        ex, ey, ez = (triple.count(v) for v in range(3))
        out[n, _XY_MONOMIALS.index((ex, ey)) * 4 + ez] = 1.0
    return out


_TRIPLE_TO_MONOMIAL = _triple_to_monomial()


def _levi_civita() -> np.ndarray:
    eps = np.zeros((3, 3, 3), np.float32)
    for p in itertools.permutations(range(3)):
        eps[p] = np.linalg.det(np.eye(3)[list(p)])
    return eps


_LEVI_CIVITA = _levi_civita()


def _null_basis_4(na: torch.Tensor, nb: torch.Tensor) -> torch.Tensor:
    """(..., 5, 2) x (..., 5, 2) -> (..., 4, 3, 3): E1..E4, a basis of the
    constraint null space (eigenvectors of the 4 smallest eigenvalues)."""
    A = _epipolar_rows(na, nb)                       # (..., 5, 9)
    M = A.transpose(-1, -2) @ A
    _, vecs = eigh_or_nan(M)                         # ascending eigenvalues
    return vecs[..., :, :4].transpose(-1, -2).reshape(
        vecs.shape[:-2] + (4, 3, 3))


def _constraint_tensor(Eb: torch.Tensor) -> torch.Tensor:
    """(..., 4, 3, 3) basis -> (..., 10 eq, 10 xy-monomial, 4 z-power)
    coefficient tensor of the cubic constraint system: det(E), then
    2 (E E^T E)_ij - tr(E E^T) E_ij for i, j in row-major order."""
    dev = Eb.device
    eps = constant(_LEVI_CIVITA.reshape(-1), dev).reshape(3, 3, 3)
    det = torch.einsum("pqr,...ap,...bq,...cr->...abc", eps, Eb[..., 0, :],
                       Eb[..., 1, :], Eb[..., 2, :])
    P = torch.einsum("...aik,...bjk->...abij", Eb, Eb)       # E E^T
    Q = torch.einsum("...abik,...ckj->...abcij", P, Eb)      # E E^T E
    trP = torch.diagonal(P, dim1=-2, dim2=-1).sum(dim=-1)    # (..., 4, 4)
    eq = 2.0 * Q - trP[..., :, :, None, None, None] * Eb[..., None, None, :, :, :]
    lead = Eb.shape[:-3]
    eqs = torch.cat([det.reshape(lead + (1, 64)),
                     eq.reshape(lead + (64, 9)).transpose(-1, -2)], dim=-2)
    C = eqs @ constant(_TRIPLE_TO_MONOMIAL.reshape(-1), dev).reshape(64, 40)
    return C.reshape(lead + (10, 10, 4))


def _detA_signs(C: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Row-normalized det A(z) for (..., G) values of z -> (..., G)."""
    zp = torch.stack([torch.ones_like(z), z, z * z, z * z * z], -1)  # (..., G, 4)
    A = torch.einsum("...ijc,...gc->...gij", C, zp)                # (..., G, 10, 10)
    # Positive row scaling keeps the determinant's sign and tames the
    # z^3-per-row growth that would overflow float32.
    norm = torch.linalg.vector_norm(A, dim=-1, keepdim=True)
    return torch.linalg.det(A / torch.clamp_min(norm, _EPS))


_GRID = 128
_MAX_ROOTS = 10
_BISECT = 40


def _z_grid() -> np.ndarray:
    theta = np.linspace(-math.pi / 2 + 0.02, math.pi / 2 - 0.02, _GRID,
                        dtype=np.float32)
    return np.tan(theta)


_Z_GRID = _z_grid()


def fit_essential_5pt(na: torch.Tensor, nb: torch.Tensor):
    """Minimal 5-point solver: (..., 5, 2) x (..., 5, 2) normalized
    correspondences -> ((..., 10, 3, 3) essential candidates, (..., 10)
    validity mask)."""
    Eb = _null_basis_4(na, nb)
    C = _constraint_tensor(Eb)
    lead = Eb.shape[:-3]

    zg = constant(_Z_GRID, na.device)
    s = _detA_signs(C, zg.expand(lead + (_GRID,)))

    flips = s[..., :-1] * s[..., 1:] < 0                       # (..., G-1)
    # Up to _MAX_ROOTS bracketing intervals, earliest first.
    order = -torch.arange(_GRID - 1, dtype=torch.float32, device=na.device)
    top, idx = top_k_stable(torch.where(flips, order, float("-inf")),
                            _MAX_ROOTS)
    has_root = torch.isfinite(top)
    lo = zg[idx]
    hi = zg[torch.clamp_max(idx + 1, _GRID - 1)]
    s_lo = torch.gather(s, -1, idx)

    for _ in range(_BISECT):
        mid = 0.5 * (lo + hi)
        left = s_lo * _detA_signs(C, mid) > 0     # root is in the right half
        lo = torch.where(left, mid, lo)
        hi = torch.where(left, hi, mid)
    roots = 0.5 * (lo + hi)                                    # (..., 10)

    # Null vector of A(z*) -> monomial vector -> (x, y).
    zp = torch.stack([torch.ones_like(roots), roots, roots * roots,
                      roots * roots * roots], -1)
    A = torch.einsum("...ijc,...rc->...rij", C, zp)            # (..., 10, 10, 10)
    _, vecs = eigh_or_nan(A.transpose(-1, -2) @ A)
    m = vecs[..., 0]                                           # (..., 10, 10)
    w0 = m[..., 9]                                             # coefficient of "1"
    ok = has_root & (w0.abs() > 1e-8 * torch.linalg.vector_norm(m, dim=-1))
    safe = torch.where(w0.abs() < _EPS, _EPS, w0)
    x = m[..., 7] / safe
    y = m[..., 8] / safe

    E1, E2, E3, E4 = (Eb[..., None, k, :, :] for k in range(4))
    E = (x[..., None, None] * E1 + y[..., None, None] * E2
         + roots[..., None, None] * E3 + E4)
    nrm = torch.linalg.matrix_norm(E)[..., None, None]
    return E / torch.clamp_min(nrm, _EPS), ok


def ransac_essential_5pt(noise: Noise, na: torch.Tensor, nb: torch.Tensor,
                         valid: torch.Tensor, cfg: RansacConfig,
                         focal: float = 1.0) -> TwoViewEstimate:
    """RANSAC with the minimal 5-point solver: every 5-set gives up to 10
    candidates, all `num_hypotheses x 10` are scored together, and the
    winner is refit on its inliers with the weighted 8-point."""
    cfg_norm = cfg.replace(inlier_threshold=cfg.inlier_threshold / focal)
    idx = sample_minimal_sets(noise, valid, cfg.num_hypotheses, 5)
    models, ok = fit_essential_5pt(na[idx], nb[idx])          # (H, 10, 3, 3)
    models = models.reshape(-1, 3, 3)
    ok = ok.reshape(-1)

    errors = sampson_error(models, na, nb)                    # (H * 10, N)
    thresh2 = cfg_norm.inlier_threshold ** 2
    inlier_mask = (errors < thresh2) & valid[None, :] & ok[:, None]
    counts = inlier_mask.sum(dim=-1)
    err_sum = torch.where(inlier_mask, errors, 0.0).sum(dim=-1)
    order = counts.to(torch.float32) - err_sum / (err_sum.max() + 1.0)
    best = torch.argmax(order)

    model = _take(models, best)
    inliers = _take(inlier_mask, best)
    num_inliers = _take(counts, best)

    if cfg.refit:
        refit_model = fit_fundamental_8pt(na, nb, inliers.to(na.dtype),
                                          essential=True)
        refit_inliers = (sampson_error(refit_model, na, nb) < thresh2) & valid
        refit_count = refit_inliers.sum()
        better = refit_count >= num_inliers
        model = torch.where(better, refit_model, model)
        inliers = torch.where(better, refit_inliers, inliers)
        num_inliers = torch.where(better, refit_count, num_inliers)

    return TwoViewEstimate(
        model=model, inliers=inliers,
        num_inliers=num_inliers.to(torch.int32),
        success=num_inliers >= cfg.min_inliers,
    )


_W90 = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])


def decompose_essential(E: torch.Tensor, na: torch.Tensor, nb: torch.Tensor,
                        weights: torch.Tensor):
    """Recover the camera-B-from-camera-A pose (R, t) from E by cheirality:
    the four (R, t) candidates triangulate every weighted correspondence,
    and the one with most points in front of both cameras wins.

    Returns (R (3, 3), t (3,), num_good int32); |t| = 1."""
    U, _, Vt = svd_or_nan(E)
    # Ensure proper rotations.
    U = U * torch.sign(torch.linalg.det(U))
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    W = constant(_W90.reshape(-1), E.device).reshape(3, 3).to(E.dtype)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]

    Rs = torch.stack([R1, R1, R2, R2])             # (4, 3, 3)
    ts = torch.stack([t, -t, t, -t])               # (4, 3)
    counts = count_in_front(Rs, ts, na, nb, weights)
    best = torch.argmax(counts)
    return _take(Rs, best), _take(ts, best), _take(counts, best).to(torch.int32)


def relative_pose_from_essential(E, na, nb, weights):
    """(R, t) as a 6-dof se(3) tangent (camera-B-from-camera-A)."""
    R, t, n = decompose_essential(E, na, nb, weights)
    return lie.se3_log(R, t), n


def _tangent_basis(t: torch.Tensor) -> torch.Tensor:
    """(3, 2) orthonormal basis of the plane orthogonal to unit vector t."""
    k = torch.argmin(t.abs())
    e = (torch.arange(3, device=t.device) == k).to(t.dtype)
    b1 = torch.linalg.cross(t, e)
    b1 = b1 / torch.clamp_min(torch.linalg.vector_norm(b1), _EPS)
    b2 = torch.linalg.cross(t, b1)
    return torch.stack([b1, b2], dim=-1)


def _sampson_residuals(E, na, nb):
    """Signed first-order geometric residuals (N,)."""
    na_h = torch.cat([na, torch.ones_like(na[..., :1])], -1)
    nb_h = torch.cat([nb, torch.ones_like(nb[..., :1])], -1)
    Ea = na_h @ E.T
    Etb = nb_h @ E
    num = (nb_h * Ea).sum(dim=-1)
    den = Ea[..., 0] ** 2 + Ea[..., 1] ** 2 + Etb[..., 0] ** 2 + Etb[..., 1] ** 2
    return num / torch.sqrt(torch.clamp_min(den, _EPS))


def refine_relative_pose(R0: torch.Tensor, t0: torch.Tensor,
                         na: torch.Tensor, nb: torch.Tensor,
                         weights: torch.Tensor, iters: int = 10,
                         damping: float = 1e-8):
    """Gauss-Newton refinement of (R, t) on weighted Sampson error: 3
    rotation + 2 translation-direction parameters, a fixed number of steps,
    Jacobians by `torch.func.jacfwd` over the 5-vector, each step kept only
    if it lowers the cost (`torch.where`, no host branch)."""
    sw = torch.sqrt(torch.clamp_min(weights, 0.0))
    eye5 = torch.eye(5, dtype=R0.dtype, device=R0.device)

    def residuals(params, R_base, t_base, B):
        R = lie.so3_exp(params[:3]) @ R_base
        t = t_base + B @ params[3:]
        t = t / torch.clamp_min(torch.linalg.vector_norm(t), _EPS)
        return _sampson_residuals(lie.hat(t) @ R, na, nb) * sw

    R, t = R0, t0
    zero = torch.zeros((5,), dtype=R0.dtype, device=R0.device)
    for _ in range(iters):
        B = _tangent_basis(t)
        r = residuals(zero, R, t, B)
        J = torch.func.jacfwd(residuals)(zero, R, t, B)        # (N, 5)
        H = J.T @ J + damping * eye5
        delta = -torch.linalg.solve_ex(H, J.T @ r)[0]
        R_new = lie.so3_exp(delta[:3]) @ R
        t_new = t + B @ delta[3:]
        t_new = t_new / torch.clamp_min(torch.linalg.vector_norm(t_new), _EPS)
        r_new = residuals(zero, R_new, t_new, _tangent_basis(t_new))
        better = (r_new ** 2).sum() < (r ** 2).sum()
        R = torch.where(better, R_new, R)
        t = torch.where(better, t_new, t)
    return R, t


def estimate_relative_pose(noise: Noise, na: torch.Tensor, nb: torch.Tensor,
                           valid: torch.Tensor, cfg: RansacConfig,
                           focal: float = 1.0, refine_iters: int = 10):
    """RANSAC essential -> cheirality decomposition -> Gauss-Newton polish.

    The RANSAC stage uses `cfg.essential_solver`: "5pt" (minimal, default)
    or "8pt" (linear). Returns (R, t, TwoViewEstimate) with (R, t) the
    camera-B-from-camera-A pose, |t| = 1."""
    if cfg.essential_solver == "5pt":
        est = ransac_essential_5pt(noise, na, nb, valid, cfg, focal=focal)
    elif cfg.essential_solver == "8pt":
        est = ransac_essential(noise, na, nb, valid, cfg, focal=focal)
    else:
        raise ValueError(f"unknown essential solver {cfg.essential_solver!r}")
    w = est.inliers.to(na.dtype)
    R0, t0, _ = decompose_essential(est.model, na, nb, w)
    R, t = refine_relative_pose(R0, t0, na, nb, w, iters=refine_iters)
    return R, t, est
