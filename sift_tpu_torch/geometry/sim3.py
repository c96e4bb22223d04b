"""Sim(3) Lie group operations, rotation + translation + scale
(counterpart of `sift_tpu/geometry/sim3.py`; formulas follow the Sophus
library's Sim(3)).

Tangent layout: xi = (omega (3), v (3), sigma (1)); the first six match
`lie.py`'s se(3) layout, and sigma = 0 reduces every map to its SE(3)
counterpart. Group action: x -> s R x + t; composition
(s1,R1,t1) o (s2,R2,t2) = (s1 s2, R1 R2, s1 R1 t2 + t1). Branch-free and
batched over leading axes, like `lie.py`.
"""

from __future__ import annotations

import torch

from sift_tpu_torch.geometry import lie
from sift_tpu_torch.utils.linalg import svd_or_nan

_EPS = 1e-6


def _calc_w(omega: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """The Sim(3) 'W' matrix: exp translation = W v (Sophus calc_W), with
    small-theta / small-sigma Taylor fallbacks in every branch."""
    theta2 = (omega * omega).sum(dim=-1)
    theta = torch.sqrt(torch.clamp_min(theta2, _EPS * _EPS))
    s = torch.exp(sigma)

    small_t = theta2 < _EPS
    small_s = sigma.abs() < _EPS
    sig = torch.where(small_s, 1.0, sigma)
    th = torch.where(small_t, 1.0, theta)
    th2 = th * th

    # sigma ~ 0 branch
    A_s0 = torch.where(small_t, 0.5 - theta2 / 24.0, (1.0 - torch.cos(th)) / th2)
    B_s0 = torch.where(small_t, 1.0 / 6.0 - theta2 / 120.0,
                       (th - torch.sin(th)) / (th2 * th))
    C_s0 = torch.ones_like(sigma)

    # generic sigma
    C_g = (s - 1.0) / sig
    # theta ~ 0 sub-branch
    A_t0 = ((sig - 1.0) * s + 1.0) / (sig * sig)
    B_t0 = ((0.5 * sig * sig - sig + 1.0) * s - 1.0) / (sig * sig * sig)
    # generic theta
    a = s * torch.sin(th)
    b = s * torch.cos(th)
    c = th2 + sig * sig
    A_g = (a * sig + (1.0 - b) * th) / (th * c)
    B_g = (C_g - ((b - 1.0) * sig + a * th) / c) / th2

    A = torch.where(small_s, A_s0, torch.where(small_t, A_t0, A_g))
    B = torch.where(small_s, B_s0, torch.where(small_t, B_t0, B_g))
    C = torch.where(small_s, C_s0, C_g)

    W = lie.hat(omega)
    W2 = W @ W
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(W.shape)
    return (C[..., None, None] * eye + A[..., None, None] * W
            + B[..., None, None] * W2)


def sim3_exp(xi: torch.Tensor):
    """(..., 7) tangent -> (s (...,), R (..., 3, 3), t (..., 3))."""
    omega, v, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    s = torch.exp(sigma)
    R = lie.so3_exp(omega)
    t = (_calc_w(omega, sigma) @ v[..., None])[..., 0]
    return s, R, t


def sim3_log(s: torch.Tensor, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(s, R, t) -> (..., 7) tangent."""
    sigma = torch.log(s)
    omega = lie.so3_log(R)
    W = _calc_w(omega, sigma)
    v = torch.linalg.solve_ex(W, t[..., None])[0][..., 0]
    return torch.cat([omega, v, sigma[..., None]], dim=-1)


def sim3_inverse(s, R, t):
    Rt = R.transpose(-1, -2)
    inv_s = 1.0 / s
    return inv_s, Rt, -(inv_s[..., None] * (Rt @ t[..., None])[..., 0])


def sim3_compose(sa, Ra, ta, sb, Rb, tb):
    return (sa * sb, Ra @ Rb,
            sa[..., None] * (Ra @ tb[..., None])[..., 0] + ta)


def sim3_transform(s, R, t, x):
    """Apply the similarity to points x (..., 3): s R x + t."""
    return s[..., None] * (R @ x[..., None])[..., 0] + t


def boxplus(xi: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Right-perturbation retraction on Sim(3)."""
    s1, R1, t1 = sim3_exp(xi)
    s2, R2, t2 = sim3_exp(delta)
    return sim3_log(*sim3_compose(s1, R1, t1, s2, R2, t2))


def from_se3(xi6: torch.Tensor) -> torch.Tensor:
    """se(3) tangent -> Sim(3) tangent with sigma = 0 (exact: the Sim(3)
    exponential at sigma = 0 is the SE(3) one)."""
    return torch.cat([xi6, torch.zeros_like(xi6[..., :1])], dim=-1)


def umeyama_alignment(src: torch.Tensor, dst: torch.Tensor,
                      weights: torch.Tensor):
    """Weighted Umeyama: similarity (s, R, t) minimizing
    sum w |s R src + t - dst|^2. src/dst (N, 3); weights (N,) >= 0."""
    w = torch.clamp_min(weights, 0.0)
    wsum = torch.clamp_min(w.sum(), _EPS)
    mu_s = (w[:, None] * src).sum(dim=0) / wsum
    mu_d = (w[:, None] * dst).sum(dim=0) / wsum
    sc = src - mu_s
    dc = dst - mu_d
    cov = (dc * w[:, None]).T @ sc / wsum                # (3, 3)
    U, D, Vt = svd_or_nan(cov)
    sgn = torch.sign(torch.linalg.det(U) * torch.linalg.det(Vt))
    diag = torch.stack([torch.ones_like(sgn), torch.ones_like(sgn), sgn])
    R = U @ (diag[:, None] * Vt)
    var_s = (w[:, None] * sc * sc).sum() / wsum
    s = (D * diag).sum() / torch.clamp_min(var_s, _EPS)
    t = mu_d - s * (R @ mu_s)
    return s, R, t
