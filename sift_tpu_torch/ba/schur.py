"""Matrix-free Schur complement and preconditioned CG (counterpart of
`sift_tpu/ba/schur.py`, single device).

The normal equations have the block structure

    [ U   W ] [dc]   [ -g_c ]
    [ W^T V ] [dl] = [ -g_l ]

with U block-diagonal over cameras (6x6), V block-diagonal over landmarks
(3x3) and W the camera-landmark coupling. Landmarks are eliminated:
S dc = b with S = U - W V^-1 W^T and b = -(g_c - W V^-1 g_l). S is applied
matrix-free by two sweeps over the observation list; each sweep is a
gather, a per-observation product and a segment sum (the JAX package's
`segment_sum`): an accumulating `index_put_` into zeros. On the card that
sorts the indices and sums each segment in a fixed order, with no float
atomics, so a solve is the same from run to run (`index_add_` would add
in whatever order its atomics land, and an ill-conditioned system, such
as map-scale BA after 50 CG steps, amplifies that into a different
trajectory). Masked observations point at slot 0 with zero weights, so no
case is special.

The block products are written as broadcast multiplies and sums over the
tiny axes, and the two matrix products (the dense Schur assembly, its
triangular solves) refuse TF32 on the card. Inverses and the Cholesky
factor use the `_ex` forms, which neither sync nor raise: a singular block
gives NaN, as the JAX package's does, and the solver's finite guards zero
the step.
"""

from __future__ import annotations

import dataclasses

import torch

from sift_tpu_torch.ba.residuals import linearize
from sift_tpu_torch.utils.device import check_f32_matmul
from sift_tpu_torch.utils.linalg import inv_or_nan


def _seg_sum(x: torch.Tensor, idx: torch.Tensor, num: int) -> torch.Tensor:
    out = torch.zeros((num,) + x.shape[1:], dtype=x.dtype, device=x.device)
    return out.index_put_((idx.long(),), x, accumulate=True)


def _bmv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product (..., m, n) x (..., n) -> (..., m)."""
    return (A * x[..., None, :]).sum(dim=-1)


def _btv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched transposed product (..., m, n)^T x (..., m) -> (..., n)."""
    return (A * x[..., :, None]).sum(dim=-2)


def _gram(A: torch.Tensor) -> torch.Tensor:
    """A^T A over the last two axes: (..., m, n) -> (..., n, n)."""
    return (A[..., :, :, None] * A[..., :, None, :]).sum(dim=-3)


@dataclasses.dataclass
class SchurSystem:
    """Linearized, damped BA system."""

    r: torch.Tensor        # (O, 2) sqrt-weighted residuals
    Jc: torch.Tensor       # (O, 2, 6)
    Jl: torch.Tensor       # (O, 2, 3)
    obs_cam: torch.Tensor  # (O,)
    obs_lm: torch.Tensor   # (O,)
    U: torch.Tensor        # (C, 6, 6) damped camera blocks
    V_inv: torch.Tensor    # (L, 3, 3) inverted damped landmark blocks
    g_cam: torch.Tensor    # (C, 6) J_c^T r
    g_lm: torch.Tensor     # (L, 3) J_l^T r


def _damp(B: torch.Tensor, damping) -> torch.Tensor:
    """Marquardt-style relative damping plus a small absolute floor: pure
    lambda*I leaves tiny-Jacobian blocks with condition ~|J^T J|/lambda,
    which overwhelms float32 inversion and emits NaN updates."""
    n = B.shape[-1]
    dv = torch.diagonal(B, dim1=-2, dim2=-1).sum(dim=-1)[:, None, None] / n
    eye = torch.eye(n, dtype=B.dtype, device=B.device)
    return B + (damping * (1.0 + dv) + 1e-6 * dv) * eye


def build_system(poses, intrinsics, landmarks, obs_cam, obs_lm, obs_uv,
                 obs_valid, huber_delta, damping, fixed_cam_mask: torch.Tensor,
                 loss: str = "huber") -> SchurSystem:
    """Linearize and assemble the damped block system. `fixed_cam_mask`
    (C,) bool: gauge-fixed cameras get zeroed Jacobian columns, so their
    blocks become pure damping and their updates vanish."""
    C = poses.shape[0]
    L = landmarks.shape[0]
    r, Jc, Jl, _ = linearize(poses, intrinsics, landmarks, obs_cam, obs_lm,
                             obs_uv, obs_valid, huber_delta, loss)
    free = 1.0 - fixed_cam_mask[obs_cam].to(Jc.dtype)
    Jc = Jc * free[:, None, None]

    U = _damp(_seg_sum(_gram(Jc), obs_cam, C), damping)
    g_cam = _seg_sum(_btv(Jc, r), obs_cam, C)
    g_lm = _seg_sum(_btv(Jl, r), obs_lm, L)
    V = _damp(_seg_sum(_gram(Jl), obs_lm, L), damping)
    return SchurSystem(r=r, Jc=Jc, Jl=Jl, obs_cam=obs_cam, obs_lm=obs_lm,
                       U=U, V_inv=inv_or_nan(V), g_cam=g_cam, g_lm=g_lm)


def _w_apply_t(sys: SchurSystem, x_cam: torch.Tensor) -> torch.Tensor:
    """W^T x: (C, 6) camera vector -> (L, 3) landmark vector."""
    t = _bmv(sys.Jc, x_cam[sys.obs_cam])                   # (O, 2)
    return _seg_sum(_btv(sys.Jl, t), sys.obs_lm, sys.V_inv.shape[0])


def _w_apply(sys: SchurSystem, z_lm: torch.Tensor) -> torch.Tensor:
    """W z: (L, 3) landmark vector -> (C, 6) camera vector."""
    t = _bmv(sys.Jl, z_lm[sys.obs_lm])                     # (O, 2)
    return _seg_sum(_btv(sys.Jc, t), sys.obs_cam, sys.U.shape[0])


def schur_matvec(sys: SchurSystem, x: torch.Tensor) -> torch.Tensor:
    """S x = (U - W V^-1 W^T) x, matrix-free. x: (C, 6)."""
    z = _bmv(sys.V_inv, _w_apply_t(sys, x))
    return _bmv(sys.U, x) - _w_apply(sys, z)


def schur_rhs(sys: SchurSystem) -> torch.Tensor:
    """b = -(g_c - W V^-1 g_l)."""
    return -(sys.g_cam - _w_apply(sys, _bmv(sys.V_inv, sys.g_lm)))


def back_substitute(sys: SchurSystem, dc: torch.Tensor) -> torch.Tensor:
    """dl = V^-1 (-g_l - W^T dc). dc: (C, 6) -> (L, 3)."""
    return _bmv(sys.V_inv, -sys.g_lm - _w_apply_t(sys, dc))


def dense_schur_solve(sys: SchurSystem, b: torch.Tensor) -> torch.Tensor:
    """Direct solve of the reduced camera system (window-BA path): the
    6C x 6C Schur complement is assembled from block-dense couplings W
    (C*L, 6, 3), keyed cam * L + lm, and solved by Cholesky. A matrix that
    is not positive definite gives a NaN step, as in the JAX package."""
    check_f32_matmul(b, "dense_schur_solve")
    C = sys.U.shape[0]
    L = sys.V_inv.shape[0]

    Wb = (sys.Jc[..., :, :, None] * sys.Jl[..., :, None, :]).sum(dim=-3)
    W = _seg_sum(Wb, sys.obs_cam * L + sys.obs_lm, C * L).reshape(C, L, 6, 3)
    T = (W[..., :, :, None] * sys.V_inv[None, :, None, :, :]).sum(dim=-2)

    # S = U - W V^-1 W^T, rows cam * 6 + i, columns cam * 6 + j.
    T2 = T.permute(0, 2, 1, 3).reshape(6 * C, 3 * L)
    W2 = W.permute(0, 2, 1, 3).reshape(6 * C, 3 * L)
    S = -(T2 @ W2.T)
    blocks = S.view(C, 6, C, 6)
    cams = torch.arange(C, device=S.device)
    blocks[cams, :, cams, :] += sys.U

    factor, info = torch.linalg.cholesky_ex(S)
    factor = torch.where(info == 0, factor, float("nan"))
    y = torch.linalg.solve_triangular(factor, b.reshape(-1, 1), upper=False)
    x = torch.linalg.solve_triangular(factor.T, y, upper=True)
    return x.reshape(C, 6)


def pcg(sys: SchurSystem, b: torch.Tensor, iters: int, tol: float,
        jacobi: bool = True):
    """Block-Jacobi preconditioned CG on the reduced camera system.

    The JAX package runs `lax.while_loop` while k < iters and
    |r|^2 > tol^2 |b|^2. Here all `iters` steps run, and once the residual
    test fails a mask freezes the state, so the result and the count of
    steps taken are the same with no host-side test. Preconditioner:
    inv(U_c), or the identity with `jacobi=False`. Returns (x, k)."""
    if jacobi:
        M_inv = inv_or_nan(sys.U)

        def precond(v):
            return _bmv(M_inv, v)
    else:
        def precond(v):
            return v

    def dot(a, c):
        return (a * c).sum()

    x = torch.zeros_like(b)
    r = b                       # since x0 = 0
    p = precond(r)
    rz = dot(r, p)
    threshold = tol * tol * torch.clamp_min(dot(b, b), 1e-30)
    k = torch.zeros((), dtype=torch.int32, device=b.device)
    for _ in range(iters):
        active = dot(r, r) > threshold
        Ap = schur_matvec(sys, p)
        alpha = rz / torch.clamp_min(dot(p, Ap), 1e-30)
        x_new = x + alpha * p
        r_new = r - alpha * Ap
        z = precond(r_new)
        rz_new = dot(r_new, z)
        beta = rz_new / torch.clamp_min(rz, 1e-30)
        p_new = z + beta * p
        x = torch.where(active, x_new, x)
        r = torch.where(active, r_new, r)
        p = torch.where(active, p_new, p)
        rz = torch.where(active, rz_new, rz)
        k = k + active.to(torch.int32)
    return x, k
