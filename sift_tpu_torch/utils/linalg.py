"""Dense linear algebra that gives NaN where the JAX package's does, and
never raises.

`torch.linalg.eigh`, `svd`, `inv` and `solve` raise on a matrix whose
factorization fails: on non-finite input (every one of them), and on a
singular one (`inv`, `solve`). The JAX package's counterparts return NaN
(or inf) there, so a degenerate RANSAC hypothesis or an empty batch
element is rejected downstream instead of ending the run. Each wrapper
replaces the non-finite batch elements by the identity, calls the solver
(the `_ex` form where one exists, which reads no error code), and sets
those elements' outputs, and the singular ones', to NaN. A finite,
regular element goes through the same call as before, so its output is
unchanged bit for bit.

`eigh` and `svd` have no `_ex` form: on the card each call still reads
its error code on the host (one sync).
"""

from __future__ import annotations

import torch


def _finite(A: torch.Tensor) -> torch.Tensor:
    """(..., m, n) -> (...,) True where the whole matrix is finite."""
    return torch.isfinite(A).all(dim=-1).all(dim=-1)


def _safe(A: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    eye = torch.eye(A.shape[-2], A.shape[-1], dtype=A.dtype, device=A.device)
    return torch.where(ok[..., None, None], A, eye)


def eigh_or_nan(A: torch.Tensor):
    """`torch.linalg.eigh` (ascending eigenvalues, eigenvectors in
    columns); a non-finite matrix gives all-NaN outputs."""
    ok = _finite(A)
    vals, vecs = torch.linalg.eigh(_safe(A, ok))
    return (torch.where(ok[..., None], vals, float("nan")),
            torch.where(ok[..., None, None], vecs, float("nan")))


def svd_or_nan(A: torch.Tensor):
    """`torch.linalg.svd` (U, S, Vh); a non-finite matrix gives all-NaN
    outputs."""
    ok = _finite(A)
    U, S, Vh = torch.linalg.svd(_safe(A, ok))
    return (torch.where(ok[..., None, None], U, float("nan")),
            torch.where(ok[..., None], S, float("nan")),
            torch.where(ok[..., None, None], Vh, float("nan")))


def inv_or_nan(A: torch.Tensor) -> torch.Tensor:
    """Batched inverse; a non-finite or singular matrix gives all NaN."""
    ok = _finite(A)
    inv, info = torch.linalg.inv_ex(_safe(A, ok))
    return torch.where((ok & (info == 0))[..., None, None], inv,
                       float("nan"))


def solve_or_nan(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """`torch.linalg.solve(A, B)` for matrix right-hand sides (..., n, k);
    a non-finite or singular A gives an all-NaN solution."""
    ok = _finite(A)
    X, info = torch.linalg.solve_ex(_safe(A, ok), B)
    return torch.where((ok & (info == 0))[..., None, None], X, float("nan"))
