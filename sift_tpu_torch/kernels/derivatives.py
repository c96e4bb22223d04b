"""Scale-space gradient and Hessian of (..., 3, 3, 3) DoG cubes [s, y, x].

Lowe-mode central differences (counterpart of the non-parity branch of
`sift_tpu/kernels/derivatives.py`). The operation order is kept term for
term: the refinement walk must take the same steps as the JAX package.
"""

from __future__ import annotations

import torch


def scale_space_gradient_hessian(p: torch.Tensor):
    """Returns (grad (..., 3), hess (..., 3, 3)), component order (x, y, s)."""
    c = p[..., 1, 1, 1]
    dx = (p[..., 1, 1, 2] - p[..., 1, 1, 0]) / 2.0
    dy = (p[..., 1, 2, 1] - p[..., 1, 0, 1]) / 2.0
    ds = (p[..., 2, 1, 1] - p[..., 0, 1, 1]) / 2.0
    grad = torch.stack([dx, dy, ds], dim=-1)

    dxx = p[..., 1, 1, 2] + p[..., 1, 1, 0] - 2.0 * c
    dyy = p[..., 1, 2, 1] + p[..., 1, 0, 1] - 2.0 * c
    dss = p[..., 2, 1, 1] + p[..., 0, 1, 1] - 2.0 * c
    dxy = (p[..., 1, 2, 2] - p[..., 1, 2, 0] - p[..., 1, 0, 2] + p[..., 1, 0, 0]) / 4.0
    dxs = (p[..., 2, 1, 2] - p[..., 2, 1, 0] - p[..., 0, 1, 2] + p[..., 0, 1, 0]) / 4.0
    dys = (p[..., 2, 2, 1] - p[..., 2, 0, 1] - p[..., 0, 2, 1] + p[..., 0, 0, 1]) / 4.0

    row0 = torch.stack([dxx, dxy, dxs], dim=-1)
    row1 = torch.stack([dxy, dyy, dys], dim=-1)
    row2 = torch.stack([dxs, dys, dss], dim=-1)
    return grad, torch.stack([row0, row1, row2], dim=-2)


def _det3(h):
    return (h[..., 0, 0] * (h[..., 1, 1] * h[..., 2, 2] - h[..., 1, 2] * h[..., 2, 1])
            - h[..., 0, 1] * (h[..., 1, 0] * h[..., 2, 2] - h[..., 1, 2] * h[..., 2, 0])
            + h[..., 0, 2] * (h[..., 1, 0] * h[..., 2, 1] - h[..., 1, 1] * h[..., 2, 0]))


def solve3x3(h: torch.Tensor, g: torch.Tensor, eps: float = 1e-12):
    """Batched 3x3 solve via the adjugate: returns (x, solvable_mask).

    The matrix-vector product is summed left to right, as the JAX walk
    and the CUDA walk do, so all three agree bit for bit."""
    det = _det3(h)
    adj = [
        [h[..., 1, 1] * h[..., 2, 2] - h[..., 1, 2] * h[..., 2, 1],
         h[..., 0, 2] * h[..., 2, 1] - h[..., 0, 1] * h[..., 2, 2],
         h[..., 0, 1] * h[..., 1, 2] - h[..., 0, 2] * h[..., 1, 1]],
        [h[..., 1, 2] * h[..., 2, 0] - h[..., 1, 0] * h[..., 2, 2],
         h[..., 0, 0] * h[..., 2, 2] - h[..., 0, 2] * h[..., 2, 0],
         h[..., 0, 2] * h[..., 1, 0] - h[..., 0, 0] * h[..., 1, 2]],
        [h[..., 1, 0] * h[..., 2, 1] - h[..., 1, 1] * h[..., 2, 0],
         h[..., 0, 1] * h[..., 2, 0] - h[..., 0, 0] * h[..., 2, 1],
         h[..., 0, 0] * h[..., 1, 1] - h[..., 0, 1] * h[..., 1, 0]],
    ]
    ok = det.abs() > eps
    safe_det = torch.where(ok, det, torch.ones_like(det))
    x = torch.stack([(a[0] * g[..., 0] + a[1] * g[..., 1] + a[2] * g[..., 2])
                     / safe_det for a in adj], dim=-1)
    return x, ok
