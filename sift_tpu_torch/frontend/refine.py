"""Keypoint refinement with contrast and edge filtering (counterpart of
`sift_tpu/frontend/refine.py`).

lowe: candidates of all images of a batch are refined together: the
five-step Taylor walk reads each candidate's (L, 16, 16) patch straight
from the DoG stack (one kernel per octave), and the final cube gives the
offset, contrast, edge and scale.

parity (the reference's `Sift::_eliminateEdgeResponses`): one 3x3x3 cube
per candidate and the parity stencils; the reference inverts -H and then
solves against the inverse, so its offset is x = (-H) g. A candidate is
dropped when -H is singular, when any offset component exceeds 127.5 (no
abs), when (g . x) * (0.5 + D) < 7.65 (a product where the paper adds),
or when the spatial Hessian fails det >= 0 and not tr^2/det > 12.1, with
IEEE semantics at det == 0. Keypoints are never moved.
"""

from __future__ import annotations

import torch

from sift_tpu_torch.config import SiftConfig
from sift_tpu_torch.kernels.cuda import refine as walk_kernel
from sift_tpu_torch.kernels.derivatives import (_det3,
                                                scale_space_gradient_hessian,
                                                solve3x3)
from sift_tpu_torch.utils.device import constant
from sift_tpu_torch.utils.lanewise import lanewise

__all__ = ["solve3x3", "refine_octave_lowe", "refine_octave_parity"]


def _gather_cubes(dogs: torch.Tensor, level, y, x) -> torch.Tensor:
    """(B, K, 3, 3, 3) [s, y, x] cubes around (level, y, x) of a (B, L, H, W)
    stack; starts clamped into the stack, as `lax.dynamic_slice` clamps
    them (padded slots sit at x = y = 0)."""
    B, L, H, W = dogs.shape
    s0 = (level.long() - 1).clamp(0, L - 3)
    y0 = (y.long() - 1).clamp(0, H - 3)
    x0 = (x.long() - 1).clamp(0, W - 3)
    tri = torch.arange(3, device=dogs.device)
    img = torch.arange(B, device=dogs.device)[:, None, None, None, None]
    ss = (s0[..., None, None, None] + tri[:, None, None])
    yy = (y0[..., None, None, None] + tri[None, :, None])
    xx = (x0[..., None, None, None] + tri[None, None, :])
    return dogs[img, ss, yy, xx]


def refine_octave_parity(dogs: torch.Tensor, cand: dict,
                         cfg: SiftConfig) -> dict:
    """dogs: (B, L, H, W); cand fields (B, K). Returns cand with the
    reference's filters applied to valid; positions and levels unchanged."""
    patches = _gather_cubes(dogs, cand["level"], cand["y"], cand["x"])
    grad, hess = scale_space_gradient_hessian(patches, parity=True)

    neg_h = -hess
    invertible = _det3(neg_h).abs() > 1e-12
    extremum = torch.stack([neg_h[..., i, 0] * grad[..., 0]
                            + neg_h[..., i, 1] * grad[..., 1]
                            + neg_h[..., i, 2] * grad[..., 2]
                            for i in range(3)], dim=-1)
    offset_ok = (extremum <= 127.5).all(dim=-1)
    fv = (grad[..., 0] * extremum[..., 0] + grad[..., 1] * extremum[..., 1]
          + grad[..., 2] * extremum[..., 2]) * (0.5 + patches[..., 1, 1, 1])
    contrast_ok = fv >= 7.65

    dxx, dyy, dxy = hess[..., 0, 0], hess[..., 1, 1], hess[..., 0, 1]
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    edge_ok = (det >= 0) & ~(tr * tr / det > (10.0 + 1.0) ** 2 / 10.0)

    out = dict(cand)
    out["valid"] = cand["valid"] & invertible & offset_ok & contrast_ok & edge_ok
    return out


def refine_octave_lowe(dogs: torch.Tensor, cand: dict, cfg: SiftConfig,
                       dog_sigmas, octave: int, octave_factor: float) -> dict:
    """dogs: (B, L, H, W); cand fields (B, K). Returns cand with refined
    x, y, level, scale and filtered valid."""
    cube, walk = walk_kernel.refine_walk(dogs, cand["x"], cand["y"],
                                         cand["level"])
    xi, yi, li = walk[..., 0], walk[..., 1], walk[..., 2]
    converged = walk[..., 3] > 0

    grad, hess = scale_space_gradient_hessian(cube.unflatten(-1, (3, 3, 3)))
    d_center = cube[..., 13]
    off, solvable = solve3x3(hess, -grad)

    d_hat = d_center + 0.5 * (grad * off).sum(dim=-1)
    contrast_ok = d_hat.abs() >= cfg.contrast_threshold * cfg.image_max
    dxx, dyy, dxy = hess[..., 0, 0], hess[..., 1, 1], hess[..., 0, 1]
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    r = cfg.edge_r
    edge_ok = (det > 0) & (tr * tr / torch.where(det > 0, det, torch.ones_like(det))
                           < (r + 1) ** 2 / r)
    in_range = (off.abs() < 0.6).all(dim=-1) & converged & solvable

    dev = dogs.device
    scale = (constant(dog_sigmas[octave], dev)[li.long()]
             * lanewise(torch.pow, constant(cfg.k, dev), off[..., 2])
             * constant(octave_factor ** octave, dev))
    out = dict(cand)
    out["x"] = xi.to(torch.float32) + off[..., 0]
    out["y"] = yi.to(torch.float32) + off[..., 1]
    out["level"] = li
    out["scale"] = scale
    out["valid"] = cand["valid"] & contrast_ok & edge_ok & in_range
    return out
