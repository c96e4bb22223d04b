"""Sub-pixel keypoint refinement with contrast and edge filtering
(counterpart of `sift_tpu/frontend/refine.py`, lowe mode).

Candidates of all images of a batch are refined together: the five-step
Taylor walk reads each candidate's (L, 16, 16) patch straight from the DoG
stack (one kernel per octave), and the final cube gives the offset,
contrast, edge and scale.
"""

from __future__ import annotations

import torch

from sift_tpu_torch.config import SiftConfig
from sift_tpu_torch.kernels.cuda import refine as walk_kernel
from sift_tpu_torch.kernels.derivatives import (scale_space_gradient_hessian,
                                                solve3x3)
from sift_tpu_torch.utils.device import constant

__all__ = ["solve3x3", "refine_octave_lowe"]


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
             * torch.pow(constant(cfg.k, dev), off[..., 2])
             * constant(octave_factor ** octave, dev))
    out = dict(cand)
    out["x"] = xi.to(torch.float32) + off[..., 0]
    out["y"] = yi.to(torch.float32) + off[..., 1]
    out["level"] = li
    out["scale"] = scale
    out["valid"] = cand["valid"] & contrast_ok & edge_ok & in_range
    return out
