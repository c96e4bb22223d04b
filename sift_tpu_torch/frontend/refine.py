"""Sub-pixel keypoint refinement with contrast and edge filtering
(counterpart of `sift_tpu/frontend/refine.py`, lowe mode).

Candidates of all images of a batch are refined together: one (L, 16, 16)
DoG patch per candidate is gathered once (kernel 1, the DoG levels as
channels and the images as the level axis), the five-step Taylor walk runs
on the patches (kernel 2), and the final cube gives the offset, contrast,
edge and scale.
"""

from __future__ import annotations

import torch

from sift_tpu_torch.config import SiftConfig
from sift_tpu_torch.kernels.cuda import refine as walk_kernel
from sift_tpu_torch.kernels.cuda import windows as window_kernel
from sift_tpu_torch.kernels.derivatives import (scale_space_gradient_hessian,
                                                solve3x3)

__all__ = ["solve3x3", "refine_octave_lowe", "PATCH_R", "PATCH_D"]

PATCH_R = 8                # local-patch radius: 16x16 covers five +-1 steps
PATCH_D = 2 * PATCH_R


def _gather_local_patches(dogs: torch.Tensor, y0: torch.Tensor,
                          x0: torch.Tensor) -> torch.Tensor:
    """dogs (B, L, H, W); y0, x0 (B, K) top-left corners -> (B*K, L, 16, 16).
    Pixels past the image edge read 0."""
    B, L, H, W = dogs.shape
    K = y0.shape[1]
    gl = torch.arange(B, dtype=torch.int32, device=dogs.device
                      ).repeat_interleave(K)
    return window_kernel.gather_windows(
        dogs.transpose(0, 1), gl, y0.reshape(-1).contiguous(),
        x0.reshape(-1).contiguous(), PATCH_D)


def refine_octave_lowe(dogs: torch.Tensor, cand: dict, cfg: SiftConfig,
                       dog_sigmas, octave: int, octave_factor: float) -> dict:
    """dogs: (B, L, H, W); cand fields (B, K). Returns cand with refined
    x, y, level, scale and filtered valid."""
    B, L, H, W = dogs.shape
    K = cand["x"].shape[1]
    xi0 = cand["x"].to(torch.int32)
    yi0 = cand["y"].to(torch.int32)
    li0 = cand["level"]
    y0 = torch.clamp(yi0 - PATCH_R, 0, max(H - PATCH_D, 0))
    x0 = torch.clamp(xi0 - PATCH_R, 0, max(W - PATCH_D, 0))
    patches = _gather_local_patches(dogs, y0, x0)
    start = torch.stack([xi0 - x0, yi0 - y0, li0, 1 - x0, (W - 2) - x0,
                         1 - y0, (H - 2) - y0, torch.zeros_like(x0)],
                        dim=-1).reshape(B * K, 8).to(torch.int32).contiguous()
    cube, walk = walk_kernel.refine_walk(patches, start)
    walk = walk.reshape(B, K, 4)
    li = walk[..., 2]
    xi = x0 + walk[..., 0]
    yi = y0 + walk[..., 1]
    converged = walk[..., 3] > 0

    grad, hess = scale_space_gradient_hessian(cube.reshape(B, K, 3, 3, 3))
    d_center = cube.reshape(B, K, 27)[..., 13]
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

    sig_table = torch.tensor(dog_sigmas[octave], dtype=torch.float32,
                             device=dogs.device)
    k = torch.tensor(cfg.k, dtype=torch.float32, device=dogs.device)
    scale = (sig_table[li.long()] * torch.pow(k, off[..., 2])
             * torch.tensor(octave_factor ** octave, dtype=torch.float32,
                            device=dogs.device))
    out = dict(cand)
    out["x"] = xi.to(torch.float32) + off[..., 0]
    out["y"] = yi.to(torch.float32) + off[..., 1]
    out["level"] = li
    out["scale"] = scale
    out["valid"] = cand["valid"] & contrast_ok & edge_ok & in_range
    return out
