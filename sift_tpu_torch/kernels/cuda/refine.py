"""Refinement walk: hand CUDA kernel (`csrc/refine.cu`) and its plain version.

Replaces the TPU kernel `sift_tpu/kernels/pallas/refine.py::
refine_walk_pallas`. Per keypoint, five steps of the Lowe Taylor walk on
its (L, 16, 16) DoG patch, then the 27-value cube at the final position.
The plain walk follows the XLA branch of `sift_tpu/frontend/refine.py`
(`refine_octave_lowe`, lines 241-271) with the same IEEE f32 operations;
the kernel repeats them without fused multiply-adds, so positions, level,
convergence and cube are bit-identical. Bound on the H100 by bytes (the
walk is a few hundred flops per keypoint).

On a CUDA tensor `refine_walk` launches the kernel (or raises); on a CPU
tensor it runs `refine_walk_plain`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from sift_tpu_torch.kernels import build
from sift_tpu_torch.kernels.derivatives import (scale_space_gradient_hessian,
                                                solve3x3)

D = 16
N_ITERS = 5
LAUNCHES = 0


def _lookup(flat: torch.Tensor, li, ly, lx) -> torch.Tensor:
    """(K, 27) taps at patch-local (li, ly, lx) in (s, dy, dx) order.

    A tap is addressed by its flat in-level index (y*16 + x), and one
    outside [0, 256) reads 0, as the JAX walk's one-hot lookup does. Only
    the padding slots of the candidate buffer (at pixel (0, 0)) reach it."""
    K = flat.shape[0]
    t = torch.arange(-1, 2, device=flat.device)
    s = (li[:, None] + t)[:, :, None, None]
    cell = ((ly[:, None] + t)[:, None, :, None] * D
            + (lx[:, None] + t)[:, None, None, :])
    inside = ((cell >= 0) & (cell < D * D)).expand(K, 3, 3, 3)
    idx = torch.where(inside, s * (D * D) + cell, 0).reshape(K, 27)
    vals = torch.gather(flat, 1, idx.long())
    return torch.where(inside.reshape(K, 27), vals, torch.zeros_like(vals))


def refine_walk_plain(patches: torch.Tensor, start: torch.Tensor):
    """patches: (K, L, 16, 16) f32; start: (K, 8) int32 rows (lx, ly, li,
    lxmin, lxmax, lymin, lymax, unused). Returns cube (K, 27) f32 and walk
    (K, 4) int32 rows (lx, ly, li, converged)."""
    K, L = patches.shape[:2]
    flat = patches.reshape(K, L * D * D)
    lx, ly, li = start[:, 0], start[:, 1], start[:, 2]
    converged = torch.zeros(K, dtype=torch.bool, device=patches.device)
    for _ in range(N_ITERS):
        grad, hess = scale_space_gradient_hessian(
            _lookup(flat, li, ly, lx).reshape(K, 3, 3, 3))
        off, solvable = solve3x3(hess, -grad)
        off = torch.where(solvable[:, None], off, torch.zeros_like(off))
        small = (off.abs() < 0.5).all(dim=-1)
        move = ~converged & ~small
        step = torch.where(move[:, None],
                           torch.round(off).clamp(-1, 1).to(torch.int32), 0)
        lx = torch.clamp(lx + step[:, 0], start[:, 3], start[:, 4])
        ly = torch.clamp(ly + step[:, 1], start[:, 5], start[:, 6])
        li = torch.clamp(li + step[:, 2], 1, L - 2)
        converged = converged | small
    cube = _lookup(flat, li, ly, lx)
    walk = torch.stack([lx, ly, li, converged.to(torch.int32)], dim=1)
    return cube, walk.to(torch.int32)


@functools.cache
def _fn():
    fn = build.library("refine").sift_refine_walk
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, i, p, p, p]
    fn.restype = i
    return fn


def refine_walk(patches: torch.Tensor, start: torch.Tensor):
    """See `refine_walk_plain`."""
    if not patches.is_cuda:
        return refine_walk_plain(patches, start)
    global LAUNCHES
    K, L = patches.shape[:2]
    if (patches.dtype != torch.float32 or patches.shape[2:] != (D, D)
            or not patches.is_contiguous()):
        raise ValueError("refine_walk: patches must be contiguous "
                         "(K, L, 16, 16) float32")
    if L < 3:
        raise ValueError(f"refine_walk: needs L >= 3 levels, got {L}")
    if (start.device != patches.device or start.dtype != torch.int32
            or start.shape != (K, 8) or not start.is_contiguous()):
        raise ValueError("refine_walk: start must be a contiguous (K, 8) "
                         f"int32 tensor on {patches.device}")
    cube = torch.empty((K, 27), dtype=torch.float32, device=patches.device)
    walk = torch.empty((K, 4), dtype=torch.int32, device=patches.device)
    if K == 0:
        return cube, walk
    rc = _fn()(patches.data_ptr(), start.data_ptr(), K, L, cube.data_ptr(),
               walk.data_ptr(),
               torch.cuda.current_stream(patches.device).cuda_stream)
    build.check(rc, "refine_walk")
    LAUNCHES += 1
    return cube, walk
