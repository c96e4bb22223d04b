"""Refinement walk: hand CUDA kernel (`csrc/refine.cu`) and its plain version.

Replaces the TPU kernel `sift_tpu/kernels/pallas/refine.py::
refine_walk_pallas`, together with the d=16 use of `gather_windows_pallas`
that fed it. Per keypoint, its (L, 16, 16) DoG patch is cut at the corner
(x0, y0) = clamp(position - 8, 0, size - 16), five steps of the Lowe Taylor
walk run on it, and the 27-value cube at the final position is read. The
walk follows the XLA branch of `sift_tpu/frontend/refine.py`
(`refine_octave_lowe`, lines 241-271) with the same IEEE f32 operations;
the kernel repeats them without fused multiply-adds, so positions, level,
convergence and cube are bit-identical. The kernel reads the DoG stack
itself and stages each patch in shared memory; no patch tensor is made.

On a CUDA tensor `refine_walk` launches the kernel (or raises); on a CPU
tensor it runs `refine_walk_plain`. `refine_walk_patches_plain` is the
same walk on patches already cut out (what the JAX walk kernel takes).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from sift_tpu_torch.kernels import build
from sift_tpu_torch.kernels.derivatives import (scale_space_gradient_hessian,
                                                solve3x3)

D = 16                  # patch side: 16x16 covers five +-1 steps and a tap
R = D // 2
N_ITERS = 5
LAUNCHES = 0


def patch_corners(x: torch.Tensor, y: torch.Tensor, H: int, W: int):
    """Integer positions and patch corners of pixel positions x, y >= 0:
    (xi, yi, x0, y0), with x0 = clamp(xi - 8, 0, max(W - 16, 0))."""
    xi = x.to(torch.int32)
    yi = y.to(torch.int32)
    x0 = torch.clamp(xi - R, 0, max(W - D, 0))
    y0 = torch.clamp(yi - R, 0, max(H - D, 0))
    return xi, yi, x0, y0


def _cells(li, ly, lx):
    """Level (K, 3, 1, 1) and flat patch cell (K, 1, 3, 3) of the 27 taps
    around patch-local (li, ly, lx), and whether each cell lies in [0, 256)
    (K, 3, 3, 3). A tap outside reads 0; one inside reads cell (c >> 4,
    c & 15), so column -1 or 16 wraps to the neighbouring row, as the JAX
    walk's flat one-hot lookup does (the padding slots of the candidate
    buffer, at level 1 on image row 0, reach it)."""
    t = torch.arange(-1, 2, device=li.device)
    s = (li[:, None] + t)[:, :, None, None]
    cell = ((ly[:, None] + t)[:, None, :, None] * D
            + (lx[:, None] + t)[:, None, None, :])
    inside = ((cell >= 0) & (cell < D * D)).expand(li.shape[0], 3, 3, 3)
    return s, torch.where(inside[:, :1], cell, 0), inside


def _walk(lookup, lx, ly, li, lxmin, lxmax, lymin, lymax, L: int):
    """The five-step walk from patch-local (lx, ly, li); `lookup(li, ly,
    lx)` gives the (K, 27) taps. Returns (cube, lx, ly, li, converged)."""
    K = lx.shape[0]
    converged = torch.zeros(K, dtype=torch.bool, device=lx.device)
    for _ in range(N_ITERS):
        grad, hess = scale_space_gradient_hessian(
            lookup(li, ly, lx).reshape(K, 3, 3, 3))
        off, solvable = solve3x3(hess, -grad)
        off = torch.where(solvable[:, None], off, torch.zeros_like(off))
        small = (off.abs() < 0.5).all(dim=-1)
        move = ~converged & ~small
        step = torch.where(move[:, None],
                           torch.round(off).clamp(-1, 1).to(torch.int32), 0)
        lx = torch.clamp(lx + step[:, 0], lxmin, lxmax)
        ly = torch.clamp(ly + step[:, 1], lymin, lymax)
        li = torch.clamp(li + step[:, 2], 1, L - 2)
        converged = converged | small
    return lookup(li, ly, lx), lx, ly, li, converged


def refine_walk_patches_plain(patches: torch.Tensor, start: torch.Tensor):
    """The walk on cut-out patches. patches: (K, L, 16, 16) f32; start:
    (K, 8) int32 rows (lx, ly, li, lxmin, lxmax, lymin, lymax, unused),
    patch-local. Returns cube (K, 27) f32 and walk (K, 4) int32 rows (lx,
    ly, li, converged), patch-local."""
    K, L = patches.shape[:2]
    flat = patches.reshape(K, L * D * D)

    def lookup(li, ly, lx):
        s, cell, inside = _cells(li, ly, lx)
        idx = (s * (D * D) + cell).reshape(K, 27)
        vals = torch.gather(flat, 1, idx.long())
        return torch.where(inside.reshape(K, 27), vals, torch.zeros_like(vals))

    cube, lx, ly, li, converged = _walk(
        lookup, start[:, 0], start[:, 1], start[:, 2], start[:, 3],
        start[:, 4], start[:, 5], start[:, 6], L)
    walk = torch.stack([lx, ly, li, converged.to(torch.int32)], dim=1)
    return cube, walk.to(torch.int32)


def refine_walk_plain(dogs: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                      level: torch.Tensor):
    """dogs: (B, L, H, W) f32; x, y: (B, K) f32 pixel positions (>= 0);
    level: (B, K) int32 in [1, L-2]. Returns cube (B, K, 27) f32 in (s, dy,
    dx) order and walk (B, K, 4) int32 rows (x, y, level, converged) in
    image coordinates. Taps are read from the zero-padded DoG stack by the
    patch's flat-cell rule (`_cells`); patch pixels past the image's bottom
    or right edge read 0."""
    B, L, H, W = dogs.shape
    K = x.shape[1]
    xi, yi, x0, y0 = (t.reshape(B * K) for t in patch_corners(x, y, H, W))
    Hp, Wp = H + D, W + D
    flat = F.pad(dogs, (0, D, 0, D)).reshape(-1)
    img = torch.arange(B, device=dogs.device).repeat_interleave(K)
    base = ((img * L) * Hp + y0.long()) * Wp + x0.long()

    def lookup(li, ly, lx):
        s, cell, inside = _cells(li, ly, lx)
        idx = (base[:, None, None, None] + s.long() * (Hp * Wp)
               + (cell // D) * Wp + cell % D)
        vals = flat[idx.reshape(B * K, 27)]
        return torch.where(inside.reshape(B * K, 27), vals,
                           torch.zeros_like(vals))

    cube, lx, ly, li, converged = _walk(
        lookup, xi - x0, yi - y0, level.reshape(B * K), 1 - x0, (W - 2) - x0,
        1 - y0, (H - 2) - y0, L)
    walk = torch.stack([x0 + lx, y0 + ly, li, converged.to(torch.int32)],
                       dim=1).to(torch.int32)
    return cube.reshape(B, K, 27), walk.reshape(B, K, 4)


@functools.cache
def _fn():
    fn = build.library("refine").sift_refine_walk
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, i, i, i, i, i, p, p, p]
    fn.restype = i
    return fn


def refine_walk(dogs: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                level: torch.Tensor):
    """See `refine_walk_plain`."""
    if not dogs.is_cuda:
        return refine_walk_plain(dogs, x, y, level)
    global LAUNCHES
    if (dogs.dim() != 4 or dogs.dtype != torch.float32
            or not dogs.is_contiguous()):
        raise ValueError("refine_walk: dogs must be a contiguous (B, L, H, W) "
                         "float32 tensor")
    B, L, H, W = dogs.shape
    if L < 3:
        raise ValueError(f"refine_walk: needs L >= 3 levels, got {L}")
    K = x.shape[-1]
    for name, t, dtype in (("x", x, torch.float32), ("y", y, torch.float32),
                           ("level", level, torch.int32)):
        if (t.device != dogs.device or t.dtype != dtype or t.shape != (B, K)
                or not t.is_contiguous()):
            raise ValueError(f"refine_walk: {name} must be a contiguous "
                             f"({B}, {K}) {dtype} tensor on {dogs.device}")
    cube = torch.empty((B, K, 27), dtype=torch.float32, device=dogs.device)
    walk = torch.empty((B, K, 4), dtype=torch.int32, device=dogs.device)
    if B * K == 0:
        return cube, walk
    rc = _fn()(dogs.data_ptr(), x.data_ptr(), y.data_ptr(), level.data_ptr(),
               B * K, K, L, H, W, cube.data_ptr(), walk.data_ptr(),
               torch.cuda.current_stream(dogs.device).cuda_stream)
    build.check(rc, "refine_walk")
    LAUNCHES += 1
    return cube, walk
