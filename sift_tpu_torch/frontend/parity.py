"""Parity-mode pipeline (counterpart of `sift_tpu/frontend/parity.py`): the
reference's `Sift::calculate`, quirks and order-dependent descriptor stage
included, for a (B, H, W) batch in one pass, as JAX's vmap of one program
runs it.

* Canonical keypoint order, per image: (octave, level, x, y) ascending,
  invalid slots last; slots with equal keys keep their detection order.
* Descriptor-stage pyramid mutation: each keypoint, in canonical order,
  ADDS its (NaN) orientation to the shared orientation pyramid's 16x16
  window and ADDS the top-left 16x16 corner of `blur(its Gaussian, 1.6)`
  to the magnitude pyramid's window, then builds its histograms from the
  mutated values; later overlapping keypoints see the writes. The ordered
  walk is one launch of the hand kernel `parity_scan` for the whole batch
  (`kernels/cuda/parity_scan.py`); the histograms are computed after it, for
  all keypoints at once. Nothing here reads to the host.
* Per-cell L1 normalization of 8-bin histograms folded `% 7`, NaN in bin
  0, cells in x-major order.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from sift_tpu_torch.config import SiftConfig
from sift_tpu_torch.frontend.extrema import detect_extrema_octave
from sift_tpu_torch.frontend.orientation import R, assign_orientation_parity
from sift_tpu_torch.frontend.pyramid import build_pyramid
from sift_tpu_torch.frontend.refine import refine_octave_parity
from sift_tpu_torch.kernels.cuda import parity_scan as scan_kernel
from sift_tpu_torch.kernels.gaussian import gaussian_blur
from sift_tpu_torch.kernels.gradients import gradient_magnitude_orientation
from sift_tpu_torch.kernels.histogram import weighted_histogram
from sift_tpu_torch.types import Keypoints
from sift_tpu_torch.utils.device import constant

# Field widths of the canonical sort key: x and y below 2^16, octave and
# level below 2^8.
_XY_BITS, _LVL_BITS = 16, 8


def _pad_to(arr: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Zero-pad the last two axes at the bottom and right to (h, w)."""
    return F.pad(arr, (0, w - arr.shape[-1], 0, h - arr.shape[-2]))


def _canonical_sort(kp: dict) -> dict:
    """(octave, level, x, y) ascending, invalid last, ties stable, along
    the last axis (each image of a (B, K) batch on its own): one int64
    key, most significant field first, and a stable sort."""
    key = (~kp["valid"]).long()
    for f, bits in (("octave", _LVL_BITS), ("level", _LVL_BITS),
                    ("x", _XY_BITS), ("y", _XY_BITS)):
        key = (key << bits) | kp[f].to(torch.int32).long()
    order = torch.sort(key, dim=-1, stable=True).indices
    return {k: torch.take_along_dim(v, order, dim=-1) for k, v in kp.items()}


def descriptor_scan_parity(kp: dict, maps: torch.Tensor,
                           gauss_stack: torch.Tensor, weight_tl: torch.Tensor,
                           shapes: np.ndarray):
    """Descriptor computation with pyramid mutation, for a batch.

    kp: (B, N) canonical-order buffers with `gauss_o`, `gauss_l`; maps: (B,
    O, Lg, 2, Hmax, Wmax) padded magnitude and orientation pyramids,
    MUTATED IN PLACE; gauss_stack: (B, O, Lg, Hmax, Wmax); weight_tl: (B,
    O, Lg, 16, 16); shapes: (O, 2) numpy (H_o, W_o). Returns (desc (B, N,
    128), ok (B, N)). Slots that fail `ok` write nothing and get a zero
    descriptor."""
    dev = maps.device
    B, N = kp["x"].shape
    win = 2 * R
    o, l = kp["gauss_o"].long(), kp["gauss_l"].long()
    xi, yi = kp["x"].to(torch.int32), kp["y"].to(torch.int32)
    h = constant(shapes[:, 0], dev, torch.int32)[o]
    w = constant(shapes[:, 1], dev, torch.int32)[o]
    # `>` form bounds test (sift.cpp:65-70): x in [R, W-R]
    ok = (xi >= R) & (xi <= w - R) & (yi >= R) & (yi <= h - R) & kp["valid"]
    y0 = (yi - R).clamp(0, maps.shape[-2] - win)
    x0 = (xi - R).clamp(0, maps.shape[-1] - win)

    table = torch.stack([o.to(torch.int32), l.to(torch.int32), y0, x0,
                         ok.to(torch.int32)], dim=-1)        # (B, N, 5)
    seen = scan_kernel.parity_scan(maps, weight_tl,
                                   kp["orientation"].contiguous(), table)

    ar = torch.arange(win, device=dev)
    img = torch.arange(B, device=dev)[:, None, None, None]
    gauss_win = gauss_stack[img, o[..., None, None], l[..., None, None],
                            (y0.long()[..., None] + ar)[..., :, None],
                            (x0.long()[..., None] + ar)[..., None, :]]

    def cells(a):        # [y, x] windows -> (B, N, cell = cx*4+cy, 16)
        return (a.reshape(B, N, 4, 4, 4, 4).permute(0, 1, 4, 2, 5, 3)
                .reshape(B, N, 16, 16))

    hist = weighted_histogram(cells(seen[:, :, 1]),
                              cells(seen[:, :, 0]) * cells(gauss_win), 8,
                              45.0, parity_fold=True)
    s = hist.sum(dim=-1, keepdim=True)
    hist = torch.where(s > 0, hist / torch.where(s > 0, s, torch.ones_like(s)),
                       hist)
    return hist.reshape(B, N, 128), ok


def extract_parity(imgs: torch.Tensor, cfg: SiftConfig) -> Keypoints:
    """The whole parity pipeline for a (B, H, W) float32 batch; every
    field gains a leading B, as under JAX's vmap."""
    scale = 2 if cfg.subpixel else 1
    if not 2 * R <= min(imgs.shape[-2:]) * scale <= \
            max(imgs.shape[-2:]) * scale < 1 << _XY_BITS:
        raise ValueError(f"parity mode takes images of {2 * R} to "
                         f"{(1 << _XY_BITS) - 1} px a side (after subpixel "
                         f"doubling), got {tuple(imgs.shape[-2:])}")
    dev = imgs.device
    B = imgs.shape[0]
    pyr = build_pyramid(imgs, cfg)
    O = pyr.num_octaves

    buffers = []
    dropped = torch.zeros((B,), dtype=torch.int32, device=dev)
    for o in range(O):
        x, y, lvl, score, valid, n_drop = detect_extrema_octave(
            pyr.dogs[o], cfg, o)                               # (B, K)
        dropped = dropped + n_drop
        cand = dict(x=x, y=y, level=lvl, score=score, valid=valid,
                    octave=torch.full_like(lvl, o),
                    scale=constant(pyr.dog_sigmas[o], dev)[lvl.long()])
        buffers.append(refine_octave_parity(pyr.dogs[o], cand, cfg))
    kp = {k: torch.cat([b[k] for b in buffers], dim=1) for k in buffers[0]}
    kp = _canonical_sort(kp)

    # Valid slots come first, so truncation to the output capacity drops
    # only padding unless more keypoints survive than it holds; each
    # image counts its own.
    N = cfg.max_keypoints
    if kp["x"].shape[1] > N:
        n_valid_all = kp["valid"].sum(dim=1, dtype=torch.int32)
        kp = {k: v[:, :N] for k, v in kp.items()}
        dropped = dropped + (n_valid_all - kp["valid"].sum(
            dim=1, dtype=torch.int32)).clamp_min(0)

    h0, w0 = pyr.gauss[0].shape[-2:]
    shapes = np.array([g.shape[-2:] for g in pyr.gauss])
    maps, gausses, wtls = [], [], []
    for g in pyr.gauss:                                   # (B, Lg, H, W)
        m, th = gradient_magnitude_orientation(g, parity=True)
        maps.append(_pad_to(torch.stack([m, th], dim=2), h0, w0))
        gausses.append(_pad_to(g, h0, w0))
        # the top-left 16x16 of the blurred full Gaussian (sift.cpp:87-92),
        # once per level; octaves under 16 px are padded with zeros
        wtls.append(_pad_to(gaussian_blur(g, 1.6)
                            [..., :2 * R, :2 * R], 2 * R, 2 * R))
    maps = torch.stack(maps, dim=1)                # (B, O, Lg, 2, h0, w0)

    kp = assign_orientation_parity(kp, pyr.gauss_sigmas, shapes)
    desc, desc_ok = descriptor_scan_parity(
        kp, maps, torch.stack(gausses, dim=1),
        torch.stack(wtls, dim=1).contiguous(), shapes)
    return Keypoints(
        x=kp["x"], y=kp["y"], octave=kp["octave"], level=kp["level"],
        scale=kp["scale"], score=kp["score"], orientation=kp["orientation"],
        valid=kp["valid"] & desc_ok, desc=desc, n_dropped=dropped)
