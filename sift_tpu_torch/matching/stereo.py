"""Stereo keypoint depth for rectified pairs (counterpart of
`sift_tpu/matching/stereo.py`; e.g. KITTI image_0/image_1).

A left keypoint's match in a rectified right image lies on the same row
with positive disparity. The all-pairs descriptor distance (`pairwise_
sqdist`, one f32 `torch.matmul`) gets two extra masks (row proximity,
disparity range) and a ratio test; a matched disparity d gives the metric
depth z = fx * baseline / d, which feeds the pipeline's RGB-D path.

Fixed shapes throughout: capacity-N keypoint tensors in, an (N,) depth
tensor out (0 where there is no valid stereo match). No host sync.
"""

from __future__ import annotations

import torch

from sift_tpu_torch.matching.matcher import pairwise_sqdist
from sift_tpu_torch.types import Keypoints

_BIG = 1e30


def stereo_depths(kp_l: Keypoints, kp_r: Keypoints, fx: float,
                  baseline: float, max_row_diff: float = 1.5,
                  min_disparity: float = 0.5, max_disparity: float = 192.0,
                  ratio: float = 0.8, subpixel: bool = False) -> torch.Tensor:
    """Per-left-keypoint metric depth from a rectified stereo pair.

    kp_l, kp_r: single-image `Keypoints` with descriptors. `subpixel` must
    match the extractor's `SiftConfig.subpixel`, so that positions land in
    original-image pixels. Returns (N_l,) float32 depths, 0 = invalid."""
    ul, vl = kp_l.to_image_xy(subpixel)
    ur, vr = kp_r.to_image_xy(subpixel)

    d = pairwise_sqdist(kp_l.desc, kp_r.desc)
    row_ok = torch.abs(vl[:, None] - vr[None, :]) <= max_row_diff
    disp = ul[:, None] - ur[None, :]
    disp_ok = (disp >= min_disparity) & (disp <= max_disparity)
    ok = row_ok & disp_ok & kp_r.valid[None, :] & kp_l.valid[:, None]
    d = torch.where(ok, d, _BIG)

    best, best_idx = torch.min(d, dim=-1)
    # The best column pushed out of the way (JAX adds a one-hot times
    # _BIG; `F.one_hot` would check its indices on the host).
    cols = torch.arange(d.shape[-1], device=d.device)
    second = torch.amin(d + torch.where(cols == best_idx[:, None], _BIG, 0.0),
                        dim=-1)
    accept = (best < _BIG) & (best < ratio * ratio * second)

    best_disp = torch.gather(disp, -1, best_idx[:, None])[:, 0]
    depth = fx * baseline / torch.clamp_min(best_disp, 1e-6)
    return torch.where(accept, depth, 0.0)


def stereo_depths_batch(kp_l: Keypoints, kp_r: Keypoints, fx: float,
                        baseline: float, subpixel: bool = False
                        ) -> torch.Tensor:
    """`stereo_depths` over a batch of pairs ((B, N) keypoint tensors):
    (B, N) depths, `torch.func.vmap`ped as the JAX package `vmap`s it."""
    fields = ("x", "y", "octave", "valid", "desc")

    def one(xl, yl, ol, vl, dl, xr, yr, orr, vr, dr):
        a = Keypoints(x=xl, y=yl, octave=ol, level=ol, scale=xl, score=xl,
                      orientation=xl, valid=vl, desc=dl)
        b = Keypoints(x=xr, y=yr, octave=orr, level=orr, scale=xr, score=xr,
                      orientation=xr, valid=vr, desc=dr)
        return stereo_depths(a, b, fx, baseline, subpixel=subpixel)

    return torch.func.vmap(one)(*[getattr(kp_l, f) for f in fields],
                                *[getattr(kp_r, f) for f in fields])
