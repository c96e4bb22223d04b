"""Photo pairs: a texture and its warp by a random homography.

scene keys: `pairs` (distinct pairs), `rotation_deg` (rotation drawn in
+-this about the centre), `scale` ([lo, hi]), `shift_px` (each component
in +-this), `perspective` (each of the two terms in +-this, per pixel),
`fill` (the value of pixels that come from outside the first image).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.inputs.texture import textured
from portbench.lib.scene import Scene
from portbench.lib.seeds import generator


def random_homography(h: int, w: int, spec: dict,
                      gen: torch.Generator) -> np.ndarray:
    u = torch.rand(6, generator=gen, dtype=torch.float64).numpy()
    th = math.radians(spec["rotation_deg"] * (2 * u[0] - 1))
    lo, hi = spec["scale"]
    s = lo + (hi - lo) * u[1]
    shift = spec["shift_px"] * (2 * u[2:4] - 1)
    persp = spec["perspective"] * (2 * u[4:6] - 1)
    P = np.eye(3)
    P[:2, :2] = s * np.array([[math.cos(th), -math.sin(th)],
                              [math.sin(th), math.cos(th)]])
    P[2, :2] = persp
    c = np.array([w / 2.0, h / 2.0])
    to_c, from_c = np.eye(3), np.eye(3)
    to_c[:2, 2] = -c
    from_c[:2, 2] = c + shift
    return from_c @ P @ to_c


def warp(img: torch.Tensor, Hm: np.ndarray, fill: float) -> torch.Tensor:
    """out(x, y) = img(H^-1 (x, y)), bilinear, `fill` outside."""
    h, w = img.shape
    Hi = torch.tensor(np.linalg.inv(Hm), dtype=torch.float64, device=img.device)
    yy, xx = torch.meshgrid(torch.arange(h, device=img.device, dtype=torch.float64),
                            torch.arange(w, device=img.device, dtype=torch.float64),
                            indexing="ij")
    den = Hi[2, 0] * xx + Hi[2, 1] * yy + Hi[2, 2]
    sx = (Hi[0, 0] * xx + Hi[0, 1] * yy + Hi[0, 2]) / den
    sy = (Hi[1, 0] * xx + Hi[1, 1] * yy + Hi[1, 2]) / den
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = sx - x0, sy - y0
    inside = (x0 >= 0) & (y0 >= 0) & (x0 < w - 1) & (y0 < h - 1)
    x0 = x0.clamp(0, w - 2).long()
    y0 = y0.clamp(0, h - 2).long()
    a = img.to(torch.float64)
    v = (a[y0, x0] * (1 - fx) * (1 - fy) + a[y0, x0 + 1] * fx * (1 - fy)
         + a[y0 + 1, x0] * (1 - fx) * fy + a[y0 + 1, x0 + 1] * fx * fy)
    return torch.where(inside, v, fill).to(torch.float32)


def make(spec: dict, height: int, width: int, seed: int, device) -> Scene:
    tex_gen = generator(seed, "warped_pairs/texture", device)
    h_gen = generator(seed, "warped_pairs/homography")
    frames, pairs, truth = [], [], []
    for p in range(spec["pairs"]):
        a = textured(height, width, tex_gen, device)
        Hm = random_homography(height, width, spec, h_gen)
        frames += [a, warp(a, Hm, spec["fill"])]
        pairs.append((2 * p, 2 * p + 1))
        truth.append(Hm)
    return Scene(torch.stack(frames), pairs, truth)
