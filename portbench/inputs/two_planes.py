"""A monocular sequence of two textured fronto-parallel planes.

The top half of each frame sees a plane at `depths_m[0]`, the bottom half
one at `depths_m[1]`; the camera moves `step_m` metres along x a frame,
so each plane's texture shifts by fx * x / z pixels (linear
interpolation), and frames are rounded to 8-bit values. The textures are
two row bands of one seeded texture, wide enough for the whole motion.

scene keys: `frames`, `step_m`, `depths_m` ([top, bottom]),
`intrinsics` ([fx, fy, cx, cy]).
"""

from __future__ import annotations

import math

import torch

from portbench.inputs.texture import textured
from portbench.lib.scene import Scene
from portbench.lib.seeds import generator


def make(spec: dict, height: int, width: int, seed: int, device) -> Scene:
    n, step = spec["frames"], spec["step_m"]
    z_top, z_bot = spec["depths_m"]
    fx = spec["intrinsics"][0]
    h, w = height, width
    span = math.ceil(fx * step * n / z_top) + w + 48
    tex = textured(2 * (h - h // 2) + 16, span,
                   generator(seed, "two_planes/texture", device), device)
    xs = step * torch.arange(n, device=device, dtype=torch.float64)
    cols0 = torch.arange(w, device=device, dtype=torch.float64)
    parts = []
    for band, z in ((tex[:h // 2], z_top), (tex[-(h - h // 2):], z_bot)):
        cols = (cols0[None, :] + fx * xs[:, None] / z + 40.0).clamp(0, span - 2)
        c0 = torch.floor(cols)
        f = (cols - c0).to(torch.float32)[:, None, :]
        c0 = c0.long()
        parts.append(band[:, c0].permute(1, 0, 2) * (1 - f)
                     + band[:, c0 + 1].permute(1, 0, 2) * f)
    frames = torch.round(torch.cat(parts, dim=1)).clamp(0, 255)
    pairs = [(i, i + 1) for i in range(n - 1)]
    return Scene(frames.contiguous(), pairs, [None] * len(pairs))
