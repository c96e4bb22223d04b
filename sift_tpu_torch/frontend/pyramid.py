"""Gaussian / DoG pyramid, lowe schedule (counterpart of
`sift_tpu/frontend/pyramid.py`).

Within-octave target sigmas sigma*k^j are reached by incremental blurs;
the next octave is seeded by a stride-2 subsample of Gaussian d-1.
Stacks are (B, L, H, W).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from sift_tpu_torch.config import SiftConfig
from sift_tpu_torch.kernels.dog import dog
from sift_tpu_torch.kernels.gaussian import gaussian_blur, incremental_sigma


@dataclasses.dataclass
class Pyramid:
    """gauss[o]: (B, d+1, H_o, W_o); dogs[o]: (B, d, H_o, W_o).

    gauss_sigmas[o, j]: within-octave sigma of Gaussian j; dog_sigmas[o, j]:
    geometric-mean sigma of DoG j's pair; abs_sigmas: x octave factor^o."""

    gauss: List[torch.Tensor]
    dogs: List[torch.Tensor]
    gauss_sigmas: np.ndarray
    dog_sigmas: np.ndarray
    abs_sigmas: np.ndarray

    @property
    def num_octaves(self) -> int:
        return len(self.gauss)


def lowe_sigma_schedule(cfg: SiftConfig):
    """(gauss_sigmas, dog_sigmas, abs_sigmas) as float64 numpy tables."""
    o, d = cfg.octaves, cfg.dogs_per_epoch
    within = np.array([cfg.sigma * cfg.k ** j for j in range(d + 1)], np.float64)
    octave_factor = cfg.k ** (d - 1)
    gs = np.tile(within, (o, 1))
    abs_s = gs * (octave_factor ** np.arange(o))[:, None]
    ds = np.sqrt(gs[:, :-1] * gs[:, 1:])
    return gs, ds, abs_s


def build_pyramid(img: torch.Tensor, cfg: SiftConfig) -> Pyramid:
    """img: (B, H, W) float32 in [0, image_max]."""
    if cfg.mode != "lowe" or cfg.subpixel:
        raise NotImplementedError("only lowe mode without subpixel is ported")
    d = cfg.dogs_per_epoch
    gs, ds, abs_s = lowe_sigma_schedule(cfg)
    sigma_n = 0.5            # nominal blur of the raw image (Lowe 2004 §3.3)
    base = gaussian_blur(img, incremental_sigma(sigma_n, cfg.sigma)) \
        if cfg.sigma > sigma_n else img
    gauss_levels, dog_levels = [], []
    for i in range(cfg.octaves):
        levels = [base]
        for j in range(1, d + 1):
            delta = incremental_sigma(float(gs[i, j - 1]), float(gs[i, j]))
            levels.append(gaussian_blur(levels[-1], delta))
        gauss_levels.append(torch.stack(levels, dim=-3))
        dog_levels.append(torch.stack(
            [dog(levels[j - 1], levels[j]) for j in range(1, d + 1)], dim=-3))
        if i < cfg.octaves - 1:
            base = levels[d - 1][..., ::2, ::2].contiguous()
    return Pyramid(gauss=gauss_levels, dogs=dog_levels, gauss_sigmas=gs,
                   dog_sigmas=ds, abs_sigmas=abs_s)
