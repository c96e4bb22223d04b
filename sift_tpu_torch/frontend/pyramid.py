"""Gaussian / DoG pyramid (counterpart of `sift_tpu/frontend/pyramid.py`).

Two schedules, one structure (`octaves` octaves of `dogs_per_epoch + 1`
Gaussians and `dogs_per_epoch` DoGs). Stacks are (B, L, H, W).

lowe: within-octave target sigmas sigma*k^j are reached by incremental
blurs; the next octave is seeded by a stride-2 subsample of Gaussian d-1.

parity (the reference's `Sift::_createDOGs`): every Gaussian is a full
re-blur of the previous one with the recorded sigma k^exp * sigma; the
recorded DoG "scale" is the difference of the two sigmas; DoG pixels
carry the +128 offset; the next octave is the nearest resize to
((H+1)//2, (W+1)//2) of Gaussian d-1 blurred once more by its own sigma.

`subpixel` starts from a 2x input: parity blurs by 1.0 and doubles by
nearest resize (the reference's `-p 1`); lowe takes a bilinear 2x and
assumes a nominal input blur of 1.0 instead of 0.5.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from sift_tpu_torch.config import SiftConfig
from sift_tpu_torch.kernels.dog import dog
from sift_tpu_torch.kernels.gaussian import gaussian_blur, incremental_sigma
from sift_tpu_torch.kernels.resize import (downsample_half, resize_bilinear,
                                           upsample_double)


@dataclasses.dataclass
class Pyramid:
    """gauss[o]: (B, d+1, H_o, W_o); dogs[o]: (B, d, H_o, W_o).

    gauss_sigmas[o, j]: within-octave sigma of Gaussian j (parity: its
    recorded sigma); dog_sigmas[o, j]: geometric-mean sigma of DoG j's pair
    (parity: the difference of the pair's sigmas); abs_sigmas: x octave
    factor^o (parity: a copy of gauss_sigmas)."""

    gauss: List[torch.Tensor]
    dogs: List[torch.Tensor]
    gauss_sigmas: np.ndarray
    dog_sigmas: np.ndarray
    abs_sigmas: np.ndarray

    @property
    def num_octaves(self) -> int:
        return len(self.gauss)

    @property
    def levels_per_octave(self) -> int:
        return self.gauss[0].shape[-3]


def parity_sigma_schedule(cfg: SiftConfig):
    """(gauss_sigmas, dog_sigmas): the reference's recorded sigmas as
    float64 numpy tables."""
    o, d = cfg.octaves, cfg.dogs_per_epoch
    gs = np.zeros((o, d + 1), np.float64)
    ds = np.zeros((o, d), np.float64)
    gs[0, 0] = cfg.sigma
    exp = 0
    for i in range(o):
        for j in range(1, d + 1):
            gs[i, j] = (cfg.k ** exp) * cfg.sigma
            ds[i, j - 1] = gs[i, j] - gs[i, j - 1]
            exp += 1
        if i < o - 1:
            gs[i + 1, 0] = gs[i, d - 1]
            exp -= 2
    return gs, ds


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
    parity = cfg.mode == "parity"
    d = cfg.dogs_per_epoch
    if cfg.subpixel:
        if parity:
            img = upsample_double(gaussian_blur(img, 1.0))
        else:
            img = resize_bilinear(img, 2 * img.shape[-2], 2 * img.shape[-1])
    gauss_levels, dog_levels = [], []
    if parity:
        gs, ds = parity_sigma_schedule(cfg)
        base = gaussian_blur(img, cfg.sigma)
        for i in range(cfg.octaves):
            levels = [base]
            for j in range(1, d + 1):
                levels.append(gaussian_blur(levels[-1], float(gs[i, j])))
            gauss_levels.append(torch.stack(levels, dim=-3))
            dog_levels.append(torch.stack(
                [dog(levels[j - 1], levels[j], parity_offset=True)
                 for j in range(1, d + 1)], dim=-3))
            if i < cfg.octaves - 1:
                base = downsample_half(
                    gaussian_blur(levels[d - 1], float(gs[i, d - 1])))
        return Pyramid(gauss=gauss_levels, dogs=dog_levels, gauss_sigmas=gs,
                       dog_sigmas=ds, abs_sigmas=gs.copy())

    gs, ds, abs_s = lowe_sigma_schedule(cfg)
    # Nominal blur of the raw image (Lowe 2004 §3.3), doubled if upsampled.
    sigma_n = 1.0 if cfg.subpixel else 0.5
    base = gaussian_blur(img, incremental_sigma(sigma_n, cfg.sigma)) \
        if cfg.sigma > sigma_n else img
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
