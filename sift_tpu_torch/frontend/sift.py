"""SIFT extraction entry points of the PyTorch port (counterpart of
`sift_tpu/frontend/sift.py`).

`extract_batch(imgs)`: (B, H, W) -> `Keypoints` with a leading B.
`extract(img)`: one (H, W) image through the batched path at B=1.
Parity mode runs `frontend/parity.py::extract_parity` once for the whole
batch; on the card its ordered descriptor walk is one launch of the hand
kernel `parity_scan`.

Both run on the card unless the caller passes `device="cpu"`. In lowe
mode, on the card, every per-keypoint stage launches its hand kernel
(window gather, refine walk, descriptor); on the CPU the same stages run
their plain versions.
The dense stages (pyramid, extrema) keep the batch axis; the per-keypoint
stages run on keypoints flattened across the batch, indexing a (2, B*L,
H, W) gradient stack with fused (image, level) indices.
"""

from __future__ import annotations

import numpy as np
import torch

from sift_tpu_torch.config import SiftConfig
from sift_tpu_torch.frontend.extrema import detect_extrema_octave, top_k_stable
from sift_tpu_torch.frontend.parity import extract_parity
from sift_tpu_torch.frontend.pyramid import build_pyramid
from sift_tpu_torch.frontend.refine import refine_octave_lowe
from sift_tpu_torch.frontend.windows import (
    R_DESC,
    R_ORI,
    descriptors_from_windows_multi,
    gather_gradient_windows,
    orientation_from_windows,
)
from sift_tpu_torch.types import Keypoints
from sift_tpu_torch.utils.device import constant

MAX_ORI_PEAKS = 2


def _gradient_xy(g: torch.Tensor):
    """Central-difference gradient maps of a (..., H, W) stack (border 0)."""
    dx = torch.zeros_like(g)
    dy = torch.zeros_like(g)
    dx[..., 1:-1] = (g[..., 2:] - g[..., :-2]) * 0.5
    dy[..., 1:-1, :] = (g[..., 2:, :] - g[..., :-2, :]) * 0.5
    return dx, dy


def _resolve_device(device, cfg: SiftConfig) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run the plain PyTorch path")
        if cfg.pallas == "off":
            raise ValueError('cfg.pallas="off" cannot be honoured on the card: '
                             "the port always runs its kernels there")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def extract_lowe_batched(imgs: torch.Tensor, cfg: SiftConfig,
                         with_descriptors: bool = True) -> Keypoints:
    """Batch-flattened lowe extraction over a (B, H, W) float32 tensor."""
    B = imgs.shape[0]
    dev = imgs.device
    pyr = build_pyramid(imgs, cfg)
    octave_factor = cfg.k ** (cfg.dogs_per_epoch - 1)
    fields = ["x", "y", "octave", "level", "scale", "score", "orientation",
              "valid"]
    buffers = {f: [] for f in fields}
    descs = []
    dropped = torch.zeros((B,), dtype=torch.int32, device=dev)
    cand_pruned = torch.zeros((B,), dtype=torch.int32, device=dev)
    P = MAX_ORI_PEAKS

    for o in range(pyr.num_octaves):
        x, y, lvl, score, valid, n_pruned = detect_extrema_octave(
            pyr.dogs[o], cfg, o)                          # fields (B, K)
        cand_pruned = cand_pruned + n_pruned
        cand = dict(x=x, y=y, level=lvl, score=score, valid=valid)
        cand = refine_octave_lowe(pyr.dogs[o], cand, cfg, pyr.dog_sigmas, o,
                                  octave_factor)

        g = pyr.gauss[o]                                  # (B, L1, H, W)
        L1, H, W = g.shape[-3:]
        K = cand["x"].shape[1]
        dxm, dym = _gradient_xy(g)
        sigma_within = cand["scale"] / constant(octave_factor ** o, dev)
        table = constant(pyr.gauss_sigmas[o], dev)
        gl = torch.argmin((table - sigma_within[..., None]).abs(), dim=-1)
        in_bounds = ((cand["x"] >= R_ORI) & (cand["x"] < W - R_ORI)
                     & (cand["y"] >= R_ORI) & (cand["y"] < H - R_ORI))

        sw_f = sigma_within.reshape(B * K)
        ib_f = in_bounds.reshape(B * K)
        r_eff = min(R_DESC, H // 2, W // 2)
        if r_eff < R_ORI:
            peak_oris = torch.zeros((B * K, P), dtype=torch.float32, device=dev)
            peak_valid = torch.zeros((B * K, P), dtype=torch.bool, device=dev)
            wins = torch.zeros((B * K, 2, 2 * R_ORI, 2 * R_ORI),
                               dtype=torch.float32, device=dev)
            oy0 = torch.zeros((B * K,), dtype=torch.float32, device=dev)
            ox0 = torch.zeros_like(oy0)
        else:
            gl_f = (gl + torch.arange(B, device=dev)[:, None] * L1).reshape(B * K)
            wins, oy0, ox0 = gather_gradient_windows(
                dxm.reshape(B * L1, H, W), dym.reshape(B * L1, H, W), gl_f,
                cand["y"].reshape(B * K), cand["x"].reshape(B * K),
                radius=r_eff, dtype=cfg.window_dtype)
            peak_oris, peak_valid = orientation_from_windows(
                wins[:, 0], wins[:, 1], oy0, ox0, sw_f, ib_f, cfg, P)

        def rep(a):                      # (B, K) -> (B, K*P), peak-major
            return torch.repeat_interleave(a, P, dim=1)

        dup = dict(
            x=rep(cand["x"]), y=rep(cand["y"]),
            octave=torch.full((B, K * P), o, dtype=torch.int32, device=dev),
            level=rep(cand["level"]), scale=rep(cand["scale"]),
            score=rep(cand["score"]),
            orientation=peak_oris.reshape(B, K * P),
            valid=rep(cand["valid"] & in_bounds) & peak_valid.reshape(B, K * P),
        )
        if with_descriptors:
            dm = descriptors_from_windows_multi(wins, oy0, ox0, peak_oris,
                                                sw_f, cfg)
            descs.append(dm.reshape(B, K * P, -1))
        for f in fields:
            buffers[f].append(dup[f])

    kp = {f: torch.cat(buffers[f], dim=1) for f in fields}
    desc = torch.cat(descs, dim=1) if with_descriptors else None

    N = min(cfg.max_keypoints, kp["score"].shape[1])
    rank_score = torch.where(kp["valid"], kp["score"], float("-inf"))
    top_scores, idx = top_k_stable(rank_score, N)

    def take(a):
        return torch.gather(a, 1, idx)

    out_valid = take(kp["valid"]) & torch.isfinite(top_scores)
    dropped = dropped + (kp["valid"].sum(dim=1) - out_valid.sum(dim=1)
                         ).clamp_min(0).to(torch.int32)
    return Keypoints(
        x=take(kp["x"]), y=take(kp["y"]), octave=take(kp["octave"]),
        level=take(kp["level"]), scale=take(kp["scale"]),
        score=take(kp["score"]), orientation=take(kp["orientation"]),
        valid=out_valid,
        desc=(torch.gather(desc, 1, idx[..., None].expand(-1, -1, 128))
              if desc is not None else None),
        n_dropped=dropped, n_cand_pruned=cand_pruned,
    )


def extract_batch(imgs, cfg: SiftConfig = SiftConfig(),
                  with_descriptors: bool = True,
                  device="cuda") -> Keypoints:
    """Extract SIFT keypoints from (B, H, W) images in [0, image_max]
    (numpy array or tensor). All fields gain a leading B."""
    dev = _resolve_device(device, cfg)
    if isinstance(imgs, np.ndarray):
        imgs = torch.from_numpy(imgs)
    imgs = imgs.to(device=dev, dtype=torch.float32).contiguous()
    if imgs.dim() != 3:
        raise ValueError(f"expected (B, H, W) images, got {tuple(imgs.shape)}")
    if cfg.mode == "parity":
        return extract_parity(imgs, cfg)
    return extract_lowe_batched(imgs, cfg, with_descriptors)


def extract(img, cfg: SiftConfig = SiftConfig(), with_descriptors: bool = True,
            device="cuda") -> Keypoints:
    """Extract SIFT keypoints from one (H, W) image through the batched
    path at B=1. Parity mode always computes descriptors (they decide
    validity), as in JAX."""
    if isinstance(img, np.ndarray):
        img = torch.from_numpy(img)
    kp = extract_batch(img[None], cfg, with_descriptors, device)
    return kp.map(lambda a: a[0])
