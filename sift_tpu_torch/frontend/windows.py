"""Shared per-keypoint gradient windows: one (2, 48, 48) window per keypoint
feeds the orientation histogram and both descriptors (counterpart of
`sift_tpu/frontend/windows.py`).

The gradient maps are cast to `cfg.window_dtype` before the gather
(round to nearest even, as in JAX); the gather widens back to f32 exactly.
Descriptors follow the f32 arithmetic of the TPU descriptor kernel, not
the bf16-operand einsum of the JAX package's fallback.
"""

from __future__ import annotations

import math

import torch

from sift_tpu_torch.config import SiftConfig
from sift_tpu_torch.frontend.orientation import (_circular_smooth,
                                                 peaks_from_histogram)
from sift_tpu_torch.kernels.cuda import descriptor as desc_kernel
from sift_tpu_torch.kernels.cuda import windows as window_kernel
from sift_tpu_torch.utils.lanewise import lanewise

R_DESC = 24        # window radius -> 48x48 windows
R_ORI = 8          # orientation uses the central 16x16
# Orientation votes an accumulating `index_put_` takes at a time on the
# CPU: under ATen's parallel grain (32768), so that one thread adds them.
_VOTES_A_CALL = 16384


def gather_gradient_windows(dx_maps: torch.Tensor, dy_maps: torch.Tensor,
                            gl: torch.Tensor, y: torch.Tensor, x: torch.Tensor,
                            radius: int = R_DESC, dtype: str = "float32"):
    """One (2, 2r, 2r) window per keypoint from (L, H, W) gradient maps.

    gl: (K,) level; y, x: (K,) float positions. Returns (wins (K, 2, 2r, 2r)
    f32, oy0, ox0): the offsets of window pixel (0, 0) from the keypoint."""
    L, H, W = dx_maps.shape
    d = 2 * radius
    stacked = torch.stack([dx_maps, dy_maps])              # (2, L, H, W)
    if dtype == "bfloat16" and d % 16 == 0:
        stacked = stacked.to(torch.bfloat16)
    hi = max(H - radius, radius)
    yi = torch.clamp(y.to(torch.int32), radius, hi)
    xi = torch.clamp(x.to(torch.int32), radius, max(W - radius, radius))
    wins = window_kernel.gather_windows(
        stacked, gl.to(torch.int32).contiguous(),
        (yi - radius).contiguous(), (xi - radius).contiguous(), d)
    oy0 = yi.to(torch.float32) - radius - y
    ox0 = xi.to(torch.float32) - radius - x
    return wins, oy0, ox0


def orientation_from_windows(gx, gy, oy0, ox0, sigma_within, in_bounds,
                             cfg: SiftConfig, max_peaks: int = 2):
    """36-bin orientation histogram over the central 16x16 of each (K, d, d)
    window + top-`max_peaks` refined peaks. Returns (degrees (K, P),
    peak_valid (K, P))."""
    K, d, _ = gx.shape
    c0, c1 = d // 2 - R_ORI, d // 2 + R_ORI
    sgx = gx[:, c0:c1, c0:c1].reshape(K, -1)
    sgy = gy[:, c0:c1, c0:c1].reshape(K, -1)
    mag = torch.sqrt(sgx * sgx + sgy * sgy)
    ang = torch.remainder(torch.rad2deg(lanewise(torch.atan2, sgy, sgx))
                          + 360.0, 360.0)

    rows = torch.arange(2 * R_ORI, dtype=torch.float32, device=gx.device) + c0
    oy = oy0[:, None, None] + rows[None, :, None]
    ox = ox0[:, None, None] + rows[None, None, :]
    sw = 1.5 * sigma_within
    wgt = lanewise(torch.exp, -(ox * ox + oy * oy).reshape(K, -1)
                   / (2.0 * sw * sw)[:, None])
    bin_idx = torch.clamp((ang / 10.0).to(torch.int64), 0, 35)
    # An accumulating `index_put_`, not `scatter_add_`: on the card it sums
    # each bin's votes in a fixed order (by sorting), where `scatter_add_`'s
    # float atomics make the bins, and every orientation after them, part
    # in the last bits from run to run. On the CPU it adds with atomics
    # across threads once a call passes the parallel grain, so it runs on
    # a block of rows at a time (one thread, votes in pixel order).
    votes = mag * wgt
    hist = torch.zeros((K, 36), dtype=torch.float32, device=gx.device)
    step = K if gx.is_cuda else max(1, _VOTES_A_CALL // votes.shape[1])
    for i in range(0, K, step):
        rows = hist[i:i + step]
        rows_k = torch.arange(rows.shape[0], device=gx.device)[:, None]
        rows.index_put_((rows_k.expand(-1, votes.shape[1]),
                         bin_idx[i:i + step]), votes[i:i + step],
                        accumulate=True)
    hist = _circular_smooth(hist, passes=2)
    hist = torch.where(in_bounds[:, None], hist, torch.zeros_like(hist))
    return peaks_from_histogram(hist, max_peaks, cfg.ori_peak_rel)


def _finalize_descriptor(desc: torch.Tensor, cfg: SiftConfig) -> torch.Tensor:
    """L2-normalize + clamp + renormalize (Lowe 2004 §6.1), or RootSIFT."""
    norm = torch.linalg.vector_norm(desc, dim=-1, keepdim=True)
    desc = desc / norm.clamp_min(1e-7)
    desc = desc.clamp_max(cfg.descriptor_max_component)
    if cfg.rootsift:
        s = desc.sum(dim=-1, keepdim=True)
        return torch.sqrt(desc / s.clamp_min(1e-7))
    norm = torch.linalg.vector_norm(desc, dim=-1, keepdim=True)
    return desc / norm.clamp_min(1e-7)


def descriptors_from_windows(gx, gy, oy0, ox0, orientation_deg, sigma_within,
                             cfg: SiftConfig) -> torch.Tensor:
    """One descriptor per keypoint at one orientation: (K, 128).

    gx, gy: (K, d, d) gradient windows; oy0, ox0: offsets of window pixel
    (0, 0) from the keypoint; orientation_deg, sigma_within: (K,). The
    descriptor kernel always computes two peaks, so the orientation goes
    in both and peak 0 is kept: bit for bit `descriptors_from_windows_multi`
    's peak 0, at twice the histogram work of one peak."""
    wins = torch.stack([gx, gy], dim=1).to(torch.float32).contiguous()
    peaks = torch.stack([orientation_deg, orientation_deg], dim=1)
    return descriptors_from_windows_multi(wins, oy0, ox0, peaks, sigma_within,
                                          cfg)[:, 0].contiguous()


def descriptors_from_windows_multi(wins, oy0, ox0, peak_oris, sigma_within,
                                   cfg: SiftConfig) -> torch.Tensor:
    """Descriptors for both orientation peaks of each keypoint: (K, 2, 128).

    wins: (K, 2, d, d) f32 gradient windows; peak_oris: (K, 2) degrees."""
    if peak_oris.shape[1] != desc_kernel.N_PEAKS:
        raise ValueError(f"expected {desc_kernel.N_PEAKS} orientation peaks")
    hw = torch.clamp_min(3.0 * sigma_within, 1e-3)
    theta = peak_oris * (math.pi / 180.0)
    cols = [oy0, ox0, 1.0 / hw]
    for pk in range(desc_kernel.N_PEAKS):
        cols += [lanewise(torch.cos, theta[:, pk]),
                 lanewise(torch.sin, theta[:, pk]),
                 peak_oris[:, pk] * (1.0 / 45.0)]
    scal = torch.stack(cols, dim=1).to(torch.float32).contiguous()
    raw = desc_kernel.descriptor_accumulate(wins, scal)
    return _finalize_descriptor(raw, cfg)
