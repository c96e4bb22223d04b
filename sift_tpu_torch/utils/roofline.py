"""Roofline accounting on the H100 (counterpart of
`sift_tpu/utils/roofline.py`).

`roofline` turns a measured time and a call's work into achieved rates
and shares of the card's peaks, with the same keys as the JAX function.
The JAX module counts work with XLA's cost analysis of the compiled
program (`compiled_costs`); the port has no compiler to ask, so it counts
the work of each hand kernel by formula from the call's inputs
(`kernel_work`): each input byte read once and each output byte written
once, and the operations that these inputs need. `bound_ms` is the least
time the card could take for that work.

Peaks: NVIDIA's H100 SXM data sheet, dense rates at the card's full
power limit of 700 W. A card set to a lower limit runs slower under load,
so a share of these peaks stands beside the card's limit.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

H100_PEAK_FLOPS_BF16 = 989e12      # tensor cores, dense
H100_PEAK_FLOPS_TF32 = 495e12      # tensor cores, dense
H100_PEAK_FLOPS_F32 = 67e12        # outside the tensor cores
H100_HBM_BYTES_S = 3.35e12         # HBM3
# f32 operations per window pixel of the descriptor pass, both peaks:
# magnitude + angle ~20 (atan2 counted as ~12), and per peak: u, v 6,
# Gaussian weight 6, orientation bins 10, tents 16, and 2x2 cells x 2 bins
# x 3 (product, weight, add) = 24 for the non-zero votes -> 20 + 2*62.
DESC_OPS_PER_PIXEL = 144


def roofline(name: str, seconds: float, flops: float, bytes_: float,
             peak_flops: float = H100_PEAK_FLOPS_BF16,
             peak_bytes_s: float = H100_HBM_BYTES_S) -> Dict:
    """Achieved rates and % of peak; names the binding wall."""
    tflops = flops / max(seconds, 1e-12) / 1e12
    gbs = bytes_ / max(seconds, 1e-12) / 1e9
    pct_compute = 100.0 * tflops * 1e12 / peak_flops
    pct_hbm = 100.0 * gbs * 1e9 / peak_bytes_s
    # Which peak would this stage hit first if sped up uniformly?
    bound = "compute" if pct_compute >= pct_hbm else "memory"
    # Arithmetic intensity vs machine balance point.
    intensity = flops / max(bytes_, 1.0)
    balance = peak_flops / peak_bytes_s
    return {
        "stage": name,
        "ms": round(seconds * 1e3, 3),
        "gflops": round(flops / 1e9, 2),
        "gbytes": round(bytes_ / 1e9, 3),
        "achieved_tflops": round(tflops, 3),
        "achieved_gbs": round(gbs, 1),
        "pct_peak_compute": round(pct_compute, 1),
        "pct_peak_hbm": round(pct_hbm, 1),
        "intensity_flop_per_byte": round(intensity, 2),
        "bound": bound if intensity < 10 * balance else "compute",
    }


def bound_ms(nbytes: float, nops: float,
             peak_flops: float = H100_PEAK_FLOPS_F32,
             peak_bytes_s: float = H100_HBM_BYTES_S) -> Tuple[float, str]:
    """(ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the operations over the peak rate (f32 outside the
    tensor cores by default, the hand kernels' type)."""
    t_bytes = nbytes / peak_bytes_s * 1e3
    t_ops = nops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def covered_cells(dogs, x, y) -> int:
    """DoG cells, all levels, that at least one keypoint's 16x16 patch of
    the refine walk covers: the patch corners box-dilated by 16 toward the
    bottom right, clipped to the image. What the kernel stages, beside
    what the walks read (`walk_cells`)."""
    from sift_tpu_torch.kernels.cuda.refine import D, patch_corners
    B, L, H, W = dogs.shape
    _, _, x0, y0 = patch_corners(x, y, H, W)
    corners = torch.zeros((B, 1, H, W), device=dogs.device)
    img = torch.arange(B, device=dogs.device)[:, None].expand_as(x0)
    corners[img, 0, y0.long(), x0.long()] = 1.0
    cover = F.max_pool2d(F.pad(corners, (D - 1, 0, D - 1, 0)), D, stride=1)
    return int(cover.sum()) * L


def walk_cells(dogs, x, y, level) -> int:
    """DoG cells that the refine walks read, each counted once: the plain
    walk (`refine._walk`) runs with a lookup that records the flat index of
    every tap it reads inside the image (taps past the image's edge read
    0, not memory)."""
    from sift_tpu_torch.kernels.cuda import refine as rk
    B, L, H, W = dogs.shape
    _, _, x0, y0 = (t.reshape(-1, 1, 1, 1).long()
                    for t in rk.patch_corners(x, y, H, W))
    img = torch.arange(B, device=dogs.device).repeat_interleave(
        x.shape[1]).reshape(-1, 1, 1, 1)
    read = []
    walk = rk._walk

    def recording_walk(lookup, *args):
        def recorded(li, ly, lx):
            s, cell, inside = rk._cells(li, ly, lx)
            yy, xx = y0 + cell // rk.D, x0 + cell % rk.D
            ok = inside & (yy < H) & (xx < W)
            idx = ((img * L + s) * H + yy) * W + xx
            read.append(idx.expand_as(ok)[ok])
            return lookup(li, ly, lx)
        return walk(recorded, *args)

    rk._walk = recording_walk
    try:
        rk.refine_walk_plain(dogs, x, y, level)
    finally:
        rk._walk = walk
    return int(torch.unique(torch.cat(read)).numel())


def kernel_work(name: str, args) -> Tuple[float, float]:
    """(bytes, f32 ops) that one call of hand kernel `name` must move and
    do on these arguments (the wrapper's)."""
    if name == "gather_windows":
        maps, gl, y0, x0, d = args
        K, C = gl.shape[0], maps.shape[0]
        return K * C * d * d * (maps.element_size() + 4) + K * 12, 0.0
    if name == "refine_walk":
        N = args[1].numel()
        return walk_cells(*args) * 4 + N * (12 + 27 * 4 + 16), N * 6 * 150.0
    if name == "streaming_top2":
        a, _, b, _ = args
        (Na, D), Nb = a.shape, b.shape[0]
        return (Na + Nb) * (D * 4 + 1) + Na * 12, 2.0 * Na * Nb * D
    if name == "descriptor_accumulate":
        wins, scal = args
        K, _, d, _ = wins.shape
        return (K * (2 * d * d * 4 + scal.shape[1] * 4 + 2 * 128 * 4),
                K * d * d * float(DESC_OPS_PER_PIXEL))
    if name == "blur":
        # each pixel read once and written once; per pass and pixel, one
        # product a tap and one sum a tap after the first
        img, taps = args
        n = img.numel()
        return n * 4 * 2.0, n * 2.0 * (2 * len(taps) - 1)
    raise ValueError(f"no work formula for kernel {name!r}")
