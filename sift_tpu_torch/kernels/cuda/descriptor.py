"""Descriptor accumulation: hand CUDA kernel (`csrc/descriptor.cu`) and its
plain version.

Replaces the TPU kernel `sift_tpu/kernels/pallas/descriptor.py::
descriptor_accumulate_pallas`. From each keypoint's (2, d, d) gradient
window, the raw 4x4x8 trilinear histograms for both orientation peaks,
with the f32 arithmetic of the TPU kernel (`_desc_kernel`). The magnitude
and angle, computed outside the TPU kernel, are fused into this one.

The kernel takes no atomics: each thread votes into its own column of a
shared [bin][thread] histogram, and each bin's columns are summed in an
order fixed by the code, so its output is bit-identical from run to run.
It sums in another order than the plain version, and its atan2f, sqrtf
and expf are CUDA's approximate forms (built with `-use_fast_math`), not
torch's; the votes are continuous in all of them, so the two agree to a
tolerance (`TOLERANCE`, on the raw histogram relative to its largest bin),
not bit for bit.

On a CUDA tensor `descriptor_accumulate` launches the kernel (or raises);
on a CPU tensor it runs `descriptor_accumulate_plain`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from sift_tpu_torch.kernels import build
from sift_tpu_torch.utils.lanewise import lanewise

N_PEAKS = 2
N_SCAL = 9          # oy0, ox0, 1/hist_width, then (cos, sin, ori/45) per peak
D_MAX = 48          # the kernel's largest window (2 * R_DESC of the frontend)
TOLERANCE = 1e-4    # max |kernel - plain| / max |plain| on raw histograms
# Keypoints per plain-version pass, by device (bounds memory): on the CPU
# a pass's cost follows its padded size, on the card its launch count.
_CHUNK = {"cpu": 64, "cuda": 512}
LAUNCHES = 0


def _accumulate_chunk(wins: torch.Tensor, scal: torch.Tensor) -> torch.Tensor:
    K, _, d, _ = wins.shape
    P = d * d
    dev = wins.device
    gx = wins[:, 0].reshape(K, P)
    gy = wins[:, 1].reshape(K, P)
    mag = torch.sqrt(gx * gx + gy * gy)
    a45 = torch.rad2deg(lanewise(torch.atan2, gy, gx)) * (1.0 / 45.0)
    pidx = torch.arange(P, device=dev)
    oy = scal[:, 0:1] + (pidx // d).to(torch.float32)
    ox = scal[:, 1:2] + (pidx % d).to(torch.float32)
    inv_hw = scal[:, 2:3]
    cc = torch.tensor([-1.5, -0.5, 0.5, 1.5], device=dev)
    out = []
    for pk in range(N_PEAKS):
        cos_t, sin_t, ori45 = (scal[:, 3 + 3 * pk + j:4 + 3 * pk + j]
                               for j in range(3))
        u = (ox * cos_t + oy * sin_t) * inv_hw
        v = (oy * cos_t - ox * sin_t) * inv_hw
        w = mag * lanewise(torch.exp, (u * u + v * v) * -0.125)
        dd = a45 - ori45
        rel = dd - 8.0 * torch.floor(dd * 0.125)
        ob = rel - 0.5
        b0f = torch.floor(ob)
        frac = ob - b0f
        b0m = torch.where(b0f < 0.0, b0f + 8.0, b0f)
        b1m = torch.where(b0m >= 7.0, b0m - 7.0, b0m + 1.0)
        wf = w * frac
        w1f = w - wf
        # each pixel's two votes, in its bins b0 and b1 = b0 + 1 (mod 8);
        # a NaN angle votes nowhere
        ok = ~torch.isnan(b0m)
        q = torch.zeros((K, P, 8), dtype=wins.dtype, device=dev)
        q.scatter_(2, torch.where(ok, b0m, 0.0).long()[..., None],
                   torch.where(ok, w1f, 0.0)[..., None])
        q.scatter_(2, torch.where(ok, b1m, 0.0).long()[..., None],
                   torch.where(ok, wf, 0.0)[..., None])
        tu = (1.0 - (u[..., None] - cc).abs()).clamp_min(0.0)
        tv = (1.0 - (v[..., None] - cc).abs()).clamp_min(0.0)
        sab = (tv[..., :, None] * tu[..., None, :]).reshape(K, P, 16)
        out.append(torch.bmm(sab.transpose(1, 2), q).reshape(K, 128))
    return torch.stack(out, dim=1)


def descriptor_accumulate_plain(wins: torch.Tensor,
                                scal: torch.Tensor) -> torch.Tensor:
    """wins: (K, 2, d, d) f32 (gx, gy); scal: (K, 9) f32. Returns the raw
    (K, 2, 128) histograms, bin a*32 + b*8 + o.

    Runs `_CHUNK` keypoints a pass (by device), the last padded with zero
    keypoints, so that every `torch.bmm` has one shape: a batched product
    computes each of its matrices alike wherever it sits and whatever
    shares it, but picks its algorithm from the shape (on the CPU a batch
    of one takes another path). Its `atan2` and `exp` run `lanewise`. A
    keypoint's histogram therefore does not depend on which others share
    its pass."""
    K = wins.shape[0]
    if K == 0:
        return wins.new_zeros((0, N_PEAKS, 128))
    chunk = _CHUNK[wins.device.type]
    pad = -K % chunk
    if pad:
        wins = torch.cat([wins, wins.new_zeros((pad,) + wins.shape[1:])])
        scal = torch.cat([scal, scal.new_zeros((pad, scal.shape[1]))])
    return torch.cat([_accumulate_chunk(wins[i:i + chunk],
                                        scal[i:i + chunk])
                      for i in range(0, K + pad, chunk)])[:K]


@functools.cache
def _fn():
    fn = build.library("descriptor").sift_descriptor_accumulate
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, i, p, p]
    fn.restype = i
    return fn


def descriptor_accumulate(wins: torch.Tensor,
                          scal: torch.Tensor) -> torch.Tensor:
    """See `descriptor_accumulate_plain`."""
    if not wins.is_cuda:
        return descriptor_accumulate_plain(wins, scal)
    global LAUNCHES
    K, C, d, d2 = wins.shape
    if (wins.dtype != torch.float32 or C != 2 or d != d2
            or not 1 <= d <= D_MAX or not wins.is_contiguous()):
        raise ValueError("descriptor_accumulate: wins must be contiguous "
                         f"(K, 2, d, d) float32 with d <= {D_MAX}")
    if (scal.device != wins.device or scal.dtype != torch.float32
            or scal.shape != (K, N_SCAL) or not scal.is_contiguous()):
        raise ValueError("descriptor_accumulate: scal must be a contiguous "
                         f"(K, {N_SCAL}) float32 tensor on {wins.device}")
    out = torch.empty((K, N_PEAKS, 128), dtype=torch.float32,
                      device=wins.device)
    if K == 0:
        return out
    rc = _fn()(wins.data_ptr(), scal.data_ptr(), K, d, out.data_ptr(),
               torch.cuda.current_stream(wins.device).cuda_stream)
    build.check(rc, "descriptor_accumulate")
    LAUNCHES += 1
    return out
