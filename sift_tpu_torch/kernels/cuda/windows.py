"""Window gather: hand CUDA kernel (`csrc/windows.cu`) and its plain version.

Replaces the TPU kernel `sift_tpu/kernels/pallas/windows.py::
gather_windows_pallas`. Two uses per octave on the main path: the (3, 16,
16) DoG patches of the refinement walk (f32) and the (2, 48, 48) gradient
windows of orientation and descriptors (bf16 maps). Bound on the H100 by
bytes: each window pixel is read once and written once as f32.

On a CUDA tensor `gather_windows` launches the kernel (or raises); on a
CPU tensor it runs `gather_windows_plain`.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from sift_tpu_torch.kernels import build

LAUNCHES = 0


def gather_windows_plain(maps: torch.Tensor, gl: torch.Tensor,
                         y0: torch.Tensor, x0: torch.Tensor,
                         d: int) -> torch.Tensor:
    """(C, L, H, W) maps + (K,) level / top-left -> (K, C, d, d) float32.
    Pixels past the bottom or right edge read 0."""
    mp = F.pad(maps, (0, d, 0, d))
    ar = torch.arange(d, device=maps.device)
    yy = (y0.long()[:, None] + ar)[:, :, None]
    xx = (x0.long()[:, None] + ar)[:, None, :]
    win = mp[:, gl.long()[:, None, None], yy, xx]          # (C, K, d, d)
    return win.permute(1, 0, 2, 3).to(torch.float32).contiguous()


@functools.cache
def _fn():
    fn = build.library("windows").sift_gather_windows
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, i, ll, ll, i, i, i, i, p, p, p, i, i, p, p]
    fn.restype = i
    return fn


def gather_windows(maps: torch.Tensor, gl: torch.Tensor, y0: torch.Tensor,
                   x0: torch.Tensor, d: int) -> torch.Tensor:
    """See `gather_windows_plain`. `maps` may be a strided view as long as
    each (H, W) plane is contiguous (the DoG stack is passed as a
    (level, image) transpose without a copy)."""
    if not maps.is_cuda:
        return gather_windows_plain(maps, gl, y0, x0, d)
    global LAUNCHES
    C, L, H, W = maps.shape
    K = gl.shape[0]
    if maps.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gather_windows: maps dtype {maps.dtype}")
    if maps.stride(3) != 1 or maps.stride(2) != W:
        raise ValueError("gather_windows: each (H, W) plane must be contiguous")
    for name, t in (("gl", gl), ("y0", y0), ("x0", x0)):
        if (t.device != maps.device or t.dtype != torch.int32
                or t.shape != (K,) or not t.is_contiguous()):
            raise ValueError(f"gather_windows: {name} must be a contiguous "
                             f"({K},) int32 tensor on {maps.device}")
    out = torch.empty((K, C, d, d), dtype=torch.float32, device=maps.device)
    if K == 0:
        return out
    rc = _fn()(maps.data_ptr(), int(maps.dtype == torch.bfloat16),
               maps.stride(0), maps.stride(1), C, L, H, W,
               gl.data_ptr(), y0.data_ptr(), x0.data_ptr(), K, d,
               out.data_ptr(), torch.cuda.current_stream(maps.device).cuda_stream)
    build.check(rc, "gather_windows")
    LAUNCHES += 1
    return out
