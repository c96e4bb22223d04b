"""Streaming masked top-2: hand CUDA kernel (`csrc/match.cu`) and its plain
version.

Replaces the TPU kernel `sift_tpu/kernels/pallas/match.py::streaming_top2`.
Per row of A, the (best, second, argbest) squared L2 distance over the rows
of B, invalid rows and columns pushed to ~1e30 by a penalty folded into the
norms, without building the (Na, Nb) distance matrix. Bound on the H100 by
operations: 2*Na*Nb*D f32 FLOP, 17.2 GFLOP per pass at 8192 x 8192 x 128.

The kernel sums each dot product in its own order with fused multiply-adds,
so its distances agree with the plain version to f32 rounding of the norm
terms (`RTOL` of an + bn), and its argbest equals the plain one wherever
the plain `second - best` is wider than that.

On a CUDA tensor `streaming_top2` launches the kernel (or raises); on a CPU
tensor it runs `streaming_top2_plain`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from sift_tpu_torch.kernels import build

BIG = 1e30          # masking penalty; never inf (inf - inf is NaN)
RTOL = 1e-5         # |kernel - plain| <= RTOL * (an + bn) on best and second
_DEPTH = 16         # the kernel stages D in slices of this depth
_ROWS = 128         # rows of A per block
_COLS = 128         # columns of B per tile
LAUNCHES = 0


def masked_norms(desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """|desc_i|^2 + (0 if valid_i else BIG), float32."""
    d = desc.to(torch.float32)
    pen = torch.where(valid, 0.0, BIG).to(torch.float32)
    return (d * d).sum(dim=1) + pen


def streaming_top2_plain(desc_a: torch.Tensor, valid_a: torch.Tensor,
                         desc_b: torch.Tensor, valid_b: torch.Tensor):
    """Masked per-row (best (Na,), second (Na,), best_idx (Na,) int32) of
    d = max(an + bn - 2 a.b, 0), dense. best_idx is the first column
    attaining the minimum; second is the minimum over the other columns.
    Rows with no valid candidate have best >= 1e29."""
    a = desc_a.to(torch.float32)
    b = desc_b.to(torch.float32)
    an = masked_norms(a, valid_a)
    bn = masked_norms(b, valid_b)
    d = torch.clamp_min(an[:, None] + bn[None, :] - 2.0 * (a @ b.T), 0.0)
    arg = torch.argmin(d, dim=1)
    best = d.gather(1, arg[:, None])[:, 0]
    second = d.scatter(1, arg[:, None], float("inf")).amin(dim=1)
    return best, second, arg.to(torch.int32)


@functools.cache
def _fn():
    fn = build.library("match").sift_streaming_top2
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, i, i, i, i, p, p, p, p, p, p, p]
    fn.restype = i
    return fn


def _splits(na: int, nb: int, device: torch.device) -> int:
    """Column ranges per row block: enough blocks for two per SM."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    row_blocks = -(-na // _ROWS)
    return max(1, min(-(-nb // _COLS), (2 * sms) // row_blocks))


def streaming_top2(desc_a: torch.Tensor, valid_a: torch.Tensor,
                   desc_b: torch.Tensor, valid_b: torch.Tensor):
    """See `streaming_top2_plain`."""
    if not desc_a.is_cuda:
        return streaming_top2_plain(desc_a, valid_a, desc_b, valid_b)
    global LAUNCHES
    dev = desc_a.device
    if desc_a.dim() != 2 or desc_b.dim() != 2:
        raise ValueError("streaming_top2: descriptors must be (N, D)")
    (Na, D), Nb = desc_a.shape, desc_b.shape[0]
    for name, t in (("desc_a", desc_a), ("desc_b", desc_b)):
        if (t.device != dev or t.dtype != torch.float32
                or not t.is_contiguous() or t.shape[1] != D
                or t.data_ptr() % 16):
            raise ValueError(f"streaming_top2: {name} must be a contiguous, "
                             f"16-byte aligned (N, {D}) float32 tensor on {dev}")
    for name, t, n in (("valid_a", valid_a, Na), ("valid_b", valid_b, Nb)):
        if t.device != dev or t.dtype != torch.bool or t.shape != (n,):
            raise ValueError(f"streaming_top2: {name} must be a ({n},) bool "
                             f"tensor on {dev}")
    if D == 0 or D % _DEPTH:
        raise ValueError(f"streaming_top2: D={D} must be a positive multiple "
                         f"of {_DEPTH}")
    best = torch.empty((Na,), dtype=torch.float32, device=dev)
    second = torch.empty_like(best)
    arg = torch.empty((Na,), dtype=torch.int32, device=dev)
    if Na == 0:
        return best, second, arg
    if Nb == 0:
        raise ValueError("streaming_top2: desc_b has no rows")
    an = masked_norms(desc_a, valid_a)
    bn = masked_norms(desc_b, valid_b)
    splits = _splits(Na, Nb, dev)
    pbest = torch.empty((splits, Na), dtype=torch.float32, device=dev)
    psecond = torch.empty_like(pbest)
    parg = torch.empty((splits, Na), dtype=torch.int32, device=dev)
    rc = _fn()(desc_a.data_ptr(), an.data_ptr(), desc_b.data_ptr(),
               bn.data_ptr(), Na, Nb, D, splits, pbest.data_ptr(),
               psecond.data_ptr(), parg.data_ptr(), best.data_ptr(),
               second.data_ptr(), arg.data_ptr(),
               torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "streaming_top2")
    LAUNCHES += 1
    return best, second, arg
