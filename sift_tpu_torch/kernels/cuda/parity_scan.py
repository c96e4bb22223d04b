"""The ordered descriptor-stage walk of parity mode: hand CUDA kernel
(`csrc/parity_scan.cu`) and its plain version.

Replaces no TPU kernel: the JAX package carries this walk as the pyramids
of a `lax.scan` over the keypoints (`sift_tpu/frontend/parity.py:66-121`).
For each slot with `ok`, in canonical order, the 16x16 window at (y0, x0)
of its plane (b, gauss_o, gauss_l) is added to, in both maps: the
magnitude map gets the plane's `weight_tl`, the orientation map the
slot's orientation. The slot then sees that window after its own add
(`seen`). Later slots whose windows overlap read those writes. Slots
without `ok` write nothing and keep a zero `seen`.

Two planes never share memory, so only the order within a plane matters.
A plane's slots are scattered through the canonical order (the plane is
the nearest Gaussian of the slot's scale, not its octave and level), so
the wrapper stable-sorts the slots by plane and finds each plane's
segment (`plane_order`); the kernel walks each plane in its own block.
Each pixel gets one f32 add a slot in the canonical order, as in the
plain loop, so kernel and plain version are bit-identical (NaN-equal).

On a CUDA tensor `parity_scan` launches the kernel (or raises); on a CPU
tensor it runs `parity_scan_plain`. `LAUNCHES` counts the launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from sift_tpu_torch.kernels import build

WIN = 16          # the parity window's side (2 * orientation.R)
LAUNCHES = 0


def _check(maps, weight_tl, orientation, table) -> None:
    B, N = table.shape[:2]
    ok = (maps.dim() == 6 and maps.shape[3] == 2 and maps.shape[0] == B
          and min(maps.shape[-2:]) >= WIN
          and tuple(weight_tl.shape) == (*maps.shape[:3], WIN, WIN)
          and tuple(orientation.shape) == (B, N)
          and table.dim() == 3 and table.shape[2] == 5
          and table.dtype == torch.int32
          and all(t.dtype == torch.float32 and t.is_contiguous()
                  for t in (maps, weight_tl, orientation))
          and table.is_contiguous()
          and len({t.device for t in (maps, weight_tl, orientation,
                                       table)}) == 1)
    if not ok:
        raise ValueError(
            "parity_scan: expected contiguous maps (B, O, Lg, 2, H, W) f32 "
            "with H, W >= 16, weight_tl (B, O, Lg, 16, 16) f32, orientation "
            "(B, N) f32 and table (B, N, 5) int32 on one device; got "
            f"{tuple(maps.shape)} {maps.dtype}, {tuple(weight_tl.shape)}, "
            f"{tuple(orientation.shape)}, {tuple(table.shape)} {table.dtype}")


def parity_scan_plain(maps: torch.Tensor, weight_tl: torch.Tensor,
                      orientation: torch.Tensor,
                      table: torch.Tensor) -> torch.Tensor:
    """maps: (B, O, Lg, 2, H, W) f32 magnitude and orientation maps,
    MUTATED IN PLACE; weight_tl: (B, O, Lg, 16, 16) f32; orientation: (B,
    N) f32; table: (B, N, 5) int32 rows (gauss_o, gauss_l, y0, x0, ok) in
    canonical order, with 0 <= y0 <= H - 16 and 0 <= x0 <= W - 16.
    Returns seen (B, N, 2, 16, 16): each ok slot's window after its own
    add, zero elsewhere. The walk, one slot after another in canonical
    order, image after image, after one read of the table to the host."""
    B, N = table.shape[:2]
    img = torch.arange(B, device=maps.device)[:, None]
    o, l = table[..., 0].long(), table[..., 1].long()
    addend = torch.stack(
        [weight_tl[img, o, l],
         orientation[..., None, None].expand(B, N, WIN, WIN)], dim=2)
    seen = torch.zeros((B, N, 2, WIN, WIN), dtype=maps.dtype,
                       device=maps.device)
    rows = table.cpu().numpy()
    for b, i in zip(*np.nonzero(rows[..., 4])):
        oi, li, ys, xs = (int(v) for v in rows[b, i, :4])
        window = maps[b, oi, li, :, ys:ys + WIN, xs:xs + WIN]
        window += addend[b, i]
        seen[b, i] = window
    return seen


def plane_order(table: torch.Tensor, shape: tuple) -> tuple:
    """The kernel's visiting order. table: (B, N, 5) as above; shape: the
    maps' (O, Lg, H, W). Returns (order, starts): `order` holds the flat
    slot indices b * N + n, the ok slots first, sorted by plane (b * O +
    gauss_o) * Lg + gauss_l and, within a plane, in canonical order (a
    stable sort), the others after them; plane p's slots are
    order[starts[p]:starts[p + 1]]. A slot whose plane or window lies
    outside the maps is left out, so the kernel never touches memory past
    them (the plain walk raises on it). On the device, no host read."""
    B, N = table.shape[:2]
    O, Lg, H, W = shape
    planes = B * O * Lg
    go, gl, y0, x0, ok = table.unbind(-1)
    inside = ((go >= 0) & (go < O) & (gl >= 0) & (gl < Lg) & (y0 >= 0)
              & (y0 <= H - WIN) & (x0 >= 0) & (x0 <= W - WIN))
    img = torch.arange(B, device=table.device, dtype=torch.int64)[:, None]
    key = (img * O + go) * Lg + gl
    key = torch.where((ok != 0) & inside, key, planes).reshape(B * N)
    sorted_key, order = torch.sort(key, stable=True)
    starts = torch.searchsorted(
        sorted_key, torch.arange(planes + 1, device=table.device,
                                 dtype=torch.int64))
    return order, starts


@functools.cache
def _fn():
    fn = build.library("parity_scan").sift_parity_scan
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, p, p, p, p, p, ll, ll, i, i, p]
    fn.restype = i
    return fn


def parity_scan(maps: torch.Tensor, weight_tl: torch.Tensor,
                orientation: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """See `parity_scan_plain`: the kernel on a CUDA tensor, one launch a
    call; the plain walk on a CPU tensor."""
    _check(maps, weight_tl, orientation, table)
    if not maps.is_cuda:
        return parity_scan_plain(maps, weight_tl, orientation, table)
    global LAUNCHES
    B, O, Lg = maps.shape[:3]
    N = table.shape[1]
    seen = torch.zeros((B, N, 2, WIN, WIN), dtype=maps.dtype,
                       device=maps.device)
    if B * N == 0:
        return seen
    H, W = maps.shape[-2:]
    order, starts = plane_order(table, (O, Lg, H, W))
    # block p walks the slots order[starts[p]:starts[p + 1]]
    rc = _fn()(maps.data_ptr(), weight_tl.data_ptr(), orientation.data_ptr(),
               table.data_ptr(), order.data_ptr(), starts.data_ptr(),
               seen.data_ptr(), B * O * Lg, B * N, H, W,
               torch.cuda.current_stream(maps.device).cuda_stream)
    build.check(rc, "parity_scan")
    LAUNCHES += 1
    return seen
