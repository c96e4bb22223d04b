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

Two pixels never interact: what a slot sees at a pixel is the pixel's
first value plus the adds of the earlier slots whose windows cover it,
in canonical order. So the wrapper cuts each plane into 16x16 tiles and
lists, for each tile, the slots whose windows overlap it, in canonical
order (`tile_order`); the kernel walks each list with one thread a pixel
of the tile, the pixel in registers. Each pixel gets one
f32 add a covering slot in the canonical order, as in the plain loop, so
kernel and plain version are bit-identical (NaN-equal).

On a CUDA tensor `parity_scan` launches the kernel (or raises); on a CPU
tensor it runs `parity_scan_plain`. `LAUNCHES` counts the launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from sift_tpu_torch.kernels import build
from sift_tpu_torch.utils.device import constant

WIN = 16          # the parity window's side (2 * orientation.R)
TILE = 16         # the tiles' side, as csrc/parity_scan.cu takes them
BLOCKS_PER_SM = 8  # the kernel's fixed grid: 256 threads a block
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


@functools.lru_cache(maxsize=64)
def _tile_constants(B: int, O: int, Lg: int, H: int, W: int,
                    device: str) -> tuple:
    """`tile_order`'s device constants for one shape, made once."""
    TY, TX = -(-H // TILE), -(-W // TILE)
    i32 = torch.int32
    return (
        # a row (gauss_o, gauss_l, y0, x0, ok) is used where each field
        # lies in [lo, hi): its plane and window inside the maps, and ok
        constant([0, 0, 0, 0, 1], device, i32),
        constant([O, Lg, H - WIN + 1, W - WIN + 1, 2 ** 31 - 1], device,
                 i32),
        # the key of the corner's tile: row // div, dotted with stride,
        # plus the image's first key
        constant([1, 1, TILE, TILE, 1], device, i32),
        constant([Lg * TY * TX, TY * TX, TX, 1, 0], device, i32),
        constant(np.arange(B) * (O * Lg * TY * TX), device, i32)[:, None],
        # entry i = (row, col) of the 2 x 2 tiles from the corner's: its
        # key offset, and which crossings (y, x) it needs
        constant([0, 1, TX, TX + 1], device, i32),
        constant([0, 0, 0, 1, 1, 0, 1, 1], device,
                 torch.bool).reshape(4, 2))


def tile_order(table: torch.Tensor, shape: tuple) -> tuple:
    """The kernel's tile lists. table: (B, N, 5) as above; shape: the
    maps' (O, Lg, H, W). Each plane (b * O + gauss_o) * Lg + gauss_l is
    cut into TILE x TILE tiles, TY = ceil(H / TILE) by TX = ceil(W /
    TILE); an ok slot emits one entry 4 * (b * N + n) + i for each tile
    its window overlaps (i = 2 * row + column of the 2 x 2 tiles at its
    corner's; 1, 2 or 4 entries). Returns (order, keys,
    starts, count): the 4 * B * N entries stable-sorted by their tile's
    int32 key (plane * TY + ty) * TX + tx, so within a tile they keep the
    canonical order, the unused entries (key B * O * Lg * TY * TX) last;
    list k < count is order[starts[k]:starts[k + 1]], all of tile
    keys[starts[k]] (starts has 4 * B * N + 1 places, count is a 0-d
    tensor). A slot whose plane or window lies outside the maps emits
    nothing, so the kernel never touches memory past them (the plain walk
    raises on it). On the device, no host read."""
    B, N = table.shape[:2]
    O, Lg, H, W = shape
    unused = B * O * Lg * -(-H // TILE) * -(-W // TILE)
    if unused >= 2 ** 31:
        raise ValueError(f"parity_scan: {unused} tiles do not fit int32 keys")
    lo, hi, div, stride, first, offset, need = _tile_constants(
        B, O, Lg, H, W, str(table.device))
    # Few operators: the wrapper's host dispatch is most of a call's time.
    use = ((table >= lo) & (table < hi)).all(-1)
    key = (table // div * stride).sum(-1, dtype=torch.int32) + first
    cross = table[..., 2:4] % TILE > TILE - WIN  # into the next (y, x) tile
    hit = (cross[..., None, :] >= need).all(-1) & use[..., None]
    keys, order = torch.sort(torch.where(hit, key[..., None] + offset,
                                         unused).reshape(-1), stable=True)
    # a list's head differs from the entry before it; so does the unused
    # entries' first, which ends the last list (entry 0 differs from the
    # last unless every entry is unused)
    head = keys != keys.roll(1)
    starts = head.nonzero_static(size=keys.numel() + 1,
                                 fill_value=keys.numel()).reshape(-1)
    count = (head & (keys < unused)).sum()
    return order, keys, starts, count


@functools.cache
def _fn():
    fn = build.library("parity_scan").sift_parity_scan
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, p, p, p, p, p, p, p, ll, i, i, i, p]
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
    order, keys, starts, count = tile_order(table, (O, Lg, H, W))
    # a fixed grid: each block takes lists by stride up to `count`, which
    # stays on the device
    sms = torch.cuda.get_device_properties(maps.device).multi_processor_count
    rc = _fn()(maps.data_ptr(), weight_tl.data_ptr(), orientation.data_ptr(),
               table.data_ptr(), order.data_ptr(), keys.data_ptr(),
               starts.data_ptr(), count.data_ptr(), seen.data_ptr(), B * N,
               H, W, min(4 * B * N, BLOCKS_PER_SM * sms),
               torch.cuda.current_stream(maps.device).cuda_stream)
    build.check(rc, "parity_scan")
    LAUNCHES += 1
    return seen
