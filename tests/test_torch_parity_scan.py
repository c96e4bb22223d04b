"""Parity mode's ordered descriptor walk (`kernels/cuda/parity_scan.py`) and the
batched parity pass, on the CPU.

The kernel (`csrc/parity_scan.cu`) runs only on the card, where
`chip_smoke.py` holds it against `parity_scan_plain` bit for bit. Here:
(a) the kernel's walk, the tile lists of `tile_order` walked per pixel
in numpy, gives the canonical loop's bits on tables built to make order
matter and on the tile edges, ragged maps, one shared window, NaN
orientations, slots without ok, slots past the maps and maps of one
window; (b) parity
`extract_batch` at B = 3, one batched pass, against the JAX package's
vmapped `extract_batch` under `test_torch_parity_extract.py`'s criteria;
(c) truncation with a different `n_dropped` for each image, as JAX
counts it.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sift_tpu.config import SiftConfig as JaxSiftConfig
from sift_tpu.frontend.sift import extract_batch as jax_extract_batch

from sift_tpu_torch import config_from_dict, extract_batch
from sift_tpu_torch.frontend import parity
from sift_tpu_torch.kernels.cuda import parity_scan as ps
from tests.test_torch_parity_extract import _frames
from tests.torch_dist_world import one_torch_thread  # noqa: F401

B, O, LG, HM, WM, N = 3, 3, 4, 40, 48, 160
WIN = ps.WIN


def _bits(t: torch.Tensor) -> np.ndarray:
    """f32 bit patterns, every NaN made the same NaN (NaN-equal)."""
    a = t.numpy()
    return np.where(np.isnan(a), np.float32(np.nan), a).view(np.uint32)


def _scan_inputs(seed: int):
    """Maps, weight_tl, orientation and a table in canonical order: slots
    clustered in a corner of few planes (heavy overlap), each slot's plane
    an octave off its own by turns (planes cross octaves), a fifth of them
    without ok, corners clamped to the padded edge. Orientations are
    finite, with some NaN, so that the order of the adds shows in both
    maps."""
    rng = np.random.default_rng(seed)
    kp = dict(octave=rng.integers(0, O, (B, N)).astype(np.int32),
              level=rng.integers(1, LG - 1, (B, N)).astype(np.int32),
              x=rng.integers(0, 30, (B, N)).astype(np.float32),
              y=rng.integers(0, 26, (B, N)).astype(np.float32),
              valid=rng.uniform(size=(B, N)) < 0.8)
    kp = {k: v.numpy() for k, v in parity._canonical_sort(
        {k: torch.from_numpy(v) for k, v in kp.items()}).items()}
    go = (kp["octave"] + rng.integers(0, 2, (B, N))) % O
    gl = rng.integers(0, 2, (B, N))
    # corners at x - 8 and y - 8 clamped into the padded maps (at 0 for
    # x, y < 8), and some at the far edges
    y0 = np.clip(kp["y"].astype(np.int32) - 8, 0, HM - WIN)
    x0 = np.clip(kp["x"].astype(np.int32) - 8, 0, WM - WIN)
    y0[:, ::13] = HM - WIN
    x0[:, ::17] = WM - WIN
    table = np.stack([go, gl, y0, x0, kp["valid"]], -1).astype(np.int32)
    maps = (rng.standard_normal((B, O, LG, 2, HM, WM)) * 50).astype(np.float32)
    wtl = rng.uniform(0, 1, (B, O, LG, WIN, WIN)).astype(np.float32)
    ori = rng.uniform(0, 360, (B, N)).astype(np.float32)
    ori[rng.uniform(size=(B, N)) < 0.05] = np.nan
    return [torch.from_numpy(a) for a in (maps, wtl, ori, table)]


def _tile_walk(maps, wtl, ori, table, reverse=False):
    """The kernel's walk emulated in numpy, on lists built by the
    package's `tile_order`: list after list, the tile's pixels loaded once
    (the threads' registers), each entry added where its window covers a
    pixel and the sums written to seen, the pixels written back at the
    end; each list's entries reversed if asked. MUTATES maps."""
    B, O, Lg, _, H, W = maps.shape
    N = table.shape[1]
    T = ps.TILE
    TY, TX = -(-H // T), -(-W // T)
    order, keys, starts, count = (a.numpy() for a in ps.tile_order(
        table, (O, Lg, H, W)))
    m = maps.numpy().reshape(B * O * Lg, 2, H, W)          # a view
    w = wtl.numpy().reshape(B * O * Lg, WIN, WIN)
    o, rows = ori.numpy().reshape(-1), table.numpy().reshape(-1, 5)
    seen = np.zeros((B * N, 2, WIN, WIN), np.float32)
    ty, tx = np.divmod(np.arange(T * T), T)
    for k in range(int(count)):
        plane, tile = divmod(int(keys[starts[k]]), TY * TX)
        y, x = tile // TX * T + ty, tile % TX * T + tx
        y, x = y[(y < H) & (x < W)], x[(y < H) & (x < W)]
        reg = m[plane][:, y, x].copy()                      # (2, pixels)
        entries = order[starts[k]:starts[k + 1]]
        assert (keys[starts[k]:starts[k + 1]] == keys[starts[k]]).all()
        for e in (entries[::-1] if reverse else entries):
            s = int(e) >> 2
            go, gl, y0, x0, ok = rows[s]
            assert ok and (s // N * O + go) * Lg + gl == plane
            dy, dx = y - y0, x - x0
            cov = (dy >= 0) & (dy < WIN) & (dx >= 0) & (dx < WIN)
            assert cov.any()
            reg[0, cov] += w[plane, dy[cov], dx[cov]]
            reg[1, cov] += o[s]
            seen[s, :, dy[cov], dx[cov]] = reg[:, cov].T
        m[plane][:, y, x] = reg
    return torch.from_numpy(seen.reshape(B, N, 2, WIN, WIN))


def _lists_hold_each_window(table, shape):
    """The lists hold each ok slot inside the maps once for every tile
    its window overlaps, and no other slot; each tile is one list."""
    order, keys, starts, count = ps.tile_order(table, shape)
    tile = ps.TILE
    n = int(count)
    assert len(set(keys[starts[:n]].tolist())) == n
    O, Lg, H, W = shape
    go, gl, y0, x0, ok = table.reshape(-1, 5).numpy().T
    inside = ((go >= 0) & (go < O) & (gl >= 0) & (gl < Lg) & (y0 >= 0)
              & (y0 <= H - WIN) & (x0 >= 0) & (x0 <= W - WIN))
    tiles = ((1 + (y0 // tile != (y0 + WIN - 1) // tile))
             * (1 + (x0 // tile != (x0 + WIN - 1) // tile)))
    want = np.where((ok != 0) & inside, tiles, 0)
    got = np.bincount(order[:int(starts[n])].numpy() >> 2,
                      minlength=want.size)
    np.testing.assert_array_equal(got, want)


def _walks_agree(maps, wtl, ori, table, plain_table=None):
    """The tile walk and the canonical loop (on `plain_table`, the same
    table unless given) give the same bits, seen and maps."""
    _lists_hold_each_window(table, (*maps.shape[1:3], *maps.shape[-2:]))
    want_maps = maps.clone()
    want = ps.parity_scan_plain(want_maps, wtl, ori,
                                table if plain_table is None else plain_table)
    got_maps = maps.clone()
    got = _tile_walk(got_maps, wtl, ori, table)
    assert np.array_equal(_bits(got), _bits(want))
    assert np.array_equal(_bits(got_maps), _bits(want_maps))
    return want


@pytest.mark.parametrize("seed", [0, 1])
def test_plane_order_walk_equals_canonical_loop(seed):
    """The tile lists, sorted by plane and then tile, walked per pixel
    give the canonical loop's bits on tables built to make order
    matter."""
    maps, wtl, ori, table = _scan_inputs(seed)
    ok = table[..., 4].numpy().astype(bool)
    want = _walks_agree(maps, wtl, ori, table)
    assert (want.reshape(B, N, -1)[~torch.from_numpy(ok)] == 0).all()
    # the wrapper runs the plain walk on a CPU tensor
    cpu_maps = maps.clone()
    assert np.array_equal(_bits(ps.parity_scan(cpu_maps, wtl, ori, table)),
                          _bits(want))
    # the tables make order matter: each list walked backwards gives
    # other bits
    rev = _tile_walk(maps.clone(), wtl, ori, table, reverse=True)
    assert not np.array_equal(_bits(rev), _bits(want))


def test_plane_order_leaves_out_slots_past_the_maps():
    """A slot whose plane or window lies outside the maps is in no tile's
    list (the kernel never writes past the maps); the others keep
    their order."""
    _, _, _, table = _scan_inputs(3)
    bad = table.clone()
    bad[0, 5, 0], bad[1, 7, 1], bad[2, 9, 2], bad[0, 11, 3] = O, -1, HM, -2
    bad[:, 5:12:2, 4] = 1
    order, _, starts, count = ps.tile_order(bad, (O, LG, HM, WM))
    walked = set((order[:int(starts[int(count)])] >> 2).tolist())
    assert not walked & {5, N + 7, 2 * N + 9, 11}
    ok = bad[..., 4].reshape(-1).numpy().astype(bool)
    ok[[5, N + 7, 2 * N + 9, 11]] = False
    assert walked == set(np.flatnonzero(ok).tolist())
    _lists_hold_each_window(bad, (O, LG, HM, WM))


def _case_inputs(case: str):
    """Maps, weight_tl, orientation and a table of B = 3 images for one
    case of the tile walk, with the table the canonical loop takes (None:
    the same)."""
    rng = np.random.default_rng(sum(map(ord, case)))
    H, W = {"ragged": (45, 53), "smallest": (WIN, WIN)}.get(case, (HM, WM))
    n = 120
    go, gl = rng.integers(0, O, (B, n)), rng.integers(0, LG, (B, n))
    ok = rng.uniform(size=(B, n)) < (0.5 if case == "not_ok" else 1.0)
    # corners on tile edges (multiples of 16), and 1-15 past one
    edge_y = rng.integers(0, (H - WIN) // 16 + 1, (B, n)) * 16
    edge_x = rng.integers(0, (W - WIN) // 16 + 1, (B, n)) * 16
    off_y, off_x = (np.where(v > hi, v - 16, v) for v, hi in (
        (edge_y + rng.integers(1, 16, (B, n)), H - WIN),
        (edge_x + rng.integers(1, 16, (B, n)), W - WIN)))
    free_y = rng.integers(0, H - WIN + 1, (B, n))
    free_x = rng.integers(0, W - WIN + 1, (B, n))
    if case == "edge":           # one tile edge crossed, by turns y or x
        by_y = rng.uniform(size=(B, n)) < 0.5
        y0, x0 = np.where(by_y, off_y, edge_y), np.where(by_y, edge_x, off_x)
    elif case == "corner":       # a tile corner inside every window
        y0, x0 = off_y, off_x
    elif case == "ragged":       # the far edges of maps of 45 x 53
        y0 = np.where(rng.uniform(size=(B, n)) < 0.5, H - WIN, free_y)
        x0 = np.where(rng.uniform(size=(B, n)) < 0.5, W - WIN, free_x)
    elif case == "one_window":   # every slot on one window, of one plane
        go[:], gl[:], y0, x0 = 1, 2, np.full((B, n), 9), np.full((B, n), 21)
    else:
        y0, x0 = free_y, free_x
    table = np.stack([go, gl, y0, x0, ok], -1).astype(np.int32)
    maps = (rng.standard_normal((B, O, LG, 2, H, W)) * 50).astype(np.float32)
    wtl = rng.uniform(0, 1, (B, O, LG, WIN, WIN)).astype(np.float32)
    ori = rng.uniform(0, 360, (B, n)).astype(np.float32)
    ori[rng.uniform(size=(B, n)) < (0.3 if case == "nan" else 0.0)] = np.nan
    plain = None
    if case == "past":           # planes and windows past the maps, ok
        bad = rng.uniform(size=(B, n)) < 0.3
        field = rng.integers(0, 4, (B, n))
        past = np.array([O, LG, H - WIN + 1, W - WIN + 1])[field]
        past = np.where(rng.uniform(size=(B, n)) < 0.5, past, -1)
        plain = table.copy()
        plain[..., 4] &= ~bad
        table[bad, field[bad]] = past[bad]
        plain = torch.from_numpy(plain)
    return [torch.from_numpy(a) for a in (maps, wtl, ori, table)] + [plain]


@pytest.mark.parametrize("case", ["edge", "corner", "ragged", "one_window",
                                  "nan", "not_ok", "past", "smallest"])
def test_tile_walk_equals_canonical_loop(case):
    """The tile walk per pixel against the canonical loop, bit for bit
    (NaN-equal), on windows across one tile edge or a tile corner, maps
    whose sides are multiples of no tile, every slot on one window (the
    longest lists), NaN orientations, slots without ok, slots past the
    maps (the loop walks the table without them), and maps of the
    smallest side the kernel takes, one window (every slot on it, one
    tile a plane)."""
    maps, wtl, ori, table, plain = _case_inputs(case)
    want = _walks_agree(maps, wtl, ori, table, plain)
    if case == "one_window":
        order, keys, starts, count = ps.tile_order(
            table, (O, LG, *maps.shape[-2:]))
        assert int(count) == 4 * B                 # 4 tiles an image
        assert (starts[1:5] - starts[:4]).tolist() == [120] * 4
    if case == "nan":
        assert want[:, :, 1].isnan().any()
    if case == "smallest":
        _, _, _, count = ps.tile_order(table, (O, LG, WIN, WIN))
        assert int(count) == len(set(
            (np.arange(B)[:, None] * O * LG + table[..., 0].numpy() * LG
             + table[..., 1].numpy())[table[..., 4].numpy() != 0].tolist()))


def test_scan_refuses_what_it_cannot_take():
    maps, wtl, ori, table = _scan_inputs(2)
    for args in ((maps.double(), wtl, ori, table),
                 (maps, wtl, ori, table.long()),
                 (maps[..., :12, :], wtl, ori, table),
                 (maps, wtl[:, :1], ori, table)):
        with pytest.raises(ValueError, match="parity_scan"):
            ps.parity_scan(*args)


PARITY_KW = dict(mode="parity", max_keypoints_per_octave=1024)


def _both(jcfg, imgs):
    run = jax.jit(functools.partial(jax_extract_batch, cfg=jcfg))
    want = jax.tree.map(np.asarray, run(jnp.asarray(imgs)))
    got = extract_batch(imgs, config_from_dict(dataclasses.asdict(jcfg)),
                        device="cpu").to_numpy()
    return got, want


@pytest.mark.parametrize("subpixel", [False, True], ids=["sub0", "sub1"])
def test_batched_parity_equals_jax_vmap(subpixel):
    """One batched pass at B = 3 against JAX's vmap of one program, slot
    for slot (`test_parity_extract_slot_equal_to_jax`'s criteria)."""
    imgs = _frames(4, B=3, H=56 if subpixel else 96,
                   W=64 if subpixel else 120, size=(3, 5, 4))
    got, want = _both(JaxSiftConfig(subpixel=subpixel, max_keypoints=1536,
                                    **PARITY_KW), imgs)
    assert want.valid.sum(axis=1).min() > 10
    for f in ("x", "y", "octave", "level", "valid", "n_dropped"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    np.testing.assert_allclose(got.scale, want.scale, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.score, want.score, rtol=0, atol=1e-4)
    assert np.isnan(got.orientation).all()
    v = want.valid
    np.testing.assert_allclose(got.desc[v], want.desc[v], rtol=0, atol=2e-3)
    assert got.n_cand_pruned is None


def test_batched_truncation_counts_dropped_per_image():
    """More survivors than `max_keypoints` in every image, each by another
    count: the canonical order keeps each image's first, and `n_dropped`
    counts the rest per image, as JAX's vmap does."""
    imgs = _frames(4, B=3, size=(3, 5, 4))
    got, want = _both(JaxSiftConfig(max_keypoints=24, **PARITY_KW), imgs)
    assert (want.n_dropped > 0).all() and len(set(want.n_dropped)) == 3
    for f in ("x", "y", "octave", "level", "valid", "n_dropped"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    v = want.valid
    np.testing.assert_allclose(got.desc[v], want.desc[v], rtol=0, atol=2e-3)
