"""Parity mode's ordered descriptor walk (`kernels/cuda/parity_scan.py`) and the
batched parity pass, on the CPU.

The kernel (`csrc/parity_scan.cu`) runs only on the card, where
`chip_smoke.py` holds it against `parity_scan_plain` bit for bit. Here:
(a) the kernel's visiting order, plane by plane and stable within each
(`plane_order`), emulated with the plain pieces, gives the canonical
loop's bits on tables built to make order matter; (b) parity
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


def _plane_walk(maps, wtl, ori, table, reverse=False):
    """The kernel's walk with the plain pieces: plane after plane, each
    plane's slots in `plane_order`'s order (reversed if asked)."""
    order, starts = ps.plane_order(table, (O, LG, HM, WM))
    seen = torch.zeros((B, N, 2, WIN, WIN))
    for p in range(B * O * LG):
        b, go, gl = p // (O * LG), p // LG % O, p % LG
        slots = order[starts[p]:starts[p + 1]].tolist()
        for s in (slots[::-1] if reverse else slots):
            bb, n = divmod(s, N)
            go_s, gl_s, y0, x0, ok = table[bb, n].tolist()
            assert (bb, go_s, gl_s, ok) == (b, go, gl, 1)
            window = maps[b, go, gl, :, y0:y0 + WIN, x0:x0 + WIN]
            window[0] += wtl[b, go, gl]
            window[1] += ori[b, n]
            seen[b, n] = window
    return seen


@pytest.mark.parametrize("seed", [0, 1])
def test_plane_order_walk_equals_canonical_loop(seed):
    maps, wtl, ori, table = _scan_inputs(seed)
    ok = table[..., 4].numpy().astype(bool)
    order, starts = ps.plane_order(table, (O, LG, HM, WM))
    # the planes' segments hold every ok slot once and none other
    assert int(starts[-1]) == ok.sum()
    assert sorted(order[:int(starts[-1])].tolist()) == \
        np.flatnonzero(ok.reshape(-1)).tolist()
    want_maps = maps.clone()
    want = ps.parity_scan_plain(want_maps, wtl, ori, table)
    got_maps = maps.clone()
    got = _plane_walk(got_maps, wtl, ori, table)
    assert np.array_equal(_bits(got), _bits(want))
    assert np.array_equal(_bits(got_maps), _bits(want_maps))
    assert (got.reshape(B, N, -1)[~torch.from_numpy(ok)] == 0).all()
    # the wrapper runs the plain walk on a CPU tensor
    cpu_maps = maps.clone()
    assert np.array_equal(_bits(ps.parity_scan(cpu_maps, wtl, ori, table)),
                          _bits(want))
    # the tables make order matter: the walk reversed within each plane
    # gives other bits
    rev = _plane_walk(maps.clone(), wtl, ori, table, reverse=True)
    assert not np.array_equal(_bits(rev), _bits(want))


def test_plane_order_leaves_out_slots_past_the_maps():
    """A slot whose plane or window lies outside the maps is in no plane's
    segment (the kernel never writes past the maps); the others keep
    their order."""
    _, _, _, table = _scan_inputs(3)
    bad = table.clone()
    bad[0, 5, 0], bad[1, 7, 1], bad[2, 9, 2], bad[0, 11, 3] = O, -1, HM, -2
    bad[:, 5:12:2, 4] = 1
    order, starts = ps.plane_order(bad, (O, LG, HM, WM))
    walked = set(order[:int(starts[-1])].tolist())
    assert not walked & {5, N + 7, 2 * N + 9, 11}
    ok = bad[..., 4].reshape(-1).numpy().astype(bool)
    ok[[5, N + 7, 2 * N + 9, 11]] = False
    assert walked == set(np.flatnonzero(ok).tolist())


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
