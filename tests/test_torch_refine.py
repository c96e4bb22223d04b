"""The port's refine walk, which reads each keypoint's (L, 16, 16) patch
straight from the DoG stack, against the JAX package's gathered-patch
walk and against the port's own patch walk.

The walk repeats the JAX walk's IEEE f32 operations and its flat-cell tap
rule (a tap one column past the patch's edge wraps to the neighbouring
row), so cube, position, level and convergence must agree bit for bit on
every slot, padding slots included.
"""

import functools

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

import jax
import jax.numpy as jnp

from sift_tpu.config import SiftConfig as JaxSiftConfig
from sift_tpu.frontend.extrema import detect_extrema_octave
from sift_tpu.frontend.pyramid import build_pyramid
from sift_tpu.frontend.refine import _gather_local_patches
from sift_tpu.kernels.pallas.refine import refine_walk_pallas

from sift_tpu_torch.config import SiftConfig
from sift_tpu_torch.frontend import refine as port_refine
from sift_tpu_torch.frontend.extrema import detect_extrema_octave as port_detect
from sift_tpu_torch.frontend.pyramid import lowe_sigma_schedule
from sift_tpu_torch.kernels.cuda import windows
from sift_tpu_torch.kernels.cuda.refine import (patch_corners, refine_walk,
                                                refine_walk_patches_plain,
                                                refine_walk_plain)

jax_detect = jax.jit(detect_extrema_octave, static_argnums=(1, 2))


@functools.partial(jax.jit, static_argnums=(1,))
def _jax_dogs(imgs, jcfg):
    return build_pyramid(imgs, jcfg).dogs


def _frames(seed, B=2, H=64, W=80):
    rng = np.random.default_rng(seed)
    imgs = [ndi.gaussian_filter(rng.uniform(0, 255, (H, W)), s)
            for s in (1.0, 2.0)[:B]]
    imgs = [(i - i.min()) / (i.max() - i.min()) * 255.0 for i in imgs]
    return np.stack(imgs).astype(np.float32)


def _jax_walk(dogs_b, x, y):
    """The JAX package's walk on one image: patches through the Pallas
    window gather, then the Pallas walk kernel, both in interpret mode.
    Returns cube (K, 27), image x, y and converged (K,)."""
    L, H, W = dogs_b.shape
    K = x.shape[0]
    xi0, yi0 = x.astype(np.int32), y.astype(np.int32)
    x0 = np.clip(xi0 - 8, 0, max(W - 16, 0))
    y0 = np.clip(yi0 - 8, 0, max(H - 16, 0))
    patches = np.asarray(_gather_local_patches(
        jnp.asarray(dogs_b), jnp.asarray(y0), jnp.asarray(x0), "on"))
    Kp = -(-K // 128) * 128
    patchT = np.zeros((L * 256, Kp), np.float32)
    patchT[:, :K] = patches.reshape(K, -1).T
    scal = np.zeros((8, Kp), np.float32)
    scal[:6, :K] = np.stack([xi0 - x0, yi0 - y0, 1 - x0, (W - 2) - x0,
                             1 - y0, (H - 2) - y0])
    out = np.asarray(refine_walk_pallas(jnp.asarray(patchT),
                                        jnp.asarray(scal), True))
    return (out[:27, :K].T, x0 + out[27, :K].astype(np.int32),
            y0 + out[28, :K].astype(np.int32), out[29, :K] > 0.5)


@pytest.mark.parametrize("seed", [0, 1])
def test_walk_matches_jax_walk(seed):
    """Every octave of two frames (64x80 down to 8x10), every candidate
    slot of `detect_extrema_octave`, padding slots included."""
    jcfg = JaxSiftConfig(max_keypoints_per_octave=64)
    n_padding = 0
    for o, dogs in enumerate(_jax_dogs(jnp.asarray(_frames(seed)), jcfg)):
        dogs = np.array(dogs)
        cands = [jax_detect(jnp.asarray(d), jcfg, o) for d in dogs]
        x = np.stack([np.asarray(c[0]) for c in cands])
        y = np.stack([np.asarray(c[1]) for c in cands])
        level = np.stack([np.asarray(c[2]) for c in cands])
        valid = np.stack([np.asarray(c[4]) for c in cands])
        n_padding += int((~valid & (x == 0) & (y == 0)).sum())
        cube, walk = refine_walk_plain(*map(torch.from_numpy,
                                            (dogs, x, y, level)))
        for b in range(dogs.shape[0]):
            want_cube, want_x, want_y, want_conv = _jax_walk(dogs[b], x[b],
                                                             y[b])
            msg = f"octave {o} image {b}"
            np.testing.assert_array_equal(cube[b].numpy(), want_cube, msg)
            np.testing.assert_array_equal(walk[b, :, 0].numpy(), want_x, msg)
            np.testing.assert_array_equal(walk[b, :, 1].numpy(), want_y, msg)
            np.testing.assert_array_equal(walk[b, :, 3].numpy() > 0,
                                          want_conv, msg)
            np.testing.assert_array_equal(walk[b, :, 2].numpy(), 1, msg)
    assert n_padding > 0


def _border_case(seed, B, L, H, W, K=96):
    """Smooth DoG noise on B distinct images, and candidates anywhere,
    a third of them on the four borders and corners."""
    rng = np.random.default_rng(seed)
    dogs = np.stack([ndi.gaussian_filter(rng.standard_normal((L, H, W)),
                                         (0.0, s, s)) * 40
                     for s in rng.uniform(0.8, 1.6, B)]).astype(np.float32)
    x = rng.integers(0, W, (B, K)).astype(np.float32)
    y = rng.integers(0, H, (B, K)).astype(np.float32)
    edge = rng.integers(0, 4, (B, K // 3))
    x[:, :K // 3] = np.where(edge == 0, 0, np.where(edge == 1, W - 1,
                                                    x[:, :K // 3]))
    y[:, :K // 3] = np.where(edge == 2, 0, np.where(edge == 3, H - 1,
                                                    y[:, :K // 3]))
    x[:, -4:] = [0, W - 1, 0, W - 1]
    y[:, -4:] = [0, 0, H - 1, H - 1]
    x[:, K // 3:K // 2] += rng.uniform(0.0, 0.99, (B, K // 2 - K // 3))
    level = rng.integers(1, L - 1, (B, K)).astype(np.int32)
    return dogs, x, y, level


@pytest.mark.parametrize("L,H,W", [
    (4, 40, 48),
    (5, 36, 30),
    (3, 12, 10),      # an octave smaller than the 16x16 patch
    (4, 9, 20),       # short and wide: rows past the bottom read 0
    (3, 16, 16),      # the patch is the whole image
    (7, 20, 24),      # the card kernel's 16-keypoint blocks
    (15, 18, 22),     # the card kernel stages 13 of the 15 levels
])
def test_walk_matches_patch_walk(L, H, W):
    """The DoG-stack walk against cut-out patches (`gather_windows_plain`,
    images as its level axis, as the walk was fed before) walked by
    `refine_walk_patches_plain`, on B=3 distinct images."""
    B = 3
    dogs, x, y, level = map(torch.from_numpy, _border_case(L + H, B, L, H, W))
    K = x.shape[1]
    cube, walk = refine_walk_plain(dogs, x, y, level)
    assert cube.shape == (B, K, 27) and walk.shape == (B, K, 4)
    assert cube.dtype == torch.float32 and walk.dtype == torch.int32

    xi, yi, x0, y0 = (t.reshape(-1) for t in patch_corners(x, y, H, W))
    gl = torch.arange(B, dtype=torch.int32).repeat_interleave(K)
    patches = windows.gather_windows_plain(dogs.transpose(0, 1), gl, y0, x0,
                                           16)
    start = torch.stack([xi - x0, yi - y0, level.reshape(-1), 1 - x0,
                         (W - 2) - x0, 1 - y0, (H - 2) - y0,
                         torch.zeros_like(x0)], dim=1).to(torch.int32)
    want_cube, want = refine_walk_patches_plain(patches, start)
    assert torch.equal(cube.reshape(B * K, 27), want_cube)
    got = walk.reshape(B * K, 4)
    assert torch.equal(got[:, 0], x0 + want[:, 0])
    assert torch.equal(got[:, 1], y0 + want[:, 1])
    assert torch.equal(got[:, 2:], want[:, 2:])
    # The walk stays in the image interior, and the level in [1, L-2].
    assert bool(((got[:, 0] >= 1) & (got[:, 0] <= W - 2)
                 & (got[:, 1] >= 1) & (got[:, 1] <= H - 2)).all())
    assert bool(((got[:, 2] >= 1) & (got[:, 2] <= L - 2)).all())
    if L > 3:
        assert bool((got[:, 2] != level.reshape(-1)).any())


def test_refine_octave_cuts_no_patches(monkeypatch):
    """The refine stage reads the DoG stack itself: no window gather, and
    the wrapper on CPU tensors is its plain version."""
    def refuse(*args, **kwargs):
        raise AssertionError("refine_octave_lowe gathered windows")

    monkeypatch.setattr(windows, "gather_windows", refuse)
    monkeypatch.setattr(windows, "gather_windows_plain", refuse)
    cfg = SiftConfig(max_keypoints_per_octave=64)
    dogs = torch.from_numpy(_border_case(7, 2, 3, 32, 40)[0])
    x, y, level, score, valid, _ = port_detect(dogs, cfg, 0)
    cand = dict(x=x, y=y, level=level, score=score, valid=valid)
    _, dog_sigmas, _ = lowe_sigma_schedule(cfg)
    out = port_refine.refine_octave_lowe(dogs, cand, cfg, dog_sigmas, 0,
                                         cfg.k ** 2)
    assert out["x"].shape == x.shape and bool(valid.any())
    for got, want in zip(refine_walk(dogs, x, y, level),
                         refine_walk_plain(dogs, x, y, level)):
        assert torch.equal(got, want)
