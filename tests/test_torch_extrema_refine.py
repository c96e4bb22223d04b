"""Extrema detection and sub-pixel refinement of the PyTorch port, fed the
JAX package's own DoG stacks.

Extrema are exact selections and must agree slot for slot, bit for bit.
The refinement walk repeats the JAX walk's IEEE f32 operations, so its
integer state and the cube it ends on are bit-identical (held against the
Pallas walk kernel run in interpret mode); the refined x, y and scale go
through one more solve whose sum order may differ, so they agree to 1e-5.
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
from sift_tpu.frontend.pyramid import build_pyramid, lowe_sigma_schedule
from sift_tpu.frontend.refine import refine_octave_lowe as jax_refine
from sift_tpu.kernels.pallas.refine import refine_walk_pallas

from sift_tpu_torch.config import SiftConfig
from sift_tpu_torch.frontend.extrema import detect_extrema_octave as port_detect
from sift_tpu_torch.frontend.refine import refine_octave_lowe
from sift_tpu_torch.kernels.cuda.refine import refine_walk_patches_plain


# Compiled once per shape: far quicker than op-by-op dispatch here.
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


def _jax_case(seed, **kw):
    """Configs and the JAX pyramid's DoG stacks (numpy) for two frames."""
    jcfg = JaxSiftConfig(max_keypoints_per_octave=64, **kw)
    dogs = [np.array(d) for d in _jax_dogs(jnp.asarray(_frames(seed)), jcfg)]
    return jcfg, SiftConfig(max_keypoints_per_octave=64, **kw), dogs


def _check_extrema(dogs_per_octave, jcfg, cfg):
    """Slot-by-slot bit equality; returns the candidates pruned by the cap."""
    pruned = 0
    for o, dogs in enumerate(dogs_per_octave):
        got = port_detect(torch.from_numpy(dogs), cfg, o)
        for b in range(dogs.shape[0]):
            want = jax_detect(jnp.asarray(dogs[b]), jcfg, o)
            for name, g, w in zip(("x", "y", "level", "score", "valid",
                                   "n_dropped"), got, want):
                np.testing.assert_array_equal(g[b].numpy(), np.asarray(w),
                                              err_msg=f"{name} octave {o}")
            pruned += int(want[5])
    return pruned


@pytest.mark.parametrize("seed,kw", [(0, {}), (2, {"dogs_per_epoch": 4})])
def test_extrema_bit_exact_on_pyramid(seed, kw):
    jcfg, cfg, dogs = _jax_case(seed, **kw)
    _check_extrema(dogs, jcfg, cfg)


@pytest.mark.parametrize("L", [3, 5])
def test_extrema_cap_and_ties(L):
    """Integer-valued DoG noise: far more candidates than the cap, and many
    equal scores at the cut, where the lower flat index must win."""
    rng = np.random.default_rng(L)
    dogs = [rng.integers(-40, 41, (2, L, 64 >> o, 80 >> o)).astype(np.float32)
            for o in range(2)]
    kw = dict(max_keypoints_per_octave=64, dogs_per_epoch=L, octaves=2)
    assert _check_extrema(dogs, JaxSiftConfig(**kw), SiftConfig(**kw)) > 0


def _refine_both(seed, pallas, **kw):
    jcfg, cfg, dogs_per_octave = _jax_case(seed, **kw)
    jcfg = jcfg.replace(pallas=pallas)
    octave_factor = cfg.k ** (cfg.dogs_per_epoch - 1)
    _, dog_sigmas, _ = lowe_sigma_schedule(jcfg)
    for o, dogs in enumerate(dogs_per_octave):
        cands = [jax_detect(jnp.asarray(dogs[b]), jcfg, o)
                 for b in range(dogs.shape[0])]
        names = ("x", "y", "level", "score", "valid")
        want = [jax_refine(jnp.asarray(dogs[b]), dict(zip(names, c[:5])), jcfg,
                           dog_sigmas, o, octave_factor)
                for b, c in enumerate(cands)]
        cand = {n: torch.from_numpy(np.stack([np.asarray(c[i]) for c in cands]))
                for i, n in enumerate(names)}
        got = refine_octave_lowe(torch.from_numpy(dogs), cand, cfg,
                                 dog_sigmas, o, octave_factor)
        yield o, got, want


@pytest.mark.parametrize("seed,pallas,kw", [(0, "off", {}),
                                            (0, "on", {"octaves": 1}),
                                            (2, "off", {"dogs_per_epoch": 4})])
def test_refine_matches_jax(seed, pallas, kw):
    n_valid = 0
    for o, got, want in _refine_both(seed, pallas, **kw):
        for b, w in enumerate(want):
            v = np.asarray(w["valid"])
            np.testing.assert_array_equal(got["valid"][b].numpy(), v)
            np.testing.assert_array_equal(got["level"][b].numpy(),
                                          np.asarray(w["level"]))
            for f in ("x", "y", "scale"):
                np.testing.assert_allclose(got[f][b].numpy()[v],
                                           np.asarray(w[f])[v], rtol=0,
                                           atol=1e-5, err_msg=f"{f} octave {o}")
            np.testing.assert_array_equal(
                np.floor(got["x"][b].numpy()[v] + 0.5),
                np.floor(np.asarray(w["x"])[v] + 0.5))
            n_valid += int(v.sum())
    assert n_valid > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_walk_matches_pallas_walk(seed):
    """The walk kernel's plain version against the TPU walk kernel."""
    rng = np.random.default_rng(seed)
    K, W = 64, 40
    base = ndi.gaussian_filter(rng.standard_normal((3, W, W)), 1.2)
    dogs = (base * 40).astype(np.float32)
    xi = rng.integers(1, W - 2, K)
    yi = rng.integers(1, W - 2, K)
    x0 = np.clip(xi - 8, 0, W - 16)
    y0 = np.clip(yi - 8, 0, W - 16)
    patches = np.stack([dogs[:, a:a + 16, c:c + 16] for a, c in zip(y0, x0)])
    start = np.stack([xi - x0, yi - y0, np.ones(K, int), 1 - x0,
                      (W - 2) - x0, 1 - y0, (W - 2) - y0,
                      np.zeros(K, int)], axis=1).astype(np.int32)
    cube, walk = refine_walk_patches_plain(torch.from_numpy(patches),
                                           torch.from_numpy(start))
    Kp = 128
    patchT = np.zeros((3 * 256, Kp), np.float32)
    patchT[:, :K] = patches.reshape(K, -1).T
    scal = np.zeros((8, Kp), np.float32)
    scal[:6, :K] = start[:, [0, 1, 3, 4, 5, 6]].T
    out = np.asarray(refine_walk_pallas(jnp.asarray(patchT),
                                        jnp.asarray(scal), True))
    np.testing.assert_array_equal(cube.numpy(), out[:27, :K].T)
    np.testing.assert_array_equal(walk[:, 0].numpy(), out[27, :K])
    np.testing.assert_array_equal(walk[:, 1].numpy(), out[28, :K])
    np.testing.assert_array_equal(walk[:, 3].numpy(), out[29, :K])
