"""Whole parity-mode and subpixel extraction of the PyTorch port (plain path
on the CPU): the reference goldens without JAX, and the JAX package's
`extract` / `extract_batch` on seeded frames.

Parity keypoints are never moved and come out in canonical order, so the
two packages agree slot for slot: positions, octave, level and validity
bit for bit, scale to 1e-4, descriptors to 2e-3. Lowe with `subpixel`
moves keypoints by the refine walk on a 2x bilinear frame; on these
frames no keypoint sits on a near tie, so its slots agree too, positions
and scale to 1e-4, descriptors to 2e-3.
"""

import dataclasses
import functools
import os

import numpy as np
import pytest
import scipy.ndimage as ndi

import jax
import jax.numpy as jnp

from sift_tpu.config import SiftConfig as JaxSiftConfig
from sift_tpu.frontend.sift import extract as jax_extract
from sift_tpu.frontend.sift import extract_batch as jax_extract_batch

from sift_tpu_torch import SiftConfig, config_from_dict, extract, extract_batch

_PARITY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "parity")

# Configs, caps and criteria of tests/parity/test_golden.py and
# test_golden_grid.py.
REFSIM_CASES = [("s0_sub0", False), ("s1_sub0", False), ("s5_sub1", True)]
GRID_CASES = ["d4", "d5", "o2", "o5", "s10", "s20", "k12", "real_sub",
              "real_d4", "d4_o5"]
GRID_CAPS = {"real_sub": 4096, "real_d4": 2048, "d4_o5": 2048}


def golden_cases():
    """(name, image, golden keypoint rows, golden descriptors, config) of
    every golden case."""
    out = []
    z = np.load(os.path.join(_PARITY, "golden_refsim.npz"))
    for key, sub in REFSIM_CASES:
        cfg = SiftConfig(mode="parity", subpixel=sub,
                         max_keypoints_per_octave=256, max_keypoints=1024)
        out.append((key, z[f"{key}_img"], z[f"{key}_kp"], z[f"{key}_desc"],
                    cfg))
    z = np.load(os.path.join(_PARITY, "golden_grid.npz"))
    for key in GRID_CASES:
        sigma, k, octaves, dogs, subpixel = z[f"{key}_params"]
        cap = GRID_CAPS.get(key, 1024)
        cfg = SiftConfig(mode="parity", sigma=float(sigma), k=float(k),
                         octaves=int(octaves), dogs_per_epoch=int(dogs),
                         subpixel=bool(subpixel),
                         max_keypoints_per_octave=cap, max_keypoints=4 * cap)
        out.append((key, z[f"{key}_img"], z[f"{key}_kp"], z[f"{key}_desc"],
                    cfg))
    return out


def by_key(kp):
    """{(octave, level, x, y): (scale, desc)} of the valid slots of a
    numpy `Keypoints`."""
    return {(int(kp.octave[i]), int(kp.level[i]), int(kp.x[i]),
             int(kp.y[i])): (float(kp.scale[i]), kp.desc[i])
            for i in np.flatnonzero(kp.valid)}


@pytest.mark.parametrize("case", golden_cases(), ids=lambda c: c[0])
def test_parity_matches_golden(case):
    key, img, want_kp, want_desc, cfg = case
    kp = extract(img, cfg, device="cpu").to_numpy()
    assert int(kp.n_dropped) == 0, "golden cases must not truncate"
    ours = by_key(kp)
    theirs = {(int(r[0]), int(r[1]), int(r[2]), int(r[3])): (r[4], d)
              for r, d in zip(want_kp, want_desc)}
    assert set(ours) == set(theirs), (
        f"{key}: ours-only={sorted(set(ours) - set(theirs))[:8]} "
        f"golden-only={sorted(set(theirs) - set(ours))[:8]}")
    assert len(theirs) > 0
    for k in theirs:
        np.testing.assert_allclose(ours[k][0], theirs[k][0], atol=1e-4)
        np.testing.assert_allclose(ours[k][1], theirs[k][1], rtol=1e-3,
                                   atol=2e-3)


def _frames(seed, B=2, H=64, W=80, size=(3, 5)):
    rng = np.random.default_rng(seed)
    imgs = [ndi.uniform_filter(rng.uniform(0, 255, (H, W)), s) for s in size]
    imgs = [(i - i.min()) / (i.max() - i.min()) * 255.0 for i in imgs[:B]]
    return np.stack(imgs).astype(np.float32)


PARITY_KW = dict(mode="parity", max_keypoints_per_octave=1024,
                 max_keypoints=1536)


@pytest.fixture(scope="module", params=[False, True], ids=["sub0", "sub1"])
def parity_both(request):
    jcfg = JaxSiftConfig(subpixel=request.param, **PARITY_KW)
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    imgs = _frames(1, H=48 if request.param else 64,
                   W=56 if request.param else 80)
    run = jax.jit(functools.partial(jax_extract, cfg=jcfg))
    want = [jax.tree.map(np.asarray, run(jnp.asarray(im))) for im in imgs]
    got = extract_batch(imgs, cfg, device="cpu").to_numpy()
    return imgs, cfg, got, want


def test_parity_extract_slot_equal_to_jax(parity_both):
    _, _, got, want = parity_both
    for i, w in enumerate(want):
        assert w.valid.sum() > 10
        for f in ("x", "y", "octave", "level", "valid", "n_dropped"):
            np.testing.assert_array_equal(getattr(got, f)[i], getattr(w, f),
                                          err_msg=f)
        np.testing.assert_allclose(got.scale[i], w.scale, rtol=0, atol=1e-4)
        np.testing.assert_allclose(got.score[i], w.score, rtol=0, atol=1e-4)
        assert np.isnan(got.orientation[i]).all()
        v = w.valid
        np.testing.assert_allclose(got.desc[i][v], w.desc[v], rtol=0,
                                   atol=2e-3)
    assert got.n_cand_pruned is None


def test_parity_batch_equals_single_images(parity_both):
    imgs, cfg, got, _ = parity_both
    one = extract(imgs[1], cfg, device="cpu").to_numpy()
    for f in ("x", "y", "octave", "level", "scale", "valid", "desc",
              "n_dropped"):
        np.testing.assert_array_equal(getattr(one, f), getattr(got, f)[1],
                                      err_msg=f)


def test_parity_truncation_counts_dropped():
    """More survivors than `max_keypoints`: the canonical order keeps the
    first, and `n_dropped` counts the rest, as in JAX."""
    img = _frames(2, B=1)[0]
    jcfg = JaxSiftConfig(mode="parity", max_keypoints_per_octave=1024,
                         max_keypoints=24)
    want = jax.tree.map(np.asarray, jax.jit(functools.partial(
        jax_extract, cfg=jcfg))(jnp.asarray(img)))
    got = extract(img, config_from_dict(dataclasses.asdict(jcfg)),
                  device="cpu").to_numpy()
    assert int(want.n_dropped) > 0
    for f in ("x", "y", "octave", "level", "valid", "n_dropped"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)


@pytest.fixture(scope="module")
def subpixel_both():
    jcfg = JaxSiftConfig(subpixel=True, max_keypoints_per_octave=256,
                         max_keypoints=384)
    imgs = _frames(3, H=48, W=64, size=(4, 6))
    run = jax.jit(functools.partial(jax_extract_batch, cfg=jcfg))
    want = jax.tree.map(np.asarray, run(jnp.asarray(imgs)))
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    got = extract_batch(imgs, cfg, device="cpu").to_numpy()
    return got, want


def test_lowe_subpixel_matches_jax(subpixel_both):
    got, want = subpixel_both
    assert want.valid.sum(axis=1).min() > 10
    for f in ("valid", "octave", "level", "n_dropped", "n_cand_pruned"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    v = want.valid
    np.testing.assert_allclose(got.x[v], want.x[v], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.y[v], want.y[v], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.scale[v], want.scale[v], rtol=0, atol=1e-4)
    dori = np.abs((got.orientation[v] - want.orientation[v] + 180.0)
                  % 360.0 - 180.0)
    assert dori.max() < 1e-2
    np.testing.assert_allclose(got.desc[v], want.desc[v], rtol=0, atol=2e-3)
