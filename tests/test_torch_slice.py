"""The whole of the port's extraction (`extract_batch`, plain path on the
CPU) against the JAX package's `extract_batch` on two seeded frames.

The pyramids differ only in f32 sum order (about 1e-5), and no keypoint
sits on a knife edge on these frames, so the outputs agree slot for slot:
valid mask, octave and level exactly, positions to 1e-4, descriptors to
6e-3 (the JAX fallback rounds its descriptor operands to bf16).
"""

import dataclasses
import functools

import numpy as np
import pytest
import scipy.ndimage as ndi

import jax
import jax.numpy as jnp

from sift_tpu.config import SiftConfig as JaxSiftConfig
from sift_tpu.frontend.sift import extract_batch as jax_extract_batch

from sift_tpu_torch import config_from_dict, extract, extract_batch
from tests.torch_dist_world import one_torch_thread  # noqa: F401


def _frames(seed, H=96, W=128):
    rng = np.random.default_rng(seed)
    imgs = [ndi.uniform_filter(rng.uniform(0, 255, (H, W)), s) for s in (5, 7)]
    imgs = [(i - i.min()) / (i.max() - i.min()) * 255.0 for i in imgs]
    return np.stack(imgs).astype(np.float32)


@pytest.fixture(scope="module")
def both():
    jcfg = JaxSiftConfig(max_keypoints_per_octave=128, max_keypoints=256)
    imgs = _frames(0)
    run = jax.jit(functools.partial(jax_extract_batch, cfg=jcfg))
    want = jax.tree.map(np.asarray, run(jnp.asarray(imgs)))
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    got = extract_batch(imgs, cfg, device="cpu").to_numpy()
    return imgs, cfg, got, want


def test_masks_and_indices_slot_equal(both):
    _, _, got, want = both
    assert want.valid.sum() > 20
    for f in ("valid", "octave", "level", "n_dropped", "n_cand_pruned"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)


def test_positions_orientations_scales(both):
    _, _, got, want = both
    v = want.valid
    np.testing.assert_allclose(got.x[v], want.x[v], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.y[v], want.y[v], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.scale[v], want.scale[v], rtol=1e-5, atol=0)
    np.testing.assert_allclose(got.score[v], want.score[v], rtol=0, atol=1e-4)
    dori = np.abs((got.orientation[v] - want.orientation[v] + 180.0)
                  % 360.0 - 180.0)
    assert dori.max() < 1e-2


def test_descriptors(both):
    _, _, got, want = both
    v = want.valid
    np.testing.assert_allclose(got.desc[v], want.desc[v], rtol=0, atol=6e-3)


def test_single_image_entry_point(both):
    imgs, cfg, got, _ = both
    one = extract(imgs[1], cfg, device="cpu").to_numpy()
    for f in ("x", "y", "octave", "level", "valid", "desc", "n_dropped"):
        np.testing.assert_array_equal(getattr(one, f), getattr(got, f)[1],
                                      err_msg=f)
