"""The port's extraction of one image does not depend on its batch.

`extract_batch(..., device="cpu")` on 8 frames made from a numpy seed,
against the same frames at B=1, B=2 and B=4 (every slot of every split):
every field of every image must be equal bit for bit (NaNs in the same
places), in lowe, lowe with `subpixel` and parity mode. This is the JAX
package's batching contract (`tests/unit/test_frontend_batched.py`)
tightened to bit equality: the blur, the bilinear upsampling and the
plain descriptor sum each output in an order fixed by that output's own
inputs, so nothing a slot computes depends on the other slots.

Two sizes: 64x80 and 40x56, whose top octave (5x7 at 4 octaves) is under
every window and walk patch, so the clamped corners and mirror folds of
radii past the plane's size are on the path. B=8 runs at two threads and
the splits at one, so the bits are also held across thread counts (the
CPU splits elementwise work over threads at other places); few threads
keep the file quick when the test runner's workers share the cores.
"""

import numpy as np
import pytest
import scipy.ndimage as ndi

from sift_tpu_torch.config import SiftConfig
from sift_tpu_torch.frontend.sift import extract_batch
from tests.torch_dist_world import (  # noqa: F401
    one_torch_thread, torch_threads)

B = 8
FIELDS = ("x", "y", "octave", "level", "scale", "score", "orientation",
          "valid", "desc", "n_dropped", "n_cand_pruned")
SIZES = {"64x80": (64, 80, 3), "40x56": (40, 56, 4)}
MODES = {
    "lowe": {"mode": "lowe"},
    "subpixel": {"mode": "lowe", "subpixel": True},
    "parity": {"mode": "parity"},
}


def _frames(h, w, seed=11):
    """Box-filtered uniform noise stretched to [0, 255] (as the frames of
    `test_torch_parity_extract.py`), a box of 5 or 7 pixels by turns: blobs
    that every mode finds keypoints on at these sizes."""
    rng = np.random.default_rng(seed)
    imgs = [ndi.uniform_filter(rng.uniform(0, 255, (h, w)), 5 + 2 * (i % 2))
            for i in range(B)]
    return np.stack([(i - i.min()) / (i.max() - i.min()) * 255.0
                     for i in imgs]).astype(np.float32)


def _cfg(mode, size):
    h, w, octaves = SIZES[size]
    return SiftConfig(octaves=octaves, max_keypoints=96,
                      max_keypoints_per_octave=64, **MODES[mode])


def _bits(a):
    """Integer view of a field: floats by their bit pattern with every NaN
    made the same NaN (NaN-equal), the rest as they are."""
    a = np.asarray(a)
    if a.dtype.kind != "f":
        return a
    return np.where(np.isnan(a), np.float32(np.nan), a).view(np.uint32)


@pytest.fixture(scope="module")
def runs(one_torch_thread):
    """{(mode, size): (frames, B=8 extraction at two threads)}, made on
    first use."""
    cache = {}

    def get(mode, size):
        if (mode, size) not in cache:
            h, w, _ = SIZES[size]
            frames = _frames(h, w)
            with torch_threads(2):
                kp = extract_batch(frames, _cfg(mode, size), device="cpu")
            cache[mode, size] = frames, kp.to_numpy()
        return cache[mode, size]
    return get


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("split", [1, 2, 4])
def test_every_field_equal_across_batch_sizes(split, mode, size, runs):
    frames, full = runs(mode, size)
    assert full.valid.sum(axis=1).min() > 0, "an image found no keypoint"
    for s in range(0, B, split):
        part = extract_batch(frames[s:s + split], _cfg(mode, size),
                             device="cpu").to_numpy()
        for f in FIELDS:
            got, want = getattr(part, f), getattr(full, f)
            if want is None:                # parity counts no pruning
                assert got is None, f
                continue
            want = want[s:s + split]
            assert got.shape == want.shape, f
            np.testing.assert_array_equal(
                _bits(got), _bits(want),
                err_msg=f"{f}: images {s}-{s + split - 1} at B={split} "
                        f"against B={B}")
