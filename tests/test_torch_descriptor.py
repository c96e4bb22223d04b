"""The port's descriptor path (`descriptors_from_windows_multi`, on the CPU
through the plain version of the descriptor kernel) against the JAX
package's, which runs the Pallas descriptor kernel in interpret mode
(`pallas="on"`), on the edge cases that `chip_smoke.py` holds the CUDA
kernel to: window widths 16 and 48, one keypoint, all-zero windows,
gradients whose angle falls on an orientation-bin edge, and offsets that
put u and v exactly on cell centres and the grid's edges; each with plain
SIFT and RootSIFT normalisation.

Both sides follow the f32 arithmetic of the TPU kernel; they differ by
summation order and atan2/exp, so normalised descriptors agree to 1e-4.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sift_tpu.config import SiftConfig as JaxSiftConfig
from sift_tpu.frontend import windows as jw

from sift_tpu_torch.config import SiftConfig
from sift_tpu_torch.frontend import windows as pw
from sift_tpu_torch.kernels.cuda import descriptor
from tests.torch_dist_world import one_torch_thread  # noqa: F401


def _random(rng, K, d):
    gx = (rng.standard_normal((K, d, d)) * 20).astype(np.float32)
    gy = (rng.standard_normal((K, d, d)) * 20).astype(np.float32)
    oy0 = rng.uniform(-d / 2 - 0.5, -d / 2 + 0.5, K).astype(np.float32)
    ox0 = rng.uniform(-d / 2 - 0.5, -d / 2 + 0.5, K).astype(np.float32)
    oris = rng.uniform(0.0, 360.0, (K, 2)).astype(np.float32)
    sw = rng.uniform(1.6, 3.2, K).astype(np.float32)
    return gx, gy, oy0, ox0, oris, sw


def _case(name, d, seed=0):
    rng = np.random.default_rng(seed)
    if name == "random":
        return _random(rng, 23, d)
    if name == "one_keypoint":
        return _random(rng, 1, d)
    if name == "zero_windows":
        gx, gy, oy0, ox0, oris, sw = _random(rng, 3, d)
        return np.zeros_like(gx), np.zeros_like(gy), oy0, ox0, oris, sw
    K = 16
    if name == "bin_edges":
        # Gradients along +x, +y, -x, -y and peaks every half bin (22.5
        # deg): each angle minus the peak is a bin edge or a bin centre.
        axis = rng.integers(0, 4, (K, d, d))
        mag = rng.uniform(1.0, 50.0, (K, d, d))
        gx = (mag * np.array([1, 0, -1, 0])[axis]).astype(np.float32)
        gy = (mag * np.array([0, 1, 0, -1])[axis]).astype(np.float32)
        oris = (np.stack([np.arange(K), np.arange(K) + 3], 1) % 16
                * 22.5).astype(np.float32)
        off = np.full(K, -d / 2, np.float32)
        return gx, gy, off, off, oris, rng.uniform(1.6, 3.2, K).astype(np.float32)
    if name == "cell_edges":
        # Peak 0 at 0 deg (cos 1, sin 0 exactly), integer offsets and
        # hist_width 3 * sw a power of two: u and v are multiples of
        # 1 / hist_width, so they land on the cell centres (-1.5 .. 1.5)
        # and on the grid's edges (+-2.5).
        gx, gy, _, _, oris, _ = _random(rng, K, d)
        oris[:, 0] = 0.0
        off = np.full(K, -d / 2, np.float32)
        sw = (np.array([2.0, 4.0, 8.0])[np.arange(K) % 3] / 3.0).astype(np.float32)
        assert set((3.0 * sw).tolist()) == {2.0, 4.0, 8.0}
        return gx, gy, off, off, oris, sw
    raise ValueError(name)


CASES = [("random", 48), ("random", 16), ("one_keypoint", 48),
         ("zero_windows", 48), ("bin_edges", 48), ("bin_edges", 16),
         ("cell_edges", 48), ("cell_edges", 16)]


@pytest.mark.parametrize("rootsift", [False, True])
@pytest.mark.parametrize("name,d", CASES)
def test_descriptors_match_jax_pallas(name, d, rootsift):
    gx, gy, oy0, ox0, oris, sw = _case(name, d)
    wins = torch.from_numpy(np.stack([gx, gy], axis=1))
    got = pw.descriptors_from_windows_multi(
        wins, *map(torch.from_numpy, (oy0, ox0, oris, sw)),
        SiftConfig(rootsift=rootsift)).numpy()
    want = np.asarray(jw.descriptors_from_windows_multi(
        *map(jnp.asarray, (gx, gy, oy0, ox0, oris, sw)),
        JaxSiftConfig(rootsift=rootsift), pallas="on"))
    assert got.shape == want.shape == (gx.shape[0], 2, 128)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    if name == "zero_windows":
        assert not got.any() and not want.any()


def test_zero_window_raw_histogram_is_zero():
    gx, gy, oy0, ox0, oris, sw = _case("zero_windows", 48)
    wins = torch.from_numpy(np.stack([gx, gy], axis=1))
    hw = 3.0 * sw
    theta = np.deg2rad(oris)
    scal = np.stack([oy0, ox0, 1.0 / hw,
                     np.cos(theta[:, 0]), np.sin(theta[:, 0]), oris[:, 0] / 45,
                     np.cos(theta[:, 1]), np.sin(theta[:, 1]), oris[:, 1] / 45],
                    axis=1).astype(np.float32)
    raw = descriptor.descriptor_accumulate(wins, torch.from_numpy(scal))
    assert raw.shape == (3, 2, 128) and raw.dtype == torch.float32
    assert not raw.any()
