"""Window gather, orientation and descriptors of the PyTorch port against
the JAX package.

The gather is an exact copy (bf16 widens to f32 exactly), so it must be
bit-identical to the Pallas gather run in interpret mode. Orientation
histograms sum in another order, so peaks agree to 1e-3 degrees. The
port's descriptor follows the f32 arithmetic of the Pallas descriptor
kernel: within 1e-4 of it (interpret mode), and within 6e-3 of the JAX
fallback, which rounds its einsum operands to bf16.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sift_tpu.config import SiftConfig as JaxSiftConfig
from sift_tpu.frontend import windows as jw
from sift_tpu.kernels.pallas.windows import gather_windows_pallas

from sift_tpu_torch.config import SiftConfig
from sift_tpu_torch.frontend import windows as pw
from sift_tpu_torch.kernels.cuda.windows import gather_windows_plain
from tests.torch_dist_world import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("dtype,C,r,shape", [
    ("float32", 3, 8, (12, 14)),        # window larger than the map: zeros
    ("bfloat16", 2, 24, (61, 75)),
])
def test_gather_bit_exact_vs_pallas(dtype, C, r, shape):
    H, W = shape
    d = 2 * r
    rng = np.random.default_rng(d + H)
    K, L = 29, 3
    maps = (rng.standard_normal((C, L, H, W)) * 50).astype(np.float32)
    gl = rng.integers(0, L, K).astype(np.int32)
    y0 = rng.integers(0, max(H - d, 0) + 1, K).astype(np.int32)
    x0 = rng.integers(0, max(W - d, 0) + 1, K).astype(np.int32)
    jmaps = jnp.asarray(maps).astype(dtype)
    want = np.asarray(gather_windows_pallas(
        jmaps, jnp.asarray(gl), jnp.asarray(y0), jnp.asarray(x0), r, True)
    ).astype(np.float32)
    tmaps = torch.from_numpy(maps).to(getattr(torch, dtype))
    got = gather_windows_plain(tmaps, torch.from_numpy(gl),
                               torch.from_numpy(y0), torch.from_numpy(x0), d)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def _gradient_case(seed, K=40, L=4, H=61, W=75):
    rng = np.random.default_rng(seed)
    dx = (rng.standard_normal((L, H, W)) * 20).astype(np.float32)
    dy = (rng.standard_normal((L, H, W)) * 20).astype(np.float32)
    gl = rng.integers(0, L, K).astype(np.int32)
    y = rng.uniform(0, H - 1, K).astype(np.float32)
    x = rng.uniform(0, W - 1, K).astype(np.float32)
    return dx, dy, gl, y, x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gradient_windows_match_jax(dtype):
    dx, dy, gl, y, x = _gradient_case(0)
    gx, gy, oy0, ox0 = jw.gather_gradient_windows(
        *map(jnp.asarray, (dx, dy, gl, y, x)), radius=24, pallas="off",
        dtype=dtype)
    wins, toy0, tox0 = pw.gather_gradient_windows(
        *map(torch.from_numpy, (dx, dy, gl, y, x)), radius=24, dtype=dtype)
    np.testing.assert_array_equal(wins[:, 0].numpy(), np.asarray(gx))
    np.testing.assert_array_equal(wins[:, 1].numpy(), np.asarray(gy))
    np.testing.assert_array_equal(toy0.numpy(), np.asarray(oy0))
    np.testing.assert_array_equal(tox0.numpy(), np.asarray(ox0))


@pytest.mark.parametrize("seed", [0, 1])
def test_orientation_peaks_match_jax(seed):
    rng = np.random.default_rng(seed)
    K, d = 64, 48
    # A weak dominant direction under noise: most windows get one peak,
    # some a second.
    ang = rng.uniform(0, 2 * np.pi, (K, 1, 1))
    gx = (np.cos(ang) * 5 + rng.standard_normal((K, d, d)) * 20).astype(np.float32)
    gy = (np.sin(ang) * 5 + rng.standard_normal((K, d, d)) * 20).astype(np.float32)
    oy0 = rng.uniform(-24.5, -23.5, K).astype(np.float32)
    ox0 = rng.uniform(-24.5, -23.5, K).astype(np.float32)
    sw = rng.uniform(1.6, 3.2, K).astype(np.float32)
    inb = rng.random(K) > 0.1
    want_o, want_v = jax.jit(jw.orientation_from_windows, static_argnums=(6, 7))(
        *map(jnp.asarray, (gx, gy, oy0, ox0, sw, inb)), JaxSiftConfig(), 2)
    got_o, got_v = pw.orientation_from_windows(
        *map(torch.from_numpy, (gx, gy, oy0, ox0, sw, inb)), SiftConfig(), 2)
    want_v = np.asarray(want_v)
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    assert want_v[:, 0].sum() > K // 2 and want_v[:, 1].sum() > 0
    diff = np.abs((got_o.numpy() - np.asarray(want_o) + 180.0) % 360.0 - 180.0)
    assert diff[want_v].max() < 1e-3


def _descriptor_case(seed, K=37, d=48):
    rng = np.random.default_rng(seed)
    gx = rng.standard_normal((K, d, d)).astype(np.float32)
    gy = rng.standard_normal((K, d, d)).astype(np.float32)
    oy0 = rng.uniform(-d / 2 - 0.5, -d / 2 + 0.5, K).astype(np.float32)
    ox0 = rng.uniform(-d / 2 - 0.5, -d / 2 + 0.5, K).astype(np.float32)
    oris = rng.uniform(0.0, 360.0, (K, 2)).astype(np.float32)
    sw = rng.uniform(1.6, 3.2, K).astype(np.float32)
    return gx, gy, oy0, ox0, oris, sw


@pytest.mark.parametrize("seed,d,rootsift", [(0, 48, False), (2, 48, True)])
def test_descriptors_match_jax(seed, d, rootsift):
    gx, gy, oy0, ox0, oris, sw = _descriptor_case(seed, d=d)
    wins = torch.from_numpy(np.stack([gx, gy], axis=1))
    got = pw.descriptors_from_windows_multi(
        wins, *map(torch.from_numpy, (oy0, ox0, oris, sw)),
        SiftConfig(rootsift=rootsift)).numpy()
    J = [jnp.asarray(a) for a in (gx, gy, oy0, ox0, oris, sw)]
    jcfg = JaxSiftConfig(rootsift=rootsift)
    on = np.asarray(jw.descriptors_from_windows_multi(*J, jcfg, pallas="on"))
    off = np.asarray(jw.descriptors_from_windows_multi(*J, jcfg, pallas="off"))
    assert got.shape == on.shape == (gx.shape[0], 2, 128)
    np.testing.assert_allclose(got, on, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got, off, rtol=0, atol=6e-3)
