"""Blur and lowe pyramid of the PyTorch port against the JAX package.

Data lie in [0, 255]; the port's f32 products sum in another order than
XLA's, so values agree to atol 1e-4, not bit for bit."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sift_tpu.config import SiftConfig as JaxSiftConfig
from sift_tpu.frontend.pyramid import build_pyramid as jax_build_pyramid
from sift_tpu.kernels.gaussian import _conv_1d as jax_conv_1d
from sift_tpu.kernels.gaussian import gaussian_blur as jax_blur

from sift_tpu_torch.config import SiftConfig
from sift_tpu_torch.frontend.pyramid import build_pyramid
from sift_tpu_torch.kernels.gaussian import (_stencil_1d, gaussian_blur,
                                             gaussian_kernel_1d)
from tests.torch_dist_world import one_torch_thread  # noqa: F401

ATOL = 1e-4


@functools.partial(jax.jit, static_argnums=(1,))
def _jax_stacks(imgs, jcfg):
    """The JAX pyramid's stacks, compiled once per shape. (The `Pyramid`
    itself carries numpy sigma tables as static metadata, which a jitted
    return value cannot hold.)"""
    pyr = jax_build_pyramid(imgs, jcfg)
    return pyr.gauss, pyr.dogs


def _frames(seed, B=2, H=64, W=80):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 255.0, (B, H, W)).astype(np.float32)


@pytest.mark.parametrize("sigma,shape", [(1.2489996, (2, 40, 56)),
                                         (2.0159, (3, 17, 9)),
                                         (4.0, (1, 5, 7))])
def test_blur_matches_jax(sigma, shape):
    img = _frames(0, *shape)
    got = gaussian_blur(torch.from_numpy(img), sigma).numpy()
    want = np.asarray(jax_blur(jnp.asarray(img), sigma))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("sigma,shape", [(1.6, (2, 30, 41)), (3.0, (1, 6, 9))])
def test_band_stencil_matches_jax_conv(sigma, shape):
    """The branch taken above 2048 pixels, checked at a small size against
    the JAX package's mirror-padded convolution."""
    img = _frames(1, *shape)
    taps = gaussian_kernel_1d(sigma)
    t = torch.from_numpy(img)
    got = _stencil_1d(_stencil_1d(t, taps, 2), taps, 1).numpy()
    want = np.asarray(jax_conv_1d(jax_conv_1d(jnp.asarray(img), taps, 1),
                                  taps, 0))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("kw", [{}, {"dogs_per_epoch": 4, "octaves": 3}])
def test_pyramid_matches_jax(kw):
    imgs = _frames(2)
    pyr = build_pyramid(torch.from_numpy(imgs), SiftConfig(**kw))
    jcfg = JaxSiftConfig(**kw)
    gauss, dogs = _jax_stacks(jnp.asarray(imgs), jcfg)
    assert pyr.num_octaves == len(gauss)
    for o in range(len(gauss)):
        for ours, theirs in ((pyr.gauss[o], gauss[o]), (pyr.dogs[o], dogs[o])):
            theirs = np.asarray(theirs)
            assert ours.shape == theirs.shape
            np.testing.assert_allclose(ours.numpy(), theirs, rtol=0, atol=ATOL)
