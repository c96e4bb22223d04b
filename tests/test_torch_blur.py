"""The blur kernel's module (`kernels/cuda/blur.py`) on the CPU: its plain
stencil against the JAX package's blur, the mirror border at any radius,
and what the wrapper refuses.

The JAX blur is two f32 matrix products up to 2048 px and a mirror-padded
convolution above; the stencil sums in another order than either, so
values in [0, 255] agree to the pyramid tests' atol of 1e-4, not bit for
bit. The kernel itself runs only on the card (`chip_smoke.py` phase 16
holds it against the stencil bit for bit).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sift_tpu.kernels.gaussian import _mirror_index as jax_mirror_index
from sift_tpu.kernels.gaussian import gaussian_blur as jax_blur

from sift_tpu_torch.kernels.cuda import blur as bk
from sift_tpu_torch.kernels.gaussian import (_mirror_index, blur_matrix,
                                             gaussian_blur,
                                             gaussian_kernel_1d)

ATOL = 1e-4


def _img(seed, shape):
    return np.random.default_rng(seed).uniform(0.0, 255.0, shape).astype(
        np.float32)


@pytest.mark.parametrize("sigma,shape", [
    (1.6, (2, 37, 45)),          # both axes on JAX's matrix branch
    (1.2489996, (1, 3, 2049)),   # W past 2048: JAX's convolution branch
    (2.0159, (1, 2050, 5)),      # H past 2048
])
def test_stencil_matches_jax_blur(sigma, shape):
    img = _img(0, shape)
    got = bk.blur_plain(torch.from_numpy(img), gaussian_kernel_1d(sigma))
    want = np.asarray(jax_blur(jnp.asarray(img), sigma))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("r", [1, 4, 9, 20])
def test_mirror_indices_any_radius(n, r):
    """The stencil's border index, radii past the line's length included
    (the top octaves of small frames reach them), against the host rule of
    both packages."""
    got = bk.mirror_indices(n, r, "cpu").tolist()
    want = [_mirror_index(j - r, n) for j in range(n + 2 * r)]
    assert got == want
    assert want == [jax_mirror_index(j - r, n) for j in range(n + 2 * r)]


@pytest.mark.parametrize("shape,sigma", [((2, 1, 5), 4.0), ((1, 4, 3), 2.5),
                                         ((3, 2, 1), 1.6), ((1, 7, 6), 6.0),
                                         ((1, 1, 1), 1.0)])
def test_blur_past_the_plane_matches_banded_operator(shape, sigma):
    """Planes smaller than the radius: the stencil equals the banded
    operator, whose band folds the same mirror index (float64 products
    here, so to a tolerance)."""
    img = _img(1, shape)
    taps = gaussian_kernel_1d(sigma)
    got = bk.blur_plain(torch.from_numpy(img), taps).numpy()
    Ah = blur_matrix(shape[1], sigma).astype(np.float64)
    Aw = blur_matrix(shape[2], sigma).astype(np.float64)
    want = Ah @ img.astype(np.float64) @ Aw.T
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_gaussian_blur_is_the_stencil_on_the_cpu():
    img = torch.from_numpy(_img(2, (3, 20, 33)))
    for sigma in (1.6, 2.2627417):
        taps = gaussian_kernel_1d(sigma)
        assert torch.equal(gaussian_blur(img, sigma), bk.blur_plain(img, taps))
    # a strided view is made contiguous before the wrapper sees it
    view = img.transpose(-1, -2)
    assert torch.equal(gaussian_blur(view, 1.6),
                       bk.blur_plain(view.contiguous(),
                                     gaussian_kernel_1d(1.6)))


def test_one_line_never_depends_on_the_others():
    """A plane blurred alone equals the same plane inside a stack, bit for
    bit, whatever its slot."""
    stack = torch.from_numpy(_img(3, (5, 17, 23)))
    taps = gaussian_kernel_1d(1.9)
    full = bk.blur(stack, taps)
    for i in range(stack.shape[0]):
        one = bk.blur(stack[i:i + 1].clone(), taps)
        assert torch.equal(one, full[i:i + 1])


@pytest.mark.parametrize("bad", ["float64", "int", "strided", "1d"])
def test_wrapper_refuses_what_it_cannot_take(bad):
    img = torch.from_numpy(_img(4, (2, 9, 10)))
    arg = {"float64": img.double(), "int": img.to(torch.int32),
           "strided": img.transpose(-1, -2), "1d": img.reshape(-1)}[bad]
    with pytest.raises(ValueError, match="blur"):
        bk.blur(arg, gaussian_kernel_1d(1.6))


@pytest.mark.parametrize("taps", [np.ones(4, np.float32) / 4,
                                  np.ones((3, 3), np.float32)])
def test_wrapper_refuses_bad_taps(taps):
    with pytest.raises(ValueError, match="taps"):
        bk.blur(torch.zeros(1, 4, 4), taps)
