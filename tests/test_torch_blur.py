"""The blur kernel's module (`kernels/cuda/blur.py`) on the CPU: its plain
stencil against the JAX package's blur, the mirror border at any radius,
what the wrapper refuses, and the fused kernel's tile plan with its index
arithmetic (tiles, strips, staging folds, the rotating register window)
mirrored in numpy.

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
from tests.torch_dist_world import one_torch_thread  # noqa: F401

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


# The fused kernel's plan and its index arithmetic, mirrored in numpy (the
# kernel runs only on the card).

def _stencil_line_offsets(ntaps: int, P: int = bk.P) -> list:
    """The offsets `stencil_line` (csrc/blur.cu) feeds output i, tap by
    tap, through its rotating window of P registers."""
    slots = list(range(P))                  # w[s] holds offset slots[s]
    used = [[slots[i]] for i in range(P)]   # tap 0
    for k0 in range(1, ntaps, P):
        full = k0 + P <= ntaps
        for u in range(P):
            if full or k0 + u < ntaps:
                k = k0 + u
                slots[u] = k + P - 1
                for i in range(P):
                    used[i].append(slots[(u + 1 + i) % P])
    return used


@pytest.mark.parametrize("ntaps", [1, 3, 7, 9, 11, 15, 17, 21, 55, 401])
def test_stencil_line_window_feeds_each_tap_in_order(ntaps):
    used = _stencil_line_offsets(ntaps)
    for i, offsets in enumerate(used):
        assert offsets == [i + k for k in range(ntaps)]


def _line_blur_emulated(img: np.ndarray, taps: np.ndarray):
    """The line path (`blur_line_kernel`): each output of a pass from its
    folded line, `mirror(i + k - r)` tap by tap, in f32 numpy."""
    N, H, W = img.shape
    r = (len(taps) - 1) // 2
    t = [np.float32(v) for v in taps]
    xs = np.array([[_mirror_index(x + k - r, W) for x in range(W)]
                   for k in range(len(t))])
    ys = np.array([[_mirror_index(y + k - r, H) for y in range(H)]
                   for k in range(len(t))])
    mid = img[:, :, xs[0]] * t[0]
    for k in range(1, len(t)):
        mid = mid + img[:, :, xs[k]] * t[k]
    out = mid[:, ys[0], :] * t[0]
    for k in range(1, len(t)):
        out = out + mid[:, ys[k], :] * t[k]
    return out, np.ones(img.shape, np.int32)


def _fused_blur_emulated(img: np.ndarray, taps: np.ndarray):
    """The kernel's tiles, strips, staging folds and both passes in f32
    numpy, one product and one sum a tap in tap order; returns the output
    and how many times each output was written. A plan of the line path
    runs `_line_blur_emulated`."""
    N, H, W = img.shape
    r = (len(taps) - 1) // 2
    TH, TW, S, _ = bk.tile_plan(H, W, r, N)
    if TH == 0:
        return _line_blur_emulated(img, taps)
    rows, cols = TH + 2 * r, TW + 2 * r
    out = np.full(img.shape, np.nan, np.float32)
    writes = np.zeros(img.shape, np.int32)
    t = [np.float32(v) for v in taps]
    xs_all = np.array([_mirror_index(j, W) for j in range(-r, W + TW + r)])
    ys_all = np.array([_mirror_index(j, H) for j in range(-r, H + TH + r)])
    for p in range(N):
        for ty0 in range(0, H, TH):
            for tx0 in range(0, W, TW):
                mid = np.empty((rows, TW), np.float32)
                xs = xs_all[tx0:tx0 + cols]
                for s0 in range(0, rows, S):
                    n = min(S, rows - s0)
                    ys = ys_all[ty0 + s0:ty0 + s0 + n]
                    stage = img[p][np.ix_(ys, xs)]
                    acc = stage[:, 0:TW] * t[0]
                    for k in range(1, len(t)):
                        acc = acc + stage[:, k:k + TW] * t[k]
                    mid[s0:s0 + n] = acc
                acc = mid[0:TH] * t[0]
                for k in range(1, len(t)):
                    acc = acc + mid[k:k + TH] * t[k]
                h, w = min(TH, H - ty0), min(TW, W - tx0)
                out[p, ty0:ty0 + h, tx0:tx0 + w] = acc[:h, :w]
                writes[p, ty0:ty0 + h, tx0:tx0 + w] += 1
    return out, writes


@pytest.mark.parametrize("shape,sigma,radius", [
    ((2, 37, 45), 1.6, None),       # one tile, ragged on both sides
    ((1, 130, 75), 2.2627417, None),  # the top lowe octave's width
    ((1, 1, 70), 3.3, None),        # one row
    ((1, 70, 1), 3.3, None),        # one column
    ((3, 1, 1), 1.0, None),
    ((2, 4, 3), 2.5, None),         # radius past the plane
    ((1, 90, 70), 9.0, 27),         # parity's largest radius: two strips
    ((1, 20, 40), 30.0, 90),        # a radius past the tile's height
    ((1, 9, 12), 167.0, 501),       # past the taps that go by value:
    ((1, 5, 7), 333.3, 1000),       # the line path, its taps from a
    ((2, 3, 4), 1000.0, 3000),      # device buffer
])
def test_fused_tiles_equal_the_stencil_bit_for_bit(shape, sigma, radius):
    """The kernel's tiling, strips and staging folds, emulated in f32,
    give the stencil's bits, and every output is written exactly once."""
    img = _img(5, shape) - 60.0
    taps = gaussian_kernel_1d(sigma, radius=radius)
    got, writes = _fused_blur_emulated(img, taps)
    want = bk.blur_plain(torch.from_numpy(img), taps).numpy()
    assert (writes == 1).all()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


_PLANE_SIDES = [1, 2, 3, 5, 7, 8, 9, 31, 61, 63, 64, 65, 75, 122, 127, 150,
                300, 488, 600, 975, 1200, 2400, 3200]


@pytest.mark.parametrize("r", [1, 2, 5, 7, 10, 14, 20, 27, 40, 64, 65, 99,
                               128, 160, 199, 200])
@pytest.mark.parametrize("planes", [1, 8])
def test_tile_plan_fits_and_covers_every_plane(r, planes):
    """Every plane from 1x1 to 2400x3200 gets a plan at radius r that fits
    the H100's opt-in shared memory, whose sides the kernel takes, and
    whose tiles cover each output exactly once."""
    for H in _PLANE_SIDES:
        for W in _PLANE_SIDES:
            TH, TW, S, smem = bk.tile_plan(H, W, r, planes)
            assert TH % bk.P == 0 and TW % bk.P == 0
            assert bk.P <= TH <= 64 and bk.P <= TW <= 64
            assert 1 <= S <= TH + 2 * r
            assert smem == bk.smem_bytes(TH, TW, S, r) <= bk.SMEM_MAX
            ty, tx = -(-H // TH), -(-W // TW)
            # tile (i, j) owns rows [i TH, (i + 1) TH) and columns
            # [j TW, (j + 1) TW), clipped to the plane
            rows = np.zeros(H, np.int32)
            cols = np.zeros(W, np.int32)
            for i in range(ty):
                rows[i * TH:min(H, (i + 1) * TH)] += 1
            for j in range(tx):
                cols[j * TW:min(W, (j + 1) * TW)] += 1
            assert (rows == 1).all() and (cols == 1).all()
            assert (ty - 1) * TH < H and (tx - 1) * TW < W


def test_tile_plan_every_radius_to_200_and_the_largest_radius():
    """Radii 1 to 200 (lowe, lowe-subpixel and parity at 4 to 8 octaves
    reach 27) on the largest and the smallest plane all fit, and so does
    the largest radius whose taps go by value, 500. Radii 501, 1000 and
    5000 take the line path, which needs no shared memory. No radius that
    the stencil takes is refused."""
    for r in range(1, 201):
        for H, W, n in ((2400, 3200, 2), (1, 1, 1), (3200, 2400, 1),
                        (61, 75, 8)):
            assert bk.tile_plan(H, W, r, n)[3] <= bk.SMEM_MAX
    for H, W, n in ((2400, 3200, 2), (1, 1, 1), (61, 75, 8)):
        TH, TW, S, smem = bk.tile_plan(H, W, (bk.MAX_TAPS - 1) // 2, n)
        assert TH >= bk.P and TW >= bk.P and S >= 1
        assert smem == bk.smem_bytes(TH, TW, S, (bk.MAX_TAPS - 1) // 2)
        assert smem <= bk.SMEM_MAX
        for r in (501, 1000, 5000):
            assert bk.tile_plan(H, W, r, n) == bk.LINE_PATH


@pytest.mark.parametrize("H,W,planes,tile", [
    ((2400, 3200, 2, (64, 64))),    # a 2400x3200 pair's first octave
    ((2400, 3200, 1, (64, 64))),    # one plane: 1900 blocks
    ((1200, 1600, 2, (32, 64))),
    ((488, 600, 8, (32, 64))),      # a B=8 488x600 batch's first octave
    ((61, 75, 8, (32, 32))),        # its 75-wide top octave
    ((488, 600, 1, (32, 32))),      # a parity frame
    ((4, 5, 1, (8, 8))),            # sides under a tile: rounded up to P
    ((1, 300, 2, (8, 32))),
])
def test_tile_plan_narrows_tiles_with_few_blocks(H, W, planes, tile):
    """The largest of TILES that gives BLOCKS blocks; the main path's
    radii stage all rows in one strip within SMEM_TARGET, so four blocks
    fit on an SM."""
    for r in (5, 7, 10):
        TH, TW, S, smem = bk.tile_plan(H, W, r, planes)
        assert (TH, TW) == tile
        assert S == TH + 2 * r and smem <= bk.SMEM_TARGET
