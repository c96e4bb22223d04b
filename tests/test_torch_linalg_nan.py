"""The dense solves of the port's geometry (`utils/linalg.py` and the
sites that use it: `epipolar.py`'s 8-point fit, 5-point null space and
10x10 null vectors and essential decomposition, `homography.py`'s DLT
fit, denormalization, transfer error and decomposition, `sim3.py`'s
Umeyama) on degenerate input, against the JAX package on the CPU.

`torch.linalg.eigh`, `svd`, `inv` and `solve` raise on non-finite (and
`inv`/`solve` on singular) matrices where JAX returns NaN; the port must
raise nowhere. Each case batches finite elements with a NaN-bearing one
and an all-zero one: the port must not raise, its outputs must be
non-finite exactly where JAX's are (NaN and inf alike: LAPACK's LU gives
inf or NaN for a singular matrix in JAX, the port NaN), and its finite
elements must be bit-identical to those of a batch of the finite
elements alone. The wrappers themselves equal the plain `torch.linalg`
calls bit for bit on finite, regular input.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sift_tpu.geometry import epipolar as jepi
from sift_tpu.geometry import homography as jhom
from sift_tpu.geometry import sim3 as jsim3

from sift_tpu_torch.geometry import epipolar, homography, sim3
from sift_tpu_torch.utils import linalg


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _bad_batch(rng, shape, scale=1.0):
    """(4, *shape) f32: finite, one NaN entry, all zeros, finite."""
    x = rng.normal(0, scale, (4,) + shape).astype(np.float32)
    x[1].flat[3] = np.nan
    x[2] = 0.0
    return x


def _nonfinite(x):
    return ~np.isfinite(np.asarray(x, np.float64))


def _hold(got, want, finite_only=None):
    """Same non-finite entries as JAX; finite elements (batch rows 0 and
    3) bit-identical to `finite_only` (the port on those rows alone)."""
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_nonfinite(g), _nonfinite(w))
    if finite_only is not None:
        for g, f in zip(got, finite_only):
            np.testing.assert_array_equal(np.asarray(g)[[0, 3]],
                                          np.asarray(f))


@pytest.mark.parametrize("essential", [False, True])
def test_fit_fundamental_8pt(essential):
    rng = np.random.default_rng(1)
    pa, pb = _bad_batch(rng, (8, 2)), _bad_batch(rng, (8, 2))
    want = jax.vmap(lambda a, b: jepi.fit_fundamental_8pt(
        a, b, essential=essential))(jnp.asarray(pa), jnp.asarray(pb))
    got = epipolar.fit_fundamental_8pt(_t(pa), _t(pb), essential=essential)
    alone = epipolar.fit_fundamental_8pt(_t(pa[[0, 3]]), _t(pb[[0, 3]]),
                                         essential=essential)
    _hold([got.numpy()], [np.asarray(want)], [alone.numpy()])
    assert _nonfinite(got[1].numpy()).all()


def test_fit_essential_5pt():
    rng = np.random.default_rng(2)
    na, nb = _bad_batch(rng, (5, 2), 0.3), _bad_batch(rng, (5, 2), 0.3)
    want = jax.vmap(jepi.fit_essential_5pt)(jnp.asarray(na), jnp.asarray(nb))
    got = epipolar.fit_essential_5pt(_t(na), _t(nb))
    alone = epipolar.fit_essential_5pt(_t(na[[0, 3]]), _t(nb[[0, 3]]))
    _hold([got[0].numpy()], [np.asarray(want[0])], [alone[0].numpy()])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[1][[0, 3]].numpy(), alone[1].numpy())
    assert not got[1][1].any() and _nonfinite(got[0][1].numpy()).all()


@pytest.mark.parametrize("kind", ["nan", "zero"])
def test_decompose_essential(kind):
    rng = np.random.default_rng(3)
    na = rng.normal(0, 0.3, (20, 2)).astype(np.float32)
    nb = rng.normal(0, 0.3, (20, 2)).astype(np.float32)
    w = np.ones(20, np.float32)
    E = np.zeros((3, 3), np.float32)
    if kind == "nan":
        E = rng.normal(0, 1, (3, 3)).astype(np.float32)
        E[1, 2] = np.nan
    want = jepi.decompose_essential(jnp.asarray(E), jnp.asarray(na),
                                    jnp.asarray(nb), jnp.asarray(w))
    got = epipolar.decompose_essential(_t(E), _t(na), _t(nb), _t(w))
    _hold([g.numpy() for g in got], [np.asarray(x) for x in want])
    assert int(got[2]) == int(want[2])


def test_fit_homography():
    rng = np.random.default_rng(4)
    pa, pb = _bad_batch(rng, (4, 2), 50.0), _bad_batch(rng, (4, 2), 50.0)
    want = jax.vmap(jhom.fit_homography)(jnp.asarray(pa), jnp.asarray(pb))
    got = homography.fit_homography(_t(pa), _t(pb))
    alone = homography.fit_homography(_t(pa[[0, 3]]), _t(pb[[0, 3]]))
    _hold([got.numpy()], [np.asarray(want)], [alone.numpy()])


def test_symmetric_transfer_error_singular_and_nan():
    rng = np.random.default_rng(5)
    H = _bad_batch(rng, (3, 3))
    H[3] = np.outer([1.0, 2.0, 0.5], [0.3, -1.0, 2.0])    # rank 1
    H[0] += 3 * np.eye(3, dtype=np.float32)
    pa = rng.normal(0, 50, (16, 2)).astype(np.float32)
    pb = rng.normal(0, 50, (16, 2)).astype(np.float32)
    want = jax.vmap(jhom.symmetric_transfer_error, (0, None, None))(
        jnp.asarray(H), jnp.asarray(pa), jnp.asarray(pb))
    got = homography.symmetric_transfer_error(_t(H), _t(pa), _t(pb))
    alone = homography.symmetric_transfer_error(_t(H[:1]), _t(pa), _t(pb))
    _hold([got.numpy()], [np.asarray(want)])
    np.testing.assert_array_equal(got[:1].numpy(), alone.numpy())
    assert _nonfinite(got[1:].numpy()).all()


@pytest.mark.parametrize("kind", ["nan", "zero"])
def test_decompose_homography(kind):
    rng = np.random.default_rng(6)
    na = rng.normal(0, 0.3, (20, 2)).astype(np.float32)
    nb = rng.normal(0, 0.3, (20, 2)).astype(np.float32)
    w = np.ones(20, np.float32)
    H = np.zeros((3, 3), np.float32)
    if kind == "nan":
        H = (np.eye(3) + rng.normal(0, 0.1, (3, 3))).astype(np.float32)
        H[0, 0] = np.nan
    want = jhom.decompose_homography(jnp.asarray(H), jnp.asarray(na),
                                     jnp.asarray(nb), jnp.asarray(w))
    got = homography.decompose_homography(_t(H), _t(na), _t(nb), _t(w))
    _hold([g.numpy() for g in got], [np.asarray(x) for x in want])


@pytest.mark.parametrize("kind", ["nan", "zero_weights", "zero_points"])
def test_umeyama_alignment(kind):
    rng = np.random.default_rng(7)
    src = rng.normal(0, 1, (12, 3)).astype(np.float32)
    dst = (2.0 * src + 0.5).astype(np.float32)
    w = np.ones(12, np.float32)
    if kind == "nan":
        src[4, 1] = np.nan
    elif kind == "zero_weights":
        w[:] = 0.0
    else:
        src[:] = 0.0
        dst[:] = 0.0
    want = jsim3.umeyama_alignment(jnp.asarray(src), jnp.asarray(dst),
                                   jnp.asarray(w))
    got = sim3.umeyama_alignment(_t(src), _t(dst), _t(w))
    _hold([g.numpy() for g in got], [np.asarray(x) for x in want])


def test_wrappers_equal_plain_calls_on_finite_input():
    rng = np.random.default_rng(8)
    A = _t(rng.normal(0, 1, (16, 9, 9)))
    S = A @ A.transpose(-1, -2)
    B = _t(rng.normal(0, 1, (16, 9, 2)))
    for got, want in ((linalg.eigh_or_nan(S), torch.linalg.eigh(S)),
                      (linalg.svd_or_nan(A), torch.linalg.svd(A))):
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert torch.equal(linalg.inv_or_nan(A), torch.linalg.inv(A))
    assert torch.equal(linalg.solve_or_nan(A, B), torch.linalg.solve(A, B))
    # Non-finite and singular matrices: all NaN, no exception.
    bad = A.clone()
    bad[2, 0, 0] = float("inf")
    bad[5] = 0.0
    for out in (linalg.eigh_or_nan(bad + bad.transpose(-1, -2))[1],
                linalg.svd_or_nan(bad)[0], linalg.inv_or_nan(bad),
                linalg.solve_or_nan(bad, B)):
        assert torch.isnan(out[2]).all()
        assert torch.isfinite(out[[0, 1, 3]]).all()
    assert torch.isnan(linalg.inv_or_nan(bad)[5]).all()
    assert torch.isnan(linalg.solve_or_nan(bad, B)[5]).all()
