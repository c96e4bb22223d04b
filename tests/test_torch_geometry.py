"""The port's homography fit and RANSAC (`sift_tpu_torch.geometry`) against
the JAX package on the CPU.

RANSAC is fed the same Gumbel noise in both packages: the test draws
`jax.random.gumbel(key, (512, N))` and hands it to the port, while JAX
draws it itself from `key`. Tolerances: the same hypotheses win, so the
inlier mask, `num_inliers` and `success` must be identical; the models come
from f32 eigen-decompositions in two libraries, so after dividing by
H[2, 2] they must map the corners of the 640x480 frame to within 0.01 px
of each other.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sift_tpu.config import RansacConfig as JaxRansacConfig
from sift_tpu.geometry.homography import fit_homography as jax_fit
from sift_tpu.geometry.homography import ransac_homography as jax_ransac
from sift_tpu.geometry.homography import symmetric_transfer_error as jax_ste
from sift_tpu.geometry.ransac import sample_minimal_sets as jax_sample

from sift_tpu_torch.config import RansacConfig
from sift_tpu_torch.geometry import homography, ransac
from tests.torch_dist_world import one_torch_thread  # noqa: F401

H_TRUE = np.array([[0.95 * np.cos(0.07), -0.95 * np.sin(0.07), 12.0],
                   [0.95 * np.sin(0.07), 0.95 * np.cos(0.07), -7.0],
                   [1e-4, -5e-5, 1.0]])
CORNERS = np.array([[0, 0], [640, 0], [640, 480], [0, 480]], np.float64)


def _map(H, pts):
    q = np.c_[pts, np.ones(len(pts))] @ np.asarray(H, np.float64).T
    return q[:, :2] / q[:, 2:]


def _corner_gap(H1, H2) -> float:
    H1 = np.asarray(H1, np.float64)
    H2 = np.asarray(H2, np.float64)
    return float(np.abs(_map(H1 / H1[2, 2], CORNERS)
                        - _map(H2 / H2[2, 2], CORNERS)).max())


def _correspondences(seed, n=200, noise=0.3, outliers=0.3):
    rng = np.random.default_rng(seed)
    pa = rng.uniform(0, 640, (n, 2))
    pb = _map(H_TRUE, pa) + rng.normal(0, noise, (n, 2))
    out = rng.random(n) < outliers
    pb[out] = rng.uniform(0, 640, (int(out.sum()), 2))
    valid = rng.random(n) > 0.05
    return pa.astype(np.float32), pb.astype(np.float32), valid


def test_fit_homography_exact_on_synthetic_h():
    pa, _, _ = _correspondences(0, n=12)
    pb = _map(H_TRUE, pa).astype(np.float32)
    got = homography.fit_homography(torch.from_numpy(pa),
                                    torch.from_numpy(pb)).numpy()
    want = np.asarray(jax_fit(jnp.asarray(pa), jnp.asarray(pb)))
    assert got[2, 2] == 1.0
    assert _corner_gap(got, H_TRUE) < 0.05
    assert _corner_gap(got, want) < 0.01


def test_fit_homography_weighted_and_batched():
    pa, pb, _ = _correspondences(1, n=60)
    w = (np.random.default_rng(1).random(60) > 0.4).astype(np.float32)
    got = homography.fit_homography(*[torch.from_numpy(x) for x in (pa, pb, w)])
    want = jax_fit(jnp.asarray(pa), jnp.asarray(pb), jnp.asarray(w))
    assert _corner_gap(got.numpy(), np.asarray(want)) < 0.01
    # A batch of 4-point fits equals the fits one by one.
    idx = np.random.default_rng(2).permutation(60)[:32].reshape(8, 4)
    batch = homography.fit_homography(torch.from_numpy(pa[idx]),
                                      torch.from_numpy(pb[idx]))
    for h in range(8):
        one = homography.fit_homography(torch.from_numpy(pa[idx[h]]),
                                        torch.from_numpy(pb[idx[h]]))
        assert _corner_gap(batch[h].numpy(), one.numpy()) < 1e-3


def test_symmetric_transfer_error_matches_jax():
    pa, pb, _ = _correspondences(3)
    Hs = np.stack([H_TRUE, np.eye(3), H_TRUE @ np.diag([1.01, 0.99, 1.0])])
    Hs = Hs.astype(np.float32)
    got = homography.symmetric_transfer_error(
        torch.from_numpy(Hs), torch.from_numpy(pa), torch.from_numpy(pb))
    assert got.shape == (3, 200)
    for h in range(3):
        want = np.asarray(jax_ste(jnp.asarray(Hs[h]), jnp.asarray(pa),
                                  jnp.asarray(pb)))
        np.testing.assert_allclose(got[h].numpy(), want, rtol=1e-4, atol=1e-3)


def test_sample_minimal_sets_matches_jax():
    _, _, valid = _correspondences(4)
    key = jax.random.PRNGKey(7)
    g = np.array(jax.random.gumbel(key, (512, valid.shape[0])))
    want = np.asarray(jax_sample(key, jnp.asarray(valid), 512, 4))
    got = ransac.sample_minimal_sets(torch.from_numpy(g),
                                     torch.from_numpy(valid), 512, 4)
    np.testing.assert_array_equal(got.numpy(), want)
    assert valid[got.numpy()].all()


@pytest.mark.parametrize("k", [0, 1, 2])
def test_ransac_homography_matches_jax(k):
    pa, pb, valid = _correspondences(10 + k)
    key = jax.random.PRNGKey(k)
    g = np.array(jax.random.gumbel(key, (512, pa.shape[0])))
    want = jax_ransac(key, jnp.asarray(pa), jnp.asarray(pb),
                      jnp.asarray(valid), JaxRansacConfig(inlier_threshold=3.0))
    got = homography.ransac_homography(
        torch.from_numpy(g), torch.from_numpy(pa), torch.from_numpy(pb),
        torch.from_numpy(valid), RansacConfig(inlier_threshold=3.0))
    assert int(got.num_inliers) == int(want.num_inliers) > 100
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    assert bool(got.success) == bool(want.success)
    assert got.num_inliers.dtype == torch.int32
    assert _corner_gap(got.model.numpy(), np.asarray(want.model)) < 0.01
    assert _corner_gap(got.model.numpy(), H_TRUE) < 1.0


def test_ransac_with_a_generator_recovers_h():
    pa, pb, valid = _correspondences(20)
    gen = torch.Generator().manual_seed(0)
    est = homography.ransac_homography(
        gen, torch.from_numpy(pa), torch.from_numpy(pb),
        torch.from_numpy(valid), RansacConfig(inlier_threshold=3.0))
    again = homography.ransac_homography(
        torch.Generator().manual_seed(0), torch.from_numpy(pa),
        torch.from_numpy(pb), torch.from_numpy(valid),
        RansacConfig(inlier_threshold=3.0))
    assert bool(est.success) and _corner_gap(est.model.numpy(), H_TRUE) < 1.0
    np.testing.assert_array_equal(est.inliers.numpy(), again.inliers.numpy())
    with pytest.raises(ValueError):
        ransac.sample_minimal_sets(torch.zeros((3, 5)), torch.ones(6, dtype=bool),
                                   3, 4)


def _near_collinear_sets(seed, count=200):
    """4-point sets within 2e-3 of a line (what RANSAC draws on a row of
    features), matched through a near-identity homography with noise."""
    rng = np.random.default_rng(seed)
    Ht = np.array([[1.01, 0.02, 0.03], [-0.01, 0.99, 0.01],
                   [0.02, -0.01, 1.0]])
    out = []
    for _ in range(count):
        d = rng.normal(size=2)
        d /= np.linalg.norm(d)
        pa = (rng.uniform(-0.5, 0.5, 2) + rng.uniform(-0.5, 0.5, 4)[:, None]
              * d + rng.normal(0, 2e-3, (4, 2)))
        pb = _map(Ht, pa) + rng.normal(0, 1e-3, (4, 2))
        out.append((pa.astype(np.float32), pb.astype(np.float32)))
    return out


def test_fit_homography_independent_of_summation_order():
    """The normal matrix is formed in float64, so reordering the points
    (another summation order, as another device's BLAS takes) moves H by
    no more than the f32 result's rounding: at most 1e-4 of its largest
    entry (the card/CPU bound of `chip_smoke.py` phase 14f), even on the
    ill-conditioned minimal sets where an f32 normal matrix moved it by
    more than its own size."""
    worst = 0.0
    for pa, pb in _near_collinear_sets(0):
        one = homography.fit_homography(torch.from_numpy(pa),
                                        torch.from_numpy(pb)).numpy()
        assert one.dtype == np.float32
        for p in ([1, 0, 3, 2], [3, 2, 1, 0], [2, 3, 0, 1]):
            other = homography.fit_homography(torch.from_numpy(pa[p]),
                                              torch.from_numpy(pb[p])).numpy()
            worst = max(worst, float(np.abs(other - one).max()
                                     / np.abs(one).max()))
    assert worst < 1e-4, worst


def test_ransac_homography_independent_of_point_order():
    """RANSAC on reordered points (the Gumbel columns moved with them)
    draws the same samples and keeps the same inliers and model."""
    pa, pb, valid = _correspondences(30, n=400, noise=0.5, outliers=0.4)
    g = np.random.default_rng(31).gumbel(size=(512, 400)).astype(np.float32)
    perm = np.random.default_rng(32).permutation(400)
    cfg = RansacConfig(inlier_threshold=3.0)
    runs = [homography.ransac_homography(
        torch.from_numpy(g[:, p]), torch.from_numpy(pa[p]),
        torch.from_numpy(pb[p]), torch.from_numpy(valid[p]), cfg)
        for p in (np.arange(400), perm)]
    np.testing.assert_array_equal(runs[1].inliers.numpy(),
                                  runs[0].inliers.numpy()[perm])
    H0, H1 = (r.model.numpy().astype(np.float64) for r in runs)
    assert np.abs(H1 - H0).max() / np.abs(H0).max() < 1e-6
