"""The port's epipolar geometry, triangulation, camera model and homography
decomposition (`sift_tpu_torch.geometry`) against the JAX package on the
CPU, on the synthetic two-view scenes of `tests/unit/test_geometry.py`.

What is compared, and to what tolerance:
- E and F are compared up to sign and scale (both unit Frobenius norm):
  SVD and eigh bases differ between libraries by sign. 8-point fits agree
  to 1e-4 entrywise.
- The 5-point solver's candidate sets: the null-space basis of 5
  constraints is any basis of a 4-dim eigenspace, so the two packages
  parametrize E differently and a root near a grid edge or a double root
  can be gained or lost. On noise-free 5-sets the true E must be among
  both packages' valid candidates (to 5e-3), every valid candidate of
  either package must satisfy the 5 constraints (Sampson error < 1e-6),
  and the valid counts may differ by at most 2 of 10.
- Poses: R to 1e-3 and t's direction to 1e-3 after cheirality and the
  Gauss-Newton polish; `num_good` exactly.
- RANSAC with JAX's Gumbel noise handed over: inlier counts within 1% (the
  5-point candidate sets differ, so the winning hypothesis may too), the
  pose within the accuracy both reach against the ground truth.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from scipy.spatial.transform import Rotation

from sift_tpu.config import RansacConfig as JaxRansacConfig
from sift_tpu.geometry import camera as jcamera
from sift_tpu.geometry import epipolar as J
from sift_tpu.geometry.homography import decompose_homography as jax_decompose_h
from sift_tpu.geometry.homography import fit_homography as jax_fit_h
from sift_tpu.geometry.triangulation import triangulate_dlt as jax_triangulate

from sift_tpu_torch.config import RansacConfig
from sift_tpu_torch.geometry import camera, epipolar
from sift_tpu_torch.geometry.homography import (decompose_homography,
                                                fit_homography)
from sift_tpu_torch.geometry.triangulation import triangulate_dlt
from tests.torch_dist_world import one_torch_thread  # noqa: F401


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _two_view(seed, n=200, noise=0.0, outliers=0):
    """`tests/unit/test_geometry.py::_synthetic_two_view`, plus planted
    outliers: normalized coordinates and ground-truth (R, t)."""
    rng = np.random.default_rng(seed)
    R = Rotation.from_rotvec(rng.normal(0, 0.1, 3) + [0.0, 0.15, 0.0]).as_matrix()
    t = np.array([0.5, 0.05, 0.1])
    t = t / np.linalg.norm(t)
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                  rng.uniform(4, 10, n)], -1)
    xa = X[:, :2] / X[:, 2:]
    Xb = X @ R.T + t
    xb = Xb[:, :2] / Xb[:, 2:]
    if noise:
        xa = xa + rng.normal(0, noise, xa.shape)
        xb = xb + rng.normal(0, noise, xb.shape)
    if outliers:
        out = rng.choice(n, outliers, replace=False)
        xb[out] = rng.uniform(-0.5, 0.5, (outliers, 2))
    return (xa.astype(np.float32), xb.astype(np.float32),
            R.astype(np.float32), t.astype(np.float32))


def _e_gap(A, B) -> float:
    """Entrywise distance of two unit-norm E/F matrices up to sign."""
    A, B = np.asarray(A, np.float64), np.asarray(B, np.float64)
    A, B = A / np.linalg.norm(A), B / np.linalg.norm(B)
    return float(min(np.abs(A - B).max(), np.abs(A + B).max()))


def _angle_deg(R1, R2) -> float:
    return float(np.degrees(Rotation.from_matrix(
        np.asarray(R1, np.float64) @ np.asarray(R2, np.float64).T).magnitude()))


@pytest.mark.parametrize("essential", [False, True])
def test_fit_8pt_matches_jax(essential):
    xa, xb, _, _ = _two_view(2)
    w = (np.random.default_rng(0).random(200) > 0.3).astype(np.float32)
    for weights in (None, w):
        got = epipolar.fit_fundamental_8pt(
            _t(xa), _t(xb), None if weights is None else _t(weights),
            essential=essential).numpy()
        want = J.fit_fundamental_8pt(jnp.asarray(xa), jnp.asarray(xb),
                                     None if weights is None else
                                     jnp.asarray(weights), essential=essential)
        assert _e_gap(got, want) < 1e-4
        err = epipolar.sampson_error(_t(got), _t(xa), _t(xb)).numpy()
        np.testing.assert_allclose(
            err, np.asarray(J.sampson_error(jnp.asarray(got), jnp.asarray(xa),
                                            jnp.asarray(xb))),
            rtol=1e-4, atol=1e-10)
        assert err.max() < 5e-4
    # A batch of fits is the fits one by one.
    idx = np.random.default_rng(1).permutation(200)[:64].reshape(8, 8)
    batch = epipolar.fit_fundamental_8pt(_t(xa[idx]), _t(xb[idx]),
                                         essential=essential)
    for h in range(8):
        one = epipolar.fit_fundamental_8pt(_t(xa[idx[h]]), _t(xb[idx[h]]),
                                           essential=essential)
        assert _e_gap(batch[h].numpy(), one.numpy()) < 1e-5


@pytest.mark.parametrize("seed", [11, 12, 13, 14, 15])
def test_fit_essential_5pt_candidate_sets(seed):
    xa, xb, R, t = _two_view(seed, n=5)
    E_gt = np.cross(t, R, axisa=0, axisb=0).T    # [t]x R
    E, ok = epipolar.fit_essential_5pt(_t(xa), _t(xb))
    Ej, okj = J.fit_essential_5pt(jnp.asarray(xa), jnp.asarray(xb))
    E, ok, Ej, okj = E.numpy(), ok.numpy(), np.asarray(Ej), np.asarray(okj)
    assert ok.any() and okj.any()
    assert abs(int(ok.sum()) - int(okj.sum())) <= 2
    for cand, valid in ((E, ok), (Ej, okj)):
        assert min(_e_gap(cand[i], E_gt) for i in range(10) if valid[i]) < 5e-3
        for i in np.flatnonzero(valid):
            err = epipolar.sampson_error(_t(cand[i]), _t(xa), _t(xb)).numpy()
            assert err.max() < 1e-6


def test_fit_essential_5pt_batched_equals_single():
    xa, xb, _, _ = _two_view(16, n=20)
    sa, sb = xa.reshape(4, 5, 2), xb.reshape(4, 5, 2)
    E, ok = epipolar.fit_essential_5pt(_t(sa), _t(sb))
    assert E.shape == (4, 10, 3, 3) and ok.shape == (4, 10)
    for h in range(4):
        E1, ok1 = epipolar.fit_essential_5pt(_t(sa[h]), _t(sb[h]))
        np.testing.assert_array_equal(ok1.numpy(), ok[h].numpy())
        np.testing.assert_allclose(E1.numpy()[ok1.numpy()],
                                   E[h].numpy()[ok1.numpy()], atol=1e-5)


def test_constraint_tensor_matches_jax():
    """The einsum construction of the cubic system against the JAX
    package's term-by-term expansion, on the same basis."""
    rng = np.random.default_rng(3)
    Eb = rng.standard_normal((4, 3, 3)).astype(np.float32)
    got = epipolar._constraint_tensor(_t(Eb)).numpy()
    want = np.asarray(J._constraint_tensor(*[jnp.asarray(e) for e in Eb]))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    z = np.tan(np.linspace(-1.5, 1.5, 33)).astype(np.float32)
    np.testing.assert_array_equal(
        np.sign(epipolar._detA_signs(_t(want), _t(z)).numpy()),
        np.sign(np.asarray(J._detA_signs(jnp.asarray(want), jnp.asarray(z)))))


def test_decompose_and_refine_match_jax():
    xa, xb, R_true, t_true = _two_view(3)
    w = np.ones(200, np.float32)
    Ej = np.asarray(J.fit_fundamental_8pt(jnp.asarray(xa), jnp.asarray(xb),
                                          essential=True))
    R, t, n = epipolar.decompose_essential(_t(Ej), _t(xa), _t(xb), _t(w))
    Rj, tj, nj = J.decompose_essential(jnp.asarray(Ej), jnp.asarray(xa),
                                       jnp.asarray(xb), jnp.asarray(w))
    assert int(n) == int(nj) >= 198 and n.dtype == torch.int32
    np.testing.assert_allclose(R.numpy(), np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(t.numpy(), np.asarray(tj), atol=1e-4)
    # Both packages polish from the same start.
    R2, t2 = epipolar.refine_relative_pose(_t(Rj), _t(tj), _t(xa), _t(xb), _t(w))
    R2j, t2j = J.refine_relative_pose(Rj, tj, jnp.asarray(xa), jnp.asarray(xb),
                                      jnp.asarray(w))
    np.testing.assert_allclose(R2.numpy(), np.asarray(R2j), atol=1e-3)
    np.testing.assert_allclose(t2.numpy(), np.asarray(t2j), atol=1e-3)
    np.testing.assert_allclose(R2.numpy(), R_true, atol=1e-3)
    assert abs(float(t2 @ _t(t_true))) > 1 - 1e-3
    # The se(3) form.
    xi, n2 = epipolar.relative_pose_from_essential(_t(Ej), _t(xa), _t(xb), _t(w))
    xij, _ = J.relative_pose_from_essential(jnp.asarray(Ej), jnp.asarray(xa),
                                            jnp.asarray(xb), jnp.asarray(w))
    np.testing.assert_allclose(xi.numpy(), np.asarray(xij), atol=1e-4)


def test_sampson_residuals_and_tangent_basis_match_jax():
    xa, xb, R, t = _two_view(4, noise=1e-3)
    E = np.cross(t, R, axisa=0, axisb=0).T.astype(np.float32)
    np.testing.assert_allclose(
        epipolar._sampson_residuals(_t(E), _t(xa), _t(xb)).numpy(),
        np.asarray(J._sampson_residuals(jnp.asarray(E), jnp.asarray(xa),
                                        jnp.asarray(xb))), rtol=1e-4, atol=1e-7)
    B = epipolar._tangent_basis(_t(t)).numpy()
    np.testing.assert_allclose(B, np.asarray(J._tangent_basis(jnp.asarray(t))),
                               atol=1e-6)
    np.testing.assert_allclose(B.T @ B, np.eye(2), atol=1e-6)
    np.testing.assert_allclose(t @ B, 0.0, atol=1e-6)


@pytest.mark.parametrize("solver,seed,outliers", [("5pt", 4, 90),
                                                   ("5pt", 13, 90),
                                                   ("8pt", 1, 30)])
def test_estimate_relative_pose_with_jax_noise(solver, seed, outliers):
    xa, xb, R_true, t_true = _two_view(seed, n=300, noise=5e-4,
                                       outliers=outliers)
    valid = np.ones(300, bool)
    key = jax.random.PRNGKey(seed)
    g = np.array(jax.random.gumbel(key, (256, 300)))
    kw = dict(num_hypotheses=256, inlier_threshold=2.0, essential_solver=solver)
    Rj, tj, estj = J.estimate_relative_pose(
        key, jnp.asarray(xa), jnp.asarray(xb), jnp.asarray(valid),
        JaxRansacConfig(**kw), focal=500.0)
    R, t, est = epipolar.estimate_relative_pose(
        _t(g), _t(xa), _t(xb), _t(valid), RansacConfig(**kw), focal=500.0)
    assert bool(est.success) and bool(estj.success)
    assert est.num_inliers.dtype == torch.int32
    n, nj = int(est.num_inliers), int(estj.num_inliers)
    assert abs(n - nj) <= 0.01 * nj and n >= 200
    assert int(est.inliers.sum()) == n
    # Against the ground truth as `tests/unit/test_geometry.py` holds JAX
    # (1 and 2 degrees); against each other ten times tighter.
    for Rx, tx in ((R.numpy(), t.numpy()), (np.asarray(Rj), np.asarray(tj))):
        assert _angle_deg(Rx, R_true) < 1.0
        assert abs(float(tx @ t_true)) > np.cos(np.radians(2.0))
    assert _angle_deg(R.numpy(), np.asarray(Rj)) < 0.1
    assert float(t.numpy() @ np.asarray(tj)) > np.cos(np.radians(0.2))


def test_ransac_essential_8pt_sampling_matches_jax():
    """With the same noise the 8-point RANSAC draws the same samples, so
    the same hypothesis wins: inliers identical."""
    xa, xb, _, _ = _two_view(4, n=300, noise=5e-4, outliers=60)
    valid = np.ones(300, bool)
    key = jax.random.PRNGKey(1)
    g = np.array(jax.random.gumbel(key, (128, 300)))
    cfg = dict(num_hypotheses=128, inlier_threshold=2.0)
    estj = J.ransac_essential(key, jnp.asarray(xa), jnp.asarray(xb),
                              jnp.asarray(valid), JaxRansacConfig(**cfg),
                              focal=500.0)
    est = epipolar.ransac_essential(_t(g), _t(xa), _t(xb), _t(valid),
                                    RansacConfig(**cfg), focal=500.0)
    np.testing.assert_array_equal(est.inliers.numpy(), np.asarray(estj.inliers))
    # The refit on noisy inliers: the two smallest eigenvalues of the 9x9
    # normal matrix are close, so the f32 eigenvector moves more between
    # libraries than on exact data.
    assert _e_gap(est.model.numpy(), estj.model) < 5e-3
    # Fundamental RANSAC in pixels (focal 500, principal point 320, 240).
    pa, pb = xa * 500 + [320, 240], xb * 500 + [320, 240]
    estj = J.ransac_fundamental(key, jnp.asarray(pa), jnp.asarray(pb),
                                jnp.asarray(valid), JaxRansacConfig(**cfg))
    est = epipolar.ransac_fundamental(_t(g), _t(pa.astype(np.float32)),
                                      _t(pb.astype(np.float32)), _t(valid),
                                      RansacConfig(**cfg))
    assert abs(int(est.num_inliers) - int(estj.num_inliers)) <= 3


def test_generator_noise_is_reproducible():
    xa, xb, R_true, _ = _two_view(13, n=300, noise=5e-4, outliers=90)
    args = (_t(xa), _t(xb), torch.ones(300, dtype=torch.bool),
            RansacConfig(num_hypotheses=256))
    R1, t1, e1 = epipolar.estimate_relative_pose(
        torch.Generator().manual_seed(0), *args, focal=500.0)
    R2, t2, e2 = epipolar.estimate_relative_pose(
        torch.Generator().manual_seed(0), *args, focal=500.0)
    assert torch.equal(R1, R2) and torch.equal(t1, t2)
    assert torch.equal(e1.inliers, e2.inliers)
    assert _angle_deg(R1.numpy(), R_true) < 0.2
    with pytest.raises(ValueError):
        epipolar.estimate_relative_pose(torch.Generator().manual_seed(0),
                                        *args[:3],
                                        RansacConfig(essential_solver="7pt"))


@pytest.mark.parametrize("kind", ["random", "rank2", "rank3"])
def test_smallest_eigvec_matches_eigh(kind):
    """The triangulation's fixed-sweep Jacobi against LAPACK's eigh (in
    float64) on random, rank-2 and rank-3 4x4 normal matrices: the
    eigen-residual within 1e-6 of the matrix norm, and the eigenvector
    itself where the two smallest eigenvalues are apart."""
    from sift_tpu_torch.geometry.triangulation import _smallest_eigvec

    A = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (4000, 4, 4)).astype(np.float32))
    if kind == "rank2":
        A[:, 2:] = A[:, :2]
    elif kind == "rank3":
        A[:, 3] = A[:, 0] + A[:, 1]
    M = A.transpose(-1, -2) @ A
    v = _smallest_eigvec(M)
    lam = (v[:, None, :] @ M @ v[:, :, None])[:, 0, 0]
    res = ((M @ v[:, :, None])[:, :, 0] - lam[:, None] * v).norm(dim=-1)
    assert (res / torch.linalg.matrix_norm(M)).max() < 1e-6
    w, U = torch.linalg.eigh(M.double())
    apart = (w[:, 1] - w[:, 0]) > 1e-3 * w[:, 3]
    align = (v.double() * U[:, :, 0]).sum(-1).abs()
    assert kind == "rank2" or apart.sum() > 3000
    assert bool((align[apart] > 1 - 1e-5).all())


def test_triangulate_dlt_degenerate_and_nonfinite_as_jax():
    """Where the JAX package's eigh returns NaN (a non-finite projection
    matrix), the port's triangulation gives NaN too, and a zero baseline
    (the two cameras equal, as a relocalization probe may triangulate)
    gives finite points; `torch.linalg.eigh` raised on the first and, on
    the card, on the second."""
    xa, xb, _, _ = _two_view(7, n=50)
    P = np.concatenate([np.eye(3), np.zeros((3, 1))], 1).astype(np.float32)
    Pn = P.copy()
    Pn[0, 3] = np.nan
    X = triangulate_dlt(_t(P), _t(Pn), _t(xa), _t(xb)).numpy()
    Xj = np.asarray(jax_triangulate(jnp.asarray(P), jnp.asarray(Pn),
                                    jnp.asarray(xa), jnp.asarray(xb)))
    assert np.isnan(X).all() and np.isnan(Xj).all()
    X0 = triangulate_dlt(_t(P), _t(P), _t(xa), _t(xa)).numpy()
    assert np.isfinite(X0).all()


def test_triangulation_and_camera_match_jax():
    xa, xb, R, t = _two_view(5, n=100)
    P1 = np.concatenate([np.eye(3), np.zeros((3, 1))], 1).astype(np.float32)
    P2 = np.concatenate([R, t[:, None]], 1).astype(np.float32)
    X = triangulate_dlt(_t(P1), _t(P2), _t(xa), _t(xb)).numpy()
    Xj = np.asarray(jax_triangulate(jnp.asarray(P1), jnp.asarray(P2),
                                    jnp.asarray(xa), jnp.asarray(xb)))
    np.testing.assert_allclose(X, Xj, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(X[:, :2] / X[:, 2:], xa, atol=1e-4)

    rng = np.random.default_rng(6)
    pose = (rng.standard_normal((100, 6)) * 0.1).astype(np.float32)
    K = np.array([500.0, 480.0, 320.0, 240.0], np.float32)
    uv, z = camera.project(_t(pose), _t(K), _t(X))
    uvj, zj = jcamera.project(jnp.asarray(pose), jnp.asarray(K), jnp.asarray(X))
    np.testing.assert_allclose(uv.numpy(), np.asarray(uvj), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(z.numpy(), np.asarray(zj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        camera.backproject(_t(K), uv, z).numpy(),
        np.asarray(jcamera.backproject(jnp.asarray(K), uvj, zj)),
        rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        camera.normalize_points(_t(K), uv).numpy(),
        np.asarray(jcamera.normalize_points(jnp.asarray(K), uvj)), atol=1e-5)
    np.testing.assert_array_equal(camera.intrinsics_matrix(_t(K)).numpy(),
                                  np.asarray(jcamera.intrinsics_matrix(K)))


def _planar_scene(seed, n=120, noise=0.0, outliers=0):
    """`tests/unit/test_homography_decomposition.py::_planar_scene`."""
    rng = np.random.default_rng(seed)
    n_plane = np.array([0.1, -0.05, 1.0])
    n_plane /= np.linalg.norm(n_plane)
    xy = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n)], -1)
    z = (8.0 - xy @ n_plane[:2]) / n_plane[2]
    X = np.concatenate([xy, z[:, None]], -1)
    R = Rotation.from_rotvec([0.02, 0.12, -0.01]).as_matrix()
    t = np.array([0.6, 0.1, 0.15])
    xa = X[:, :2] / X[:, 2:]
    Xb = X @ R.T + t
    xb = Xb[:, :2] / Xb[:, 2:]
    if noise:
        xa = xa + rng.normal(0, noise, xa.shape)
        xb = xb + rng.normal(0, noise, xb.shape)
    inlier = np.ones(n, np.float32)
    if outliers:
        out = rng.choice(n, outliers, replace=False)
        xb[out] = rng.uniform(-0.4, 0.4, (outliers, 2))
        inlier[out] = 0.0
    return (xa.astype(np.float32), xb.astype(np.float32), R.astype(np.float32),
            (t / np.linalg.norm(t)).astype(np.float32), n_plane.astype(np.float32),
            inlier)


@pytest.mark.parametrize("seed,noise,outliers", [(0, 0.0, 0), (1, 5e-4, 50)])
def test_decompose_homography_matches_jax(seed, noise, outliers):
    n = 120 if not outliers else 200
    xa, xb, R_true, t_true, n_true, w = _planar_scene(seed, n, noise, outliers)
    Hj = np.asarray(jax_fit_h(jnp.asarray(xa), jnp.asarray(xb), jnp.asarray(w)))
    R, t, nv, good = decompose_homography(_t(Hj), _t(xa), _t(xb), _t(w))
    Rj, tj, nj, goodj = jax_decompose_h(jnp.asarray(Hj), jnp.asarray(xa),
                                        jnp.asarray(xb), jnp.asarray(w))
    assert int(good) == int(goodj) > 0.9 * w.sum()
    assert good.dtype == torch.int32
    np.testing.assert_allclose(R.numpy(), np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(t.numpy(), np.asarray(tj), atol=1e-4)
    np.testing.assert_allclose(nv.numpy(), np.asarray(nj), atol=1e-4)
    assert _angle_deg(R.numpy(), R_true) < 1.0
    assert abs(float(t @ _t(t_true))) > 0.995
    assert abs(float(nv @ _t(n_true))) > 0.99
    # The port's own fit decomposes the same way.
    Ht = fit_homography(_t(xa), _t(xb), _t(w))
    R2, t2, _, _ = decompose_homography(Ht, _t(xa), _t(xb), _t(w))
    assert _angle_deg(R2.numpy(), R.numpy()) < 0.05
