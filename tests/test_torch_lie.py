"""The port's Lie groups (`sift_tpu_torch.geometry.lie`, `sim3`, `lie_np`)
against the JAX package on the CPU.

Tolerances: the maps are the same f32 formulas in two libraries, so
values agree to 2e-6 away from the singular points and to 1e-4 near pi
(the log's axis there is a quotient of small differences). `lie_np` is a
verbatim copy and must agree bit for bit with the JAX package's copy.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sift_tpu.geometry import lie as jlie
from sift_tpu.geometry import lie_np as jlie_np
from sift_tpu.geometry import sim3 as jsim3

from sift_tpu_torch.geometry import lie, lie_np, sim3
from tests.torch_dist_world import one_torch_thread  # noqa: F401


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _rotvecs(seed, n, lo, hi):
    rng = np.random.default_rng(seed)
    axis = rng.standard_normal((n, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    return (axis * rng.uniform(lo, hi, (n, 1))).astype(np.float32)


@pytest.mark.parametrize("lo,hi,atol", [(0.0, 1e-6, 2e-6), (0.01, 1.0, 2e-6),
                                        (1.0, 3.0, 2e-6),
                                        (np.pi - 0.05, np.pi - 1e-4, 1e-4)])
def test_so3_exp_log_match_jax(lo, hi, atol):
    w = _rotvecs(0, 64, lo, hi)
    R = lie.so3_exp(_t(w))
    np.testing.assert_allclose(R.numpy(), np.asarray(jlie.so3_exp(w)),
                               atol=2e-6)
    # Both logs of the same matrices, and the round trip.
    got = lie.so3_log(R).numpy()
    np.testing.assert_allclose(got, np.asarray(jlie.so3_log(R.numpy())),
                               atol=atol)
    back = lie.so3_exp(_t(got)).numpy()
    np.testing.assert_allclose(back, R.numpy(), atol=max(atol, 1e-5))


def test_so3_log_jacfwd_is_finite_at_zero():
    # Zero rotation is the common case (zero-residual edges): the log's
    # forward-mode derivative there must be finite and equal to JAX's.
    R0 = np.eye(3, dtype=np.float32)
    got = torch.func.jacfwd(lie.so3_log)(_t(R0)).numpy()
    want = np.asarray(jax.jacfwd(jlie.so3_log)(jnp.asarray(R0)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-6)
    # Through exp at zero, d log(exp(w)) / dw = I.
    J = torch.func.jacfwd(lambda w: lie.so3_log(lie.so3_exp(w)))(
        torch.zeros(3))
    np.testing.assert_allclose(J.numpy(), np.eye(3), atol=1e-6)


@pytest.mark.parametrize("scale", [1e-6, 0.1, 1.0, 2.5])
def test_se3_ops_match_jax(scale):
    rng = np.random.default_rng(3)
    xi = (rng.standard_normal((32, 6)) * scale).astype(np.float32)
    d = (rng.standard_normal((32, 6)) * 0.05).astype(np.float32)
    R, t = lie.se3_exp(_t(xi))
    Rj, tj = jlie.se3_exp(xi)
    np.testing.assert_allclose(R.numpy(), np.asarray(Rj), atol=2e-6)
    np.testing.assert_allclose(t.numpy(), np.asarray(tj), atol=1e-5)
    np.testing.assert_allclose(lie.se3_log(R, t).numpy(),
                               np.asarray(jlie.se3_log(Rj, tj)), atol=1e-4)
    np.testing.assert_allclose(lie.boxplus(_t(xi), _t(d)).numpy(),
                               np.asarray(jlie.boxplus(xi, d)), atol=1e-4)
    np.testing.assert_allclose(lie.se3_matrix(_t(xi)).numpy(),
                               np.asarray(jlie.se3_matrix(xi)), atol=1e-5)
    Ri, ti = lie.se3_inverse(R, t)
    Rc, tc = lie.se3_compose(Ri, ti, R, t)
    np.testing.assert_allclose(Rc.numpy(), np.tile(np.eye(3), (32, 1, 1)),
                               atol=1e-5)
    np.testing.assert_allclose(tc.numpy(), 0.0, atol=1e-4 * max(scale, 1))
    x = rng.standard_normal((32, 3)).astype(np.float32)
    np.testing.assert_allclose(lie.transform(R, t, _t(x)).numpy(),
                               np.asarray(jlie.transform(Rj, tj, x)), atol=1e-5)


def test_hat_vee():
    w = np.random.default_rng(4).standard_normal((5, 3)).astype(np.float32)
    W = lie.hat(_t(w))
    np.testing.assert_array_equal(W.numpy(), np.asarray(jlie.hat(w)))
    np.testing.assert_array_equal(lie.vee(W).numpy(), w)


@pytest.mark.parametrize("scale", [1e-6, 0.1, 1.0, 2.5])
def test_lie_np_is_the_jax_packages_copy(scale):
    rng = np.random.default_rng(7)
    xi = (rng.standard_normal((64, 6)) * scale).astype(np.float32)
    d = (rng.standard_normal((64, 6)) * 0.05).astype(np.float32)
    for a, b in zip(lie_np.se3_exp(xi), jlie_np.se3_exp(xi)):
        np.testing.assert_array_equal(a, b)
    R, t = lie_np.se3_exp(xi)
    np.testing.assert_array_equal(lie_np.se3_log(R, t), jlie_np.se3_log(R, t))
    np.testing.assert_array_equal(lie_np.boxplus(xi, d), jlie_np.boxplus(xi, d))
    np.testing.assert_array_equal(lie_np.rel_pose(xi[:32], xi[32:]),
                                  jlie_np.rel_pose(xi[:32], xi[32:]))
    for a, b in zip(lie_np.pose_deltas(xi[:32], xi[32:]),
                    jlie_np.pose_deltas(xi[:32], xi[32:])):
        np.testing.assert_array_equal(a, b)
    # And it mirrors the port's torch ops.
    np.testing.assert_allclose(lie_np.boxplus(xi, d),
                               lie.boxplus(_t(xi), _t(d)).numpy(), atol=1e-4)


def _rand_sim3(seed, n=32, scale=0.5, sig=0.3):
    rng = np.random.default_rng(seed)
    xi = (rng.standard_normal((n, 7)) * scale).astype(np.float32)
    xi[:, 6] = (rng.standard_normal(n) * sig).astype(np.float32)
    return xi


@pytest.mark.parametrize("scale", [1e-5, 0.1, 1.0])
def test_sim3_ops_match_jax(scale):
    xi = _rand_sim3(0, scale=scale)
    d = _rand_sim3(1, scale=0.05, sig=0.05)
    S = sim3.sim3_exp(_t(xi))
    Sj = jsim3.sim3_exp(xi)
    for a, b in zip(S, Sj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5)
    np.testing.assert_allclose(sim3.sim3_log(*S).numpy(),
                               np.asarray(jsim3.sim3_log(*Sj)), atol=2e-4)
    unique = np.linalg.norm(xi[:, :3], axis=-1) < np.pi - 0.1
    np.testing.assert_allclose(sim3.sim3_log(*S).numpy()[unique], xi[unique],
                               atol=2e-4)
    np.testing.assert_allclose(sim3.boxplus(_t(xi), _t(d)).numpy(),
                               np.asarray(jsim3.boxplus(xi, d)), atol=2e-4)
    inv = sim3.sim3_compose(*sim3.sim3_inverse(*S), *S)
    np.testing.assert_allclose(inv[0].numpy(), 1.0, atol=1e-5)
    np.testing.assert_allclose(inv[2].numpy(), 0.0, atol=1e-4)
    x = np.random.default_rng(2).standard_normal((32, 3)).astype(np.float32)
    np.testing.assert_allclose(sim3.sim3_transform(*S, _t(x)).numpy(),
                               np.asarray(jsim3.sim3_transform(*Sj, x)),
                               atol=1e-4)
    # sigma = 0 reduces to SE(3).
    xi6 = xi[:, :6]
    s6, R6, t6 = sim3.sim3_exp(sim3.from_se3(_t(xi6)))
    Rse, tse = lie.se3_exp(_t(xi6))
    np.testing.assert_allclose(s6.numpy(), 1.0, atol=1e-6)
    np.testing.assert_allclose(R6.numpy(), Rse.numpy(), atol=1e-5)
    np.testing.assert_allclose(t6.numpy(), tse.numpy(), atol=1e-5)


def test_umeyama_matches_jax_and_recovers_similarity():
    rng = np.random.default_rng(3)
    src = rng.standard_normal((50, 3)).astype(np.float32)
    R_gt = np.asarray(jlie.so3_exp(np.array([0.2, -0.1, 0.3], np.float32)))
    dst = (1.7 * src @ R_gt.T + np.array([0.5, -1.0, 2.0])).astype(np.float32)
    w = rng.uniform(0.5, 1.0, 50).astype(np.float32)
    w[:5] = 0.0
    dst[:5] += 10.0                      # zero-weight outliers are ignored
    s, R, t = sim3.umeyama_alignment(_t(src), _t(dst), _t(w))
    sj, Rj, tj = jsim3.umeyama_alignment(src, dst, w)
    np.testing.assert_allclose(float(s), float(sj), rtol=1e-5)
    np.testing.assert_allclose(R.numpy(), np.asarray(Rj), atol=1e-5)
    np.testing.assert_allclose(t.numpy(), np.asarray(tj), atol=1e-4)
    np.testing.assert_allclose(float(s), 1.7, rtol=1e-4)
    np.testing.assert_allclose(R.numpy(), R_gt, atol=1e-4)
