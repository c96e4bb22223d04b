"""The port's pose graph (`sift_tpu_torch/slam/pose_graph.py`) against the
JAX package's on the CPU: the SE(3) scenarios of
`tests/unit/test_pose_graph.py`, the Sim(3) scenarios of
`tests/unit/test_sim3.py`, and a random 64-node / 256-edge graph with
padding edges and several fixed nodes, in both groups.

The JAX package's LM and CG loops stop early (CG once |r|^2 <= tol^2
|b|^2, LM once the damping reaches 1e8); the port runs every step and
freezes the state by mask. Cases where CG stops early and where the
damping saturates check that the two loops end in the same state, and
that the port's frozen state does not move with more steps.

The JAX solves run under one `jax.jit` per group and graph shape, with
the loop counts and the initial damping traced: eager, each call would
compile its loops anew (about 17 s apiece here).

Tolerances: residuals to 1e-4; Jacobian blocks to 1e-4 of the largest
entry on SE(3) and 5e-4 on Sim(3) (both are forward-mode derivatives of
the same f32 maps, but the Sim(3) W matrix's coefficients, such as
(e^sigma - 1) / sigma, cancel in f32 at small sigma, and their
derivatives carry that rounding: measured 2e-4 of the largest entry on
the test graph); optimized poses to 1e-4 (absolute, on
tangent coordinates of order 1). The two packages add f32 sums in other
orders, so an LM accept test at the f32 optimum may go either way; the
steps it decides are below 1e-5 there.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sift_tpu.geometry import lie as jlie
from sift_tpu.geometry import sim3 as jsim3
from sift_tpu.slam import pose_graph as J
from tests.test_torch_sfm_loop import torch_threads
from tests.unit.test_pose_graph import _compose_np, _make_loop

from sift_tpu_torch.slam import pose_graph as P

POSE_TOL = 1e-4
LIN_TOL = {6: 1e-4, 7: 5e-4}


@pytest.fixture(autouse=True)
def one_thread():
    with torch_threads(1):
        yield


def _t(a):
    return torch.from_numpy(np.array(a))


def _graphs(poses, ei, ej, ez, ew, fixed):
    """The same graph for both packages, as (JAX graph, port graph)."""
    sim = poses.shape[-1] == 7
    jcls, pcls = (J.Sim3Graph, P.Sim3Graph) if sim else (J.PoseGraph,
                                                          P.PoseGraph)
    arrays = dict(poses=np.asarray(poses, np.float32),
                  edge_i=np.asarray(ei, np.int32),
                  edge_j=np.asarray(ej, np.int32),
                  edge_z=np.asarray(ez, np.float32),
                  edge_w=np.asarray(ew, np.float32),
                  fixed=np.asarray(fixed, bool))
    return (jcls(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            pcls(**{k: _t(v) for k, v in arrays.items()}))


@functools.lru_cache(maxsize=None)
def _jax_solver(sim: bool):
    opt = J.optimize_pose_graph_sim3 if sim else J.optimize_pose_graph
    return jax.jit(lambda g, it, cg, tol, damping: opt(
        g, iterations=it, cg_iterations=cg, cg_tol=tol,
        damping_init=damping).poses)


def _port_solver(sim: bool):
    return P.optimize_pose_graph_sim3 if sim else P.optimize_pose_graph


def _optimize(jg, pg, iterations=20, cg_iterations=64, cg_tol=1e-6,
              damping_init=1e-4):
    """(JAX poses, port poses) after the same solve."""
    sim = pg.poses.shape[-1] == 7
    want = _jax_solver(sim)(jg, jnp.int32(iterations),
                            jnp.int32(cg_iterations), jnp.float32(cg_tol),
                            jnp.float32(damping_init))
    got = _port_solver(sim)(pg, iterations=iterations,
                            cg_iterations=cg_iterations, cg_tol=cg_tol,
                            damping_init=damping_init)
    return np.asarray(want), got.poses.numpy()


def _sim3_rel(a, b):
    Sa = jsim3.sim3_exp(jnp.asarray(a))
    Sb = jsim3.sim3_exp(jnp.asarray(b))
    return np.asarray(jsim3.sim3_log(
        *jsim3.sim3_compose(*jsim3.sim3_inverse(*Sa), *Sb)))


def _se3_rel(a, b):
    Ra, ta = jlie.se3_exp(jnp.asarray(a))
    Rb, tb = jlie.se3_exp(jnp.asarray(b))
    return np.asarray(jlie.se3_log(*jlie.se3_compose(
        *jlie.se3_inverse(Ra, ta), Rb, tb)))


def _random_graph(D, seed, n=64, e=256, pad=32):
    """n nodes, an odometry chain plus random chords (e - pad edges with
    noisy measurements and weights in [0.5, 20]), `pad` padding edges
    (weight 0, garbage measurements), node 0 and four random nodes fixed;
    the start is the truth plus noise."""
    rng = np.random.default_rng(seed)
    gt = np.zeros((n, D), np.float32)
    gt[:, :3] = rng.uniform(-0.6, 0.6, (n, 3))
    gt[:, 3:6] = rng.uniform(-3.0, 3.0, (n, 3))
    if D == 7:
        gt[:, 6] = rng.uniform(-0.2, 0.2, n)
    rel = _sim3_rel if D == 7 else _se3_rel
    m = e - pad
    ei = np.concatenate([np.arange(n - 1), rng.integers(0, n, m - n + 1)])
    # Chords join distinct nodes.
    ej = np.concatenate([np.arange(1, n), (ei[n - 1:] + rng.integers(
        1, n, m - n + 1)) % n])
    ez = rel(gt[ei], gt[ej]) + rng.normal(0, 0.01, (m, D))
    ew = rng.uniform(0.5, 20.0, m)
    ei = np.concatenate([ei, rng.integers(0, n, pad)])
    ej = np.concatenate([ej, rng.integers(0, n, pad)])
    ez = np.concatenate([ez, np.full((pad, D), 9.5)])
    ew = np.concatenate([ew, np.zeros(pad)])
    fixed = np.zeros(n, bool)
    fixed[[0, *rng.choice(np.arange(1, n), 4, replace=False)]] = True
    init = gt + rng.normal(0, 0.05, gt.shape).astype(np.float32)
    init[fixed] = gt[fixed]
    return init, ei, ej, ez, ew, fixed


@pytest.mark.parametrize("D", [6, 7])
def test_edge_residual_matches_jax(D):
    rng = np.random.default_rng(D)
    xi = rng.normal(0, 0.5, (3, 32, D)).astype(np.float32)
    if D == 7:
        xi[..., 6] *= 0.3
        jf, pf = J.sim3_edge_residual, P.sim3_edge_residual
    else:
        jf, pf = J.edge_residual, P.edge_residual
    want = np.asarray(jf(*(jnp.asarray(a) for a in xi)))
    got = pf(*(_t(a) for a in xi)).numpy()
    np.testing.assert_allclose(got, want, atol=LIN_TOL[6])


@pytest.mark.parametrize("D", [6, 7])
def test_linearize_matches_jax(D):
    jg, pg = _graphs(*_random_graph(D, seed=10 + D, n=16, e=48, pad=8))
    lin = jax.jit(J._linearize_sim3 if D == 7 else J._linearize)
    want = [np.asarray(a) for a in lin(jg)]
    got = [a.numpy() for a in P._linearize(pg, pg.poses)]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(
            g, w, atol=LIN_TOL[D] * max(1.0, np.abs(w).max()))


def _se3_loop():
    """tests/unit/test_pose_graph.py::test_loop_closure_corrects_drift's
    graph: a 12-node square loop started from the integrated noisy
    odometry, closed by exact high-weight edges."""
    gt, (ei, ej, z, w) = _make_loop(n=12, drift=0.03)
    n = gt.shape[0]
    init = [gt[0]]
    for k in range(n - 1):
        init.append(_compose_np(init[-1], z[k]).astype(np.float32))
    fixed = np.zeros(n, bool)
    fixed[0] = True
    return gt, (np.stack(init), ei, ej, z, w, fixed)


def _sim3_loop():
    """tests/unit/test_sim3.py::test_scale_drift_loop_correction's graph:
    a 12-node circle whose integrated odometry drifts in scale, closed by
    one drift-free loop edge."""
    n = 12
    rng = np.random.default_rng(4)
    xs_gt = []
    for k in range(n):
        ang = 2 * np.pi * k / n
        xi = np.zeros(7, np.float32)
        xi[:3] = [0, 0, ang]
        xi[3:6] = [np.cos(ang) * 3, np.sin(ang) * 3, 0]
        xs_gt.append(xi)
    xs_gt = np.stack(xs_gt)
    xs_init = [xs_gt[0]]
    for k in range(1, n):
        z_noisy = _sim3_rel(xs_gt[k - 1], xs_gt[k]) + np.concatenate(
            [rng.standard_normal(6) * 0.01, [0.04]]).astype(np.float32)
        S = jsim3.sim3_compose(*jsim3.sim3_exp(jnp.asarray(xs_init[-1])),
                               *jsim3.sim3_exp(jnp.asarray(z_noisy)))
        xs_init.append(np.asarray(jsim3.sim3_log(*S)))
    ei = np.concatenate([np.arange(n - 1), [n - 1]])
    ej = np.concatenate([np.arange(1, n), [0]])
    ez = np.stack([_sim3_rel(xs_gt[a], xs_gt[b]) for a, b in zip(ei, ej)])
    ew = np.ones(n, np.float32)
    ew[-1] = 10.0
    fixed = np.zeros(n, bool)
    fixed[0] = True
    return xs_gt, (np.stack(xs_init), ei, ej, ez, ew, fixed)


def _scenario(D):
    return _sim3_loop() if D == 7 else _se3_loop()


def test_loop_closure_corrects_drift_matches_jax():
    """tests/unit/test_pose_graph.py::test_loop_closure_corrects_drift
    through both packages."""
    gt, graph = _se3_loop()
    init, _, _, z, _, _ = graph
    n = gt.shape[0]
    want, got = _optimize(*_graphs(*graph), iterations=25)
    np.testing.assert_allclose(got, want, atol=POSE_TOL)
    _, t_got = jlie.se3_exp(jnp.asarray(got))
    _, t_init = jlie.se3_exp(jnp.asarray(init))
    _, t_gt = jlie.se3_exp(jnp.asarray(gt))
    drift = np.linalg.norm(np.asarray(t_init - t_gt), axis=-1).max()
    err = np.linalg.norm(np.asarray(t_got - t_gt), axis=-1).max()
    assert err < 0.5 * drift, (drift, err)
    r = P.edge_residual(_t(got[n - 1]), _t(got[0]), _t(z[-3]))
    assert float(r.abs().max()) < 0.02


def test_sim3_scale_drift_matches_jax():
    """tests/unit/test_sim3.py::test_scale_drift_loop_correction through
    both packages."""
    _, graph = _sim3_loop()
    _, ei, ej, ez, _, _ = graph
    want, got = _optimize(*_graphs(*graph), iterations=30)
    np.testing.assert_allclose(got, want, atol=POSE_TOL)
    assert np.abs(got[:, 6]).max() < 0.02, got[:, 6]
    r = P.sim3_edge_residual(_t(got)[ei], _t(got)[ej], _t(ez))
    assert float(r.abs().max()) < 0.05


@pytest.mark.parametrize("D", [6, 7])
def test_padding_edges_inert(D):
    """Weight-0 padding edges with garbage measurements change nothing
    (tests/unit/test_pose_graph.py::test_masked_edges_inert and
    tests/unit/test_sim3.py::test_inert_padding_edges, on the port)."""
    _, (init, ei, ej, ez, ew, fixed) = _scenario(D)
    n, pad = init.shape[0], 5
    _, g1 = _graphs(init, ei, ej, ez, ew, fixed)
    _, g2 = _graphs(init, np.concatenate([ei, np.zeros(pad, np.int64)]),
                    np.concatenate([ej, np.full(pad, n - 1)]),
                    np.concatenate([ez, np.full((pad, D), 7.7)]),
                    np.concatenate([ew, np.zeros(pad)]), fixed)
    o1 = _port_solver(D == 7)(g1, iterations=5).poses.numpy()
    o2 = _port_solver(D == 7)(g2, iterations=5).poses.numpy()
    np.testing.assert_allclose(o1, o2, atol=1e-6)


@pytest.mark.parametrize("D", [6, 7])
def test_random_graph_matches_jax(D):
    """64 nodes, 256 edges (32 of them padding), 5 fixed nodes, the
    pipeline's 15 LM iterations."""
    init, *rest = _random_graph(D, seed=D)
    want, got = _optimize(*_graphs(init, *rest), iterations=15)
    fixed = rest[-1]
    # Fixed nodes take a zero step: boxplus(x, 0) = x up to f32 rounding,
    # as in JAX.
    np.testing.assert_allclose(got[fixed], init[fixed], atol=1e-5)
    assert np.abs(got - init).max() > 1e-2          # the solve moved
    np.testing.assert_allclose(got, want, atol=POSE_TOL)


@pytest.mark.parametrize("D", [6, 7])
def test_cg_stopping_early_matches_jax(D):
    """On the 12-node loops at cg_tol 1e-3, CG reaches its tolerance well
    before 64 steps at every LM step, so the JAX loop exits early. The
    port's masked loop must end where it ends, and more masked steps must
    change nothing, bit for bit."""
    _, graph = _scenario(D)
    jg, pg = _graphs(*graph)
    want, got = _optimize(jg, pg, iterations=4, cg_tol=1e-3)
    np.testing.assert_allclose(got, want, atol=POSE_TOL)
    more = _port_solver(D == 7)(pg, iterations=4, cg_iterations=200,
                                cg_tol=1e-3)
    np.testing.assert_array_equal(more.poses.numpy(), got)


@pytest.mark.parametrize("D", [6, 7])
def test_damping_saturation_matches_jax(D):
    """The JAX LM loop exits once the damping reaches 1e8: (a) at once
    when it starts there (the state is the start, bit for bit); (b) on a
    loop run far past convergence, where rejected f32-resolution steps
    multiply the damping by 4 until it saturates. The port's frozen state
    equals JAX's and stays put under more iterations."""
    _, graph = _scenario(D)
    jg, pg = _graphs(*graph)
    want, got = _optimize(jg, pg, iterations=20, damping_init=1e8)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, graph[0])
    want, got = _optimize(jg, pg, iterations=60)
    np.testing.assert_allclose(got, want, atol=POSE_TOL)
    more = _port_solver(D == 7)(pg, iterations=90).poses.numpy()
    np.testing.assert_array_equal(more, got)
