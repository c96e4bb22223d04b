"""The port's bundle adjustment (`sift_tpu_torch.ba`) against the JAX
package on the CPU, on the synthetic scenes of `tests/unit/test_ba.py`
and `test_intrinsics.py` (built by the port's copy of `io/synthetic.py`,
which must give the JAX package's scenes bit for bit).

Tolerances:
- Jacobian blocks: the port's are closed-form, JAX's come from `jacfwd`;
  both are exact derivatives of the same f32 function, so they agree to
  2e-5 of the largest entry of each block type.
- System blocks (U, g, V^-1) to 1e-4 relative to their largest entry.
- `run_ba`: poses to 2e-4, landmarks to 5e-3 (the least constrained
  landmarks move most between two f32 solves), cost and RMSE to 1e-4
  relative, damping to 1e-6 relative; `iterations` and `cg_iters`
  exactly. Two decisions in the loop compare f32 sums: the LM accept test
  (new cost < old cost) and the PCG exit (|r|^2 <= tol^2 |b|^2). Once the
  cost has converged to f32 resolution, or the PCG ratio sits at the
  threshold, rounding decides them, and from then on the damping and the
  counts of the two packages part (measured on a 24-camera corridor: the
  PCG counts agree for 6 LM steps at tol 1e-3 and for 2 at tol 1e-6, then
  differ by 3-4; on the arcs the cost reaches f32 resolution after 6-7
  steps, and from there the accept tests can even differ between two runs
  of one package under other thread counts). So every comparison with JAX
  stops a step or more before the first decision that rounding can turn,
  and the runs to convergence are held against the ground truth.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sift_tpu.ba import intrinsics as jintr
from sift_tpu.ba import pose_only as jpose
from sift_tpu.ba.residuals import cost as jcost
from sift_tpu.ba.residuals import linearize as jlinearize
from sift_tpu.ba.schur import build_system as jbuild
from sift_tpu.ba.schur import dense_schur_solve as jdense
from sift_tpu.ba.schur import schur_rhs as jrhs
from sift_tpu.ba.solver import run_ba as jrun_ba
from sift_tpu.config import BAConfig as JaxBAConfig
from sift_tpu.io import synthetic as jsynthetic

from sift_tpu_torch.ba import intrinsics, pose_only
from sift_tpu_torch.ba.residuals import cost, linearize
from sift_tpu_torch.ba.schur import (build_system, dense_schur_solve, pcg,
                                     schur_matvec, schur_rhs)
from sift_tpu_torch.ba.solver import run_ba, run_ba_map
from sift_tpu_torch.config import BAConfig, config_from_dict
from sift_tpu_torch.io.synthetic import (make_corridor_scene, make_scene,
                                         pad_observations)
from sift_tpu_torch.types import MapState
from tests.torch_dist_world import one_torch_thread  # noqa: F401

KEYS = ("poses_init", "intrinsics", "landmarks_init", "obs_cam", "obs_lm",
        "obs_uv", "obs_valid")


def _args(scene, lib=torch):
    conv = torch.from_numpy if lib is torch else jnp.asarray
    return [conv(np.asarray(scene[k])) for k in KEYS]


def _fixed(c, lib=torch):
    m = np.zeros(c, bool)
    m[:2] = True          # gauge: first two cameras pinned
    return torch.from_numpy(m) if lib is torch else jnp.asarray(m)


def _run_both(scene, **cfg_kw):
    C = scene["poses_init"].shape[0]
    fixed = _fixed(C, jnp)
    want = jax.jit(lambda *a: jrun_ba(*a, JaxBAConfig(**cfg_kw), fixed))(
        *_args(scene, jnp))
    got = run_ba(*_args(scene), BAConfig(**cfg_kw), _fixed(C))
    return got, want


def _assert_same_state(got, want, lm_atol=5e-3):
    assert int(got.iterations) == int(want.iterations)
    assert int(got.cg_iters) == int(want.cg_iters)
    assert got.iterations.dtype == got.cg_iters.dtype == torch.int32
    np.testing.assert_allclose(got.poses.numpy(), np.asarray(want.poses),
                               atol=2e-4)
    np.testing.assert_allclose(got.landmarks.numpy(),
                               np.asarray(want.landmarks), atol=lm_atol)
    np.testing.assert_allclose(float(got.cost), float(want.cost), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(float(got.rmse), float(want.rmse), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(float(got.damping), float(want.damping),
                               rtol=1e-6)


def test_ba_config_matches_jax():
    ours = {f.name: f.default for f in dataclasses.fields(BAConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxBAConfig)}
    assert ours == theirs
    jcfg = JaxBAConfig(max_iterations=7, solver="pcg", loss="cauchy")
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    assert isinstance(cfg, BAConfig)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)


@pytest.mark.parametrize("make,kw", [
    ("make_scene", dict(num_cameras=6, num_landmarks=150, pixel_noise=0.5,
                        pose_noise=0.02, landmark_noise=0.1, drop_rate=0.2)),
    ("make_corridor_scene", dict(num_cameras=32, num_landmarks=2048,
                                 obs_per_camera=128)),
])
def test_synthetic_scenes_are_the_jax_packages(make, kw):
    ours = getattr(__import__("sift_tpu_torch.io.synthetic",
                              fromlist=[make]), make)(
        np.random.default_rng(1), **kw)
    theirs = getattr(jsynthetic, make)(np.random.default_rng(1), **kw)
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_array_equal(np.asarray(ours[k]),
                                      np.asarray(theirs[k]), err_msg=k)
    padded = pad_observations(ours, ours["obs_cam"].shape[0] + 37)
    want = jsynthetic.pad_observations(theirs, theirs["obs_cam"].shape[0] + 37)
    for k in padded:
        np.testing.assert_array_equal(np.asarray(padded[k]),
                                      np.asarray(want[k]), err_msg=k)


def test_corridor_scene_invariants():
    sc = make_corridor_scene(np.random.default_rng(1), num_cameras=32,
                             num_landmarks=2048, obs_per_camera=128)
    n_lms = sc["landmarks_init"].shape[0]
    counts = np.bincount(sc["obs_lm"], minlength=n_lms)
    assert counts.min() >= 2
    assert sc["obs_lm"].max() == n_lms - 1
    assert np.bincount(sc["obs_cam"], minlength=32).max() <= 128
    assert sc["obs_cam"].shape[0] >= 32 * 32


def test_zero_noise_scene_has_zero_cost():
    scene = make_scene(np.random.default_rng(0))
    a = _args(scene)
    c, rmse = cost(torch.from_numpy(scene["poses_gt"]), a[1],
                   torch.from_numpy(scene["landmarks_gt"]), *a[3:],
                   huber_delta=3.0)
    cj, rmsej = jcost(jnp.asarray(scene["poses_gt"]), jnp.asarray(a[1].numpy()),
                      jnp.asarray(scene["landmarks_gt"]),
                      *[jnp.asarray(x.numpy()) for x in a[3:]], huber_delta=3.0)
    assert float(rmse) < 1e-2
    np.testing.assert_allclose(float(rmse), float(rmsej), atol=1e-4)
    np.testing.assert_allclose(float(c), float(cj), rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("loss,delta", [("huber", 3.0), ("cauchy", 1.0),
                                        ("none", 3.0)])
def test_linearize_matches_jax(loss, delta):
    scene = pad_observations(make_scene(
        np.random.default_rng(1), num_cameras=5, num_landmarks=80,
        pixel_noise=2.0, pose_noise=0.03, landmark_noise=0.2), 700)
    got = linearize(*_args(scene), delta, loss)
    want = jlinearize(*_args(scene, jnp), delta, loss)
    for g, w, name in zip(got, want, ("r", "Jc", "Jl", "w")):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=2e-5 * np.abs(w).max(), err_msg=name)


def test_build_system_matches_jax():
    scene = make_scene(np.random.default_rng(1), num_cameras=4,
                       num_landmarks=30, pose_noise=0.01, landmark_noise=0.05)
    got = build_system(*_args(scene), 3.0, 1e-2, _fixed(4))
    want = jbuild(*_args(scene, jnp), 3.0, 1e-2, _fixed(4, jnp))
    for name in ("U", "V_inv", "g_cam", "g_lm"):
        w = np.asarray(getattr(want, name))
        np.testing.assert_allclose(getattr(got, name).numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)
    b = schur_rhs(got).numpy()
    bj = np.asarray(jrhs(want))
    np.testing.assert_allclose(b, bj, rtol=0, atol=1e-4 * np.abs(bj).max())
    x = dense_schur_solve(got, torch.from_numpy(bj)).numpy()
    xj = np.asarray(jdense(want, jnp.asarray(bj)))
    np.testing.assert_allclose(x, xj, rtol=0, atol=1e-3 * np.abs(xj).max())


def test_schur_matvec_matches_dense():
    """S x from the matrix-free path == U - W V^-1 W^T assembled in numpy
    from the same blocks (`tests/unit/test_ba.py`)."""
    scene = make_scene(np.random.default_rng(1), num_cameras=4,
                       num_landmarks=30, pose_noise=0.01, landmark_noise=0.05)
    damping = 1e-2
    sys = build_system(*_args(scene), 3.0, damping, _fixed(4))
    Jc, Jl = sys.Jc.double().numpy(), sys.Jl.double().numpy()
    oc, ol = sys.obs_cam.numpy(), sys.obs_lm.numpy()
    C, L = 4, 30
    U = np.zeros((6 * C, 6 * C))
    V = np.zeros((3 * L, 3 * L))
    W = np.zeros((6 * C, 3 * L))
    for o in range(oc.shape[0]):
        c, l = oc[o], ol[o]
        U[6*c:6*c+6, 6*c:6*c+6] += Jc[o].T @ Jc[o]
        V[3*l:3*l+3, 3*l:3*l+3] += Jl[o].T @ Jl[o]
        W[6*c:6*c+6, 3*l:3*l+3] += Jc[o].T @ Jl[o]
    for blocks, n in ((U, 6), (V, 3)):
        for i in range(blocks.shape[0] // n):
            blk = blocks[n*i:n*i+n, n*i:n*i+n]
            d = np.trace(blk) / n
            blk += (damping * (1.0 + d) + 1e-6 * d) * np.eye(n)
    S = U - W @ np.linalg.inv(V) @ W.T
    x = np.random.default_rng(2).standard_normal((C, 6)).astype(np.float32)
    got = schur_matvec(sys, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, (S @ x.reshape(-1)).reshape(C, 6),
                               rtol=2e-3, atol=2e-3)


def _system(seed, C, L):
    scene = make_scene(np.random.default_rng(seed), num_cameras=C,
                       num_landmarks=L, pose_noise=0.01, landmark_noise=0.05)
    sys = build_system(*_args(scene), 3.0, 1e-2, _fixed(C))
    return sys, schur_rhs(sys)


def test_pcg_solves_reduced_system_and_counts_like_jax():
    from sift_tpu.ba.schur import pcg as jpcg
    scene = make_scene(np.random.default_rng(3), num_cameras=4,
                       num_landmarks=50, pose_noise=0.01, landmark_noise=0.05)
    sys = build_system(*_args(scene), 3.0, 1e-2, _fixed(4))
    b = schur_rhs(sys)
    x, k = pcg(sys, b, iters=200, tol=1e-6)
    res = (schur_matvec(sys, x) - b).numpy()
    assert np.linalg.norm(res) < 1e-3 * max(np.linalg.norm(b.numpy()), 1.0)
    jsys = jbuild(*_args(scene, jnp), 3.0, 1e-2, _fixed(4, jnp))
    for iters, tol in ((200, 1e-3), (3, 1e-6)):
        _, k = pcg(sys, b, iters=iters, tol=tol)
        _, kj = jpcg(jsys, jrhs(jsys), iters, tol)
        assert int(k) == int(kj) > 0
        assert k.dtype == torch.int32


def test_pcg_without_jacobi_and_dense_reach_the_same_solution():
    sys, b = _system(11, 4, 40)
    x_pre, _ = pcg(sys, b, 200, 1e-8, jacobi=True)
    x_cg, _ = pcg(sys, b, 500, 1e-8, jacobi=False)
    np.testing.assert_allclose(x_pre.numpy(), x_cg.numpy(), atol=1e-3)
    sys, b = _system(21, 5, 48)
    x_pcg, _ = pcg(sys, b, 300, 1e-8)
    np.testing.assert_allclose(dense_schur_solve(sys, b).numpy(),
                               x_pcg.numpy(), atol=2e-3)


def test_run_ba_dense_matches_jax_and_converges():
    scene = pad_observations(make_scene(
        np.random.default_rng(4), num_cameras=6, num_landmarks=150,
        pose_noise=0.02, landmark_noise=0.10), 1024)
    got, want = _run_both(scene, max_iterations=6, cg_iterations=60)
    _assert_same_state(got, want)
    assert int(got.cg_iters) == 0            # "auto" picks dense at C <= 16
    st = run_ba(*_args(scene), BAConfig(max_iterations=25, cg_iterations=60),
                _fixed(6))
    assert float(st.rmse) < 0.05
    np.testing.assert_allclose(st.poses.numpy(), scene["poses_gt"], atol=2e-3)


@pytest.mark.parametrize("kw", [
    dict(solver="pcg", cg_tol=1e-3, max_iterations=4),
    dict(solver="pcg", cg_tol=1e-3, cg_iterations=4, jacobi_precond=False,
         max_iterations=4),
    dict(solver="dense", loss="none", robust_anneal=0.0, max_iterations=4),
])
def test_run_ba_pcg_matches_jax(kw):
    scene = make_scene(np.random.default_rng(22), num_cameras=6,
                       num_landmarks=64, pixel_noise=0.3, pose_noise=0.05,
                       landmark_noise=0.2)
    got, want = _run_both(scene, **kw)
    _assert_same_state(got, want)
    if kw["solver"] == "pcg":
        assert int(got.cg_iters) > 0


@pytest.mark.parametrize("solver", ["dense", "pcg"])
def test_run_ba_damping_bound_masks_the_loop(solver):
    """Damping at damping_max ends the loop (the masked loop's exit): with
    damping_init = damping_max no step runs and the state is the input's;
    just under it, the steps run as in JAX."""
    scene = make_scene(np.random.default_rng(7), num_cameras=4,
                       num_landmarks=40, pose_noise=0.01, landmark_noise=0.05)
    got, want = _run_both(scene, max_iterations=5, damping_init=1e6,
                          solver=solver)
    _assert_same_state(got, want)
    assert int(got.iterations) == 0 and int(got.cg_iters) == 0
    assert torch.equal(got.poses, torch.from_numpy(scene["poses_init"]))
    got, want = _run_both(scene, max_iterations=4, damping_init=3e5,
                          solver=solver, cg_tol=1e-3)
    _assert_same_state(got, want)
    assert int(got.iterations) == 4


def test_run_ba_cauchy_outliers_matches_jax():
    rng = np.random.default_rng(5)
    scene = make_scene(rng, num_cameras=5, num_landmarks=120, pixel_noise=0.2,
                       pose_noise=0.01, landmark_noise=0.05)
    n = scene["obs_uv"].shape[0]
    bad = rng.choice(n, n // 10, replace=False)
    scene["obs_uv"][bad] += rng.uniform(30, 80, (bad.shape[0], 2)).astype(
        np.float32)
    scene = pad_observations(scene, 1024)
    kw = dict(huber_delta=1.0, loss="cauchy")
    got, want = _run_both(scene, max_iterations=5, **kw)
    _assert_same_state(got, want)
    st = run_ba(*_args(scene), BAConfig(max_iterations=30, **kw), _fixed(5))
    np.testing.assert_allclose(st.poses.numpy(), scene["poses_gt"], atol=1e-2)


def test_gnc_anneal_from_bad_init_on_the_corridor():
    sc = make_corridor_scene(np.random.default_rng(3), num_cameras=16,
                             num_landmarks=768, obs_per_camera=160,
                             pose_noise=0.02, landmark_noise=0.2)
    kw = dict(cg_iterations=30, solver="pcg")
    got, want = _run_both(sc, max_iterations=4, cg_tol=1e-3, **kw)
    _assert_same_state(got, want, lm_atol=2e-2)
    got, want = _run_both(sc, max_iterations=2, **kw)      # tol 1e-6
    _assert_same_state(got, want, lm_atol=2e-2)
    from sift_tpu_torch.ba.residuals import reprojection_residuals
    a = _args(sc)
    st = run_ba(*a, BAConfig(max_iterations=10, **kw), _fixed(16))
    r, _ = reprojection_residuals(st.poses, a[1], st.landmarks, *a[3:6])
    assert float(torch.linalg.vector_norm(r, dim=-1).median()) < 1.0


def test_singular_landmark_blocks_match_jax():
    """(a) A landmark seen once: its damped 3x3 block is near singular.
    (b) A landmark seen only by masked observations, with no damping: its
    block is exactly zero and its inverse non-finite in both packages (the
    port's inverse does not raise), as are the fixed cameras' zero blocks
    and so the dense Schur matrix and the Jacobi preconditioner; the
    finite guards zero every non-finite update, the landmark stays where
    it was, and the other landmarks still move as in JAX."""
    scene = make_scene(np.random.default_rng(8), num_cameras=4,
                       num_landmarks=40, pixel_noise=0.5, pose_noise=0.01,
                       landmark_noise=0.05)
    once = scene["obs_lm"] == 3
    keep = ~once | (np.cumsum(once) == 1)
    scene = {k: (v[keep] if k.startswith("obs_") else v)
             for k, v in scene.items()}
    got, want = _run_both(scene, max_iterations=4)
    _assert_same_state(got, want)

    masked = scene["obs_lm"] == 5
    assert masked.sum() >= 2
    scene["obs_valid"] = scene["obs_valid"] & ~masked
    sys = build_system(*_args(scene), 3.0, 0.0, _fixed(4))
    jsys = jbuild(*_args(scene, jnp), 3.0, 0.0, _fixed(4, jnp))
    # JAX's LU inverse gives NaN and inf there, the port's NaN.
    assert torch.isnan(sys.V_inv[5]).all()
    assert not np.isfinite(np.asarray(jsys.V_inv[5])).any()
    assert torch.isnan(dense_schur_solve(sys, schur_rhs(sys))).all()
    for solver in ("dense", "pcg"):
        got, want = _run_both(scene, max_iterations=3, damping_init=0.0,
                              solver=solver, cg_tol=1e-3)
        _assert_same_state(got, want)
        np.testing.assert_array_equal(got.landmarks[5].numpy(),
                                      scene["landmarks_init"][5])
        assert int(got.iterations) == 3


def test_masked_observations_are_inert():
    scene = pad_observations(make_scene(
        np.random.default_rng(6), num_cameras=4, num_landmarks=60,
        pose_noise=0.01, landmark_noise=0.05), 800)
    cfg = BAConfig(max_iterations=5, cg_iterations=30, solver="pcg")
    st1 = run_ba(*_args(scene), cfg, _fixed(4))
    uv2 = np.array(scene["obs_uv"])
    uv2[~scene["obs_valid"]] = 1e5
    st2 = run_ba(*_args(dict(scene, obs_uv=uv2)), cfg, _fixed(4))
    np.testing.assert_allclose(st1.poses.numpy(), st2.poses.numpy(), atol=1e-6)
    assert int(st1.cg_iters) == int(st2.cg_iters)


def test_run_ba_map_wrapper():
    scene = pad_observations(make_scene(
        np.random.default_rng(9), num_cameras=4, num_landmarks=60,
        pose_noise=0.01, landmark_noise=0.05), 512)
    a = _args(scene)
    state = MapState(poses=a[0], intrinsics=a[1], landmarks=a[2],
                     obs_cam=a[3], obs_lm=a[4], obs_uv=a[5],
                     pose_valid=torch.ones(4, dtype=torch.bool),
                     landmark_valid=torch.ones(60, dtype=torch.bool),
                     obs_valid=a[6])
    new_state, st = run_ba_map(state, BAConfig(max_iterations=10), _fixed(4))
    assert float(st.rmse) < 0.05
    assert torch.equal(new_state.poses, st.poses)
    assert torch.equal(new_state.landmarks, st.landmarks)
    assert new_state.obs_uv is state.obs_uv


def _localization_problem(seed, outliers=0.0):
    scene = make_scene(np.random.default_rng(seed), num_cameras=3,
                       num_landmarks=120, pixel_noise=0.5)
    sel = scene["obs_cam"] == 2
    lms = scene["landmarks_gt"][scene["obs_lm"][sel]]
    uv = scene["obs_uv"][sel].copy()
    rng = np.random.default_rng(seed + 100)
    bad = rng.random(uv.shape[0]) < outliers
    uv[bad] += rng.uniform(40, 90, (int(bad.sum()), 2)).astype(np.float32)
    valid = np.ones(uv.shape[0], bool)
    valid[-3:] = False
    init = (scene["poses_gt"][2] + rng.normal(0, 0.02, 6)).astype(np.float32)
    return (init, scene["intrinsics"], lms.astype(np.float32), uv, valid,
            scene["poses_gt"][2])


def test_pose_only_refine_matches_jax():
    init, K, lms, uv, valid, gt = _localization_problem(0, outliers=0.1)
    args = [init, K, lms, uv, valid]
    pose, inl, rmse = pose_only.pose_only_refine(
        *[torch.from_numpy(np.asarray(x)) for x in args])
    posej, inlj, rmsej = jpose.pose_only_refine(*[jnp.asarray(x) for x in args])
    np.testing.assert_allclose(pose.numpy(), np.asarray(posej), atol=1e-4)
    np.testing.assert_array_equal(inl.numpy(), np.asarray(inlj))
    np.testing.assert_allclose(float(rmse), float(rmsej), rtol=1e-3)
    np.testing.assert_allclose(pose.numpy(), gt, atol=5e-3)
    # A batch of poses is refined one by one.
    batch = np.stack([init, init + 0.01]).astype(np.float32)
    pb, ib, rb = pose_only.pose_only_refine(
        torch.from_numpy(batch), *[torch.from_numpy(np.asarray(x))
                                   for x in args[1:]])
    # (Rounding decides the accept tests once converged, so the batched
    # and the single solve may end a few steps apart: 2e-4.)
    np.testing.assert_allclose(pb[0].numpy(), pose.numpy(), atol=2e-4)
    assert ib.shape == (2, uv.shape[0]) and rb.shape == (2,)


def test_pose_ransac_refine_with_jax_noise():
    init, K, lms, uv, valid, gt = _localization_problem(1, outliers=0.3)
    key = jax.random.PRNGKey(2)
    g = np.array(jax.random.gumbel(key, (8, uv.shape[0])))
    args = [init, K, lms, uv, valid]
    pose, inl, rmse = pose_only.pose_ransac_refine(
        torch.from_numpy(g), *[torch.from_numpy(np.asarray(x)) for x in args])
    posej, inlj, rmsej = jpose.pose_ransac_refine(
        key, *[jnp.asarray(x) for x in args])
    np.testing.assert_allclose(pose.numpy(), np.asarray(posej), atol=1e-4)
    np.testing.assert_array_equal(inl.numpy(), np.asarray(inlj))
    np.testing.assert_allclose(float(rmse), float(rmsej), rtol=1e-3)
    np.testing.assert_allclose(pose.numpy(), gt, atol=2e-2)
    again = pose_only.pose_ransac_refine(
        torch.Generator().manual_seed(0),
        *[torch.from_numpy(np.asarray(x)) for x in args])
    np.testing.assert_allclose(again[0].numpy(), gt, atol=2e-2)


def test_refine_intrinsics_matches_jax():
    scene = pad_observations(make_scene(np.random.default_rng(0), num_cameras=6,
                                        num_landmarks=200), 2048)
    K0 = scene["intrinsics"] + np.array([25.0, -18.0, 6.0, -4.0], np.float32)
    args = [K0, scene["poses_gt"], scene["landmarks_gt"], scene["obs_cam"],
            scene["obs_lm"], scene["obs_uv"], scene["obs_valid"]]
    K, rmse = intrinsics.refine_intrinsics(
        *[torch.from_numpy(np.asarray(x)) for x in args])
    Kj, rmsej = jintr.refine_intrinsics(*[jnp.asarray(x) for x in args])
    np.testing.assert_allclose(K.numpy(), np.asarray(Kj), atol=1e-2)
    np.testing.assert_allclose(K.numpy(), scene["intrinsics"], atol=0.1)
    np.testing.assert_allclose(float(rmse), float(rmsej), atol=1e-3)
    assert float(rmse) < 0.05


def test_self_calibrate_matches_jax():
    scene = pad_observations(make_scene(
        np.random.default_rng(1), num_cameras=6, num_landmarks=200,
        pose_noise=0.01, landmark_noise=0.05), 2048)
    K0 = scene["intrinsics"] + np.array([15.0, -10.0, 4.0, -3.0], np.float32)
    a = _args(scene)
    kw = dict(max_iterations=5, cg_iterations=40)
    K, poses, _, st = intrinsics.self_calibrate(
        torch.from_numpy(K0), a[0], a[2], *a[3:], BAConfig(**kw), _fixed(6),
        rounds=2)
    aj = _args(scene, jnp)
    Kj, posesj, _, stj = jintr.self_calibrate(
        jnp.asarray(K0), aj[0], aj[2], *aj[3:], JaxBAConfig(**kw),
        _fixed(6, jnp), rounds=2)
    assert float(st.rmse) < 0.1
    np.testing.assert_allclose(K.numpy(), np.asarray(Kj), rtol=1e-3)
    np.testing.assert_allclose(poses.numpy(), np.asarray(posesj), atol=1e-3)
    assert int(st.iterations) == int(stj.iterations)
