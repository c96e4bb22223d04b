"""The device stages of the port's `SfmPipeline` against the JAX
instance's `_jit_*` stages on the CPU, fed the same inputs and JAX's own
Gumbel noise (drawn from the key the JAX stage consumes, with the key
splits the JAX stage makes).

Scene: `tests/e2e/test_sfm_pipeline.py::SyntheticWorld` (its keypoints are
landmark projections plus 0.3 px noise, its descriptors per-landmark codes
plus noise) with that file's pipeline configuration. What is compared:
- `_track_local`: the inlier count exactly, the pose within TRACK_POSE of
  each coordinate, the RMSE within 1e-3 px;
- `_kf_track` (guided promotion match): the matches as a set of (a, b)
  pairs, and each pair's inlier and health flags, exactly (two matches
  with near-equal distances may swap slots, ROADMAP queue 3 item 2); the
  pose within TRACK_POSE, triangulated points within TRI_RTOL of their
  norm;
- `_bootstrap` (E-vs-H over `boot_attempts` draws): success and model
  choice exactly, inlier and healthy-triangulation counts within 1%, the
  rotation within 0.05 deg and the baseline direction within 0.1 deg. The
  5-point candidate sets of the two packages differ, so where a pair has
  two RANSAC basins that tie on triangulation health, the two packages may
  reach them in other attempts and keep other ones: frames 10 and 14 of
  this world have two basins one inlier apart, 0.33 deg apart in
  rotation. The pairs below have one basin in every attempt of both;
- `_triangulate`: the health flags on 99% of the points, the points within
  TRI_RTOL of their norm (the tolerance of test_torch_epipolar.py: the
  DLT's f32 eigen-solve is ill-conditioned at short baselines, and the
  port solves it by Jacobi sweeps where JAX calls `eigh`);
- the local-map build: rows, ids and validity exactly;
- the window BA on a perturbed map (3 LM iterations, before f32 rounding
  decides the accept tests): poses and landmarks within BA_ATOL, the
  logged RMSE within 1e-4 relative and the iteration count exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sift_tpu.geometry import lie as jlie
from sift_tpu.slam.pipeline import Keyframe as JaxKeyframe
from sift_tpu.slam.pipeline import SfmPipeline as JaxSfmPipeline
from sift_tpu.slam.pipeline import _np_kp as jax_np_kp
from tests.e2e.test_sfm_pipeline import INTR, SyntheticWorld, _pipeline
from tests.test_torch_sfm_loop import torch_threads

from sift_tpu_torch.config import config_from_dict
from sift_tpu_torch.slam.pipeline import Keyframe, SfmPipeline, _np_kp
from sift_tpu_torch.types import Keypoints

TRACK_POSE = 2e-4
TRI_RTOL = 1e-3
BA_ATOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port on one CPU thread: reproducible sums (test_torch_sfm_loop.py)."""
    with torch_threads():
        yield


@pytest.fixture(scope="module")
def world():
    return SyntheticWorld()


def _make_pipes(world, **overrides):
    cfg = _pipeline(world).cfg.replace(**overrides)
    return (JaxSfmPipeline(INTR, cfg),
            SfmPipeline(INTR, config_from_dict(dataclasses.asdict(cfg)),
                        device="cpu"))


@pytest.fixture(scope="module")
def pipes(world):
    return _make_pipes(world)


def _project(world, i):
    """True pixel projections (L, 2) and camera-frame points of frame i."""
    fx, fy, cx, cy = INTR
    R, t = [np.asarray(x) for x in jlie.se3_exp(jnp.asarray(world.poses[i]))]
    Xc = (world.X - t) @ R
    return np.stack([fx * Xc[:, 0] / Xc[:, 2] + cx,
                     fy * Xc[:, 1] / Xc[:, 2] + cy], -1), Xc


def _t(x):
    return torch.from_numpy(np.array(x))


def _port_kp(kp) -> Keypoints:
    return Keypoints(**{f: _t(getattr(kp, f)) for f in (
        "x", "y", "octave", "level", "scale", "score", "orientation",
        "valid", "desc")})


def _perturb(pose, seed, scale=0.01):
    rng = np.random.default_rng(seed)
    return (np.asarray(pose) + rng.normal(0, scale, 6)).astype(np.float32)


def _local_map(world, n=192, cap=256):
    """The most salient landmarks: descriptors, validity, positions,
    padded to `cap`."""
    ids = np.argsort(-world.saliency)[:n]
    desc = np.zeros((cap, 128), np.float32)
    desc[:n] = world.codes[ids]
    valid = np.zeros(cap, bool)
    valid[:n] = True
    lms = np.zeros((cap, 3), np.float32)
    lms[:n] = world.X[ids]
    return desc, valid, lms


@pytest.mark.parametrize("frame,seed", [(6, 0), (15, 1), (30, 2)])
def test_track_local_matches_jax(world, pipes, frame, seed):
    jp, pp = pipes
    kp = world.frame_keypoints(frame)
    desc, valid, lms = _local_map(world)
    init = _perturb(world.poses[frame], seed)
    key = jax.random.PRNGKey(seed)
    noise = np.array(jax.random.gumbel(
        key, (jp.cfg.tracking_ransac_hypotheses, jp.cfg.match.max_matches)))
    want = np.asarray(jp._jit_track_local(
        key, jnp.asarray(init), jnp.asarray(desc), jnp.asarray(valid),
        jnp.asarray(lms), kp))
    got = pp._track_local(_t(noise), _t(init), _t(desc), _t(valid), _t(lms),
                          _port_kp(kp)).numpy()
    assert got.shape == want.shape == (8,)
    assert got[6] == want[6] and got[6] >= 100
    np.testing.assert_allclose(got[:6], want[:6], atol=TRACK_POSE)
    np.testing.assert_allclose(got[7], want[7], atol=1e-3)
    np.testing.assert_allclose(got[:6], world.poses[frame], atol=0.01)


def _kf_inputs(world, a, b):
    """Keyframe `a` as the reference (landmarks for half its keypoints),
    frame `b` as the query, as host arrays."""
    ka, kb = world.frame_keypoints(a), world.frame_keypoints(b)
    da = jax_np_kp(ka)
    db = jax_np_kp(kb)
    # Landmark of each of a's keypoints: the nearest true projection.
    uv, _ = _project(world, a)
    nearest = np.argmin(((da["u"][:, None] - uv[None, :, 0]) ** 2
                         + (da["v"][:, None] - uv[None, :, 1]) ** 2), axis=1)
    has = da["valid"] & (np.arange(da["x"].shape[0]) % 2 == 0)
    lms = world.X[nearest].astype(np.float32)
    uv_a = np.stack([da["u"], da["v"]], -1).astype(np.float32)
    uv_b = np.stack([db["u"], db["v"]], -1).astype(np.float32)
    return ka, kb, da, db, has, lms, uv_a, uv_b


@pytest.mark.parametrize("a,b,seed", [(6, 9, 3), (20, 24, 4)])
def test_kf_track_matches_jax(world, pipes, a, b, seed):
    jp, pp = pipes
    ka, kb, da, db, has, lms, uv_a, uv_b = _kf_inputs(world, a, b)
    init = _perturb(world.poses[b], seed, 0.005)
    ref = np.asarray(world.poses[a], np.float32)
    key = jax.random.PRNGKey(seed)
    M = jp.cfg.match.max_matches
    noise = np.array(jax.random.gumbel(key, (8, M)))
    want = np.asarray(jp._jit_kf_track[True](
        key, jnp.asarray(init), jnp.asarray(ref), ka.desc, ka.valid,
        jnp.asarray(lms), jnp.asarray(has), jnp.asarray(uv_a), kb.desc,
        kb.valid, jnp.asarray(uv_b)))
    got = pp._kf_track(True, _t(noise), _t(init), _t(ref), _t(ka.desc),
                       _t(ka.valid), _t(lms), _t(has), _t(uv_a), _t(kb.desc),
                       _t(kb.valid), _t(uv_b)).numpy()
    assert got.shape == want.shape == (8 * M + 8,)

    def by_pair(buf):
        ia, ib = buf[:M].astype(int), buf[M:2 * M].astype(int)
        valid, inl = buf[2 * M:3 * M] > 0.5, buf[3 * M:4 * M]
        tri = buf[4 * M:8 * M].reshape(M, 4)
        return {(ia[k], ib[k]): (inl[k], tri[k]) for k in np.nonzero(valid)[0]}

    g, w = by_pair(got), by_pair(want)
    assert set(g) == set(w) and len(g) >= 100
    # Inlier flags are per sorted slot of the 2D-3D rows: a slot swap moves
    # them with their pair only when both rows have a landmark.
    assert sorted(v[0] for v in g.values()) == sorted(v[0] for v in w.values())
    assert got[8 * M + 6] == want[8 * M + 6] and got[8 * M + 6] >= 50
    np.testing.assert_allclose(got[8 * M:8 * M + 6], want[8 * M:8 * M + 6],
                               atol=TRACK_POSE)
    tri_g = np.stack([g[k][1] for k in sorted(w)])
    tri_w = np.stack([w[k][1] for k in sorted(w)])
    np.testing.assert_array_equal(tri_g[:, 3], tri_w[:, 3])
    ok = tri_w[:, 3] > 0.5
    assert ok.sum() > 20
    scale = np.linalg.norm(tri_w[ok, :3], axis=1, keepdims=True)
    np.testing.assert_allclose(tri_g[ok, :3] / scale, tri_w[ok, :3] / scale,
                               atol=TRI_RTOL)


def _boot_pair(world, a, b, cap, seed):
    """Matched pixel pairs of frames a and b through the true landmark
    identity, padded to `cap`, with a few planted outliers."""
    rng = np.random.default_rng(seed)
    uvs = [_project(world, i)[0] for i in (a, b)]
    vis = np.all([(u[:, 0] >= 0) & (u[:, 0] < 640) & (u[:, 1] >= 0)
                  & (u[:, 1] < 480) for u in uvs], axis=0)
    ids = np.nonzero(vis)[0][:cap - 20]
    n = ids.shape[0]
    pa = np.zeros((cap, 2), np.float32)
    pb = np.zeros((cap, 2), np.float32)
    pa[:n] = uvs[0][ids] + rng.normal(0, 0.3, (n, 2))
    pb[:n] = uvs[1][ids] + rng.normal(0, 0.3, (n, 2))
    out = rng.choice(n, 15, replace=False)
    pb[out] = rng.uniform([0, 0], [640, 480], (15, 2))
    valid = np.zeros(cap, bool)
    valid[:n] = True
    return pa, pb, valid


def _rot_deg(Ra, Rb):
    R = np.asarray(Ra, np.float64) @ np.asarray(Rb, np.float64).T
    s = np.linalg.norm([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                        R[1, 0] - R[0, 1]]) / 2.0
    return np.degrees(np.arctan2(s, (np.trace(R) - 1.0) / 2.0))


@pytest.mark.parametrize("a,b,seed", [(0, 3, 5), (0, 6, 5), (10, 18, 6)])
def test_bootstrap_matches_jax(world, pipes, a, b, seed):
    jp, pp = pipes
    M = jp.cfg.match.max_matches
    pa, pb, valid = _boot_pair(world, a, b, M, seed)
    key = jax.random.PRNGKey(seed)
    H = jp.cfg.ransac.num_hypotheses
    ge, gh = [], []
    for k in jax.random.split(key, jp.cfg.boot_attempts):
        ke, kh = jax.random.split(k)
        ge.append(np.array(jax.random.gumbel(ke, (H, M))))
        gh.append(np.array(jax.random.gumbel(kh, (H, M))))
    want = [np.asarray(x) for x in jp._jit_bootstrap(
        key, jnp.asarray(pa), jnp.asarray(pb), jnp.asarray(valid))]
    got = [x.numpy() for x in pp._bootstrap(
        (_t(np.stack(ge)), _t(np.stack(gh))), _t(pa), _t(pb), _t(valid))]
    R, t, X, good, n_inl, success, use_h = got
    Rj, tj, Xj, goodj, n_inlj, successj, use_hj = want
    assert bool(success) and bool(successj)
    assert bool(use_h) == bool(use_hj)
    assert abs(int(n_inl) - int(n_inlj)) <= 0.01 * int(n_inlj)
    assert abs(int(good.sum()) - int(goodj.sum())) <= 0.01 * int(goodj.sum())
    assert good.sum() > 100
    assert _rot_deg(R, Rj) < 0.05
    assert np.degrees(np.arccos(np.clip(t @ tj, -1, 1))) < 0.1
    both = good & goodj
    np.testing.assert_allclose(X[both], Xj[both], rtol=0, atol=5e-3 * np.abs(
        Xj[both]).max())


@pytest.mark.parametrize("a,b", [(0, 6), (12, 20)])
def test_triangulate_matches_jax(world, pipes, a, b):
    jp, pp = pipes
    M = jp.cfg.match.max_matches
    pa, pb, valid = _boot_pair(world, a, b, M, 7)
    pose_a = np.asarray(world.poses[a], np.float32)
    pose_b = np.asarray(world.poses[b], np.float32)
    want = np.asarray(jp._jit_triangulate(jnp.asarray(pose_a),
                                          jnp.asarray(pose_b),
                                          jnp.asarray(pa), jnp.asarray(pb)))
    got = pp._triangulate(_t(pose_a), _t(pose_b), _t(pa), _t(pb)).numpy()
    assert got.shape == want.shape == (M, 4)
    ok = valid & np.isfinite(want).all(axis=1)
    scale = np.maximum(np.linalg.norm(want[ok, :3], axis=1, keepdims=True), 1)
    np.testing.assert_allclose(got[ok, :3] / scale, want[ok, :3] / scale,
                               atol=TRI_RTOL)
    # Health flags agree wherever the reprojection error and the angle are
    # clear of their thresholds (the same test, recomputed in float64).
    assert (got[ok, 3] == want[ok, 3]).mean() > 0.99
    assert want[ok, 3].sum() > 100


def _twin_keyframes(world, jp, pp, frames, seed):
    """The same keyframes in both pipelines: keypoints of the given frames,
    landmark ids by true identity for every third keypoint."""
    rng = np.random.default_rng(seed)
    jp.keyframes, pp.keyframes = [], []
    for f in frames:
        kp = world.frame_keypoints(f)
        dj = jax_np_kp(kp)
        dp = _np_kp(_port_kp(kp))
        kfj = JaxKeyframe(f, np.asarray(world.poses[f]), dj)
        kfp = Keyframe(f, np.asarray(world.poses[f]), dp)
        lm = np.where(dj["valid"] & (rng.random(dj["x"].shape[0]) < 0.6),
                      rng.integers(0, 300, dj["x"].shape[0]), -1)
        kfj.kp_lm = lm.copy()
        kfp.kp_lm = lm.copy()
        jp.keyframes.append(kfj)
        pp.keyframes.append(kfp)


@pytest.mark.parametrize("frames", [[0, 4, 8], [2, 5, 9, 14, 20, 26, 31, 35,
                                                 38]])
def test_local_map_build_matches_jax(world, pipes, frames):
    jp, pp = pipes
    _twin_keyframes(world, jp, pp, frames, len(frames))
    jp._local_map_cache = pp._local_map_cache = None
    jp._map_version += 1
    pp._map_version += 1
    dj, vj, ij = jp._build_local_map()
    dp, vp, ip, vtp = pp._build_local_map()
    np.testing.assert_array_equal(vp, vj)
    np.testing.assert_array_equal(vtp.numpy(), vj)
    np.testing.assert_array_equal(ip, ij)
    np.testing.assert_array_equal(dp.numpy(), np.asarray(dj))
    assert vp.sum() > 100
    assert pp._build_local_map() is pp._local_map_cache[1]   # cached


@pytest.mark.parametrize("frames,seed", [([0, 3, 6, 9, 12, 15], 8),
                                         ([10, 13, 16, 19], 9)])
def test_window_ba_matches_jax(world, frames, seed):
    """Keyframes observe true landmarks (noisy pixels); poses after the
    two fixed ones and all landmarks start perturbed."""
    jp, pp = _make_pipes(world, ba_tracking_iterations=3)
    logs = {}
    for name, pipe in (("jax", jp), ("port", pp)):
        pipe.logger = type("Log", (), {"log": lambda self, ev, _n=name, **kw:
                                       logs.setdefault(_n, []).append(
                                           (ev, kw))})()
    rng = np.random.default_rng(seed)
    lm_ids = np.arange(world.X.shape[0])
    for f in frames:
        uv, Xc = _project(world, f)
        u, v = uv[:, 0], uv[:, 1]
        vis = np.nonzero((Xc[:, 2] > 0.5) & (u >= 0) & (u < 640) & (v >= 0)
                         & (v < 480))[0][:150]
        n = vis.shape[0]
        kp = dict(x=np.zeros(n, np.float32), y=np.zeros(n, np.float32),
                  valid=np.ones(n, bool), octave=np.zeros(n, np.int32),
                  u=u[vis] + rng.normal(0, 0.3, n),
                  v=v[vis] + rng.normal(0, 0.3, n))
        pose0 = np.asarray(world.poses[f], np.float32)
        if len(jp.keyframes) >= 2:
            pose0 = _perturb(pose0, seed + f, 0.003)
        for pipe, K in ((jp, JaxKeyframe), (pp, Keyframe)):
            kf = K(f, pose0, dict(kp))
            kf.kp_lm = lm_ids[vis].copy()
            pipe.keyframes.append(kf)
    lms = (world.X + rng.normal(0, 0.02, world.X.shape)).astype(np.float32)
    for pipe in (jp, pp):
        pipe.landmarks = lms.copy()
        pipe.state = "tracking"
    jp._run_window_ba(fix_first_n=2)
    pp._run_window_ba(fix_first_n=2)
    for kj, kp_ in zip(jp.keyframes, pp.keyframes):
        np.testing.assert_allclose(kp_.pose, kj.pose, atol=BA_ATOL)
    moved = np.abs(pp.landmarks - lms).max()
    assert moved > 1e-3
    np.testing.assert_allclose(pp.landmarks, jp.landmarks, atol=BA_ATOL)
    (ev_j, kw_j), (ev_p, kw_p) = logs["jax"][-1], logs["port"][-1]
    assert ev_j == ev_p == "window_ba"
    assert kw_p["iters"] == kw_j["iters"] == 3
    assert (kw_p["n_obs"], kw_p["n_lms"]) == (kw_j["n_obs"], kw_j["n_lms"])
    np.testing.assert_allclose(kw_p["rmse"], kw_j["rmse"], rtol=1e-4)
    assert kw_p["rmse"] < 1.0
