"""Loop closure in the port's `SfmPipeline` against the JAX package's on
the CPU, on the injected-keypoint worlds of
`tests/e2e/test_sfm_pipeline.py` (`SyntheticWorld`, `LoopWorld`) with
that file's loop configuration (`_loop_cfg`).

The JAX pipeline runs the world once; its maps after 16 and 24 frames
(written by its `save_map`) are loaded into fresh pipelines of both
packages, so each comparison starts from one state:
- the fused loop probe (`_loop_probe`) on a forced revisit, fed JAX's
  Gumbel noise: per candidate the counts exactly, the 2D-3D rows as a set
  (two matches at near-equal distances may swap slots), the pose within
  PROBE_POSE and the RMSE within 1e-3 px;
- `_try_loop_closure` on the forced revisit (keyframe 0's keypoints with
  fresh slots, `test_loop_probe_accepts_revisit`): the same accepted
  candidate and loop edge, the same fused landmark ids in every keyframe,
  and the pose graph's result, keyframe poses within POSE_TOL and
  landmarks within LM_RTOL of their norm;
- the SE(3) graph re-anchoring an injected rigid drift
  (`test_pose_graph_correction_reanchors_map`) and the Sim(3) graph
  correcting an injected scale drift
  (`test_sim3_pose_graph_corrects_scale_drift`), held to both JAX's
  result (same tolerances) and that test's own bounds.
Last, the port alone runs the out-and-back corridor
(`test_out_and_back_stays_consistent`) to that test's bounds. The port
runs on one CPU thread (`tests/test_torch_sfm_loop.py`).

Tolerances: the probe's pose comes out of `pose_ransac_refine`'s 8 GN
iterations, which the two packages' f32 sums end at slightly different
points: 2.9e-4 apart (keyframe 0's keypoints localized in keyframe 2's
map), so PROBE_POSE = 5e-4. A closure's graph is solved from that pose;
POSE_TOL = 1e-3 covers what 15 LM iterations make of it, and the
landmarks follow their keyframes (LM_RTOL of their norm).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sift_tpu.slam.pipeline import Keyframe as JaxKeyframe
from sift_tpu.slam.pipeline import SfmPipeline as JaxSfmPipeline
from tests.e2e.test_sfm_pipeline import (INTR, LoopWorld, SyntheticWorld,
                                         _loop_cfg)
from tests.test_torch_sfm_loop import port_frames

from sift_tpu_torch.config import config_from_dict
from sift_tpu_torch.eval.ate import ate_rmse
from sift_tpu_torch.geometry import lie_np
from sift_tpu_torch.slam.pipeline import Keyframe, SfmPipeline
from tests.torch_dist_world import one_torch_thread  # noqa: F401

PROBE_POSE = 5e-4
POSE_TOL = 1e-3
LM_RTOL = 1e-3


@pytest.fixture(scope="module")
def world():
    return SyntheticWorld()


@pytest.fixture(scope="module")
def jax_maps(world, tmp_path_factory):
    """The JAX pipeline's maps after 16 and 24 frames of the world."""
    frames = {i: world.frame_keypoints(i) for i in range(24)}
    pipe = JaxSfmPipeline(INTR, _loop_cfg(),
                          frontend=lambda g: frames[int(g[0, 0])])
    paths = {}
    for i in range(24):
        pipe.process_frame(np.full((2, 2), i, np.float32))
        if i + 1 in (16, 24):
            paths[i + 1] = str(tmp_path_factory.mktemp("maps") /
                               f"map{i + 1}.npz")
            pipe.save_map(paths[i + 1])
    return paths


def _pipes(path, **overrides):
    """A JAX and a port pipeline, both loaded from the JAX map at
    `path`."""
    cfg = _loop_cfg().replace(**overrides)
    jp = JaxSfmPipeline(INTR, cfg, frontend=lambda g: None)
    pp = SfmPipeline(INTR, config_from_dict(dataclasses.asdict(cfg)),
                     device="cpu")
    jp.load_map(path)
    pp.load_map(path)
    return jp, pp


def _add_revisit(jp, pp):
    """Keyframe 0's keypoints as a new keyframe with fresh slots, in both
    pipelines; returns its index."""
    for p, cls in ((jp, JaxKeyframe), (pp, Keyframe)):
        kf0 = p.keyframes[0]
        p.keyframes.append(cls(p._frame_idx + 1, kf0.pose.copy(), kf0.kp))
    return len(pp.keyframes) - 1


def _probe_noise(key, kc, m):
    """The JAX probe's Gumbel draws: one per candidate from its key
    split, (Kc, 8, M)."""
    keys = jax.random.split(key, kc)
    return torch.from_numpy(np.stack([
        np.array(jax.random.gumbel(k, (8, m))) for k in keys]))


def _record_key(pipe):
    """Make the JAX pipeline record the keys it hands out."""
    keys = []
    draw = pipe._next_key

    def next_key():
        keys.append(draw())
        return keys[-1]

    pipe._next_key = next_key
    return keys


def _hold_maps(jp, pp):
    for kj, kp in zip(jp.keyframes, pp.keyframes):
        np.testing.assert_allclose(kp.pose, kj.pose, atol=POSE_TOL)
    scale = np.maximum(np.linalg.norm(jp.landmarks, axis=1, keepdims=True),
                       1.0)
    np.testing.assert_allclose(pp.landmarks / scale, jp.landmarks / scale,
                               atol=LM_RTOL)


def test_loop_probe_matches_jax(jax_maps):
    jp, pp = _pipes(jax_maps[24])
    new_idx = _add_revisit(jp, pp)
    new_j, new_p = jp.keyframes[new_idx], pp.keyframes[new_idx]
    cands = [0, 1, 2]
    Kc, N = jp.cfg.loop_candidates, new_j.kp["x"].shape[0]
    M = jp.cfg.match.max_matches
    kp_lm = np.zeros((Kc, N), np.float32)
    valid = np.zeros((Kc, N), np.float32)
    ok = np.zeros(Kc, np.float32)
    for s, oi in enumerate(cands):
        kp_lm[s] = jp.keyframes[oi].kp_lm
        valid[s] = jp.keyframes[oi].kp["valid"]
        ok[s] = 1.0
    uv_q = np.stack([new_j.kp["u"], new_j.kp["v"]], -1).astype(np.float32)
    packed = np.concatenate([kp_lm.ravel(), valid.ravel(), uv_q.ravel(),
                             new_j.kp["valid"].astype(np.float32), ok])
    L = jp.landmarks.shape[0]
    lm_table = np.zeros((4096, 3), np.float32)
    lm_table[:L] = jp.landmarks
    order = cands + [cands[0]] * (Kc - len(cands))
    key = jax.random.PRNGKey(5)
    want = np.asarray(jp._jit_loop_probe(
        key, jnp.asarray(new_j.pose),
        jnp.stack([jnp.asarray(jp.keyframes[o].kp["desc"]) for o in order]),
        jnp.asarray(new_j.kp["desc"]), jnp.asarray(packed),
        jnp.asarray(lm_table)))
    got = pp._loop_probe(
        _probe_noise(key, Kc, M), torch.from_numpy(new_p.pose.copy()),
        torch.stack([pp.keyframes[o].kp["desc"] for o in order]),
        new_p.kp["desc"], torch.from_numpy(packed),
        torch.from_numpy(lm_table)).numpy()
    assert got.shape == want.shape == (Kc, 9 + 3 * M)
    for s in range(Kc):
        g, w = got[s], want[s]
        np.testing.assert_array_equal(g[6:8], w[6:8])      # n_has, n_inl

        def rows(r):
            inl = r[9 + 2 * M:] > 0.5
            return sorted(zip(r[9:9 + M][inl], r[9 + M:9 + 2 * M][inl]))

        assert rows(g) == rows(w)
        np.testing.assert_allclose(g[:6], w[:6], atol=PROBE_POSE)
        np.testing.assert_allclose(g[8], w[8], atol=1e-3)
    assert got[0, 7] >= jp.cfg.loop_min_inliers        # keyframe 0: a hit
    assert (got[3:, 6] == 0).all()                     # padding rows


@pytest.mark.parametrize("sim3", [False, True])
def test_forced_revisit_closes_like_jax(jax_maps, sim3):
    """`_try_loop_closure` on keyframe 0's keypoints with fresh slots
    (no shared ids, so the covisibility gate passes): the probe must
    accept keyframe 0, add one loop edge, fuse at least loop_min_inliers
    slots and optimize the graph, as in JAX."""
    jp, pp = _pipes(jax_maps[24], pose_graph_sim3=sim3)
    new_idx = _add_revisit(jp, pp)
    keys = _record_key(jp)
    jp._try_loop_closure(new_idx)
    noise = _probe_noise(keys[0], jp.cfg.loop_candidates,
                         jp.cfg.match.max_matches)
    pp._next_key = lambda: noise
    pp._try_loop_closure(new_idx)

    assert pp.num_loop_closures == jp.num_loop_closures == 1
    assert [(r["old"], r["n_has"], r["n_inl"], r["accepted"])
            for r in pp.loop_probe_log] == \
        [(r["old"], r["n_has"], r["n_inl"], r["accepted"])
         for r in jp.loop_probe_log]
    ej, ep = jp.pose_edges[-1], pp.pose_edges[-1]
    assert (ep["i"], ep["j"], ep["kind"]) == (ej["i"], ej["j"], "loop") == \
        (0, new_idx, "loop")
    np.testing.assert_allclose(ep["z"], ej["z"], atol=POSE_TOL)
    assert ep["sigma"] == pytest.approx(ej["sigma"], abs=1e-4)
    for kj, kp in zip(jp.keyframes, pp.keyframes):
        np.testing.assert_array_equal(kp.kp_lm, kj.kp_lm)
    assert (pp.keyframes[new_idx].kp_lm >= 0).sum() >= \
        pp.cfg.loop_min_inliers
    _hold_maps(jp, pp)


def _drift(pipes, s_d, drift):
    """Similarity drift (scale s_d about the origin, then a rigid offset)
    on keyframes >= 2 and the landmarks they created, in both pipelines,
    and a loop edge carrying the true relative pose kf0 -> last (with
    sigma = -log(s_d) when s_d != 1). Returns the true last pose and the
    drifted landmark mask."""
    jp, pp = pipes
    true_last = pp.keyframes[-1].pose.copy()
    Rd, td = lie_np.se3_exp(np.asarray(drift, np.float32))
    mask = pp.lm_ref_kf >= 2
    for p in pipes:
        for k in range(2, len(p.keyframes)):
            R, t = lie_np.se3_exp(p.keyframes[k].pose)
            p.keyframes[k].pose = lie_np.se3_log(
                Rd @ R, (s_d * (Rd @ t) + td).astype(np.float32))
        p.landmarks[mask] = s_d * (p.landmarks[mask] @ Rd.T) + td
        edge = dict(i=0, j=len(p.keyframes) - 1, kind="loop",
                    z=p._rel_pose(p.keyframes[0].pose, true_last), w=100.0)
        if s_d != 1.0:
            edge["sigma"] = float(-np.log(s_d))
        p.pose_edges.append(edge)
    return true_last, mask


def test_pose_graph_reanchors_drift_like_jax(jax_maps):
    """Rigid drift on the later keyframes and their landmarks, pulled back
    by a ground-truth loop edge; landmarks move with their keyframes."""
    pipes = _pipes(jax_maps[16])
    jp, pp = pipes
    assert len(pp.keyframes) >= 4
    true_last, _ = _drift(pipes, 1.0, [0.0, 0.03, 0.0, 0.4, -0.2, 0.1])
    for p in pipes:
        p._run_pose_graph()
    _hold_maps(jp, pp)
    _, t_fixed = lie_np.se3_exp(pp.keyframes[-1].pose)
    _, t_true = lie_np.se3_exp(true_last)
    assert np.linalg.norm(t_fixed - t_true) < 0.15
    # Self-reprojection of the last keyframe stays tight.
    fx, fy, cx, cy = INTR
    kf = pp.keyframes[-1]
    slots = np.nonzero(kf.kp_lm >= 0)[0]
    R, t = lie_np.se3_exp(kf.pose)
    Xc = (pp.landmarks[kf.kp_lm[slots]] - t) @ R
    pred = np.stack([fx * Xc[:, 0] / Xc[:, 2] + cx,
                     fy * Xc[:, 1] / Xc[:, 2] + cy], -1)
    err = np.linalg.norm(pred - np.stack([kf.kp["u"][slots],
                                          kf.kp["v"][slots]], -1), axis=-1)
    assert np.median(err[np.isfinite(err)]) < 2.0


def test_sim3_graph_corrects_scale_drift_like_jax(jax_maps):
    """Similarity drift (scale 1.25) on the later keyframes and their
    landmarks; the Sim(3) graph with the loop edge's relative scale must
    restore position and scale."""
    pipes = _pipes(jax_maps[16], pose_graph_sim3=True)
    jp, pp = pipes
    mask = pp.lm_ref_kf >= 2
    lm = pp.landmarks[mask][:40]
    d_true = np.linalg.norm(lm[:, None] - lm[None], axis=-1)
    true_last, mask = _drift(pipes, 1.25, [0.0, 0.02, 0.0, 0.3, -0.1, 0.05])
    for p in pipes:
        p._run_pose_graph()
    _hold_maps(jp, pp)
    _, t_fixed = lie_np.se3_exp(pp.keyframes[-1].pose)
    _, t_true = lie_np.se3_exp(true_last)
    assert np.linalg.norm(t_fixed - t_true) < 0.2
    lm = pp.landmarks[mask][:40]
    d_after = np.linalg.norm(lm[:, None] - lm[None], axis=-1)
    ratio = d_after[d_true > 1.0] / d_true[d_true > 1.0]
    assert abs(np.median(ratio) - 1.0) < 0.08, np.median(ratio)


def test_out_and_back_stays_consistent():
    """The corridor out and back with loop closure on: the trajectory
    returns to the start with ATE < 0.05 and no lost frame (the bounds of
    the JAX test)."""
    world = LoopWorld()
    frames = port_frames({i: world.frame_keypoints(i)
                          for i in range(len(world.poses))})
    pipe = SfmPipeline(INTR, config_from_dict(dataclasses.asdict(
        _loop_cfg())), frontend=lambda g: frames[int(g[0, 0])],
        device="cpu")
    lost = 0
    for i in range(len(world.poses)):
        r = pipe.process_frame(np.full((2, 2), i, np.float32))
        lost += 0 if r["tracked"] else 1
    assert pipe.state == "tracking"
    assert lost == 0
    ate = ate_rmse(pipe.positions(), world.positions, align=True,
                   with_scale=True)
    assert ate < 0.05, ate
    # Every probe is logged with its gates; a closure is only counted
    # when one was accepted.
    assert pipe.num_loop_closures == sum(r["accepted"]
                                         for r in pipe.loop_probe_log)
