"""Map maintenance in the port's `SfmPipeline` against the JAX package's
on the CPU: landmark fusion and compaction (the cases of
`tests/unit/test_landmark_fusion.py` and a random one, array for array),
a map the JAX package wrote (loaded bit for bit), full-map BA on it, on
one device and on a one-rank process mesh (the RMSE within GBA_RTOL of
JAX's), keyframe culling on it (the same
keyframes, edges, anchors and ids as JAX, then tracking on, as
`tests/e2e/test_sfm_pipeline.py::test_keyframe_culling_keeps_tracking`),
save -> load -> continue on the port, and periodic compaction
(`compact_interval_kf`), which must not change the trajectory.

The injected-keypoint `SyntheticWorld` of `tests/e2e/test_sfm_pipeline.py`
drives the runs; the port runs on one CPU thread
(`tests/test_torch_sfm_loop.py`).

Tolerances: host bookkeeping (fusion, compaction, culling, loading) is
exact. Full-map BA runs 8 LM iterations from the same map in both
packages, whose f32 sums differ in order: RMSE within GBA_RTOL = 1e-4
relative, poses within 1e-3. A resumed run against the uninterrupted one:
positions within 2e-2 (the bound of
`tests/e2e/test_map_save_resume.py`: the saved map holds no trajectory,
so the resumed run predicts its first pose from the last keyframe), and
two resumes from one map are bit-identical.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sift_tpu.config import (BAConfig, MatchConfig, PipelineConfig,
                             RansacConfig, SiftConfig)
from sift_tpu.slam.pipeline import Keyframe as JaxKeyframe
from sift_tpu.slam.pipeline import SfmPipeline as JaxSfmPipeline
from tests.e2e.test_sfm_pipeline import (INTR, KP_CAP, SyntheticWorld,
                                         _pipeline)
from tests.test_torch_sfm_loop import port_frames

from sift_tpu_torch.config import config_from_dict
from sift_tpu_torch.eval.ate import ate_rmse
from sift_tpu_torch.slam.pipeline import Keyframe, SfmPipeline
from tests.torch_dist_world import (  # noqa: F401
    one_torch_thread, torch_threads)

GBA_RTOL = 1e-4
RESUME_ATOL = 2e-2


def _port_cfg(cfg):
    return config_from_dict(dataclasses.asdict(cfg))


# ------------------------------------------------ fusion and compaction
def _twins(n_lm):
    """A JAX and a port pipeline with the same `n_lm` landmarks (row i =
    3i, 3i+1, 3i+2) and creator 0, and no keyframes."""
    jp = JaxSfmPipeline(INTR, PipelineConfig(), frontend=lambda g: None)
    pp = SfmPipeline(INTR, device="cpu")
    for p in (jp, pp):
        p.landmarks = np.arange(3 * n_lm, dtype=np.float32).reshape(-1, 3)
        p.lm_ref_kf = np.zeros(n_lm, np.int64)
    return jp, pp


def _add_kf(pipes, n, frame, kp_lm):
    """The same keyframe (n slots, landmark ids `kp_lm`) in both."""
    for p, cls in zip(pipes, (JaxKeyframe, Keyframe)):
        kp = dict(x=np.zeros(n, np.float32), y=np.zeros(n, np.float32),
                  valid=np.ones(n, bool), octave=np.zeros(n, np.int32),
                  u=np.zeros(n, np.float32), v=np.zeros(n, np.float32),
                  desc=np.zeros((n, 128), np.float32))
        kf = cls(frame, np.zeros(6, np.float32), kp)
        kf.kp_lm[:] = kp_lm
        p.keyframes.append(kf)


def _hold_equal(jp, pp):
    np.testing.assert_array_equal(pp.landmarks, jp.landmarks)
    np.testing.assert_array_equal(pp.lm_ref_kf, jp.lm_ref_kf)
    assert len(pp.keyframes) == len(jp.keyframes)
    for kj, kp in zip(jp.keyframes, pp.keyframes):
        np.testing.assert_array_equal(kp.kp_lm, kj.kp_lm)


def _adopt_and_merge(pipes):
    _add_kf(pipes, 8, 0, [0, 1, 2] + [-1] * 5)
    _add_kf(pipes, 8, 1, [4, -1, -1, -1, -1, 5, -1, -1])
    for p in pipes:
        p._fuse_loop_landmarks(p.keyframes[1], np.asarray([0, 1, 5]),
                               np.asarray([0, 1, 2]))


def _chain_one_at_a_time(pipes, D=24):
    _add_kf(pipes, 1, 0, [0])
    for i in range(D):
        _add_kf(pipes, 1, i + 1, [i + 1])
        for p in pipes:
            old = int(p.keyframes[-2].kp_lm[0])
            p._fuse_loop_landmarks(p.keyframes[-1], np.asarray([0]),
                                   np.asarray([old]))


def _chain_in_one_batch(pipes, D=24):
    _add_kf(pipes, D, 0, np.arange(1, D + 1))
    for p in pipes:
        p._fuse_loop_landmarks(p.keyframes[0], np.arange(D)[::-1].copy(),
                               np.arange(D)[::-1].copy())


def _compact_orphans(pipes):
    _add_kf(pipes, 8, 0, [0, 1, 2] + [-1] * 5)
    _add_kf(pipes, 8, 1, [4, -1, -1, -1, -1, 5, -1, -1])
    for p in pipes:
        p.lm_ref_kf = np.asarray([0, 0, 0, 1, 1, 1], np.int64)
        p._fuse_loop_landmarks(p.keyframes[1], np.asarray([0, 5]),
                               np.asarray([0, 2]))
    return [p.compact_landmarks() for p in pipes]


def _compact_singletons(pipes):
    _add_kf(pipes, 4, 0, [0, 1, 2, -1])
    _add_kf(pipes, 4, 1, [0, -1, -1, -1])
    return [p.compact_landmarks(min_refs=2) for p in pipes]


def _random_fuse_compact(pipes, seed=3):
    """Twelve keyframes with random ids over 200 landmarks, six closures
    fusing random slots onto random old ids, then compaction."""
    rng = np.random.default_rng(seed)
    for f in range(12):
        _add_kf(pipes, 64, f, np.where(rng.random(64) < 0.7,
                                       rng.integers(0, 200, 64), -1))
    for p in pipes:
        p.lm_ref_kf = np.repeat(np.arange(10), 20).astype(np.int64)
    for _ in range(6):
        k = int(rng.integers(0, 12))
        slots = rng.choice(64, 20, replace=False)
        olds = rng.integers(0, 200, 20)
        for p in pipes:
            p._fuse_loop_landmarks(p.keyframes[k], slots, olds)
    return [p.compact_landmarks() for p in pipes]


@pytest.mark.parametrize("case,n_lm", [
    (_adopt_and_merge, 6), (_chain_one_at_a_time, 25),
    (_chain_in_one_batch, 25), (_compact_orphans, 6),
    (_compact_singletons, 3), (_random_fuse_compact, 200)])
def test_fusion_and_compaction_match_jax(case, n_lm):
    jp, pp = _twins(n_lm)
    stats = case((jp, pp))
    if stats is not None:
        assert stats[1] == stats[0]
    _hold_equal(jp, pp)


def test_fusion_cases_hold_their_bounds():
    """The unit tests' own expectations, on the port."""
    jp, pp = _twins(6)
    _adopt_and_merge((jp, pp))
    kf0, kf1 = pp.keyframes
    assert kf1.kp_lm[1] == 1 and kf1.kp_lm[0] == 0 and kf1.kp_lm[5] == 2
    assert not any(np.isin(kf.kp_lm, [4, 5]).any() for kf in pp.keyframes)
    jp, pp = _twins(25)
    _chain_in_one_batch((jp, pp))
    assert (pp.keyframes[0].kp_lm == 0).all()
    jp, pp = _twins(6)
    assert _compact_orphans((jp, pp))[1] == dict(kept=3, dropped=3)
    np.testing.assert_array_equal(pp.landmarks,
                                  np.arange(9, dtype=np.float32).reshape(3, 3))


# ------------------------------------------- a JAX map: load, BA, cull
def _cull_cfg():
    """test_keyframe_culling_keeps_tracking's dense keyframing."""
    return PipelineConfig(
        sift=SiftConfig(mode="lowe", max_keypoints=KP_CAP),
        match=MatchConfig(ratio=0.85, max_matches=KP_CAP),
        ransac=RansacConfig(num_hypotheses=256, inlier_threshold=2.0,
                            min_inliers=15),
        ba=BAConfig(max_iterations=8, cg_iterations=30),
        window_size=4, ba_max_landmarks=1024, ba_max_observations=4096,
        min_bootstrap_parallax=6.0, kf_min_tracked=120, kf_max_interval=2,
        min_triangulation_angle_deg=0.25)


@pytest.fixture(scope="module")
def world():
    return SyntheticWorld()


@pytest.fixture(scope="module")
def jax_map(world, tmp_path_factory):
    """The JAX pipeline after 30 of the world's 40 frames, and the map it
    wrote then."""
    frames = {i: world.frame_keypoints(i) for i in range(30)}
    pipe = JaxSfmPipeline(INTR, _cull_cfg(),
                          frontend=lambda g: frames[int(g[0, 0])])
    for i in range(30):
        pipe.process_frame(np.full((2, 2), i, np.float32))
    path = str(tmp_path_factory.mktemp("map") / "jax_map.npz")
    pipe.save_map(path)
    return pipe, path


def _loaded(path, world=None):
    """A JAX and a port pipeline loaded from `path`; the port's frontend
    serves the world's frames."""
    jp = JaxSfmPipeline(INTR, _cull_cfg(), frontend=lambda g: None)
    jp.load_map(path)
    frames = port_frames({i: world.frame_keypoints(i) for i in range(40)}) \
        if world is not None else {}
    pp = SfmPipeline(INTR, _port_cfg(_cull_cfg()), device="cpu",
                     frontend=lambda g: frames[int(g[0, 0])])
    pp.load_map(path)
    return jp, pp


def test_jax_map_loads_bit_for_bit(jax_map):
    src, path = jax_map
    _, pp = _loaded(path)
    assert len(src.keyframes) >= 8
    np.testing.assert_array_equal(pp.landmarks, src.landmarks)
    np.testing.assert_array_equal(pp.lm_ref_kf, src.lm_ref_kf)
    assert (pp._frame_idx, pp._frames_since_kf, pp._frames_lost,
            pp.num_loop_closures, pp.state) == \
        (src._frame_idx, src._frames_since_kf, src._frames_lost,
         src.num_loop_closures, src.state)
    assert len(pp.keyframes) == len(src.keyframes)
    for ks, kp in zip(src.keyframes, pp.keyframes):
        assert kp.frame_idx == ks.frame_idx
        np.testing.assert_array_equal(kp.pose, ks.pose)
        np.testing.assert_array_equal(kp.kp_lm, ks.kp_lm)
        for f in ("x", "y", "valid", "octave", "u", "v"):
            np.testing.assert_array_equal(kp.kp[f], ks.kp[f])
        np.testing.assert_array_equal(kp.kp["desc"].numpy(),
                                      np.asarray(ks.kp["desc"]))
        np.testing.assert_array_equal(kp.kp["valid_t"].numpy(),
                                      ks.kp["valid"])
    assert len(pp.pose_edges) == len(src.pose_edges)
    for es, ep in zip(src.pose_edges, pp.pose_edges):
        assert (ep["i"], ep["j"], ep["kind"], ep["w"]) == \
            (es["i"], es["j"], es["kind"], es["w"])
        np.testing.assert_array_equal(ep["z"], es["z"])
    # The JAX map's prng_key is ignored: the generator is reseeded.
    assert torch.equal(pp._gen.get_state(),
                       torch.Generator().manual_seed(0).get_state())


def test_global_ba_on_jax_map_matches_jax(jax_map, tmp_path):
    jp, pp = _loaded(jax_map[1])
    want = jp.run_global_ba()
    got = pp.run_global_ba()
    assert {k: got[k] for k in ("n_obs", "n_cams", "n_lms")} == \
        {k: want[k] for k in ("n_obs", "n_cams", "n_lms")}
    assert got["rmse"] == pytest.approx(want["rmse"], rel=GBA_RTOL)
    for kj, kp in zip(jp.keyframes, pp.keyframes):
        np.testing.assert_allclose(kp.pose, kj.pose, atol=1e-3)
    # On a process mesh (a one-rank gloo world in this process) the same
    # map gives the same result: a one-rank all-reduce is the identity.
    from sift_tpu_torch.dist import make_mesh
    from sift_tpu_torch.dist.mesh import init_distributed
    _, pm = _loaded(jax_map[1])
    init_distributed("cpu", f"file://{tmp_path / 'store'}", 0, 1)
    try:
        with torch_threads():
            meshed = pm.run_global_ba(mesh=make_mesh())
    finally:
        torch.distributed.destroy_process_group()
    assert {k: meshed[k] for k in ("n_obs", "n_cams", "n_lms")} == \
        {k: want[k] for k in ("n_obs", "n_cams", "n_lms")}
    assert meshed["rmse"] == pytest.approx(want["rmse"], rel=GBA_RTOL)
    assert meshed["rmse"] == pytest.approx(got["rmse"], rel=GBA_RTOL)
    for kj, kp in zip(jp.keyframes, pm.keyframes):
        np.testing.assert_allclose(kp.pose, kj.pose, atol=1e-3)


def test_cull_keyframes_matches_jax_and_keeps_tracking(world, jax_map):
    jp, pp = _loaded(jax_map[1], world)
    want = jp.cull_keyframes(redundancy=0.5, min_other_refs=2)
    got = pp.cull_keyframes(redundancy=0.5, min_other_refs=2)
    assert got == want and got["culled"] >= 1, got
    assert [k.frame_idx for k in pp.keyframes] == \
        [k.frame_idx for k in jp.keyframes]
    _hold_equal(jp, pp)
    assert [(e["i"], e["j"], e["kind"]) for e in pp.pose_edges] == \
        [(e["i"], e["j"], e["kind"]) for e in jp.pose_edges]
    for ej, ep in zip(jp.pose_edges, pp.pose_edges):
        np.testing.assert_array_equal(ep["z"], ej["z"])
    assert pp.lm_ref_kf.max() < len(pp.keyframes)
    odo = [(e["i"], e["j"]) for e in pp.pose_edges if e["kind"] == "odom"]
    assert odo == [(k, k + 1) for k in range(len(pp.keyframes) - 1)]
    assert pp._global_index is not None

    for i in range(30, 40):
        pp.process_frame(np.full((2, 2), i, np.float32))
    tracked = [r["tracked"] for r in pp.trajectory]
    assert np.mean(tracked) > 0.8, tracked
    ate = ate_rmse(pp.positions(), world.positions[30:], align=True,
                   with_scale=True)
    assert ate < 0.08, ate


# ------------------------------------------------ save / resume, compaction
def _run(world, n, start=0, pipe=None, **overrides):
    cfg = _port_cfg(_pipeline(world).cfg.replace(**overrides))
    frames = port_frames({i: world.frame_keypoints(i)
                          for i in range(len(world.poses))})
    if pipe is None:
        pipe = SfmPipeline(INTR, cfg, device="cpu",
                           frontend=lambda g: frames[int(g[0, 0])])
    for i in range(start, n):
        pipe.process_frame(np.full((2, 2), i, np.float32))
    return pipe


def test_save_load_continue(tmp_path):
    """A port map saved mid-run loads into fresh pipelines with the same
    state (the generator's too); a resumed run follows the uninterrupted
    one, and two resumes from one map are identical."""
    world = SyntheticWorld(seed=3)
    cut, n = 15, 28
    a = _run(world, cut)
    path = str(tmp_path / "map.npz")
    a.save_map(path)
    resumed = []
    for _ in range(2):
        b = _run(world, 0)
        b.load_map(path)
        np.testing.assert_array_equal(b.landmarks, a.landmarks)
        np.testing.assert_array_equal(b.lm_ref_kf, a.lm_ref_kf)
        assert torch.equal(b._gen.get_state(), a._gen.get_state())
        assert b._frame_idx == a._frame_idx and b.state == a.state
        for ka, kb in zip(a.keyframes, b.keyframes):
            np.testing.assert_array_equal(kb.pose, ka.pose)
            np.testing.assert_array_equal(kb.kp_lm, ka.kp_lm)
            assert torch.equal(kb.kp["desc"], ka.kp["desc"])
            assert torch.equal(kb.kp["valid_t"], ka.kp["valid_t"])
        assert [(e["i"], e["j"], e["kind"]) for e in b.pose_edges] == \
            [(e["i"], e["j"], e["kind"]) for e in a.pose_edges]
        resumed.append(_run(world, n, start=cut, pipe=b))
    a = _run(world, n, start=cut, pipe=a)
    np.testing.assert_array_equal(resumed[0].positions(),
                                  resumed[1].positions())
    np.testing.assert_allclose(resumed[0].positions(),
                               a.positions()[cut:], atol=RESUME_ATOL)
    assert len(resumed[0].keyframes) == len(a.keyframes)


def test_periodic_compaction_is_result_neutral():
    """compact_interval_kf relabels landmark ids mid-run (a monotonic
    remap): the trajectory is the uncompacted run's, bit for bit."""
    world = SyntheticWorld()
    n = 20
    plain = _run(world, n)
    compacted = _run(world, n, compact_interval_kf=2)
    np.testing.assert_array_equal(compacted.positions(), plain.positions())
    assert compacted.landmarks.shape[0] <= plain.landmarks.shape[0]
    for kf in compacted.keyframes:
        assert kf.kp_lm.max() < compacted.landmarks.shape[0]
    compacted.compact_landmarks()
    refs = np.zeros(compacted.landmarks.shape[0], np.int64)
    for kf in compacted.keyframes:
        np.add.at(refs, kf.kp_lm[kf.kp_lm >= 0], 1)
    assert (refs > 0).all()
