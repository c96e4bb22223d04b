"""The port's SfM loop in RGB-D mode against the JAX package on the CPU:
the RGB-D variant of `tests/e2e/test_sfm_pipeline.py`
(`test_rgbd_pipeline_metric_scale`: the `SyntheticWorld` with depth maps
splatted from the true landmark depths, that test's configuration).

Both packages must meet that test's bound (rigid-aligned ATE < 0.1 m).
The port must bootstrap at the frame JAX does, keep a keyframe count
within 1 of JAX's, and give positions within POS_TOL of JAX's after a
rigid alignment (measured 1.70e-4 m on the CPU; POS_TOL is twice that).
The port runs on one CPU thread, as in `test_torch_sfm_loop.py`.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from sift_tpu.config import (BAConfig, MatchConfig, PipelineConfig,
                             RansacConfig, SiftConfig)
from sift_tpu.eval.ate import ate_rmse
from sift_tpu.geometry import lie
from sift_tpu.slam.pipeline import SfmPipeline as JaxSfmPipeline
from tests.e2e.test_sfm_pipeline import H, INTR, KP_CAP, W, SyntheticWorld
from tests.test_torch_sfm_loop import boot_frame, run_port, torch_threads

POS_TOL = 3.4e-4


def _depth_maps(world):
    """Per frame, the true landmark depths splatted 3x3 at their pixels
    (the e2e test's renderer)."""
    fx, fy, cx, cy = INTR
    out = []
    for i in range(len(world.poses)):
        R, t = lie.se3_exp(jnp.asarray(world.poses[i]))
        R, t = np.asarray(R), np.asarray(t)
        depth = np.zeros((H, W), np.float32)
        Xc = (world.X - t) @ R
        uu = fx * Xc[:, 0] / Xc[:, 2] + cx
        vv = fy * Xc[:, 1] / Xc[:, 2] + cy
        ok = (Xc[:, 2] > 0.5) & (uu >= 1) & (uu < W - 1) & (vv >= 1) & \
            (vv < H - 1)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                depth[vv[ok].astype(int) + dy,
                      uu[ok].astype(int) + dx] = Xc[ok, 2]
        out.append(depth)
    return out


@pytest.fixture(scope="module")
def runs():
    world = SyntheticWorld()
    cfg = PipelineConfig(
        sift=SiftConfig(mode="lowe", max_keypoints=KP_CAP),
        match=MatchConfig(ratio=0.85, max_matches=KP_CAP),
        ransac=RansacConfig(num_hypotheses=256, inlier_threshold=2.0,
                            min_inliers=15),
        ba=BAConfig(max_iterations=8, cg_iterations=30),
        window_size=6, ba_max_landmarks=1024, ba_max_observations=4096,
        kf_min_tracked=80, kf_max_interval=6,
        min_triangulation_angle_deg=0.25,
    )
    n = len(world.poses)
    frames = {i: world.frame_keypoints(i) for i in range(n)}
    depths = _depth_maps(world)
    jp = JaxSfmPipeline(INTR, cfg, frontend=lambda g: frames[int(g[0, 0])])
    for i in range(n):
        jp.process_frame(np.full((2, 2), i, np.float32), depth=depths[i])
    with torch_threads():
        pp = run_port(cfg, frames, n, depths=depths)
    return world, jp, pp


@pytest.mark.parametrize("which", ["port", "jax"])
def test_meets_the_e2e_bound(runs, which):
    world, jp, pp = runs
    pipe = pp if which == "port" else jp
    assert pipe.state == "tracking"
    ate = ate_rmse(pipe.positions(), world.positions, align=True,
                   with_scale=False)
    assert ate < 0.1, ate


def test_bootstrap_and_keyframes_agree(runs):
    _, jp, pp = runs
    assert boot_frame(pp) == boot_frame(jp) == 0
    assert abs(len(pp.keyframes) - len(jp.keyframes)) <= 1
    assert abs(pp.landmarks.shape[0] - jp.landmarks.shape[0]) <= \
        0.02 * jp.landmarks.shape[0]


def test_positions_agree_after_alignment(runs):
    _, jp, pp = runs
    assert ate_rmse(pp.positions(), jp.positions(), align=True,
                    with_scale=False) < POS_TOL
    assert all(r["tracked"] for r in pp.trajectory)
