"""The port's whole SfM loop against the JAX package on the CPU, on the
injected-frontend `SyntheticWorld` of `tests/e2e/test_sfm_pipeline.py`
(40 frames, monocular, that file's configuration), fed to both packages.

Both packages must meet that file's bounds (`test_incremental_sfm_tracks_
trajectory`). Beyond them, the port must leave bootstrap at the frame JAX
does, keep a keyframe count within 1 of JAX's, and give positions within
POS_TOL of JAX's after a similarity alignment (the trajectories' own sim3
ATE against each other measured 4.95e-4 m on the CPU; POS_TOL is twice
that, rounded down). Two port runs with one seed are identical.

The port runs on one CPU thread here (`torch_threads`): with several, the
CPU BLAS picks its partition of a product at run time, so sums differ in
the last bits from run to run, and a RANSAC count that ties can flip, so
two 8-thread runs of this world can part. On one thread two runs are
bit-identical, loaded machine or not.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from sift_tpu.eval.ate import ate_rmse
from tests.e2e.test_sfm_pipeline import INTR, SyntheticWorld, _pipeline

from sift_tpu_torch.config import config_from_dict
from sift_tpu_torch.eval.ate import ate_rmse as port_ate_rmse
from sift_tpu_torch.slam.pipeline import SfmPipeline
from sift_tpu_torch.types import Keypoints

POS_TOL = 9.9e-4


def port_frames(frames):
    """JAX `Keypoints` -> the port's, per frame index."""
    return {i: Keypoints(**{f: torch.from_numpy(np.array(getattr(kp, f)))
                            for f in ("x", "y", "octave", "level", "scale",
                                      "score", "orientation", "valid",
                                      "desc")})
            for i, kp in frames.items()}


@contextlib.contextmanager
def torch_threads(n: int = 1):
    """Run the block on `n` CPU threads of PyTorch."""
    threads = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def run_port(cfg, frames, n, seed=0, depths=None, logger=None):
    pf = port_frames(frames)
    pipe = SfmPipeline(INTR, config_from_dict(dataclasses.asdict(cfg)),
                       seed=seed, frontend=lambda g: pf[int(g[0, 0])],
                       device="cpu", logger=logger)
    for i in range(n):
        pipe.process_frame(np.full((2, 2), i, np.float32),
                           depth=None if depths is None else depths[i])
    return pipe


def boot_frame(pipe):
    return next(i for i, r in enumerate(pipe.trajectory)
                if r["state"] == "tracking")


class _Events:
    def __init__(self):
        self.events = []

    def log(self, event, **fields):
        self.events.append((event, fields))


@pytest.fixture(scope="module")
def runs():
    world = SyntheticWorld()
    jp = _pipeline(world)            # draws every frame's keypoints in order
    n = len(world.poses)
    frames = {i: world.frame_keypoints(i) for i in range(n)}
    for i in range(n):
        jp.process_frame(np.full((2, 2), i, np.float32))
    log = _Events()
    with torch_threads():
        pp = run_port(jp.cfg, frames, n, logger=log)
    return world, frames, jp, pp, log


@pytest.mark.parametrize("which", ["port", "jax"])
def test_meets_the_e2e_bounds(runs, which):
    world, _, jp, pp, _ = runs
    pipe = pp if which == "port" else jp
    assert pipe.state == "tracking"
    tracked = [r["tracked"] for r in pipe.trajectory]
    assert np.mean(tracked[2:]) > 0.95
    assert len(pipe.keyframes) >= 4
    assert pipe.landmarks.shape[0] > 100
    ate = ate_rmse(pipe.positions(), world.positions, align=True,
                   with_scale=True)
    assert ate < 0.1, ate


def test_bootstrap_and_keyframes_agree(runs):
    _, _, jp, pp, _ = runs
    assert boot_frame(pp) == boot_frame(jp)
    assert abs(len(pp.keyframes) - len(jp.keyframes)) <= 1
    assert [r["is_keyframe"] for r in pp.trajectory][:boot_frame(jp) + 1] == \
        [r["is_keyframe"] for r in jp.trajectory][:boot_frame(jp) + 1]


def test_positions_agree_after_alignment(runs):
    _, _, jp, pp, _ = runs
    est, ref = pp.positions(), jp.positions()
    assert est.shape == ref.shape == (40, 3)
    assert port_ate_rmse(est, ref, align=True, with_scale=True) < POS_TOL


def test_trajectory_outputs(runs):
    _, _, _, pp, log = runs
    Rs, ts = pp.poses_Rt()
    assert Rs.shape == (40, 3, 3) and ts.shape == (40, 3)
    np.testing.assert_allclose(ts, pp.positions(), atol=1e-6)
    np.testing.assert_allclose(Rs @ Rs.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), Rs.shape), atol=1e-5)
    names = [e for e, _ in log.events]
    assert names.count("frame") == 40 and "bootstrap" in names
    assert names.count("keyframe") == len(pp.keyframes) - 2
    ba = [f for e, f in log.events if e == "window_ba"]
    assert ba and all(np.isfinite(f["rmse"]) for f in ba)
    assert len(pp.pose_edges) == len(pp.keyframes) - 1
    assert pp.lm_ref_kf.shape[0] == pp.landmarks.shape[0]


def test_same_seed_same_trajectory(runs):
    """The analog of `test_pipeline_deterministic`: two port runs with one
    seed give identical trajectories."""
    _, frames, jp, _, _ = runs
    with torch_threads():
        a = run_port(jp.cfg, frames, 12, seed=3).positions()
        b = run_port(jp.cfg, frames, 12, seed=3).positions()
    np.testing.assert_array_equal(a, b)

