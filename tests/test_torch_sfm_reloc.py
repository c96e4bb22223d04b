"""Relocalization of the port's SfM loop against the JAX package on the
CPU: `test_relocalization_after_blackout` of `tests/e2e/test_sfm_pipeline.py`
(the `SyntheticWorld`, that test's configuration without loop closure,
frames 14-17 blank) and a blackout of frames 14-21, after which the
prediction has drifted past the guided-matching radius: tracking comes
back only through `_attempt_relocalization` (the global index's vote-ranked
candidates, probed in one batch). There the port must relocalize at the
frame, against the keyframe and with the inlier count JAX does, and track
the same frames.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sift_tpu.eval.ate import ate_rmse
from sift_tpu.slam.pipeline import SfmPipeline as JaxSfmPipeline
from sift_tpu.types import Keypoints as JaxKeypoints
from tests.e2e.test_sfm_pipeline import INTR, KP_CAP, SyntheticWorld, _loop_cfg
from tests.test_torch_sfm_loop import _Events, port_frames, torch_threads

from sift_tpu_torch.config import config_from_dict
from sift_tpu_torch.slam.pipeline import SfmPipeline
from sift_tpu_torch.types import Keypoints

N_FRAMES = 40


def _blank(mod, zeros, ones, i32, b):
    """A frame without keypoints (the e2e test's blank frame)."""
    return mod(x=zeros(KP_CAP), y=zeros(KP_CAP),
               octave=zeros(KP_CAP, dtype=i32),
               level=zeros(KP_CAP, dtype=i32), scale=ones(KP_CAP),
               score=zeros(KP_CAP), orientation=zeros(KP_CAP),
               valid=zeros(KP_CAP, dtype=b), desc=zeros((KP_CAP, 128)))


@pytest.fixture(scope="module")
def world():
    world = SyntheticWorld()
    frames = {i: world.frame_keypoints(i) for i in range(N_FRAMES)}
    return world, frames


def _run(pipe_cls, frames, blank, blackout, **kw):
    log = _Events()
    cfg = _loop_cfg().replace(enable_loop_closure=False)
    if pipe_cls is SfmPipeline:
        cfg = config_from_dict(dataclasses.asdict(cfg))
    pipe = pipe_cls(INTR, cfg, logger=log, **kw,
                    frontend=lambda g: (blank if int(g[0, 0]) in blackout
                                        else frames[int(g[0, 0])]))
    results = [pipe.process_frame(np.full((2, 2), i, np.float32))
               for i in range(N_FRAMES)]
    return pipe, results, [f for e, f in log.events if e == "relocalized"]


def _run_port(frames, blackout):
    blank = _blank(Keypoints, torch.zeros, torch.ones,
                   torch.int32, torch.bool)
    with torch_threads():
        return _run(SfmPipeline, port_frames(frames), blank, blackout,
                    device="cpu")


def test_blackout_of_the_e2e_test(world):
    """The e2e test's bounds: lost in the blackout, tracked after."""
    world, frames = world
    blackout = set(range(14, 18))
    pipe, results, _ = _run_port(frames, blackout)
    assert not any(r["tracked"] for i, r in enumerate(results)
                   if i in blackout)
    post = [r["tracked"] for i, r in enumerate(results) if i >= 21]
    assert np.mean(post) > 0.9, post
    assert ate_rmse(pipe.positions()[21:], world.positions[21:], align=True,
                    with_scale=True) < 0.1


def test_relocalization_matches_jax(world):
    world, frames = world
    blackout = set(range(14, 22))
    jblank = _blank(JaxKeypoints, jnp.zeros, jnp.ones, jnp.int32, bool)
    jp, jres, jrel = _run(JaxSfmPipeline, frames, jblank, blackout)
    pp, pres, prel = _run_port(frames, blackout)
    assert jrel, "the JAX run must relocalize for this test to mean anything"
    assert [r["tracked"] for r in pres] == [r["tracked"] for r in jres]
    assert [(r["ref_kf"], r["inliers"]) for r in prel] == \
        [(r["ref_kf"], r["inliers"]) for r in jrel]
    np.testing.assert_allclose([r["rmse"] for r in prel],
                               [r["rmse"] for r in jrel], rtol=1e-3)
    assert prel[0]["inliers"] >= pp.cfg.keyframe_min_inliers
    assert len(pp.keyframes) == len(jp.keyframes)
    for pipe in (pp, jp):
        assert ate_rmse(pipe.positions()[25:], world.positions[25:],
                        align=True, with_scale=True) < 0.1
