"""The port's asynchronous window BA (`ba_async`, with `ba_defer_kickoff` on
the chunked path) and `extract_ahead` against the JAX package on the CPU.

On `SyntheticWorld` (tests/e2e/test_sfm_pipeline.py, its configuration),
both packages run 16 frames (three solves, one chunk after the bootstrap)
and, marked `slow`, 40 frames with `ba_async`: per frame, and chunked (B =
8) with the deferred kickoff. The port draws JAX's noise
(`test_torch_chunk_track.py::feed_jax_noise`): with independent draws the
runs part by up to 0.02 m (sim3 ATE), as two JAX runs with other seeds do,
since a solve applied a chunk late leaves tracking on a stale map. Held:
the same apply points (frame, window keyframes, landmark and observation
counts), the window poses at each within POSE_TOL, at most two solves in
flight after any solve, none after `finalize`, and the keyframes at JAX's
frames.

The chunk stage and the window BA leave (stage, args) in `_capture` as
JAX's do. `extract_ahead` on and off give bit-identical positions through
`process_sequence` on small frames rendered as `chip_smoke.
make_sfm_sequence` renders (with the `track_saturation` audit on); `cli
sfm --chunked --ba-async` runs on the TUM and KITTI fixtures.
"""

import dataclasses
import os
import tempfile

import numpy as np
import pytest

import chip_smoke
from sift_tpu.slam.pipeline import SfmPipeline as JaxSfmPipeline
from tests.e2e.test_sfm_pipeline import INTR, SyntheticWorld, _pipeline
from tests.test_torch_chunk_track import (_stack_jax, _stack_port,
                                          drive_chunked, feed_jax_noise)
from tests.test_torch_sfm_loop import port_frames

from sift_tpu_torch import cli
from sift_tpu_torch.config import PipelineConfig, config_from_dict
from sift_tpu_torch.slam.pipeline import SfmPipeline
from tests.torch_dist_world import (  # noqa: F401
    one_torch_thread, torch_threads)

# Window poses (log coordinates) at each apply point, port against JAX on
# the same noise: measured up to 2.6e-3 (a 33 m trajectory); JAX against
# itself with seed 1 in place of 0 parts by more.
POSE_TOL = 5e-3
FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
TUM_DIR = os.path.join(FIXDIR, "tum_mini", "rgbd_dataset_freiburg1_mini")
KITTI_ROOT = os.path.join(FIXDIR, "kitti_mini")


@pytest.fixture(scope="module")
def world():
    return SyntheticWorld()


def _watch(pipe):
    """Record every applied solve (frame count, window keyframes' frames,
    L, O, window poses) and the in-flight count after every solve."""
    applies, in_flight = [], []
    apply, run = pipe._apply_ba_result, pipe._run_window_ba

    def on_apply(packed, window, uniq, L, O):
        apply(packed, window, uniq, L, O)
        applies.append(((len(pipe.trajectory),
                         tuple(kf.frame_idx for kf in window), L, O),
                        np.stack([kf.pose for kf in window])))

    def on_run(**kw):
        run(**kw)
        in_flight.append(len(pipe._pending_ba))

    pipe._apply_ba_result, pipe._run_window_ba = on_apply, on_run
    return applies, in_flight


def _drive(pipe, kind, kps, stack):
    if kind == "per_frame":
        for i in range(len(kps)):
            pipe.process_frame(np.full((2, 2), i, np.float32))
        pipe.finalize()
    else:
        drive_chunked(pipe, kps, 8, stack)


def _async_ba_against_jax(world, kind, n):
    kw = dict(ba_async=True)
    if kind == "chunked_deferred":
        kw.update(chunked_tracking=True, ba_defer_kickoff=True)
    cfg = _pipeline(world).cfg.replace(**kw)
    kps = [world.frame_keypoints(i) for i in range(n)]
    jp = JaxSfmPipeline(INTR, cfg, frontend=lambda g: kps[int(g[0, 0])])
    pf = port_frames(dict(enumerate(kps)))
    pp = feed_jax_noise(SfmPipeline(
        INTR, config_from_dict(dataclasses.asdict(cfg)),
        frontend=lambda g: pf[int(g[0, 0])], device="cpu"))
    (aj, fj), (ap, fp) = _watch(jp), _watch(pp)
    jp._capture, pp._capture = {}, {}     # the benchmark's stash
    _drive(jp, kind, kps, _stack_jax)
    _drive(pp, kind, kps, _stack_port)
    assert [a[0] for a in ap] == [a[0] for a in aj]
    assert len(aj) >= (5 if n >= 40 else 3)
    for (_, got), (_, want) in zip(ap, aj):
        np.testing.assert_allclose(got, want, rtol=0, atol=POSE_TOL)
    assert fp == fj and max(fp) <= 2
    assert pp._pending_ba == [] and pp._ba_kickoff is None
    assert [r["is_keyframe"] for r in pp.trajectory] == \
        [r["is_keyframe"] for r in jp.trajectory]
    assert pp.chunk_stats == jp.chunk_stats
    assert sorted(pp._capture) == sorted(jp._capture) == (
        ["ba", "chunk"] if kind == "chunked_deferred" else ["ba"])
    if kind == "chunked_deferred":
        assert pp.chunk_stats["chunks"] >= (3 if n >= 40 else 1)
        stage, args = pp._capture["chunk"]
        assert stage(*args)[0].shape == (8 * 8 + 1 + (
            8 * pp.cfg.match.max_matches + 8) + 4 * args[8].x.shape[1],)


@pytest.mark.parametrize("kind", ["per_frame", "chunked_deferred"])
def test_async_ba_matches_jax(world, kind):
    _async_ba_against_jax(world, kind, 16)


# Slow (two 40-frame runs of both packages, 1-2 minutes a case on a loaded
# CPU): out of tier-1, which runs the 16 frames above. Chunked runs with
# async BA are held on the card to the JAX run's bounds by chip_smoke.py
# phase 11.
@pytest.mark.slow
@pytest.mark.parametrize("kind", ["per_frame", "chunked_deferred"])
def test_async_ba_matches_jax_40_frames(world, kind):
    _async_ba_against_jax(world, kind, 40)


def test_deferred_solves_flush_before_the_map_changes(world):
    """Operations that rewrite the map apply the solves in flight first
    (a pending solve's landmark ids belong to the map it was made on), and
    `load_map` drops them."""
    cfg = _pipeline(world).cfg.replace(ba_async=True)
    kps = port_frames({i: world.frame_keypoints(i) for i in range(16)})
    pipe = SfmPipeline(INTR, config_from_dict(dataclasses.asdict(cfg)),
                       frontend=lambda g: kps[int(g[0, 0])], device="cpu")
    for i in range(16):
        pipe.process_frame(np.full((2, 2), i, np.float32))
    assert pipe._pending_ba
    for op in ("compact_landmarks", "cull_keyframes", "run_global_ba",
               "_run_pose_graph"):
        pipe._run_window_ba(fix_first_n=2)
        assert pipe._pending_ba
        getattr(pipe, op)()
        assert pipe._pending_ba == [], op
    pipe._run_window_ba(fix_first_n=2)
    pipe._ba_kickoff = dict(fix_first_n=2)
    pipe.finalize()
    assert pipe._pending_ba == [] and pipe._ba_kickoff is None
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "map.npz")
        pipe._run_window_ba(fix_first_n=2)
        pipe.save_map(path)                 # applies, then writes
        assert pipe._pending_ba == []
        pipe._run_window_ba(fix_first_n=2)
        pipe._ba_kickoff = dict(fix_first_n=2)
        pipe.load_map(path)
        assert pipe._pending_ba == [] and pipe._ba_kickoff is None


# ---------------------------------------------------------- extract_ahead

H, W = 180, 240
SMALL_INTR = (chip_smoke.SFM_INTRINSICS[0], chip_smoke.SFM_INTRINSICS[1],
              W / 2.0, H / 2.0)


def test_extract_ahead_is_bit_identical():
    """Extracting the next chunk ahead reorders independent work only."""
    frames, gt = chip_smoke.make_sfm_sequence(n=12, h=H, w=W)
    runs = []
    for ahead in (False, True):
        cfg = PipelineConfig(chunked_tracking=True, ba_async=True,
                             kf_max_interval=4, extract_ahead=ahead,
                             track_saturation=True)
        pipe = SfmPipeline(SMALL_INTR, cfg, device="cpu")
        calls = []
        extract = pipe._extract_batch
        pipe._extract_batch = lambda imgs: (calls.append(len(calls)),
                                            extract(imgs))[1]
        pipe.process_sequence(list(frames), batch=4)
        assert pipe.chunk_stats["chunks"] == 2, pipe.chunk_stats
        assert pipe.chunk_stats["extract_dropped"] >= 0     # the audit ran
        assert len(calls) == 3
        runs.append(pipe.positions())
    np.testing.assert_array_equal(runs[0], runs[1])
    from sift_tpu_torch.eval.ate import ate_rmse
    assert ate_rmse(runs[1], gt, align=True, with_scale=True) < 0.01


# -------------------------------------------------------------------- cli

@pytest.mark.parametrize("args", [
    [TUM_DIR, "--format", "tum"],
    [KITTI_ROOT, "--format", "kitti", "--sequence", "05", "--batch", "4"],
])
def test_cli_sfm_chunked_ba_async(args, capsys, monkeypatch):
    """The flags run; on the KITTI fixture (monocular) the chunk stage
    takes the chunks after the bootstrap (the TUM run has depth, which
    keeps the per-frame path, as in JAX)."""
    chunks = []
    orig = SfmPipeline._process_chunk_tracked

    def counted(self, *a, **k):
        handled = orig(self, *a, **k)
        chunks.append(handled)
        return handled

    monkeypatch.setattr(SfmPipeline, "_process_chunk_tracked", counted)
    with torch_threads(2):
        rc = cli.main(["sfm", *args, "--chunked", "--ba-async", "--device",
                       "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "10 frames in" in out
    ate = float(out.split("ATE RMSE")[1].split(":")[1].split("m")[0])
    assert ate < (0.05 if "tum" in args else 0.1), out
    assert (chunks and all(chunks)) if "kitti" in args else not chunks
