"""The SfM slice's support modules of the port against the JAX package on
the CPU: the copied evaluation, trajectory export and metrics modules
(bit-equal outputs), the dataset loaders on the checked-in TUM and KITTI
fixtures (equal arrays), the global descriptor index (equal votes and
candidates), and the arguments the port refuses (naming them)."""

import json
import os
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sift_tpu.eval import ate as jate
from sift_tpu.io import datasets as jdatasets
from sift_tpu.io import trajectory as jtrajectory
from sift_tpu.matching.global_index import \
    GlobalDescriptorIndex as JaxGlobalDescriptorIndex
from sift_tpu.utils import metrics as jmetrics

from sift_tpu_torch import cli
from sift_tpu_torch.eval import ate
from sift_tpu_torch.io import datasets, trajectory
from sift_tpu_torch.matching.global_index import GlobalDescriptorIndex
from sift_tpu_torch.slam.pipeline import SfmPipeline
from sift_tpu_torch.utils import metrics
from tests.torch_dist_world import one_torch_thread  # noqa: F401

FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
TUM_DIR = os.path.join(FIXDIR, "tum_mini", "rgbd_dataset_freiburg1_mini")
KITTI_ROOT = os.path.join(FIXDIR, "kitti_mini")
INTR = (500.0, 500.0, 320.0, 240.0)


def _trajectory(seed, n=30):
    rng = np.random.default_rng(seed)
    gt = np.cumsum(rng.normal(0, 0.1, (n, 3)), axis=0)
    th = 0.3
    R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                  [0, 0, 1.0]])
    est = 0.7 * gt @ R.T + [1.0, -2.0, 0.5] + rng.normal(0, 0.01, (n, 3))
    return est, gt


def _poses(seed, n=20):
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.4, (n, 3))
    th = np.linalg.norm(w, axis=1, keepdims=True)
    k = w / th
    Kx = np.zeros((n, 3, 3))
    Kx[:, 0, 1], Kx[:, 0, 2], Kx[:, 1, 2] = -k[:, 2], k[:, 1], -k[:, 0]
    Kx = Kx - Kx.transpose(0, 2, 1)
    s, c = np.sin(th)[..., None], np.cos(th)[..., None]
    Rs = np.eye(3) + s * Kx + (1 - c) * Kx @ Kx
    return Rs, rng.normal(0, 2.0, (n, 3))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("with_scale", [False, True])
def test_ate_and_rpe_bit_equal(seed, with_scale):
    est, gt = _trajectory(seed)
    for a, b in zip(ate.umeyama_alignment(est, gt, with_scale),
                    jate.umeyama_alignment(est, gt, with_scale)):
        np.testing.assert_array_equal(a, b)
    assert ate.ate_rmse(est, gt, True, with_scale) == \
        jate.ate_rmse(est, gt, True, with_scale)
    assert ate.rpe_rmse(est, gt, 2) == jate.rpe_rmse(est, gt, 2)
    Rs, ts = _poses(seed, est.shape[0])
    Te, Tg = ate.poses_from_Rt(Rs, est), jate.poses_from_Rt(Rs, gt)
    np.testing.assert_array_equal(Te, jate.poses_from_Rt(Rs, est))
    assert ate.rpe_rmse_poses(Te, Tg, 1, 0.7) == \
        jate.rpe_rmse_poses(Te, Tg, 1, 0.7)


def test_trajectory_export_bit_equal(tmp_path):
    Rs, ts = _poses(3)
    # Near-180-degree rotations reach every pivot of Shepperd's method.
    Rs[0] = np.diag([1.0, -1.0, -1.0])
    Rs[1] = np.diag([-1.0, 1.0, -1.0])
    Rs[2] = np.diag([-1.0, -1.0, 1.0])
    np.testing.assert_array_equal(trajectory.rotmat_to_quat(Rs),
                                  jtrajectory.rotmat_to_quat(Rs))
    stamps = 1305031100.0 + np.arange(ts.shape[0]) / 30.0
    colors = np.random.default_rng(0).integers(0, 255, (ts.shape[0], 3))
    for mod, name in ((trajectory, "ours"), (jtrajectory, "theirs")):
        mod.save_tum(str(tmp_path / f"{name}.txt"), Rs, ts, stamps)
        mod.save_tum(str(tmp_path / f"{name}_idx.txt"), Rs, ts)
        mod.save_ply(str(tmp_path / f"{name}.ply"), ts)
        mod.save_ply(str(tmp_path / f"{name}_rgb.ply"), ts, colors)
    for suffix in (".txt", "_idx.txt", ".ply", "_rgb.ply"):
        assert (tmp_path / f"ours{suffix}").read_bytes() == \
            (tmp_path / f"theirs{suffix}").read_bytes()


def test_metrics_logger_and_stage(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(metrics.time, "time", lambda: 1.5)
    monkeypatch.setattr(jmetrics.time, "time", lambda: 1.5)
    for mod, name in ((metrics, "ours"), (jmetrics, "theirs")):
        path = str(tmp_path / name / "m.jsonl")
        with mod.MetricsLogger(path) as log:
            log.log("frame", tracked=True, n=np.int64(3), x=np.float32(0.25))
            with mod.stage("extract", log, batch=8):
                pass
    ours = [json.loads(l) for l in open(tmp_path / "ours" / "m.jsonl")]
    theirs = [json.loads(l) for l in open(tmp_path / "theirs" / "m.jsonl")]
    assert ours[0] == theirs[0]
    assert [r["event"] for r in ours] == ["frame", "stage"]
    assert {k: v for k, v in ours[1].items() if k != "wall_s"} == \
        {k: v for k, v in theirs[1].items() if k != "wall_s"}
    metrics.MetricsLogger().log("x", a=1)
    assert json.loads(capsys.readouterr().out) == {"ts": 1.5, "event": "x",
                                                    "a": 1}


def test_profile_trace_writes_a_trace(tmp_path):
    with metrics.profile_trace(str(tmp_path / "trace")):
        with metrics.stage("matmul"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    text = (tmp_path / "trace" / "trace.json").read_text()
    assert "matmul" in text


def _same_sequence(a, b):
    assert len(a) == len(b) and a.name == b.name
    assert a.intrinsics == b.intrinsics and a.baseline == b.baseline
    for fa, fb in zip(a, b):
        assert fa.index == fb.index and fa.timestamp == fb.timestamp
        for f in ("gray", "depth", "gray_right", "gt_pose"):
            x, y = getattr(fa, f), getattr(fb, f)
            assert (x is None) == (y is None), f
            if x is not None:
                assert x.dtype == y.dtype, f
                np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.gt_positions(), b.gt_positions())
    np.testing.assert_array_equal(a.gt_poses(), b.gt_poses())


@pytest.mark.parametrize("kw", [{}, {"max_frames": 4, "stride": 2},
                                {"with_depth": False}])
def test_tum_loader_matches_jax(kw):
    seq = datasets.load_tum_rgbd(TUM_DIR, **kw)
    _same_sequence(seq, jdatasets.load_tum_rgbd(TUM_DIR, **kw))
    assert seq.intrinsics == datasets.TUM_FR1_INTRINSICS
    assert seq.frames[0].gray.dtype == np.uint8


@pytest.mark.parametrize("kw", [{}, {"stereo": True},
                                {"max_frames": 3, "stride": 3}])
def test_kitti_loader_matches_jax(kw):
    seq = datasets.load_kitti_odometry(KITTI_ROOT, "05", **kw)
    _same_sequence(seq, jdatasets.load_kitti_odometry(KITTI_ROOT, "05", **kw))


def test_tum_constants_match_jax():
    for name in ("TUM_FR1_INTRINSICS", "TUM_FR2_INTRINSICS",
                 "TUM_FR3_INTRINSICS", "TUM_DEPTH_SCALE"):
        assert getattr(datasets, name) == getattr(jdatasets, name)


def _index_data(seed, n_kf=5, n=96, nq=64):
    """Bank and query descriptors whose best cosine similarity per keyframe
    is either a near-copy (> 0.95) or unrelated (< 0.5): no vote sits near
    the 0.85 threshold."""
    rng = np.random.default_rng(seed)
    bank = np.abs(rng.normal(size=(n_kf, n, 128))).astype(np.float32) ** 3
    valid = rng.random((n_kf, n)) > 0.1
    q = np.abs(rng.normal(size=(nq, 128))).astype(np.float32) ** 3
    for j in range(nq):                 # some queries copy bank rows
        k = rng.integers(0, n_kf + 2)
        if k < n_kf:
            q[j] = bank[k, rng.integers(0, n)] * rng.uniform(0.5, 2.0) + \
                rng.normal(0, 0.01, 128).astype(np.float32)
    q = np.abs(q)
    valid_q = rng.random(nq) > 0.1
    return bank, valid, q, valid_q


def _best_sims(bank, valid, q):
    """Best similarity per (keyframe, query) of the bf16-rounded unit
    vectors, in float64."""
    def bf16(x):
        x = x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)
        return torch.from_numpy(x.astype(np.float32)).to(
            torch.bfloat16).double().numpy()
    s = np.einsum("nd,kmd->knm", bf16(q), bf16(bank))
    return np.where(valid[:, None, :], s, -1.0).max(axis=-1)


@pytest.mark.parametrize("seed", [0, 1])
def test_global_index_votes_match_jax(seed):
    bank, valid, q, valid_q = _index_data(seed)
    best = _best_sims(bank, valid, q)
    assert np.abs(best - 0.85).min() > 1e-2      # no knife-edge votes
    ours = GlobalDescriptorIndex(8, bank.shape[1], device="cpu")
    theirs = JaxGlobalDescriptorIndex(8, bank.shape[1])
    for k in (0, 1, 2, 4, 3):           # slot 5 onwards stays unused
        ours.add(k, torch.from_numpy(bank[k]), torch.from_numpy(valid[k]))
        theirs.add(k, jnp.asarray(bank[k]), jnp.asarray(valid[k]))
    assert ours._bank.dtype == torch.bfloat16
    np.testing.assert_array_equal(ours._bank.float().numpy(),
                                  np.asarray(theirs._bank, np.float32))
    vq = torch.from_numpy(valid_q)
    votes = ours.query(torch.from_numpy(q), vq)
    np.testing.assert_array_equal(votes, theirs.query(jnp.asarray(q),
                                                      jnp.asarray(valid_q)))
    assert votes.sum() > 0
    want = ((best > 0.85) & valid_q[None]).sum(axis=1)
    np.testing.assert_array_equal(votes[:5], want)
    for kw in ({"k": 3}, {"k": 8, "exclude_from": 3},
               {"k": 5, "min_votes": 4}):
        np.testing.assert_array_equal(
            ours.top_candidates(torch.from_numpy(q), vq, **kw),
            theirs.top_candidates(jnp.asarray(q), jnp.asarray(valid_q), **kw))


def test_global_index_add_is_in_place_and_capped():
    idx = GlobalDescriptorIndex(2, 4, dim=8, device="cpu")
    storage = idx._bank.data_ptr()
    idx.add(1, torch.ones(4, 8), torch.ones(4, dtype=torch.bool))
    idx.add(2, torch.ones(4, 8), torch.ones(4, dtype=torch.bool))  # over cap
    assert idx._bank.data_ptr() == storage
    assert idx._used.tolist() == [False, True]
    np.testing.assert_allclose(idx._bank[1].float().numpy(),
                               np.full((4, 8), 8 ** -0.5), rtol=4e-3)


@pytest.mark.parametrize("kw,name", [
    ({"mesh": types.SimpleNamespace(device_type="cuda")}, "mesh")])
def test_refused_constructor_arguments(kw, name):
    """A process mesh is taken (`dist/`); one on another device type than
    the pipeline's is refused, naming it."""
    with pytest.raises(ValueError, match=name):
        SfmPipeline(INTR, device="cpu", **kw)


@pytest.mark.parametrize("method", ["run_global_ba"])
def test_refused_methods(method):
    """No map-maintenance method is refused: a sharded global BA
    (`mesh=`, dist/) runs too, and on a map of fewer than two keyframes
    returns at once, as on one device (the sharded solve itself:
    tests/test_torch_dist_pipeline.py)."""
    pipe = SfmPipeline(INTR, device="cpu")
    mesh = types.SimpleNamespace(device_type="cpu")
    assert getattr(pipe, method)(mesh=mesh) == getattr(pipe, method)() == \
        dict(rmse=0.0, n_obs=0, n_cams=0, n_lms=0)


def test_pipeline_needs_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SfmPipeline(INTR)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["sfm", TUM_DIR, "--max-frames", "1"])
    assert SfmPipeline(INTR, device="cpu").device.type == "cpu"
