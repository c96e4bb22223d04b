"""The port's stereo depth path against the JAX package on the CPU.

- `matching/stereo.py::stereo_depths` against JAX's on the cases of
  `tests/unit/test_stereo.py` (planted depths, the row and disparity
  gates, invalid masks) and on seeded random keypoints: accepted sets
  exactly, depths within 1e-6 relative; the batched form against the
  single one.
- The pipeline on a rectified pair sequence rendered as
  `chip_smoke.make_sfm_sequence` renders (two textured planes, the right
  camera a baseline of four steps to the right): `process_sequence(
  rights=)` against per-frame `process_frame(right=)` within 1e-3 m (the
  JAX test's bound, tests/e2e/test_image_sfm.py:318), at metric scale
  (rigid alignment).
- `cli sfm --stereo` on the KITTI fixture (10 stereo pairs, 120x400,
  baseline 0.54 m): the JAX command's printed lines; and a KITTI sequence
  with a missing right image takes the per-frame path, as in JAX
  (tests/e2e/test_cli_sfm.py:54).
"""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from sift_tpu.matching.stereo import stereo_depths as jax_stereo_depths
from sift_tpu.types import Keypoints as JaxKeypoints

from sift_tpu_torch import cli
from sift_tpu_torch.config import PipelineConfig
from sift_tpu_torch.eval.ate import ate_rmse
from sift_tpu_torch.matching.stereo import stereo_depths, stereo_depths_batch
from sift_tpu_torch.slam.pipeline import SfmPipeline
from sift_tpu_torch.types import Keypoints
from tests.torch_dist_world import (  # noqa: F401
    one_torch_thread, torch_threads)

FX, BASELINE = 700.0, 0.54
FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
KITTI_ROOT = os.path.join(FIXDIR, "kitti_mini")


@pytest.fixture(autouse=True)
def two_threads():
    with torch_threads(2):
        yield


def _kp_pair(u, v, desc, valid=None):
    n = u.shape[0]
    valid = np.ones(n, bool) if valid is None else valid
    fields = dict(x=np.asarray(u, np.float32), y=np.asarray(v, np.float32),
                  octave=np.zeros(n, np.int32), level=np.zeros(n, np.int32),
                  scale=np.ones(n, np.float32), score=np.ones(n, np.float32),
                  orientation=np.zeros(n, np.float32), valid=valid,
                  desc=np.asarray(desc, np.float32))
    return (JaxKeypoints(**{k: jnp.asarray(a) for k, a in fields.items()}),
            Keypoints(**{k: torch.from_numpy(a) for k, a in fields.items()}))


def _planted(seed=0, n=64):
    rng = np.random.default_rng(seed)
    depth = rng.uniform(4.0, 40.0, n)
    disp = FX * BASELINE / depth
    ul = rng.uniform(200, 1000, n)
    vl = rng.uniform(20, 350, n)
    codes = rng.standard_normal((n, 128)).astype(np.float32)
    codes /= np.linalg.norm(codes, axis=-1, keepdims=True)
    perm = rng.permutation(n)
    return (_kp_pair(ul, vl, codes),
            _kp_pair((ul - disp)[perm], vl[perm] + rng.normal(0, 0.3, n),
                     codes[perm] + 0.02 * rng.standard_normal(
                         (n, 128)).astype(np.float32)), {})


def _gates():
    codes = np.random.default_rng(1).standard_normal((4, 128))
    return (_kp_pair(np.full(4, 500.0), np.array([100.0, 120, 140, 160]),
                     codes),
            _kp_pair(np.array([480.0, 505, 250, 480]),
                     np.array([100.0, 120, 140, 190]), codes),
            dict(max_disparity=192.0))


def _masks():
    codes = np.random.default_rng(2).standard_normal((8, 128))
    valid = np.ones(8, bool)
    valid[:4] = False
    return (_kp_pair(np.full(8, 500.0), np.arange(8.0) * 30, codes, valid),
            _kp_pair(np.full(8, 480.0), np.arange(8.0) * 30, codes), {})


def _random(seed, n=300, m=280):
    """Random keypoints with clustered rows and shared descriptor codes,
    so that the row gate, the disparity gate and the ratio test all cut."""
    rng = np.random.default_rng(seed)
    codes = rng.standard_normal((40, 128)).astype(np.float32)
    vl = rng.integers(0, 30, n) * 4.0 + rng.normal(0, 0.5, n)
    vr = rng.integers(0, 30, m) * 4.0 + rng.normal(0, 0.5, m)
    dl = codes[rng.integers(0, 40, n)] + 0.3 * rng.standard_normal((n, 128))
    dr = codes[rng.integers(0, 40, m)] + 0.3 * rng.standard_normal((m, 128))
    return (_kp_pair(rng.uniform(0, 600, n), vl, dl, rng.random(n) < 0.9),
            _kp_pair(rng.uniform(0, 600, m), vr, dr, rng.random(m) < 0.9),
            dict(ratio=0.9))


@pytest.mark.parametrize("case", ["planted", "gates", "masks", 3, 4])
def test_stereo_depths_match_jax(case):
    left, right, kw = {"planted": _planted, "gates": _gates,
                       "masks": _masks}.get(case, _random)(
        *(() if isinstance(case, str) else (case,)))
    want = np.asarray(jax_stereo_depths(left[0], right[0], FX, BASELINE,
                                        **kw))
    got = stereo_depths(left[1], right[1], FX, BASELINE, **kw).numpy()
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    n_ok = int((want > 0).sum())
    assert n_ok == {"planted": 64, "gates": 1, "masks": 4}.get(case, n_ok)
    assert n_ok >= 1 and (case == "planted" or n_ok < want.shape[0])


def test_stereo_depths_batch_matches_single():
    pairs = [_random(s, n=200, m=200)[:2] for s in (5, 6, 7)]
    stack = [Keypoints(**{f: torch.stack([getattr(p[side][1], f)
                                          for p in pairs])
                          for f in ("x", "y", "octave", "level", "scale",
                                    "score", "orientation", "valid",
                                    "desc")}) for side in (0, 1)]
    got = stereo_depths_batch(stack[0], stack[1], FX, BASELINE)
    for i, (left, right) in enumerate(pairs):
        want = stereo_depths(left[1], right[1], FX, BASELINE)
        torch.testing.assert_close(got[i], want, rtol=0, atol=0)
        assert (want > 0).sum() > 0


# --------------------------------------------------------------- pipeline

H, W = 120, 160
STEREO_INTR = (chip_smoke.SFM_INTRINSICS[0], chip_smoke.SFM_INTRINSICS[1],
               W / 2.0, H / 2.0)
N_FRAMES, STEP = 12, chip_smoke.SFM_STEP
STEREO_BASELINE = 4 * STEP


@pytest.fixture(scope="module")
def stereo_frames():
    """Left frames at x = STEP * i and right frames at x + STEREO_BASELINE,
    rendered in one call so that both sides see one texture."""
    xs = [STEP * i for i in range(N_FRAMES)]
    frames, gt = chip_smoke.make_sfm_sequence(
        h=H, w=W, xs=xs + [x + STEREO_BASELINE for x in xs])
    return list(frames[:N_FRAMES]), list(frames[N_FRAMES:]), gt[:N_FRAMES]


def _stereo_cfg():
    return PipelineConfig(kf_max_interval=4)


def test_batched_stereo_matches_per_frame(stereo_frames):
    left, right, gt = stereo_frames
    per = SfmPipeline(STEREO_INTR, _stereo_cfg(), device="cpu",
                      stereo_baseline=STEREO_BASELINE)
    for a, b in zip(left, right):
        per.process_frame(a, right=b)
    per.finalize()
    bat = SfmPipeline(STEREO_INTR, _stereo_cfg(), device="cpu",
                      stereo_baseline=STEREO_BASELINE)
    bat.process_sequence(left, rights=right, batch=4)
    assert per.state == bat.state == "tracking"
    assert bat.trajectory[0]["is_keyframe"]        # RGB-D style bootstrap
    assert len(bat.keyframes) >= 3
    np.testing.assert_allclose(bat.positions(), per.positions(), rtol=0,
                               atol=1e-3)
    assert ate_rmse(bat.positions(), gt, align=True, with_scale=False) < 0.01


def test_stereo_input_checks(stereo_frames):
    left, right, _ = stereo_frames
    mono = SfmPipeline(STEREO_INTR, device="cpu")
    with pytest.raises(ValueError, match="stereo_baseline"):
        mono.process_frame(left[0], right=right[0])
    with pytest.raises(ValueError, match="stereo_baseline"):
        mono.process_sequence(left[:2], rights=right[:2])
    pipe = SfmPipeline(STEREO_INTR, device="cpu", stereo_baseline=0.1)
    with pytest.raises(ValueError, match="every right frame"):
        pipe.process_sequence(left[:2], rights=[right[0], None])


# -------------------------------------------------------------------- cli

def _report(out: str):
    """The command's counts line without its timing, and its ATE and RPE
    in metres."""
    lines = [line for line in out.splitlines() if line.strip()]
    counts = re.sub(r" in [0-9.]+s \([0-9.]+ fps\)", "", lines[0])
    errs = [float(re.search(r": ([0-9.]+) m$", line).group(1))
            for line in lines[1:3]]
    return counts, [line.split(":")[0] for line in lines[1:3]], errs


# Slow (both packages' commands on the KITTI fixture, 1.5 minutes on a
# loaded CPU): out of tier-1. The batched and per-frame stereo paths and
# stereo_depths against JAX stay above; chip_smoke.py phase 12a runs the
# command on the card to the JAX test's ATE bound.
@pytest.mark.slow
def test_cli_sfm_stereo_prints_the_jax_lines(tmp_path, capsys, monkeypatch):
    """The same frame, keyframe and landmark counts and metric report as
    the JAX command; the ATE and RPE (both near 0.045 m on this fixture)
    within 2 mm of JAX's, the two packages drawing other RANSAC noise."""
    from sift_tpu import cli as jax_cli

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "xla"))
    args = ["sfm", KITTI_ROOT, "--format", "kitti", "--sequence", "05",
            "--stereo", "--batch", "4"]
    assert cli.main(args + ["--device", "cpu"]) == 0
    got = _report(capsys.readouterr().out)
    assert jax_cli.main(args) == 0
    want = _report(capsys.readouterr().out)
    assert got[:2] == want[:2]
    assert got[1][0] == "ATE RMSE (se3-aligned)"     # metric: stereo
    assert got[2][0] < 0.1                  # the JAX test's bound
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=2e-3)


def test_cli_sfm_stereo_missing_right_falls_back(tmp_path, monkeypatch):
    """tests/e2e/test_cli_sfm.py:54 on the port: a missing right image
    keeps the per-frame path (never `process_sequence`)."""
    from sift_tpu_torch.io.image import save_image_gray

    seq = tmp_path / "kitti" / "sequences" / "00"
    (seq / "image_0").mkdir(parents=True)
    (seq / "image_1").mkdir(parents=True)
    rng = np.random.default_rng(0)
    n = 6
    for i in range(n):
        img = (rng.random((64, 96)) * 255).astype(np.float32)
        save_image_gray(str(seq / "image_0" / f"{i:06d}.png"), img)
        if i != 3:                       # drop one right frame
            save_image_gray(str(seq / "image_1" / f"{i:06d}.png"), img)
    (seq / "calib.txt").write_text(
        "P0: 100 0 48 0 0 100 32 0 0 0 1 0\n"
        "P1: 100 0 48 -50 0 100 32 0 0 0 1 0\n")
    (seq / "times.txt").write_text(
        "".join(f"{i / 10.0:.6f}\n" for i in range(n)))
    frames = []
    orig = SfmPipeline.process_frame

    def per_frame(self, gray, depth=None, right=None):
        frames.append(right is not None)
        return orig(self, gray, depth=depth, right=right)

    def batched(*a, **k):
        raise AssertionError("process_sequence with a missing right frame")

    monkeypatch.setattr(SfmPipeline, "process_frame", per_frame)
    monkeypatch.setattr(SfmPipeline, "process_sequence", batched)
    rc = cli.main(["sfm", str(tmp_path / "kitti"), "--format", "kitti",
                   "--stereo", "--batch", "4", "--device", "cpu"])
    assert rc in (0, 1)
    assert frames == [True, True, True, False, True, True]
