"""The port's two-view path (extract -> match -> relative pose, the
`twoview` command) against the JAX package on the CPU, on the TUM-RGBD
fixture pair: frames 0 and 9 of `tests/fixtures/tum_mini`, 3 cm a frame
along x with no rotation, so camera B sees camera A's points moved by
t = (-1, 0, 0) (unit scale) and R = I.

- Extraction on a 320x440 crop of the pair (rows 80-399, columns
  100-539, to keep the JAX compile short; the crop moves the principal
  point by (-100, -80) px): keypoints compared as sets, since slot order
  can flip at near-tied scores: at least 99% of each side's valid
  keypoints have a counterpart (same octave and level, position within 0.01 px,
  orientation within 0.1 deg) and matched descriptors differ by at most
  6e-3.
- Relative pose on JAX's matched coordinates with JAX's Gumbel noise: the
  inlier counts within 1%, R within 0.05 deg and t within 0.2 deg of
  JAX's.
- The port end to end (its own keypoints, matches and a seeded
  generator): R within 0.1 deg of the identity, t within 2 deg of
  (-1, 0, 0), at least half the matches inliers.
- `python -m sift_tpu_torch.cli twoview` at full size with the TUM
  fr1 intrinsics prints the JAX command's three lines with the library
  calls' counts, `success: True`, and the same pose bounds.
"""

import dataclasses
import functools
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sift_tpu.config import MatchConfig as JaxMatchConfig
from sift_tpu.config import RansacConfig as JaxRansacConfig
from sift_tpu.config import SiftConfig as JaxSiftConfig
from sift_tpu.frontend.sift import extract_batch as jax_extract_batch
from sift_tpu.geometry.epipolar import estimate_relative_pose as jax_pose
from sift_tpu.matching.matcher import match_keypoints as jax_match
from sift_tpu.matching.matcher import matched_coords as jax_matched_coords

from sift_tpu_torch import cli, config_from_dict, extract_batch
from sift_tpu_torch.config import RansacConfig
from sift_tpu_torch.geometry.epipolar import estimate_relative_pose
from sift_tpu_torch.io.image import load_image_gray
from tests.torch_dist_world import (  # noqa: F401
    ONE_THREAD_ENV, one_torch_thread)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_RGB = os.path.join(_REPO, "tests", "fixtures", "tum_mini",
                    "rgbd_dataset_freiburg1_mini", "rgb")
FRAMES = [os.path.join(_RGB, f) for f in ("1305031100.000000.png",
                                          "1305031100.300000.png")]
TUM_FR1 = (517.3, 516.5, 318.6, 255.3)
T_TRUE = np.array([-1.0, 0.0, 0.0])


def _rot_deg(R) -> float:
    """Rotation angle of R in degrees, from atan2(|skew|, cos): exact near
    zero, where arccos of the trace loses half the digits."""
    R = np.asarray(R, np.float64)
    s = np.linalg.norm([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                        R[1, 0] - R[0, 1]]) / 2.0
    return float(np.degrees(np.arctan2(s, (np.trace(R) - 1.0) / 2.0)))


def _dir_deg(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    c = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


CROP_Y, CROP_X, CROP_H, CROP_W = 80, 100, 320, 440
CROP_FR1 = (TUM_FR1[0], TUM_FR1[1], TUM_FR1[2] - CROP_X, TUM_FR1[3] - CROP_Y)


def _crop(img: np.ndarray) -> np.ndarray:
    return img[CROP_Y:CROP_Y + CROP_H, CROP_X:CROP_X + CROP_W]


@pytest.fixture(scope="module")
def both():
    imgs = np.stack([_crop(load_image_gray(f)) for f in FRAMES])
    jcfg = JaxSiftConfig(window_dtype="float32")
    run = jax.jit(functools.partial(jax_extract_batch, cfg=jcfg))
    want = jax.tree.map(np.array, run(jnp.asarray(imgs)))
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    got = extract_batch(imgs, cfg, device="cpu")
    return imgs, got, want


def _set_match(a, b, i):
    """Fraction of image i's valid keypoints in `a` with a counterpart in
    `b`, and the largest descriptor difference over those pairs."""
    va, vb = np.flatnonzero(a.valid[i]), np.flatnonzero(b.valid[i])
    matched, worst = 0, 0.0
    for s in va:
        cand = vb[(b.octave[i, vb] == a.octave[i, s])
                  & (b.level[i, vb] == a.level[i, s])
                  & (np.abs(b.x[i, vb] - a.x[i, s]) < 1e-2)
                  & (np.abs(b.y[i, vb] - a.y[i, s]) < 1e-2)]
        dori = np.abs((b.orientation[i, cand] - a.orientation[i, s]
                       + 180.0) % 360.0 - 180.0)
        cand = cand[dori < 0.1]
        if cand.size:
            matched += 1
            worst = max(worst, float(np.abs(
                b.desc[i, cand] - a.desc[i, s]).max(axis=1).min()))
    return matched / max(va.size, 1), worst


def test_extraction_matches_jax_as_sets(both):
    _, got, want = both
    got = got.to_numpy()
    for i in range(2):
        assert want.valid[i].sum() > 120
        fwd, worst_fwd = _set_match(got, want, i)
        back, worst_back = _set_match(want, got, i)
        assert min(fwd, back) >= 0.99, (i, fwd, back)
        assert max(worst_fwd, worst_back) <= 6e-3


def _jax_image(kp, i):
    return jax.tree.map(lambda x: jnp.asarray(x[i]) if np.ndim(x) else x, kp)


def test_relative_pose_on_jax_matches(both):
    _, _, want = both
    ka, kb = _jax_image(want, 0), _jax_image(want, 1)
    m = jax_match(ka, kb, JaxMatchConfig(ratio=0.8))
    pa, pb, valid = (np.array(x) for x in jax_matched_coords(ka, kb, m))
    fx, fy, cx, cy = CROP_FR1
    na = np.stack([(pa[:, 0] - cx) / fx, (pa[:, 1] - cy) / fy], -1)
    nb = np.stack([(pb[:, 0] - cx) / fx, (pb[:, 1] - cy) / fy], -1)
    key = jax.random.PRNGKey(0)
    g = np.array(jax.random.gumbel(key, (512, na.shape[0])))
    Rj, tj, estj = jax_pose(key, jnp.asarray(na), jnp.asarray(nb),
                            jnp.asarray(valid), JaxRansacConfig(), focal=fx)
    R, t, est = estimate_relative_pose(
        torch.from_numpy(g), torch.from_numpy(na), torch.from_numpy(nb),
        torch.from_numpy(valid), RansacConfig(), focal=fx)
    n, nj = int(est.num_inliers), int(estj.num_inliers)
    assert bool(est.success) and abs(n - nj) <= 0.01 * nj
    assert _rot_deg(R.numpy() @ np.asarray(Rj).T) < 0.05
    assert _dir_deg(t.numpy(), np.asarray(tj)) < 0.2
    assert _rot_deg(R.numpy()) < 0.2 and _dir_deg(t.numpy(), T_TRUE) < 2.0


def test_port_path_recovers_the_motion(both):
    imgs, got, _ = both
    kps = [got.map(lambda a, i=i: a[i]) for i in range(2)]
    m, pa, pb, valid = cli.twoview_match(kps, 0.8)
    R, t, est = cli.twoview_pose(pa, pb, valid, CROP_FR1, 2.0)
    assert bool(est.success)
    assert int(est.num_inliers) * 2 >= int(m.count()) >= 50
    assert _rot_deg(R.numpy()) < 0.1
    assert _dir_deg(t.numpy(), T_TRUE) < 2.0


def test_cli_twoview_prints_the_library_results():
    env = dict(os.environ, PYTHONPATH="", **ONE_THREAD_ENV)
    intr = [f"--{k}={v}" for k, v in zip(("fx", "fy", "cx", "cy"), TUM_FR1)]
    out = subprocess.run([sys.executable, "-m", "sift_tpu_torch.cli", "twoview",
                          *FRAMES, *intr, "--device", "cpu", "--time"],
                         cwd=_REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    head = re.search(r"^matches: (\d+)  inliers: (\d+)  success: (\w+)$",
                     out.stdout, re.M)
    assert head and head.group(3) == "True", out.stdout
    rows = re.search(r"R =\n(.*?)\nt = \[(.*?)\] \(unit scale\)", out.stdout,
                     re.S)
    R = np.array([[float(v) for v in ln.strip(" []").split()]
                  for ln in rows.group(1).splitlines()])
    t = np.array([float(v) for v in rows.group(2).split()])
    assert R.shape == (3, 3) and _rot_deg(R) < 0.1
    assert _dir_deg(t, T_TRUE) < 2.0
    assert "relative pose" in out.stdout

    # The same counts from the library calls on the same files.
    args = cli.build_parser().parse_args(["twoview", *FRAMES, "--device", "cpu"])
    kps = cli.twoview_extract([load_image_gray(f) for f in FRAMES],
                              cli._sift_config(args), "cpu")
    m, pa, pb, valid = cli.twoview_match(kps, 0.8)
    _, _, est = cli.twoview_pose(pa, pb, valid, TUM_FR1, 2.0)
    assert int(head.group(1)) == int(m.count()) >= 200
    assert int(head.group(2)) == int(est.num_inliers)


def test_cli_twoview_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["twoview", *FRAMES])


def test_default_intrinsics_as_jax():
    # The JAX command: focal = max image dim, principal point = centre.
    assert cli.default_intrinsics(480, 640) == (640.0, 640.0, 320.0, 240.0)
