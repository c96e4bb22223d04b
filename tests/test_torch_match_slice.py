"""The port's two-image matching path (extract -> match -> homography
RANSAC), plain path on the CPU, against the JAX package on a 96x128 frame
and its warp by a known homography.

- Extraction is held as `test_torch_slice.py` holds it: valid mask, octave
  and level slot for slot, descriptors to 6e-3; positions to 5e-4 (on this
  pair two of 97 keypoints differ by 1.5e-4: the sub-pixel offset solves a
  3x3 system of DoG differences that carry the pyramids' ~1e-5 sum-order
  difference).
- Matching: both matchers get JAX's descriptors, and the `Matches` must be
  equal slot for slot (indices and mask exactly, distances to 1e-5: unit
  descriptors, f32 sums in two orders).
- RANSAC: both get the matched coordinates from JAX's keypoints and the
  same Gumbel noise; inliers and counts must be identical, and the models
  must map the frame's corners to within 0.01 px of each other.
- The port end to end (its own keypoints, matches and a seeded generator)
  recovers the true homography to within 1 px at the corners.
- `python -m sift_tpu_torch.cli match a.png b.png --device cpu` prints the
  match and inlier counts that the library calls give on the same files.
"""

import dataclasses
import functools
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

import jax
import jax.numpy as jnp

from sift_tpu.config import MatchConfig as JaxMatchConfig
from sift_tpu.config import RansacConfig as JaxRansacConfig
from sift_tpu.config import SiftConfig as JaxSiftConfig
from sift_tpu.frontend.sift import extract_batch as jax_extract_batch
from sift_tpu.geometry.homography import ransac_homography as jax_ransac
from sift_tpu.matching.matcher import match_descriptors as jax_match
from sift_tpu.matching.matcher import matched_coords as jax_matched_coords

from sift_tpu_torch import config_from_dict, extract, extract_batch
from sift_tpu_torch.config import MatchConfig, RansacConfig, SiftConfig
from sift_tpu_torch.geometry.homography import ransac_homography
from sift_tpu_torch.io.image import load_image_gray, save_image_gray
from sift_tpu_torch.matching.matcher import match_descriptors, matched_coords
from tests.torch_dist_world import (  # noqa: F401
    ONE_THREAD_ENV, one_torch_thread)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 96, 128
CORNERS = np.array([[0, 0], [W, 0], [W, H], [0, H]], np.float64)


def _true_h() -> np.ndarray:
    """Rotation 4 deg and scale 0.95 about the centre, a small shift and a
    perspective term: B = H(A)."""
    th, s = np.deg2rad(4.0), 0.95
    R = s * np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    c = np.array([W / 2.0, H / 2.0])
    Ht = np.eye(3)
    Ht[:2, :2] = R
    Ht[:2, 2] = c - R @ c + np.array([3.0, -2.0])
    Ht[2, :2] = [2e-4, -1e-4]
    return Ht


def _map(Hm, pts):
    q = np.c_[pts, np.ones(len(pts))] @ np.asarray(Hm, np.float64).T
    return q[:, :2] / q[:, 2:]


def _corner_gap(H1, H2) -> float:
    H1 = np.asarray(H1, np.float64)
    H2 = np.asarray(H2, np.float64)
    return float(np.abs(_map(H1 / H1[2, 2], CORNERS)
                        - _map(H2 / H2[2, 2], CORNERS)).max())


def _pair() -> np.ndarray:
    rng = np.random.default_rng(1)
    a = ndi.gaussian_filter(rng.uniform(0, 255, (H, W)), 2.5)
    a = (a - a.min()) / (a.max() - a.min()) * 255.0
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    q = np.stack([xx, yy, np.ones_like(xx)], -1) @ np.linalg.inv(_true_h()).T
    b = ndi.map_coordinates(a, [q[..., 1] / q[..., 2], q[..., 0] / q[..., 2]],
                            order=1, mode="nearest")
    return np.stack([a, b]).astype(np.float32)


def _image(kp, i):
    return jax.tree.map(lambda x: x[i] if np.ndim(x) else x, kp)


@pytest.fixture(scope="module")
def both():
    jcfg = JaxSiftConfig(max_keypoints_per_octave=256, max_keypoints=256)
    imgs = _pair()
    run = jax.jit(functools.partial(jax_extract_batch, cfg=jcfg))
    want = jax.tree.map(np.array, run(jnp.asarray(imgs)))
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    got = extract_batch(imgs, cfg, device="cpu")
    return imgs, cfg, got, want


def test_extraction_matches_jax(both):
    _, _, got, want = both
    got = got.to_numpy()
    assert (want.valid.sum(axis=1) > 40).all()
    for f in ("valid", "octave", "level", "n_dropped", "n_cand_pruned"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    v = want.valid
    np.testing.assert_allclose(got.x[v], want.x[v], rtol=0, atol=5e-4)
    np.testing.assert_allclose(got.y[v], want.y[v], rtol=0, atol=5e-4)
    np.testing.assert_allclose(got.desc[v], want.desc[v], rtol=0, atol=6e-3)


def _jax_matches(want):
    jcfg = JaxMatchConfig(ratio=0.8, mutual=True, max_matches=256)
    ka, kb = _image(want, 0), _image(want, 1)
    return jax_match(jnp.asarray(ka.desc), jnp.asarray(ka.valid),
                     jnp.asarray(kb.desc), jnp.asarray(kb.valid), jcfg), jcfg


def test_matches_equal_on_jax_descriptors(both):
    _, _, _, want = both
    jm, jcfg = _jax_matches(want)
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    ka, kb = _image(want, 0), _image(want, 1)
    got = match_descriptors(torch.from_numpy(ka.desc), torch.from_numpy(ka.valid),
                            torch.from_numpy(kb.desc), torch.from_numpy(kb.valid),
                            cfg).to_numpy()
    assert int(np.asarray(jm.valid).sum()) >= 25
    for f in ("valid", "idx_a", "idx_b"):
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(jm, f)),
                                      err_msg=f)
    np.testing.assert_allclose(got.distance, np.asarray(jm.distance),
                               rtol=1e-5, atol=1e-5)


def test_ransac_on_jax_matches(both):
    _, _, _, want = both
    jm, _ = _jax_matches(want)
    ka = jax.tree.map(jnp.asarray, _image(want, 0))
    kb = jax.tree.map(jnp.asarray, _image(want, 1))
    pa, pb, valid = (np.array(x) for x in jax_matched_coords(ka, kb, jm))
    key = jax.random.PRNGKey(0)
    g = np.array(jax.random.gumbel(key, (512, pa.shape[0])))
    jest = jax_ransac(key, jnp.asarray(pa), jnp.asarray(pb), jnp.asarray(valid),
                      JaxRansacConfig(inlier_threshold=3.0))
    est = ransac_homography(torch.from_numpy(g), torch.from_numpy(pa),
                            torch.from_numpy(pb), torch.from_numpy(valid),
                            RansacConfig(inlier_threshold=3.0))
    assert bool(est.success) and bool(jest.success)
    assert int(est.num_inliers) == int(jest.num_inliers)
    np.testing.assert_array_equal(est.inliers.numpy(), np.asarray(jest.inliers))
    assert _corner_gap(est.model.numpy(), np.asarray(jest.model)) < 0.01


def test_port_path_recovers_the_homography(both):
    _, _, got, _ = both
    ka = got.map(lambda t: t[0])
    kb = got.map(lambda t: t[1])
    m = match_descriptors(ka.desc, ka.valid, kb.desc, kb.valid,
                          MatchConfig(ratio=0.8, mutual=True, max_matches=256))
    pa, pb, valid = matched_coords(ka, kb, m)
    est = ransac_homography(torch.Generator().manual_seed(0), pa, pb, valid,
                            RansacConfig(inlier_threshold=3.0))
    assert bool(est.success)
    assert int(est.num_inliers) >= int(m.count()) // 2
    assert _corner_gap(est.model.numpy(), _true_h()) < 1.0


def test_cli_match_prints_the_library_counts(tmp_path):
    imgs = _pair()
    paths = [str(tmp_path / f"{n}.png") for n in ("a", "b")]
    for p, img in zip(paths, imgs):
        save_image_gray(p, img)
    env = dict(os.environ, PYTHONPATH="", **ONE_THREAD_ENV)
    out = subprocess.run([sys.executable, "-m", "sift_tpu_torch.cli", "match",
                          *paths, "--device", "cpu"], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n_matches = int(re.search(r"^(\d+) matches", out.stdout, re.M).group(1))
    n_inliers = int(re.search(r"inliers: (\d+)", out.stdout).group(1))

    # The CLI's defaults: max_keypoints 1024, float32 windows, ratio 0.8,
    # mutual, RANSAC threshold 3 px from a generator seeded with 0.
    cfg = SiftConfig(max_keypoints=1024, window_dtype="float32")
    kps = [extract(load_image_gray(p), cfg, device="cpu") for p in paths]
    m = match_descriptors(kps[0].desc, kps[0].valid, kps[1].desc,
                          kps[1].valid, MatchConfig(ratio=0.8))
    pa, pb, valid = matched_coords(kps[0], kps[1], m)
    est = ransac_homography(torch.Generator().manual_seed(0), pa, pb, valid,
                            RansacConfig(inlier_threshold=3.0))
    assert n_matches == int(m.count()) >= 20
    assert n_inliers == int(est.num_inliers) >= 10
    assert "success=True" in out.stdout


def test_cli_defaults_to_the_card(tmp_path, monkeypatch):
    from sift_tpu_torch import cli
    paths = [str(tmp_path / f"{n}.png") for n in ("a", "b")]
    for p, img in zip(paths, _pair()):
        save_image_gray(p, img)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["match", *paths])
