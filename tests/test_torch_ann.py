"""The port's IVF-Flat index (`sift_tpu_torch.matching.ann`) on the CPU: the
seven cases of `tests/unit/test_ann.py` on the port, and the port against
the JAX package (`sift_tpu.matching.ann`) on the same inputs.

- `build_ivf` fed JAX's k-means init draws (`jax.random.uniform(
  PRNGKey(0), (N,))`, what the JAX build draws by default): centroids
  within 1e-5, `bucket_ids`, `bucket_valid` and `n_overflow` equal.
- `search_ivf` and `match_descriptors_ann` on one index: best indices
  and masks equal, the matched (query, database) pairs equal as sets,
  distances within `tests/unit/test_ann.py`'s 1e-4 relative + 1e-3: the
  squared distance |q|^2 + |c|^2 - 2 q.c of two ~130-norm descriptors
  carries f32 rounding of that size in either package, and the
  compaction orders distances that close either way.
- A JAX-built index carried into the port by `ivf_index_from_numpy` and
  searched there gives JAX's search.
- `cli match --match-impl ivf --device cpu` on crops of a fixture pair
  prints the library calls' counts.

PyTorch runs on two threads, light on a machine that runs other tests
beside it.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sift_tpu.config import AnnConfig as JaxAnnConfig
from sift_tpu.config import MatchConfig as JaxMatchConfig
from sift_tpu.matching.ann import build_ivf as jax_build_ivf
from sift_tpu.matching.ann import match_descriptors_ann as jax_match_ann
from sift_tpu.matching.ann import search_ivf as jax_search_ivf

from sift_tpu_torch import cli
from sift_tpu_torch.config import AnnConfig, MatchConfig, SiftConfig
from sift_tpu_torch.frontend.sift import extract
from sift_tpu_torch.io.image import load_image_gray
from sift_tpu_torch.matching import (build_ivf, ivf_index_from_numpy,
                                     match_descriptors_ann, search_ivf)
from sift_tpu_torch.io.image import save_image_gray
from sift_tpu_torch.matching.matcher import match_descriptors
from tests.test_torch_sfm_loop import torch_threads

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_RGB = os.path.join(_REPO, "tests", "fixtures", "tum_mini",
                    "rgbd_dataset_freiburg1_mini", "rgb")
FRAMES = [os.path.join(_RGB, f) for f in ("1305031100.000000.png",
                                          "1305031100.100000.png")]


@pytest.fixture(autouse=True)
def two_threads():
    with torch_threads(2):
        yield


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _clustered_db(rng, n, d=128, n_centers=32, spread=0.15):
    """Descriptors with cluster structure (what IVF assumes of SIFT space)."""
    centers = rng.standard_normal((n_centers, d)).astype(np.float32)
    which = rng.integers(0, n_centers, n)
    return (centers[which] +
            spread * rng.standard_normal((n, d))).astype(np.float32)


def _jax_uniform(n: int) -> np.ndarray:
    return np.array(jax.random.uniform(jax.random.PRNGKey(0), (n,)))


# --- the seven cases of tests/unit/test_ann.py, on the port ----------------

def test_exact_when_probing_everything():
    rng = np.random.default_rng(0)
    db = _clustered_db(rng, 512)
    q = _clustered_db(rng, 128)
    vdb = rng.random(512) > 0.1
    vq = rng.random(128) > 0.1
    ann = AnnConfig(n_clusters=16, nprobe=16, bucket_capacity=512,
                    kmeans_iters=5)
    idx = build_ivf(_t(db), _t(vdb), ann)
    assert int(idx.n_overflow) == 0
    best, second, arg = search_ivf(idx, _t(q), _t(vq), ann)
    d2 = ((q[:, None, :] - db[None, :, :]) ** 2).sum(-1)
    d2[:, ~vdb] = np.inf
    m = vq
    np.testing.assert_array_equal(arg.numpy()[m], d2.argmin(-1)[m])
    np.testing.assert_allclose(best.numpy()[m], d2.min(-1)[m],
                               rtol=1e-4, atol=1e-3)
    assert (best.numpy()[~m] > 1e29).all()


def test_recall_with_partial_probing():
    rng = np.random.default_rng(1)
    db = _clustered_db(rng, 2048, n_centers=24)
    src = rng.permutation(2048)[:256]
    q = db[src] + 0.01 * rng.standard_normal((256, 128)).astype(np.float32)
    ann = AnnConfig(n_clusters=24, nprobe=4, bucket_capacity=512,
                    kmeans_iters=10)
    idx = build_ivf(_t(db), torch.ones(2048, dtype=torch.bool), ann)
    assert int(idx.n_overflow) == 0
    _, _, arg = search_ivf(idx, _t(q), torch.ones(256, dtype=torch.bool), ann)
    assert (arg.numpy() == src).mean() >= 0.95


def test_overflow_counted_not_silent():
    rng = np.random.default_rng(2)
    db = rng.standard_normal((256, 128)).astype(np.float32)
    ann = AnnConfig(n_clusters=2, nprobe=2, bucket_capacity=64,
                    kmeans_iters=3)
    idx = build_ivf(_t(db), torch.ones(256, dtype=torch.bool), ann)
    n_in = int(idx.bucket_valid.sum())
    assert n_in <= 128
    assert int(idx.n_overflow) == 256 - n_in > 0


def test_match_ann_agrees_with_exact_on_easy_pairs():
    rng = np.random.default_rng(3)
    db = _clustered_db(rng, 1024, n_centers=20)
    sel = rng.permutation(1024)[:128]
    q = np.concatenate([
        db[sel] + 0.005 * rng.standard_normal((128, 128)),
        rng.standard_normal((128, 128)) * 3.0,     # distractors
    ]).astype(np.float32)
    vq = torch.ones(256, dtype=torch.bool)
    vdb = torch.ones(1024, dtype=torch.bool)
    cfg = MatchConfig(ratio=0.8, mutual=True, max_matches=256)
    ann = AnnConfig(n_clusters=20, nprobe=5, bucket_capacity=256,
                    kmeans_iters=10)
    idx = build_ivf(_t(db), vdb, ann)
    got = match_descriptors_ann(_t(q), vq, idx, cfg, ann).to_numpy()
    ref = match_descriptors(_t(q), vq, _t(db), vdb, cfg).to_numpy()
    ref_pairs = set(zip(ref.idx_a[ref.valid].tolist(),
                        ref.idx_b[ref.valid].tolist()))
    got_pairs = set(zip(got.idx_a[got.valid].tolist(),
                        got.idx_b[got.valid].tolist()))
    assert len(ref_pairs) >= 100
    assert len(got_pairs & ref_pairs) / len(ref_pairs) >= 0.9
    planted = dict(enumerate(sel.tolist()))
    for a, b in got_pairs:
        if a < 128:
            assert b == planted[a]


def test_determinism():
    rng = np.random.default_rng(4)
    db = _clustered_db(rng, 512)
    q = _clustered_db(rng, 64)
    ann = AnnConfig(n_clusters=8, nprobe=3, bucket_capacity=256,
                    kmeans_iters=4)
    ones = torch.ones(512, dtype=torch.bool)
    i1, i2 = build_ivf(_t(db), ones, ann), build_ivf(_t(db), ones, ann)
    assert torch.equal(i1.centroids, i2.centroids)
    vq = torch.ones(64, dtype=torch.bool)
    b1, _, a1 = search_ivf(i1, _t(q), vq, ann)
    b2, _, a2 = search_ivf(i2, _t(q), vq, ann)
    assert torch.equal(a1, a2) and torch.equal(b1, b2)


def test_query_tiling_invariant():
    rng = np.random.default_rng(5)
    db = _clustered_db(rng, 1024, n_centers=16)
    q = _clustered_db(rng, 300)          # deliberately not a tile multiple
    vq = _t(rng.random(300) > 0.1)
    idx, outs = None, []
    for tile in (512, 64):               # single tile vs 5 tiles (padded)
        ann = AnnConfig(n_clusters=16, nprobe=16, bucket_capacity=512,
                        kmeans_iters=5, query_tile=tile)
        if idx is None:
            idx = build_ivf(_t(db), torch.ones(1024, dtype=torch.bool), ann)
        outs.append(search_ivf(idx, _t(q), vq, ann))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_build_padding_inert_even_when_clusters_exceed_valid():
    rng = np.random.default_rng(6)
    db = rng.standard_normal((64, 128)).astype(np.float32)
    valid = np.arange(64) < 12           # fewer valid rows than clusters
    q = rng.standard_normal((16, 128)).astype(np.float32)
    ann = AnnConfig(n_clusters=16, nprobe=16, bucket_capacity=64,
                    kmeans_iters=4)
    outs = []
    for poison in (0.0, 1e3):
        db2 = db.copy()
        db2[~valid] = poison
        idx = build_ivf(_t(db2), _t(valid), ann)
        best, _, arg = search_ivf(idx, _t(q), torch.ones(16, dtype=torch.bool),
                                  ann)
        outs.append((idx.centroids, best, arg))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


# --- the port against the JAX package ---------------------------------------

CASES = {
    # (N, Q, db valid share, AnnConfig kwargs)
    "clustered": (1024, 300, 0.9, dict(n_clusters=16, nprobe=4,
                                       bucket_capacity=256, kmeans_iters=6,
                                       query_tile=128)),
    "overflow": (512, 64, 1.0, dict(n_clusters=4, nprobe=2,
                                    bucket_capacity=96, kmeans_iters=3)),
    "sparse_valid": (64, 16, 0.2, dict(n_clusters=16, nprobe=16,
                                       bucket_capacity=64, kmeans_iters=4)),
}


def _case(name):
    n, nq, share, kw = CASES[name]
    rng = np.random.default_rng(len(name))
    db = _clustered_db(rng, n, n_centers=20)
    q = np.concatenate([db[rng.permutation(n)[:nq // 2]]
                        + 0.01 * rng.standard_normal((nq // 2, 128)),
                        _clustered_db(rng, nq - nq // 2, n_centers=20)]
                       ).astype(np.float32)
    vdb = rng.random(n) < share
    vdb[0] = True
    vq = rng.random(nq) > 0.1
    return db, vdb, q, vq, kw


@pytest.fixture(scope="module", params=sorted(CASES))
def built(request):
    db, vdb, q, vq, kw = _case(request.param)
    jidx = jax_build_ivf(jnp.asarray(db), jnp.asarray(vdb), JaxAnnConfig(**kw))
    idx = build_ivf(_t(db), _t(vdb), AnnConfig(**kw),
                    noise=_t(_jax_uniform(len(db))))
    return db, vdb, q, vq, kw, jax.tree.map(np.asarray, jidx), idx


def test_build_matches_jax(built):
    _, _, _, _, kw, jidx, idx = built
    np.testing.assert_allclose(idx.centroids.numpy(), jidx.centroids,
                               rtol=0, atol=1e-5)
    for f in ("bucket_ids", "bucket_valid", "n_overflow"):
        np.testing.assert_array_equal(getattr(idx, f).numpy(),
                                      getattr(jidx, f), err_msg=f)
    np.testing.assert_array_equal(idx.bucket_desc.numpy(), jidx.bucket_desc)
    if kw["n_clusters"] == 4:
        assert int(jidx.n_overflow) > 0


RTOL, ATOL = 1e-4, 1e-3


def _hold_search(got, want):
    (b, s, i), (bj, sj, ij) = got, want
    np.testing.assert_array_equal(i.numpy(), np.asarray(ij))
    for x, y in ((b, bj), (s, sj)):
        x, y = x.numpy(), np.asarray(y)
        np.testing.assert_array_equal(x > 1e29, y > 1e29)
        finite = y < 1e29
        np.testing.assert_allclose(x[finite], y[finite], rtol=RTOL,
                                   atol=ATOL)


def _hold_matches(got, want):
    """Matches equal as (query, database) pairs with their distances; slot
    order may differ only between distances within the tolerance."""
    def pairs(m):
        v = np.asarray(m.valid)
        return {(int(a), int(b)): float(d) for a, b, d in
                zip(np.asarray(m.idx_a)[v], np.asarray(m.idx_b)[v],
                    np.asarray(m.distance)[v])}
    pg, pw = pairs(got), pairs(want)
    assert set(pg) == set(pw)
    for k, d in pw.items():
        assert abs(pg[k] - d) <= ATOL + RTOL * abs(d), k
    np.testing.assert_array_equal(np.asarray(got.valid),
                                  np.asarray(want.valid))
    np.testing.assert_allclose(np.asarray(got.distance),
                               np.asarray(want.distance), rtol=RTOL,
                               atol=ATOL)


def test_search_and_match_match_jax(built):
    _, _, q, vq, kw, jidx, idx = built
    jann = JaxAnnConfig(**kw)
    jidx_d = jax.tree.map(jnp.asarray, jidx)
    _hold_search(search_ivf(idx, _t(q), _t(vq), AnnConfig(**kw)),
                 jax_search_ivf(jidx_d, jnp.asarray(q), jnp.asarray(vq), jann))
    for mutual in (True, False):
        jcfg = JaxMatchConfig(ratio=0.8, mutual=mutual, max_matches=128)
        want = jax_match_ann(jnp.asarray(q), jnp.asarray(vq), jidx_d, jcfg,
                             jann)
        got = match_descriptors_ann(
            _t(q), _t(vq), idx, MatchConfig(ratio=0.8, mutual=mutual,
                                            max_matches=128),
            AnnConfig(**kw)).to_numpy()
        _hold_matches(got, want)


def test_jax_built_index_searched_by_the_port(built):
    _, _, q, vq, kw, jidx, _ = built
    idx = ivf_index_from_numpy(jidx, device="cpu")
    assert idx.bucket_ids.dtype == torch.int32 and idx.bucket_valid.dtype \
        == torch.bool and idx.n_overflow.dtype == torch.int32
    _hold_search(search_ivf(idx, _t(q), _t(vq), AnnConfig(**kw)),
                 jax_search_ivf(jax.tree.map(jnp.asarray, jidx),
                                jnp.asarray(q), jnp.asarray(vq),
                                JaxAnnConfig(**kw)))
    as_dict = ivf_index_from_numpy(
        {f: getattr(jidx, f) for f in ("centroids", "bucket_ids",
                                       "bucket_valid", "bucket_desc", "desc",
                                       "n_overflow")}, device="cpu")
    assert torch.equal(as_dict.bucket_desc, idx.bucket_desc)


def test_nprobe_all_equals_exact_matches():
    rng = np.random.default_rng(7)
    db = _clustered_db(rng, 512, n_centers=12)
    q = np.concatenate([db[:100] + 0.01 * rng.standard_normal((100, 128)),
                        _clustered_db(rng, 60, n_centers=12)]).astype(np.float32)
    vdb, vq = _t(rng.random(512) > 0.05), _t(rng.random(160) > 0.05)
    ann = AnnConfig(n_clusters=12, nprobe=12, bucket_capacity=512,
                    kmeans_iters=5)
    cfg = MatchConfig(ratio=0.8, mutual=True, max_matches=160)
    got = match_descriptors_ann(_t(q), vq, build_ivf(_t(db), vdb, ann), cfg,
                                ann).to_numpy()
    want = match_descriptors(_t(q), vq, _t(db), vdb, cfg).to_numpy()
    _hold_matches(got, want)


def test_noise_shape_and_metric_refused():
    db = torch.zeros((8, 128))
    with pytest.raises(ValueError, match="noise"):
        build_ivf(db, torch.ones(8, dtype=torch.bool),
                  AnnConfig(n_clusters=2), noise=torch.zeros(7))
    idx = build_ivf(db, torch.ones(8, dtype=torch.bool),
                    AnnConfig(n_clusters=2, kmeans_iters=1))
    with pytest.raises(ValueError, match="squared L2"):
        match_descriptors_ann(db, torch.ones(8, dtype=torch.bool), idx,
                              MatchConfig(metric="dot"), AnnConfig())


def test_cli_match_ivf(tmp_path):
    """`cli match --match-impl ivf --device cpu` prints the counts that the
    library calls give on the same files (240x320 crops of the frames)."""
    paths = [str(tmp_path / f"{i}.png") for i in range(2)]
    for p, f in zip(paths, FRAMES):
        save_image_gray(p, load_image_gray(f)[120:360, 160:480])
    env = dict(os.environ, PYTHONPATH="", OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-m", "sift_tpu_torch.cli", "match",
                          *paths, "--match-impl", "ivf", "--device", "cpu"],
                         cwd=_REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    n_matches = int(re.search(r"^(\d+) matches", out.stdout, re.M).group(1))
    n_inliers = int(re.search(r"inliers: (\d+)", out.stdout).group(1))

    cfg = SiftConfig(max_keypoints=1024, window_dtype="float32")
    kps = [extract(load_image_gray(p), cfg, device="cpu") for p in paths]
    m, index = cli.match_ivf(kps, cfg, MatchConfig(ratio=0.8))
    assert cli.ivf_config(cfg) == AnnConfig(n_clusters=32,
                                            bucket_capacity=256)
    assert ("warning: IVF bucket overflow" in out.stdout) == \
        (int(index.n_overflow) > 0)
    assert n_matches == int(m.count()) >= 50
    assert n_inliers >= n_matches // 2
    # Exact matching on the same keypoints finds most of the same pairs.
    exact = match_descriptors(kps[0].desc, kps[0].valid, kps[1].desc,
                              kps[1].valid, MatchConfig(ratio=0.8)).to_numpy()
    m = m.to_numpy()
    pairs = set(zip(m.idx_a[m.valid].tolist(), m.idx_b[m.valid].tolist()))
    ref = set(zip(exact.idx_a[exact.valid].tolist(),
                  exact.idx_b[exact.valid].tolist()))
    assert len(pairs & ref) >= 0.9 * len(pairs)
