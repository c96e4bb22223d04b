"""Sharded extraction of the port (`dist.extract_batch_sharded`) in gloo
worlds of 2 and 4 processes, started together, against the port's
`extract_batch` of the whole batch.

Every mesh shape of one world size runs the same per-rank program on the
same images, so (4, 1) and (2, 2) must be bit-identical. Against one
`extract_batch` of all 8 images the per-rank batch differs (2 or 4), and
the ranks run one thread each; the extraction of an image depends on
neither, so the gathered batch equals it bit for bit. Beside it stands
the JAX suite's keypoint-set criterion (`tests/multidevice/
test_sharded_frontend.py:52-89`, whose frames and config these are): per
image at most 3 keypoints apart, 90% of the keypoints matched one to one
within 1e-2 of (x, y, 100 octave, 0.01 orientation) with descriptors
within 5e-3. `replicate=True` must give every rank the whole batch, bit
for bit the same on every rank and equal to the ranks' own shards.
"""

import numpy as np
import pytest

from sift_tpu_torch.config import SiftConfig
from sift_tpu_torch.frontend.sift import extract_batch
from tests.torch_dist_world import World, one_torch_thread  # noqa: F401

FIELDS = ("x", "y", "octave", "level", "scale", "score", "orientation",
          "valid", "desc", "n_dropped", "n_cand_pruned")
B = 8

_BODY = '''
from sift_tpu_torch.config import MeshConfig, SiftConfig
from sift_tpu_torch.dist import extract_batch_sharded, make_mesh

FIELDS = ("x", "y", "octave", "level", "scale", "score", "orientation",
          "valid", "desc", "n_dropped", "n_cand_pruned")
cfg = SiftConfig(mode="lowe", octaves=3, max_keypoints=256,
                 max_keypoints_per_octave=128)
shapes = {2: [(2, 1)], 4: [(4, 1), (2, 2)]}[WORLD]
for d, m in shapes:
    mesh = make_mesh(MeshConfig(data=d, model=m))
    for replicate in (False, True):
        # uint8 frames: the cast to f32 happens on the rank's device.
        kp = extract_batch_sharded(mesh, IN["frames"], cfg, True,
                                   replicate=replicate)
        save(f"kp_{d}x{m}_{replicate}",
             **{f: getattr(kp, f).numpy() for f in FIELDS})
try:
    extract_batch_sharded(mesh, IN["frames"][:WORLD + 1], cfg)
except ValueError as e:
    save("refused", message=np.array(str(e)))
'''


def _frames(b=B, h=96, w=128):
    """The JAX suite's frames, rounded to uint8."""
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = (128 + 60 * np.sin(xx / 5.0) * np.cos(yy / 7.0)
            + 25 * rng.standard_normal((h, w))).clip(0, 255)
    shift = rng.uniform(-2, 2, (b, 1, 1)).astype(np.float32)
    return np.round(np.clip(base[None] + shift, 0, 255)).astype(np.uint8)


def _cfg():
    return SiftConfig(mode="lowe", octaves=3, max_keypoints=256,
                      max_keypoints_per_octave=128)


@pytest.fixture(scope="module")
def frames():
    return _frames()


@pytest.fixture(scope="module")
def worlds(frames, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_frontend")
    np.savez(tmp / "in.npz", frames=frames)
    ws = {n: World(tmp, _BODY, n) for n in (2, 4)}
    for w in ws.values():
        w.wait(timeout=240)
    return ws


@pytest.fixture(scope="module")
def single(frames):
    kp = extract_batch(frames, _cfg(), device="cpu").to_numpy()
    return {f: getattr(kp, f) for f in FIELDS}


def _bits(a):
    """Floats by their bit pattern, NaNs made one NaN; the rest as is."""
    if a.dtype.kind != "f":
        return a
    return np.where(np.isnan(a), np.float32(np.nan), a).view(np.uint32)


CASES = [(2, (2, 1)), (4, (4, 1)), (4, (2, 2))]
IDS = [f"w{n}_{d}x{m}" for n, (d, m) in CASES]


@pytest.mark.parametrize("n,shape", CASES, ids=IDS)
def test_replicated_batch_on_every_rank(n, shape, worlds):
    """Every rank holds all B images, the same bits on every rank, and its
    own images' rows equal its unreplicated shard."""
    d, m = shape
    full = worlds[n].assert_replicated(f"kp_{d}x{m}_True")
    assert full["x"].shape == (B, 256) and full["desc"].shape == (B, 256, 128)
    assert full["valid"].dtype == bool and full["octave"].dtype == np.int32
    per = B // n
    for rank in range(n):
        own = worlds[n].load(f"kp_{d}x{m}_False", rank)
        assert own["x"].shape == (per, 256)
        for f in FIELDS:
            np.testing.assert_array_equal(
                own[f], full[f][rank * per:(rank + 1) * per], err_msg=f)


def test_identical_across_mesh_shapes(worlds):
    a = worlds[4].load("kp_4x1_True")
    b = worlds[4].load("kp_2x2_True")
    for f in FIELDS:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)


@pytest.mark.parametrize("n,shape", CASES, ids=IDS)
def test_matches_single_device_as_sets(n, shape, worlds, single):
    got = worlds[n].load(f"kp_{shape[0]}x{shape[1]}_True")
    ref = single
    for b in range(B):
        rv, gv = ref["valid"][b], got["valid"][b]
        assert rv.sum() > 20
        assert abs(int(rv.sum()) - int(gv.sum())) <= 3, (rv.sum(), gv.sum())
        key = lambda k, v: np.stack([k["x"][b][v], k["y"][b][v],  # noqa
                                     100.0 * k["octave"][b][v],
                                     0.01 * k["orientation"][b][v]], -1)
        rpos, gpos = key(ref, rv), key(got, gv)
        dist = np.linalg.norm(rpos[:, None] - gpos[None, :], axis=-1)
        j = np.argmin(dist, axis=1)
        close = dist[np.arange(j.size), j] < 1e-2
        bij = np.zeros(j.size, bool)
        seen = set()
        for i, jj in enumerate(j):
            if close[i] and jj not in seen:
                seen.add(jj)
                bij[i] = True
        assert bij.mean() >= 0.9, (b, bij.mean())
        np.testing.assert_allclose(got["desc"][b][gv][j[bij]],
                                   ref["desc"][b][rv][bij], atol=5e-3)


@pytest.mark.parametrize("n,shape", CASES, ids=IDS)
def test_matches_single_device_bit_for_bit(n, shape, worlds, single):
    got = worlds[n].load(f"kp_{shape[0]}x{shape[1]}_True")
    for f in FIELDS:
        np.testing.assert_array_equal(_bits(got[f]), _bits(single[f]),
                                      err_msg=f)


@pytest.mark.parametrize("n", [2, 4])
def test_batch_must_divide(n, worlds):
    msg = str(worlds[n].assert_replicated("refused")["message"])
    assert msg == f"batch {n + 1} must divide by the process count {n}"
