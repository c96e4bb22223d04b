"""Sharded matching of the port (`dist.match_large_sharded`,
`match_pairs_sharded`) in gloo worlds of 1, 2 and 4 processes, started
together, against the JAX package's sharded matchers (virtual CPU
devices, in this process).

Against JAX (the criteria of `tests/test_torch_match.py`): the same
valid mask, the same set of (idx_a, idx_b) pairs, and per pair distances
within the JAX suite's rtol 1e-5 / atol 1e-3
(`tests/multidevice/test_sharded_matching.py`, whose data these are). The
valid slots are ordered by distance, and distances that differ in the
last bits between the packages may swap neighbours, so the port's slots
are checked to be sorted instead of slot-equal. Across the port's world
sizes and mesh shapes the integer outputs must be equal slot for slot,
and every rank's replicated `Matches` must equal rank 0's bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_tpu.config import MatchConfig as JaxMatchConfig
from sift_tpu.config import MeshConfig as JaxMeshConfig
from sift_tpu.dist.matching_dist import match_large_sharded as jax_large
from sift_tpu.dist.matching_dist import match_pairs_sharded as jax_pairs
from sift_tpu.dist.mesh import make_mesh as jax_make_mesh

from sift_tpu_torch.config import MatchConfig
from sift_tpu_torch.matching.matcher import match_descriptors
from tests.torch_dist_world import World, one_torch_thread  # noqa: F401

FIELDS = ("idx_a", "idx_b", "distance", "valid")
# world size -> mesh shapes run in it
MESHES = {1: [(1, 1)], 2: [(2, 1)], 4: [(4, 1), (2, 2)]}
PAIRS, PAIR_N = 16, 128

_BODY = '''
from sift_tpu_torch.config import MatchConfig, MeshConfig
from sift_tpu_torch.dist import (make_mesh, match_large_sharded,
                                 match_pairs_sharded)

FIELDS = ("idx_a", "idx_b", "distance", "valid")
shapes = {1: [(1, 1)], 2: [(2, 1)], 4: [(4, 1), (2, 2)]}[WORLD]
for d, m in shapes:
    mesh = make_mesh(MeshConfig(data=d, model=m))
    for mutual in (True, False):
        got = match_large_sharded(mesh, IN["a"], IN["va"], IN["b"], IN["vb"],
                                  MatchConfig(max_matches=256, mutual=mutual))
        save(f"large_{d}x{m}_{mutual}",
             **{f: getattr(got, f).numpy() for f in FIELDS})
    got = match_pairs_sharded(mesh, IN["pa"], IN["pv"], IN["pb"], IN["pv"],
                              MatchConfig(max_matches=int(IN["pair_n"])))
    save(f"pairs_{d}x{m}", **{f: getattr(got, f).numpy() for f in FIELDS})
if WORLD == 4:
    # Rows 384-447 repeat rows 0-63, at the same local rows of the first
    # and last rank: a tie across ranks that the mutual check must give to
    # the lower global row.
    tie = IN["a"].copy()
    tie[384:448] = tie[0:64]
    got = match_large_sharded(make_mesh(MeshConfig(data=4, model=1)), tie,
                              IN["va"], IN["b"], IN["vb"],
                              MatchConfig(max_matches=256, mutual=True))
    save("tie", **{f: getattr(got, f).numpy() for f in FIELDS})
refused = []
for call in (lambda: match_large_sharded(mesh, IN["a"], IN["va"], IN["b"],
                                         IN["vb"], MatchConfig(metric="l2q8")),
             lambda: match_large_sharded(mesh, IN["a"][:-1], IN["va"][:-1],
                                         IN["b"], IN["vb"], MatchConfig()),
             lambda: match_pairs_sharded(mesh, IN["pa"][:-1], IN["pv"][:-1],
                                         IN["pb"][:-1], IN["pv"][:-1],
                                         MatchConfig())):
    try:
        call()
    except ValueError as e:
        refused.append(str(e))
save("refused", messages=np.array(refused))
'''


def _large_data():
    rng = np.random.default_rng(3)
    na, nb = 512, 384
    b = rng.standard_normal((nb, 128)).astype(np.float32) * 4.0
    sel = rng.permutation(nb)[: na // 2]
    a = np.concatenate([
        b[sel] + 0.02 * rng.standard_normal((sel.shape[0], 128)),
        rng.standard_normal((na - sel.shape[0], 128)) * 4.0,
    ]).astype(np.float32)
    return a, rng.random(na) > 0.15, b, rng.random(nb) > 0.15


def _pair_data():
    rng = np.random.default_rng(0)
    b = rng.standard_normal((PAIRS, PAIR_N, 128)).astype(np.float32)
    b /= np.linalg.norm(b, axis=-1, keepdims=True)
    perm = np.stack([rng.permutation(PAIR_N) for _ in range(PAIRS)])
    a = np.take_along_axis(b, perm[..., None], axis=1) + \
        1e-4 * rng.standard_normal((PAIRS, PAIR_N, 128)).astype(np.float32)
    return a.astype(np.float32), b, np.ones((PAIRS, PAIR_N), bool), perm


@pytest.fixture(scope="module")
def data():
    a, va, b, vb = _large_data()
    pa, pb, pv, perm = _pair_data()
    return dict(a=a, va=va, b=b, vb=vb, pa=pa, pb=pb, pv=pv, perm=perm,
                pair_n=PAIR_N)


@pytest.fixture(scope="module")
def worlds(data, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_match")
    np.savez(tmp / "in.npz", **data)
    return {n: World(tmp, _BODY, n) for n in MESHES}


@pytest.fixture(scope="module")
def jax_results(data, worlds, eight_devices):
    out = {}
    for d, m in MESHES[4]:
        mesh = jax_make_mesh(JaxMeshConfig(data=d, model=m))
        for mutual in (True, False):
            got = jax_large(mesh, *(jnp.asarray(data[k])
                                    for k in ("a", "va", "b", "vb")),
                            JaxMatchConfig(max_matches=256, mutual=mutual))
            out[f"large_{d}x{m}_{mutual}"] = {f: np.asarray(getattr(got, f))
                                              for f in FIELDS}
    got = jax_pairs(jax_make_mesh(JaxMeshConfig(data=4, model=1)),
                    *(jnp.asarray(data[k]) for k in ("pa", "pv", "pb", "pv")),
                    JaxMatchConfig(max_matches=PAIR_N))
    out["pairs"] = {f: np.asarray(getattr(got, f)) for f in FIELDS}
    for w in worlds.values():
        w.wait(timeout=240)
    return out


def _hold(got: dict, want: dict):
    """One `Matches`, or a leading axis of them, against JAX's."""
    if want["valid"].ndim == 2:
        for p in range(want["valid"].shape[0]):
            _hold({k: v[p] for k, v in got.items()},
                  {k: v[p] for k, v in want.items()})
        return
    np.testing.assert_array_equal(got["valid"], want["valid"])
    m = want["valid"]

    def pairs(r):
        return {(int(a), int(b)): float(d) for a, b, d in
                zip(r["idx_a"][m], r["idx_b"][m], r["distance"][m])}

    g, w = pairs(got), pairs(want)
    assert g.keys() == w.keys()
    np.testing.assert_allclose([g[k] for k in w], list(w.values()),
                               rtol=1e-5, atol=1e-3)
    assert (np.diff(got["distance"][m]) >= 0).all()


LARGE_CASES = [(n, shape, mutual) for n in MESHES for shape in MESHES[n]
               for mutual in (True, False)]


@pytest.mark.parametrize("n,shape,mutual", LARGE_CASES,
                         ids=[f"w{n}_{s[0]}x{s[1]}_{'mutual' if mu else 'ratio'}"
                              for n, s, mu in LARGE_CASES])
def test_large_sharded_matches_jax(n, shape, mutual, worlds, jax_results):
    """Every world and mesh shape against JAX's (4, 1) (and (2, 2))
    sharded matcher; the comparison has power (over 50 matches)."""
    name = f"large_{shape[0]}x{shape[1]}_{mutual}"
    got = worlds[n].assert_replicated(name)
    want = jax_results.get(name, jax_results[f"large_4x1_{mutual}"])
    assert want["valid"].sum() > 50
    _hold(got, want)
    # Integer outputs agree with every other world size bit for bit.
    ref = worlds[4].load(f"large_4x1_{mutual}")
    for f in ("idx_a", "idx_b", "valid"):
        np.testing.assert_array_equal(got[f], ref[f])


@pytest.mark.parametrize("mutual", [True, False], ids=["mutual", "ratio"])
def test_large_sharded_matches_single_device(mutual, data, worlds,
                                             jax_results):
    """The port's sharded matcher against its `match_descriptors`: the
    cross-rank (min, argmin) of the mutual check is the argmin over the
    whole distance matrix, so every slot is equal."""
    ref = match_descriptors(*(torch.from_numpy(data[k])
                              for k in ("a", "va", "b", "vb")),
                            MatchConfig(max_matches=256, mutual=mutual))
    for n, shapes in MESHES.items():
        for d, m in shapes:
            got = worlds[n].load(f"large_{d}x{m}_{mutual}")
            for f in ("idx_a", "idx_b", "valid"):
                np.testing.assert_array_equal(got[f], getattr(ref, f).numpy())


def test_mutual_tie_across_ranks_goes_to_the_lower_row(data, worlds,
                                                       jax_results):
    got = worlds[4].assert_replicated("tie")
    v = got["valid"]
    idx_a, idx_b = got["idx_a"][v], got["idx_b"][v]
    assert len(set(idx_b.tolist())) == idx_b.size      # mutual: one a per b
    low = set(idx_a[idx_a < 64].tolist())
    assert len(low) > 20                                # the check has power
    assert not set(idx_a[(idx_a >= 384) & (idx_a < 448)].tolist()) & \
        {k + 384 for k in low}


@pytest.mark.parametrize("n", sorted(MESHES))
def test_pairs_sharded_matches_jax(n, data, worlds, jax_results):
    d, m = MESHES[n][0]
    got = worlds[n].assert_replicated(f"pairs_{d}x{m}")
    want = jax_results["pairs"]
    _hold(got, want)
    # The planted permutation is recovered in every pair.
    for p in range(PAIRS):
        v = got["valid"][p]
        assert v.sum() > PAIR_N // 2
        assert (data["perm"][p][got["idx_a"][p][v]] == got["idx_b"][p][v]).all()


@pytest.mark.parametrize("n", sorted(MESHES))
def test_refusals(n, worlds, jax_results):
    msgs = list(worlds[n].assert_replicated("refused")["messages"])
    assert msgs[0].startswith("l2q8's per-tensor quantization scale")
    if n == 1:            # every count divides by one process
        assert len(msgs) == 1
    else:
        assert msgs[1:] == [f"Na=511 must divide device count {n}",
                            f"P=15 must divide by the process count {n}"]
