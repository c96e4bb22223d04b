"""The port's matcher (`sift_tpu_torch.matching`) and the plain version of
its streaming top-2 kernel, against the JAX package on the CPU.

The JAX streaming kernel runs in Pallas interpret mode, as
`tests/unit/test_pallas_match.py` runs it. Tolerances:
- top-2: the same has-a-candidate mask, `arg` identical, best and second
  within rtol=1e-5, atol=1e-2 (descriptors of scale 10: |a|^2 ~ 1e4, so
  f32 cancellation in |a|^2 + |b|^2 - 2 a.b leaves ~1e-3);
- matches: the same valid mask, the same set of (idx_a, idx_b) pairs and,
  per pair, distances within rtol=1e-5 and atol=1e-2 ("l2", "l2q8") or
  1e-5 ("dot", distances on the unit sphere). The order of the valid slots
  is by distance, and distances that differ in the last bits may swap
  neighbours, so the port's slots are checked to be sorted instead of
  slot-equal; the invalid slots list the rejected rows in index order in
  both.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sift_tpu.config import MatchConfig as JaxMatchConfig
from sift_tpu.kernels.pallas.match import streaming_top2 as jax_streaming_top2
from sift_tpu.matching.matcher import match_descriptors as jax_match
from sift_tpu.matching.matcher import match_descriptors_guided as jax_guided
from sift_tpu.matching.matcher import matched_coords as jax_matched_coords
from sift_tpu.types import Keypoints as JaxKeypoints
from sift_tpu.types import Matches as JaxMatches

from sift_tpu_torch.config import MatchConfig
from sift_tpu_torch.kernels.cuda import match as match_kernel
from sift_tpu_torch.matching import matcher
from sift_tpu_torch.types import Keypoints, Matches


def _case(seed, na, nb, d=128, invalid_frac=0.2):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((na, d)).astype(np.float32) * 10.0
    b = rng.standard_normal((nb, d)).astype(np.float32) * 10.0
    va = rng.random(na) > invalid_frac
    vb = rng.random(nb) > invalid_frac
    va[0] = vb[0] = True
    return a, va, b, vb


def _noisy_permutation(n=512):
    """b is a noisy permutation of a, so most rows pass the ratio test."""
    rng = np.random.default_rng(11)
    a = rng.standard_normal((n, 128)).astype(np.float32) * 5.0
    perm = rng.permutation(n)
    b = a[perm] + rng.standard_normal((n, 128)).astype(np.float32) * 0.05
    va = rng.random(n) > 0.1
    vb = rng.random(n) > 0.1
    return a, va, b, vb


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in arrays]


def _j(*arrays):
    return [jnp.asarray(x) for x in arrays]


def _plain_and_jax(a, va, b, vb):
    got = [x.numpy() for x in match_kernel.streaming_top2_plain(*_t(a, va, b, vb))]
    want = [np.asarray(x) for x in jax_streaming_top2(*_j(a, va, b, vb),
                                                      interpret=True)]
    return got, want


@pytest.mark.parametrize("seed,na,nb", [
    (0, 1024, 1024),
    (1, 2048, 1536),
    (2, 700, 900),
    (3, 100, 60),
])
def test_top2_plain_matches_jax_kernel(seed, na, nb):
    a, va, b, vb = _case(seed, na, nb)
    (best, second, arg), (jbest, jsecond, jarg) = _plain_and_jax(a, va, b, vb)
    has = va & (jbest < 1e29)
    np.testing.assert_array_equal(va & (best < 1e29), has)
    np.testing.assert_array_equal(arg[has], jarg[has])
    np.testing.assert_allclose(best[has], jbest[has], rtol=1e-5, atol=1e-2)
    np.testing.assert_allclose(second[has], jsecond[has], rtol=1e-5, atol=1e-2)
    assert (best[~has] >= 1e29).all()
    assert arg.dtype == np.int32 and ((arg >= 0) & (arg < nb)).all()


def test_top2_plain_all_invalid_columns():
    a, va, b, _ = _case(4, 256, 256)
    vb = np.zeros(256, bool)
    (best, _, arg), (jbest, _, _) = _plain_and_jax(a, va, b, vb)
    assert (best >= 1e29).all() and (jbest >= 1e29).all()
    assert ((arg >= 0) & (arg < 256)).all()


def test_top2_plain_padding_slots_inert():
    a, va, b, vb = _case(5, 300, 450)
    out1 = match_kernel.streaming_top2_plain(*_t(a, va, b, vb))
    a2, b2 = a.copy(), b.copy()
    a2[~va] = 1e6
    b2[~vb] = -1e6
    out2 = match_kernel.streaming_top2_plain(*_t(a2, va, b2, vb))
    (_, _, _), (jbest, jsecond, jarg) = _plain_and_jax(a2, va, b2, vb)
    has = va & (out1[0].numpy() < 1e29)
    for x, y in zip(out1, out2):
        np.testing.assert_array_equal(x.numpy()[has], y.numpy()[has])
    np.testing.assert_array_equal(out2[2].numpy()[has], jarg[has])


def _assert_matches_agree(got: Matches, want, atol: float):
    got = got.to_numpy()
    want = {f: np.asarray(getattr(want, f))
            for f in ("idx_a", "idx_b", "distance", "valid")}
    np.testing.assert_array_equal(got.valid, want["valid"])
    v = want["valid"]
    pairs = dict(zip(got.idx_a[v].tolist(), got.idx_b[v].tolist()))
    assert len(pairs) == v.sum()
    assert pairs == dict(zip(want["idx_a"][v].tolist(),
                             want["idx_b"][v].tolist()))
    dist = dict(zip(got.idx_a[v].tolist(), got.distance[v].tolist()))
    wdist = np.array([dist[i] for i in want["idx_a"][v].tolist()])
    np.testing.assert_allclose(wdist, want["distance"][v], rtol=1e-5, atol=atol)
    assert (np.diff(got.distance[v]) >= 0).all()
    np.testing.assert_array_equal(got.idx_a[~v], want["idx_a"][~v])
    np.testing.assert_array_equal(got.distance[~v], want["distance"][~v])


@pytest.mark.parametrize("mutual", [False, True])
@pytest.mark.parametrize("metric", ["l2", "dot", "l2q8"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_match_descriptors_matches_jax(impl, metric, mutual):
    a, va, b, vb = _noisy_permutation()
    kw = dict(ratio=0.8, mutual=mutual, max_matches=600, metric=metric,
              impl=impl)
    want = jax_match(*_j(a, va, b, vb), JaxMatchConfig(**kw))
    got = matcher.match_descriptors(*_t(a, va, b, vb), MatchConfig(**kw))
    assert int(np.asarray(want.valid).sum()) > 256      # real matches
    _assert_matches_agree(got, want, 1e-5 if metric == "dot" else 1e-2)


@pytest.mark.parametrize("mutual", [False, True])
def test_match_descriptors_guided_matches_jax(mutual):
    a, va, b, vb = _noisy_permutation(256)
    rng = np.random.default_rng(3)
    uv_b = rng.uniform(0, 100, (256, 2)).astype(np.float32)
    uv_pred = rng.uniform(0, 100, (256, 2)).astype(np.float32)
    has = rng.random(256) > 0.5
    kw = dict(ratio=0.9, mutual=mutual, max_matches=128)
    want = jax_guided(*_j(a, va, b, vb, uv_pred, has, uv_b), 30.0,
                      JaxMatchConfig(**kw))
    got = matcher.match_descriptors_guided(*_t(a, va, b, vb, uv_pred, has,
                                               uv_b), 30.0, MatchConfig(**kw))
    assert int(np.asarray(want.valid).sum()) > 20
    _assert_matches_agree(got, want, 1e-2)


def test_small_capacity_pads_like_jax():
    a, va, b, vb = _noisy_permutation(64)
    kw = dict(ratio=0.8, mutual=True, max_matches=100)
    want = jax_match(*_j(a, va, b, vb), JaxMatchConfig(**kw))
    got = matcher.match_descriptors(*_t(a, va, b, vb), MatchConfig(**kw))
    assert got.idx_a.shape == (100,)
    _assert_matches_agree(got, want, 1e-2)


def test_auto_on_the_cpu_never_calls_the_kernel(monkeypatch):
    """Above the 4096^2 threshold "auto" stays dense on CPU tensors: neither
    the streaming wrapper nor the kernel's CUDA entry is reached."""
    def refuse(*_a, **_k):
        raise AssertionError("streaming path reached on the CPU")
    monkeypatch.setattr(match_kernel, "streaming_top2", refuse)
    monkeypatch.setattr(match_kernel, "_fn", refuse)
    n = 4100
    assert n * n > 4096 * 4096
    rng = np.random.default_rng(0)
    a = rng.standard_normal((n, 128)).astype(np.float32)
    b = a[rng.permutation(n)] + 0.01 * rng.standard_normal((n, 128)).astype(
        np.float32)
    v = np.ones(n, bool)
    m = matcher.match_descriptors(*_t(a, v, b, v),
                                  MatchConfig(max_matches=n, impl="auto"))
    assert int(m.count()) > n // 2
    assert match_kernel.LAUNCHES == 0


def test_pallas_on_the_cpu_runs_the_plain_version_twice(monkeypatch):
    calls = []
    real = match_kernel.streaming_top2

    def counted(*args):
        calls.append(args[0].shape)
        return real(*args)
    monkeypatch.setattr(match_kernel, "streaming_top2", counted)
    a, va, b, vb = _noisy_permutation(128)
    matcher.match_descriptors(*_t(a, va, b[:100], vb[:100]),
                              MatchConfig(impl="pallas", mutual=True))
    assert calls == [(128, 128), (100, 128)]
    assert match_kernel.LAUNCHES == 0


def test_use_streaming_resolution():
    cpu = torch.zeros((8192, 128))
    assert not matcher._use_streaming(MatchConfig(impl="auto"), cpu, 8192)
    assert matcher._use_streaming(MatchConfig(impl="pallas"), cpu, 8)
    assert not matcher._use_streaming(MatchConfig(impl="pallas", metric="l2q8"),
                                      cpu, 8)
    assert not matcher._use_streaming(MatchConfig(impl="pallas"),
                                      torch.zeros((8, 64)), 8)
    with pytest.raises(ValueError):
        matcher._use_streaming(MatchConfig(impl="ivf"), cpu, 8)


def _keypoints(seed, n=300):
    rng = np.random.default_rng(seed)
    f = dict(x=rng.uniform(0, 90, n), y=rng.uniform(0, 60, n),
             octave=rng.integers(0, 4, n), level=rng.integers(1, 3, n),
             scale=rng.uniform(1, 8, n), score=rng.uniform(0, 1, n),
             orientation=rng.uniform(0, 360, n), valid=rng.random(n) > 0.2)
    f = {k: (v.astype(np.int32) if k in ("octave", "level") else
             v if k == "valid" else v.astype(np.float32)) for k, v in f.items()}
    return f


@pytest.mark.parametrize("subpixel", [False, True])
def test_matched_coords_matches_jax(subpixel):
    fa, fb = _keypoints(1), _keypoints(2)
    rng = np.random.default_rng(4)
    m = dict(idx_a=rng.integers(0, 300, 64).astype(np.int32),
             idx_b=rng.integers(0, 300, 64).astype(np.int32),
             distance=rng.uniform(0, 1, 64).astype(np.float32),
             valid=rng.random(64) > 0.3)
    want = jax_matched_coords(
        JaxKeypoints(**{k: jnp.asarray(v) for k, v in fa.items()}),
        JaxKeypoints(**{k: jnp.asarray(v) for k, v in fb.items()}),
        JaxMatches(**{k: jnp.asarray(v) for k, v in m.items()}), subpixel)
    got = matcher.matched_coords(
        Keypoints(**{k: torch.from_numpy(v) for k, v in fa.items()}),
        Keypoints(**{k: torch.from_numpy(v) for k, v in fb.items()}),
        Matches(**{k: torch.from_numpy(v) for k, v in m.items()}), subpixel)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    kp = Keypoints(**{k: torch.from_numpy(v) for k, v in fa.items()})
    assert kp.capacity == 300 and int(kp.count()) == int(fa["valid"].sum())
