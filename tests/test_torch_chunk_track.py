"""The port's chunked tracking against the JAX package on the CPU.

- `_promo_lm_table` (the device replay of a promotion's landmark
  bookkeeping) against JAX's `_promo_lm_table_for_tests`: the cases of
  `tests/unit/test_promo_lm_table.py`, seeded random payloads, and two
  rows writing one slot (possible only with `mutual=False` matching),
  where the later row wins in both packages as in the host's numpy
  assignment. Exact.
- The chunk stage (`_track_chunk_promo`) against JAX's
  `_jit_track_chunk_promo` on `SyntheticWorld` keypoint batches
  (tests/e2e/test_sfm_pipeline.py) at B = 4 (one slot, fired or not), 16
  (two slots, a padded chunk too) and 32 (four 8-frame sub-chunks), fed
  JAX's own Gumbel noise with the key folds the JAX stage makes:
  `promote_at`, the promoted frames' metadata and the inlier counts of
  frames tracked against the given local map exactly (within one in the
  sub-chunks tracked against a promoted frame's triangulated landmarks),
  poses within TRACK_POSE of each coordinate, each payload's matches as a
  set of (a, b) pairs with their inlier and health flags (as
  `test_torch_sfm_stages.py` compares `_kf_track`).
- Whole chunked runs of both packages on that world (bootstrap per frame,
  then chunk by chunk, falling back per frame as `process_sequence` does),
  the port drawing JAX's noise (`feed_jax_noise`) at B = 8 and 16:
  keyframes at JAX's frames, equal `chunk_stats`, positions within
  POS_TOL after a similarity alignment.

The port runs on one CPU thread (`tests/torch_dist_world.py::
one_torch_thread`).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sift_tpu.slam.pipeline import SfmPipeline as JaxSfmPipeline
from tests.e2e.test_sfm_pipeline import INTR, SyntheticWorld, _pipeline
from tests.test_torch_sfm_loop import POS_TOL, port_frames

from sift_tpu_torch.config import config_from_dict
from sift_tpu_torch.eval.ate import ate_rmse
from sift_tpu_torch.slam.pipeline import SfmPipeline
from tests.torch_dist_world import one_torch_thread  # noqa: F401

TRACK_POSE = 2e-4
TRI_RTOL = 1e-3


@pytest.fixture(scope="module")
def world():
    return SyntheticWorld()


def _pipes(world, **overrides):
    cfg = _pipeline(world).cfg.replace(**overrides)
    return (JaxSfmPipeline(INTR, cfg),
            SfmPipeline(INTR, config_from_dict(dataclasses.asdict(cfg)),
                        device="cpu"))


@pytest.fixture(scope="module")
def pipes(world):
    return _pipes(world)


def _t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------ _promo_lm_table

def _payload(M, ia, ib, mvalid, inl, tri_good, X):
    pay = np.zeros(8 * M + 8, np.float32)
    pay[0:M], pay[M:2 * M] = ia, ib
    pay[2 * M:3 * M], pay[3 * M:4 * M] = mvalid, inl
    tri = np.zeros((M, 4), np.float32)
    tri[:, :3], tri[:, 3] = X, tri_good
    pay[4 * M:8 * M] = tri.reshape(-1)
    return pay


def _unit_case(M, N):
    """tests/unit/test_promo_lm_table.py's rows: an inlier 2D-3D
    adoption, a healthy triangulation, a non-inlier 2D-3D row, and a
    triangulation that lands on the adopted slot (it wins)."""
    rng = np.random.default_rng(0)
    lms = rng.standard_normal((N, 3)).astype(np.float32)
    has = np.zeros(N, bool)
    has[[1, 4, 7]] = True
    ia, ib = np.zeros(M, np.int32), np.zeros(M, np.int32)
    mvalid, inl, good = (np.zeros(M, np.float32) for _ in range(3))
    X = np.zeros((M, 3), np.float32)
    ia[0], ib[0], mvalid[0], inl[0] = 1, 3, 1, 1
    ia[1], ib[1], mvalid[1], good[1] = 2, 5, 1, 1
    X[1] = [1.0, 2.0, 3.0]
    ia[2], ib[2], mvalid[2] = 4, 6, 1
    ia[3], ib[3], mvalid[3], good[3] = 9, 3, 1, 1
    X[3] = [-1.0, -2.0, -3.0]
    return _payload(M, ia, ib, mvalid, inl, good, X), lms, has


def _random_case(M, N, seed, duplicates=False):
    """Random match rows as `_kf_track` leaves them: valid rows with
    distinct b slots (mutual matching) unless `duplicates`, inlier flags
    on some rows, health flags only on valid no-landmark rows; invalid
    rows at index 0."""
    rng = np.random.default_rng(seed)
    lms = rng.standard_normal((N, 3)).astype(np.float32)
    has = rng.random(N) < 0.5
    n = int(rng.integers(M // 4, M // 2))
    ia = np.zeros(M, np.int32)
    ib = np.zeros(M, np.int32)
    ia[:n] = rng.integers(0, N, n)
    ib[:n] = (rng.integers(0, N // 4, n) if duplicates
              else rng.permutation(N)[:n])
    mvalid = np.zeros(M, np.float32)
    mvalid[:n] = 1
    inl = (rng.random(M) < 0.7).astype(np.float32) * mvalid
    good = ((rng.random(M) < 0.6) & (mvalid > 0) & ~has[ia]).astype(
        np.float32)
    X = rng.standard_normal((M, 3)).astype(np.float32)
    return _payload(M, ia, ib, mvalid, inl, good, X), lms, has


def _host_rule(pay, lms, has, M, N):
    """`_promote_keyframe`'s numpy assignments (the later row wins)."""
    ia = pay[:M].astype(int)
    ib = pay[M:2 * M].astype(int)
    take = (pay[3 * M:4 * M] > 0.5) & has[ia]
    tri = pay[4 * M:8 * M].reshape(M, 4)
    good = tri[:, 3] > 0.5
    pos = np.zeros((N, 3), np.float32)
    hasv = np.zeros(N, bool)
    pos[ib[take]] = lms[ia[take]]
    hasv[ib[take]] = True
    pos[ib[good]] = tri[good, :3]
    hasv[ib[good]] = True
    return pos, hasv


@pytest.mark.parametrize("case", ["unit", 0, 1, 2, 3, "duplicates"])
def test_promo_lm_table_matches_jax(pipes, case):
    jp, pp = pipes
    M = jp.cfg.match.max_matches
    N = 16 if case == "unit" else 200
    if case == "unit":
        pay, lms, has = _unit_case(M, N)
    else:
        pay, lms, has = _random_case(M, N, 7 if case == "duplicates"
                                     else case, case == "duplicates")
    want = [np.asarray(a) for a in jax.jit(
        jp._promo_lm_table_for_tests, static_argnums=3)(
        jnp.asarray(pay), jnp.asarray(lms), jnp.asarray(has), N)]
    got = [a.numpy() for a in pp._promo_lm_table(_t(pay), _t(lms), _t(has),
                                                 N)]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    pos_h, has_h = _host_rule(pay, lms, has, M, N)
    np.testing.assert_array_equal(got[1], has_h)
    np.testing.assert_array_equal(got[0][has_h], pos_h[has_h])
    assert has_h.sum() >= (2 if case == "unit" else 20)
    if case == "duplicates":
        ib = pay[M:2 * M].astype(int)
        part = ((pay[3 * M:4 * M] > 0.5) & has[pay[:M].astype(int)]) | \
            (pay[4 * M:8 * M].reshape(M, 4)[:, 3] > 0.5)
        assert np.unique(ib[part]).size < part.sum()   # slots written twice


# ---------------------------------------------------------- chunk stage

def _stack_jax(kps):
    return jax.tree.map(lambda *a: jnp.stack(a), *kps)


def _stack_port(kps):
    pf = port_frames(dict(enumerate(kps)))
    return type(pf[0])(**{f: torch.stack([getattr(pf[i], f)
                                          for i in range(len(kps))])
                          for f in ("x", "y", "octave", "level", "scale",
                                    "score", "orientation", "valid",
                                    "desc")})


def _chunk_noise(cfg, key, B):
    """JAX's draws inside `_track_chunk_promo`: frame b of sub-chunk s
    from fold_in(key_s, b - s * SUB) (key_s = key, or fold_in(key, 0xC40
    + s) for s > 0), slot p from fold_in(key, 0x5EED + p)."""
    M = cfg.match.max_matches
    H = cfg.tracking_ransac_hypotheses
    subs = [8] * (B // 8) if B % 8 == 0 and B > 16 else [B]
    frames = []
    for s, SUB in enumerate(subs):
        ks = key if s == 0 else jax.random.fold_in(key, 0xC40 + s)
        frames += [np.array(jax.random.gumbel(jax.random.fold_in(ks, i),
                                              (H, M))) for i in range(SUB)]
    P = max(1, B // 8)
    slots = [np.array(jax.random.gumbel(jax.random.fold_in(key, 0x5EED + p),
                                        (8, M))) for p in range(P)]
    return _t(np.stack(frames)), _t(np.stack(slots))


def feed_jax_noise(pp, seed=0):
    """Make the port pipeline `pp` draw the JAX pipeline's noise: its
    `_next_key` hands out the keys a JAX pipeline with `seed` splits off
    (both packages take one at the same call sites), and each stage turns
    its key into the Gumbel draws the JAX stage makes from it."""
    cfg = pp.cfg
    M = cfg.match.max_matches
    state = {"key": jax.random.PRNGKey(seed)}

    def next_key():
        state["key"], k = jax.random.split(state["key"])
        return k

    def gumbel(key, shape):
        return _t(jax.random.gumbel(key, shape))

    def is_key(n):
        return isinstance(n, jax.Array)

    track_local, kf_track = pp._track_local, pp._kf_track
    bootstrap, chunk, reloc = (pp._bootstrap, pp._track_chunk_promo,
                               pp._reloc_probe)

    def boot_noise(key, A, H, n):
        ge, gh = [], []
        for k in jax.random.split(key, A):
            ke, kh = jax.random.split(k)
            ge.append(gumbel(ke, (H, n)))
            gh.append(gumbel(kh, (H, n)))
        return torch.stack(ge), torch.stack(gh)

    pp._next_key = next_key
    pp._track_local = lambda n, *a: track_local(
        gumbel(n, (cfg.tracking_ransac_hypotheses, M)) if is_key(n) else n,
        *a)
    pp._kf_track = lambda g, n, *a: kf_track(
        g, gumbel(n, (8, M)) if is_key(n) else n, *a)
    pp._bootstrap = lambda n, pa, pb, v: bootstrap(
        boot_noise(n, cfg.boot_attempts, cfg.ransac.num_hypotheses,
                   v.shape[0]), pa, pb, v)
    pp._track_chunk_promo = lambda n, *a: chunk(
        _chunk_noise(cfg, n, a[7].x.shape[0]), *a)
    pp._reloc_probe = lambda n, bank, *a: reloc(torch.stack([
        gumbel(k, (8, M)) for k in jax.random.split(
            n, cfg.reloc_candidates)[:bank.shape[0]]]), bank, *a)
    return pp


def _chunk_inputs(world, start, B):
    """Frames start..start+B-1 against a local map of the most salient
    landmarks and keyframe start-1 (landmarks on half its keypoints, by
    true identity), seeded with the true pose and velocity before."""
    from tests.test_torch_sfm_stages import _kf_inputs, _local_map
    desc, valid, lms = _local_map(world)
    kf = start - 1
    ka, _, _, _, has, lms_a, uv_a, _ = _kf_inputs(world, kf, kf + 1)
    pose_kf = np.asarray(world.poses[kf], np.float32)
    from sift_tpu.geometry import lie_np
    vel = lie_np.rel_pose(np.asarray(world.poses[kf - 1], np.float32),
                          pose_kf).astype(np.float32)
    kps = [world.frame_keypoints(i) for i in range(start, start + B)]
    return dict(pose0=pose_kf, vel0=vel, desc_ref=desc, valid_ref=valid,
                lms_ref=lms, kps=kps, pose_kf=pose_kf, ka=ka, lms_kf=lms_a,
                has=has, uv_kf=uv_a)


def _by_pair(buf, M):
    ia, ib = buf[:M].astype(int), buf[M:2 * M].astype(int)
    valid, inl = buf[2 * M:3 * M] > 0.5, buf[3 * M:4 * M]
    tri = buf[4 * M:8 * M].reshape(M, 4)
    return {(ia[k], ib[k]): (inl[k], tri[k]) for k in np.nonzero(valid)[0]}


@pytest.mark.parametrize("B,start,since0,nf,fired", [
    (4, 10, 3, 4, [12]),            # one slot, fires at frame 2
    (4, 10, 0, 4, [-1]),            # one slot, nothing qualifies
    (16, 6, 3, 16, [8, 14]),        # two slots
    (16, 20, 3, 12, [22, 28]),      # padded chunk: frames 12-15 not real
    (32, 6, 3, 32, [8, 14, 22, 30]),  # four 8-frame sub-chunks
])
def test_chunk_stage_matches_jax(world, pipes, B, start, since0, nf, fired):
    jp, pp = pipes
    cfg = jp.cfg
    M = cfg.match.max_matches
    d = _chunk_inputs(world, start, B)
    key = jax.random.PRNGKey(B + since0)
    want = [np.asarray(a) for a in jp._jit_track_chunk_promo(
        key, jnp.asarray(d["pose0"]), jnp.asarray(d["vel0"]),
        jnp.int32(since0), jnp.int32(nf), jnp.asarray(d["desc_ref"]),
        jnp.asarray(d["valid_ref"]), jnp.asarray(d["lms_ref"]),
        _stack_jax(d["kps"]), jnp.asarray(d["pose_kf"]), d["ka"].desc,
        d["ka"].valid, jnp.asarray(d["lms_kf"]), jnp.asarray(d["has"]),
        jnp.asarray(d["uv_kf"]))]
    got = [a.numpy() for a in pp._track_chunk_promo(
        _chunk_noise(jp.cfg, key, B), _t(d["pose0"]), _t(d["vel0"]), since0,
        nf,
        _t(d["desc_ref"]), _t(d["valid_ref"]), _t(d["lms_ref"]),
        _stack_port(d["kps"]), _t(d["pose_kf"]), _t(d["ka"].desc),
        _t(d["ka"].valid), _t(d["lms_kf"]), _t(d["has"]), _t(d["uv_kf"]))]
    P = max(1, B // 8)
    N = d["kps"][0].x.shape[0]
    assert len(got) == len(want) == 1 + 2 * P
    g, w = got[0], want[0]
    assert g.shape == w.shape == (B * 8 + P * (1 + 8 * M + 8 + 4 * N),)
    # Per frame: inlier counts exactly against the given local map; in
    # the sub-chunks that track against a promoted frame's triangulated
    # landmarks within one (TRI_RTOL above: the two packages' DLT points
    # are up to 2e-4 of their norm apart, a tenth of a pixel here, so a
    # residual at the inlier threshold can fall either side); poses within
    # TRACK_POSE.
    fg, fw = g[:B * 8].reshape(B, 8), w[:B * 8].reshape(B, 8)
    given = np.arange(B) < (8 if B > 16 else B)
    np.testing.assert_array_equal(fg[given, 6], fw[given, 6])
    assert np.abs(fg[~given, 6] - fw[~given, 6]).max(initial=0) <= 1
    assert (fw[:nf, 6] >= cfg.keyframe_min_inliers).all()
    np.testing.assert_allclose(fg[:, :6], fw[:, :6], atol=TRACK_POSE)
    same = fg[:, 6] == fw[:, 6]          # one flipped inlier moves the rmse
    np.testing.assert_allclose(fg[same, 7], fw[same, 7], atol=1e-3)
    np.testing.assert_allclose(fg[~same, 7], fw[~same, 7], atol=0.1)
    np.testing.assert_allclose(fg[:nf][given[:nf], :6],
                               np.stack(world.poses[start:start + nf])[
                                   given[:nf]], atol=0.01)
    # promote_at and the promoted frames' metadata exactly.
    pa = B * 8
    np.testing.assert_array_equal(g[pa:pa + P], w[pa:pa + P])
    assert [start + int(a) if a >= 0 else -1 for a in w[pa:pa + P]] == fired
    m0 = pa + P + P * (8 * M + 8)
    np.testing.assert_array_equal(g[m0:], w[m0:])
    for a, b in zip(got[1:], want[1:]):            # desc_p, valid_p
        np.testing.assert_array_equal(a, b)
    # Payloads: matches as sets with their flags, poses, points.
    for p in range(P):
        pg = g[pa + P + p * (8 * M + 8):pa + P + (p + 1) * (8 * M + 8)]
        pw = w[pa + P + p * (8 * M + 8):pa + P + (p + 1) * (8 * M + 8)]
        if fired[p] < 0:
            assert not pg.any() and not pw.any()
            continue
        bg, bw = _by_pair(pg, M), _by_pair(pw, M)
        assert set(bg) == set(bw) and len(bg) >= 100
        assert sorted(v[0] for v in bg.values()) == \
            sorted(v[0] for v in bw.values())
        assert pg[8 * M + 6] == pw[8 * M + 6] >= 50
        np.testing.assert_allclose(pg[8 * M:8 * M + 6], pw[8 * M:8 * M + 6],
                                   atol=TRACK_POSE)
        tri_g = np.stack([bg[k][1] for k in sorted(bw)])
        tri_w = np.stack([bw[k][1] for k in sorted(bw)])
        np.testing.assert_array_equal(tri_g[:, 3], tri_w[:, 3])
        ok = tri_w[:, 3] > 0.5
        scale = np.maximum(np.linalg.norm(tri_w[ok, :3], axis=1,
                                          keepdims=True), 1)
        np.testing.assert_allclose(tri_g[ok, :3] / scale,
                                   tri_w[ok, :3] / scale, atol=TRI_RTOL)


def test_chunk_stage_draws_from_the_generator(world, pipes):
    """On its own generator the stage draws every frame's and slot's
    noise at its start, in that fixed order: the same seed gives the same
    output, and the generator advances by exactly those draws."""
    _, pp = pipes
    d = _chunk_inputs(world, 10, 4)
    args = (_t(d["pose0"]), _t(d["vel0"]), 3, 4, _t(d["desc_ref"]),
            _t(d["valid_ref"]), _t(d["lms_ref"]), _stack_port(d["kps"]),
            _t(d["pose_kf"]), _t(d["ka"].desc), _t(d["ka"].valid),
            _t(d["lms_kf"]), _t(d["has"]), _t(d["uv_kf"]))
    outs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(5)
        outs.append(pp._track_chunk_promo(gen, *args)[0])
        after = torch.rand(3, generator=gen)
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    M = pp.cfg.match.max_matches
    ref = torch.Generator().manual_seed(5)
    torch.rand((4, pp.cfg.tracking_ransac_hypotheses, M), generator=ref)
    torch.rand((1, 8, M), generator=ref)
    torch.testing.assert_close(after, torch.rand(3, generator=ref), rtol=0,
                               atol=0)
    n_inl = outs[0][:32].reshape(4, 8)[:, 6]
    assert (n_inl >= pp.cfg.keyframe_min_inliers).all()
    assert outs[0][32].item() == 2           # since0 3: frame 2 promotes


# ------------------------------------------------------------ whole runs

def drive_chunked(pipe, kps, batch, stack, marker=np.full):
    """Frames as `process_sequence` feeds them (chunks at multiples of
    `batch`): a chunk in the tracking state goes to
    `_process_chunk_tracked`, and when that declines, or in bootstrap,
    frame by frame through `process_frame` (its injected frontend serves
    `kps`)."""
    n = len(kps)
    results = []
    for start in range(0, n, batch):
        idx = list(range(start, min(start + batch, n)))
        if pipe.state == "tracking":
            chunk = [kps[i] for i in idx] + [kps[idx[-1]]] * (
                batch - len(idx))
            if pipe._process_chunk_tracked(stack(chunk), len(idx), results):
                continue
        for i in idx:
            results.append(pipe.process_frame(marker((2, 2), i, np.float32)))
    pipe.finalize()
    return results


def whole_runs(world, batch, **overrides):
    jcfg = _pipeline(world).cfg.replace(chunked_tracking=True, **overrides)
    n = len(world.poses)
    kps = [world.frame_keypoints(i) for i in range(n)]
    jp = JaxSfmPipeline(INTR, jcfg, frontend=lambda g: kps[int(g[0, 0])])
    drive_chunked(jp, kps, batch, _stack_jax)
    pf = port_frames(dict(enumerate(kps)))
    pp = feed_jax_noise(SfmPipeline(
        INTR, config_from_dict(dataclasses.asdict(jcfg)),
        frontend=lambda g: pf[int(g[0, 0])], device="cpu"))
    drive_chunked(pp, kps, batch, _stack_port)
    return jp, pp


# Slow (two 40-frame runs of both packages, 1.5-2 minutes a case on a
# loaded CPU): out of tier-1. The chunk stage is held to JAX by
# test_chunk_stage_matches_jax here; whole chunked runs on the card to the
# JAX run's bounds by chip_smoke.py phase 11.
@pytest.mark.slow
@pytest.mark.parametrize("batch", [8, 16])
def test_chunked_run_matches_jax(world, batch):
    """A 40-frame chunked run, the port drawing JAX's noise
    (`feed_jax_noise`): keyframes at JAX's frames, equal chunk_stats (at
    B = 16 some chunk promotes twice), positions within POS_TOL of JAX's
    after alignment and within the e2e bound of the truth."""
    jp, pp = whole_runs(world, batch)
    kf = [[r["frame_idx"] for r in p.trajectory if r["is_keyframe"]]
          for p in (jp, pp)]
    assert kf[1] == kf[0]
    assert pp.chunk_stats == jp.chunk_stats
    assert jp.chunk_stats["chunks"] >= (3 if batch == 8 else 2)
    if batch == 16:
        assert jp.chunk_stats["fused_promotions"] > jp.chunk_stats["chunks"]
    est, ref = pp.positions(), jp.positions()
    assert est.shape == ref.shape == (40, 3)
    assert ate_rmse(est, ref, align=True, with_scale=True) < POS_TOL
    assert ate_rmse(est, world.positions, align=True, with_scale=True) < 0.1
    assert all(r["tracked"] for r in pp.trajectory[2:])
