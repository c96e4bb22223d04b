"""Data-parallel descriptor matching over a process mesh (counterpart of
`sift_tpu/dist/matching_dist.py`).

Two regimes:

- `match_pairs_sharded`: matching image pairs is embarrassingly parallel.
  Each rank matches its P / world pairs and one all-gather gives every rank
  the `Matches` of all P.
- `match_large_sharded`: one large problem (place recognition, offline
  matching) split over the mesh. Query rows are sharded, the database is
  replicated, and each rank runs the impl-dispatched local top-2
  (`matcher.top2_masked`: the streaming kernel on the card above 4096^2
  pairs). The mutual-nearest check crosses ranks by a two-step min
  all-reduce. Each rank's memory and operations drop n-fold; the only
  collectives are over (Nb,) and (Na,) vectors.
"""

from __future__ import annotations

import torch

from sift_tpu_torch.config import MatchConfig
from sift_tpu_torch.dist.mesh import (all_gather_tiled, mesh_device,
                                      mesh_group, mesh_index, pmin,
                                      shard_rows, to_device)
from sift_tpu_torch.matching.matcher import (_BIG, _compact,
                                             match_descriptors, top2_masked)
from sift_tpu_torch.types import Matches


def _gather_matches(m: Matches, group) -> Matches:
    return Matches(**{f: all_gather_tiled(getattr(m, f), group)
                      for f in ("idx_a", "idx_b", "distance", "valid")})


def match_pairs_sharded(mesh, desc_a, valid_a, desc_b, valid_b,
                        cfg: MatchConfig) -> Matches:
    """Match P descriptor-set pairs across the mesh.

    desc_a/desc_b: (P, N, D); valid_a/valid_b: (P, N), the same whole
    arrays on every rank. P must divide by the mesh's process count.
    Returns a `Matches` with leading axis P on every rank."""
    n = mesh.mesh.numel()
    if desc_a.shape[0] % n != 0:
        raise ValueError(f"P={desc_a.shape[0]} must divide by the process "
                         f"count {n}")
    dev, i = mesh_device(mesh), mesh_index(mesh)
    da, va, db, vb = (shard_rows(x, i, n, dev)
                      for x in (desc_a, valid_a, desc_b, valid_b))
    per_pair = [match_descriptors(da[p], va[p], db[p], vb[p], cfg)
                for p in range(da.shape[0])]
    local = Matches(**{f: torch.stack([getattr(m, f) for m in per_pair])
                       for f in ("idx_a", "idx_b", "distance", "valid")})
    return _gather_matches(local, mesh_group(mesh))


def match_large_sharded(mesh, desc_a, valid_a, desc_b, valid_b,
                        cfg: MatchConfig) -> Matches:
    """One (Na, D) x (Nb, D) matching problem split over the mesh.

    Query rows are split over every mesh axis (Na must divide by the
    process count); the database is replicated. The same result as
    `match_descriptors` (ratio, mutual, capacity-M compaction), replicated
    on every rank."""
    if cfg.metric == "l2q8":
        raise ValueError("l2q8's per-tensor quantization scale is "
                         "shard-local here, which breaks mesh-shape "
                         "invariance: use metric='l2' for the distributed "
                         "matcher")
    n = mesh.mesh.numel()
    Na = desc_a.shape[0]
    if Na % n != 0:
        raise ValueError(f"Na={Na} must divide device count {n}")
    dev, idx, group = mesh_device(mesh), mesh_index(mesh), mesh_group(mesh)
    da, va = (shard_rows(x, idx, n, dev) for x in (desc_a, valid_a))
    db, vb = to_device(desc_b, dev), to_device(valid_b, dev)
    local_na = Na // n
    offset = idx * local_na

    # Local rows against the whole database: independent per rank.
    best, second, arg_b = top2_masked(da, va, db, vb, cfg)
    arg_b = arg_b.to(torch.int32)
    ok = best < (cfg.ratio * cfg.ratio) * second
    ok &= va & (best < _BIG)

    if cfg.mutual:
        # Reverse direction: each database row's best over the local
        # query rows, then a cross-rank (min, argmin). Ties pick the
        # lowest global row, argmin's first occurrence.
        bb, _, bb_arg = top2_masked(db, vb, da, va, cfg)
        bb_garg = bb_arg.to(torch.int32) + offset
        gmin = pmin(bb.clone(), group)
        garg = pmin(torch.where(bb <= gmin, bb_garg, 2**31 - 1)
                    .to(torch.int32), group)
        grow = offset + torch.arange(local_na, dtype=torch.int32, device=dev)
        ok &= garg[arg_b.long()] == grow

    # Small (Na,) gathers; the compaction is the same on every rank.
    return _compact(all_gather_tiled(ok, group), all_gather_tiled(best, group),
                    all_gather_tiled(arg_b, group), cfg.max_matches)
