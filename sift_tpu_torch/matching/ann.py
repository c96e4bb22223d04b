"""Approximate nearest-neighbour matching: IVF-Flat (counterpart of
`sift_tpu/matching/ann.py`).

An inverted-file index over one database descriptor set, for databases
past what one all-pairs pass holds. `MatchConfig.impl="auto"` never
routes here; the exact matcher (`matcher.py`) stays the default.

- **Build**: masked k-means whose steps are both f32 matrix products
  (assignment = a distance product + first-occurrence argmin; update = a
  one-hot (C, N) x (N, D) segment sum), then a sort-based inversion into
  a fixed-capacity (C, cap) bucket table with a validity mask. Overflow is
  counted in `n_overflow`, never silent.
- **Search**: each query probes its `nprobe` nearest centroids; a probe
  scores the query against that bucket's candidates and merges the
  per-probe top-2 into a running one. Queries run `query_tile` rows at a
  time, so the peak working set is one (tile, cap, D) gather. Every loop
  has a fixed count and no host sync.
- **Mutual check**: exact on the candidates; each accepted database row
  is scored against all queries.

`nprobe == n_clusters` degenerates to exact brute force. The JAX package
draws the k-means initialization from `jax.random.uniform(PRNGKey(0))`;
the port takes `noise`: that (N,) uniform tensor itself, or a
`torch.Generator` from which it draws its own.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from sift_tpu_torch.config import AnnConfig, MatchConfig
from sift_tpu_torch.frontend.extrema import top_k_stable
from sift_tpu_torch.matching.matcher import (_BIG, _compact, _top2_min,
                                             pairwise_sqdist)
from sift_tpu_torch.types import Matches
from sift_tpu_torch.utils.device import check_f32_matmul

Noise = Union[torch.Tensor, torch.Generator]


@dataclasses.dataclass
class IvfIndex:
    """Inverted-file index over one database descriptor set.

    centroids:    (C, D) float32 k-means centroids.
    bucket_ids:   (C, cap) int32 database row ids per cluster (padded 0).
    bucket_valid: (C, cap) bool.
    bucket_desc:  (C, cap, D) float32 descriptors copied into bucket
                  layout, so a probe gathers along the first axis only.
    desc:         (N, D) float32 the caller's database buffer (no copy),
                  read by the mutual check.
    n_overflow:   () int32 database points dropped because their cluster's
                  bucket was full.
    """

    centroids: torch.Tensor
    bucket_ids: torch.Tensor
    bucket_valid: torch.Tensor
    bucket_desc: torch.Tensor
    desc: torch.Tensor
    n_overflow: torch.Tensor


def ivf_index_from_numpy(fields, device="cuda") -> IvfIndex:
    """An `IvfIndex` from another package's index: `fields` has the six
    fields as attributes or keys (numpy arrays, e.g. a JAX-built index's
    leaves), placed on `device` with the port's dtypes."""
    def get(name):
        return fields[name] if isinstance(fields, dict) else getattr(fields, name)

    dtypes = {"centroids": torch.float32, "bucket_ids": torch.int32,
              "bucket_valid": torch.bool, "bucket_desc": torch.float32,
              "desc": torch.float32, "n_overflow": torch.int32}
    return IvfIndex(**{
        name: torch.from_numpy(np.array(get(name))).to(device=device,
                                                       dtype=dtype)
        for name, dtype in dtypes.items()})


def _uniform(noise: Noise, n: int, device) -> torch.Tensor:
    if isinstance(noise, torch.Generator):
        noise = torch.rand((n,), generator=noise, device=noise.device)
    if noise.shape != (n,):
        raise ValueError(f"noise shape {tuple(noise.shape)} != {(n,)}")
    return noise.to(device=device, dtype=torch.float32)


def _kmeans(desc: torch.Tensor, valid: torch.Tensor, c: int, iters: int,
            noise: Noise) -> torch.Tensor:
    """Masked k-means; returns (C, D) centroids.

    Init: a random valid subset (the top C of uniform keys, invalid rows
    pushed down by 2). Where fewer than C rows are valid, the surplus
    slots seed from the first valid row, so padding contents never reach
    a centroid. Empty clusters keep their previous centroid."""
    check_f32_matmul(desc, "IVF k-means")
    n = desc.shape[0]
    keys = _uniform(noise, n, desc.device) + torch.where(valid, 0.0, -2.0)
    _, init_idx = top_k_stable(keys, c)
    first_valid = desc[torch.argmax(valid.to(torch.int32))]
    desc_init = torch.where(valid[:, None], desc, first_valid[None, :])
    cent = desc_init[init_idx]

    big = torch.where(valid, 0.0, _BIG)[:, None]
    validf = valid[:, None].to(torch.float32)
    for _ in range(iters):
        assign = torch.argmin(pairwise_sqdist(desc, cent) + big, dim=-1)
        one_hot = F.one_hot(assign, c).to(torch.float32) * validf
        sums = one_hot.T @ desc                                # (C, D)
        counts = one_hot.sum(dim=0)                            # (C,)
        new = sums / torch.clamp_min(counts[:, None], 1.0)
        cent = torch.where(counts[:, None] > 0, new, cent)
    return cent


def build_ivf(desc: torch.Tensor, valid: torch.Tensor, cfg: AnnConfig,
              noise: Optional[Noise] = None) -> IvfIndex:
    """Build an IVF-Flat index over a masked (N, D) descriptor buffer, on
    the buffer's device. `noise` seeds the k-means init (default: a
    generator seeded with 0 on that device, so builds are deterministic)."""
    if noise is None:
        noise = torch.Generator(device=desc.device).manual_seed(0)
    desc = desc.to(torch.float32)
    n, dev = desc.shape[0], desc.device
    c, cap = cfg.n_clusters, cfg.bucket_capacity
    cent = _kmeans(desc, valid, c, cfg.kmeans_iters, noise)

    assign = torch.argmin(pairwise_sqdist(desc, cent), dim=-1)
    assign = torch.where(valid, assign, c)       # invalid rows -> ghost bucket

    # Sort-based inversion: a stable sort by cluster; a row's slot in its
    # cluster is its sorted position less the cluster's start.
    sorted_assign, order = torch.sort(assign, stable=True)
    starts = torch.searchsorted(sorted_assign,
                                torch.arange(c + 1, device=dev))
    slot = torch.arange(n, device=dev) - starts[sorted_assign]
    in_cap = (slot < cap) & (sorted_assign < c)
    n_overflow = ((~in_cap) & (sorted_assign < c)).sum().to(torch.int32)

    # Rows past capacity and ghost rows each get a scratch cell of their
    # own past the table, so every written index is unique (a deterministic
    # scatter); the scratch cells are sliced off.
    flat = torch.where(in_cap, sorted_assign * cap + slot,
                       c * cap + torch.arange(n, device=dev))
    bucket_ids = torch.zeros(c * cap + n, dtype=torch.int32, device=dev)
    bucket_ids[flat] = order.to(torch.int32)
    bucket_valid = torch.zeros(c * cap + n, dtype=torch.bool, device=dev)
    bucket_valid[flat] = in_cap
    bucket_ids = bucket_ids[:c * cap].reshape(c, cap)
    bucket_valid = bucket_valid[:c * cap].reshape(c, cap)
    return IvfIndex(centroids=cent, bucket_ids=bucket_ids,
                    bucket_valid=bucket_valid,
                    bucket_desc=desc[bucket_ids.long()], desc=desc,
                    n_overflow=n_overflow)


def _merge_top2(a, b):
    """Merge two per-row (best, second, idx) triples over disjoint
    candidate sets: the merged second is min(s_a, s_b, max(b_a, b_b))."""
    ba, sa, ia = a
    bb, sb, ib = b
    best = torch.minimum(ba, bb)
    second = torch.minimum(torch.minimum(sa, sb), torch.maximum(ba, bb))
    return best, second, torch.where(ba <= bb, ia, ib)


def _search_tile(index: IvfIndex, dq: torch.Tensor, vq: torch.Tensor,
                 nprobe: int):
    cdist = pairwise_sqdist(dq, index.centroids)             # (T, C)
    _, probe = top_k_stable(-cdist, nprobe)                  # (T, nprobe)
    q2 = (dq * dq).sum(dim=-1)[:, None]                      # (T, 1)
    t = dq.shape[0]
    out = (torch.full((t,), _BIG, device=dq.device),
           torch.full((t,), _BIG, device=dq.device),
           torch.zeros((t,), dtype=torch.int32, device=dq.device))
    for j in range(nprobe):
        p = probe[:, j]
        ids = index.bucket_ids[p]                            # (T, cap)
        cand = index.bucket_desc[p]                          # (T, cap, D)
        c2 = (cand * cand).sum(dim=-1)
        qc = torch.bmm(cand, dq[:, :, None])[..., 0]         # (T, cap)
        dist = torch.clamp_min(q2 + c2 - 2.0 * qc, 0.0)
        dist = torch.where(index.bucket_valid[p], dist, _BIG)
        best, second, pos = _top2_min(dist)
        idx = ids.gather(-1, pos[:, None])[:, 0]
        out = _merge_top2(out, (best, second, idx))
    best, second, idx = out
    return (torch.where(vq, best, _BIG), torch.where(vq, second, _BIG), idx)


def search_ivf(index: IvfIndex, desc_q: torch.Tensor, valid_q: torch.Tensor,
               cfg: AnnConfig):
    """Per-query (best, second, best_idx) squared-L2 distances over the
    probed candidates, as `matcher.top2_masked`: invalid queries and empty
    candidate sets saturate to ~1e30. desc_q: (Q, D); valid_q: (Q,)."""
    check_f32_matmul(desc_q, "IVF search")
    nprobe = min(cfg.nprobe, index.centroids.shape[0])
    desc_q = desc_q.to(torch.float32)
    q = desc_q.shape[0]
    tile = min(cfg.query_tile, q)
    if q <= tile:
        return _search_tile(index, desc_q, valid_q, nprobe)
    pad = (-q) % tile
    dq = F.pad(desc_q, (0, 0, 0, pad))
    vq = F.pad(valid_q, (0, pad))
    parts = [_search_tile(index, dq[s:s + tile], vq[s:s + tile], nprobe)
             for s in range(0, q + pad, tile)]
    return tuple(torch.cat(f)[:q] for f in zip(*parts))


def match_descriptors_ann(desc_q: torch.Tensor, valid_q: torch.Tensor,
                          index: IvfIndex, cfg: MatchConfig,
                          ann: AnnConfig) -> Matches:
    """ANN counterpart of `match_descriptors`: ratio test, exact-on-candidate
    mutual check and capacity-M compaction over the probed candidates.
    idx_a indexes the query buffer, idx_b the index's database buffer."""
    if cfg.metric != "l2":
        raise ValueError(f"IVF search computes squared L2 only, got "
                         f"metric={cfg.metric!r} (normalize descriptors "
                         "upstream for cosine semantics)")
    best, second, best_idx = search_ivf(index, desc_q, valid_q, ann)
    ok = best < (cfg.ratio * cfg.ratio) * second
    ok &= valid_q & (best < _BIG)
    if cfg.mutual:
        # A database row matched by several queries keeps only its nearest.
        matched = index.desc[best_idx.long()]                 # (Q, D)
        back = pairwise_sqdist(matched, desc_q.to(torch.float32))
        back = torch.where(valid_q[None, :], back, _BIG)
        rows = torch.arange(desc_q.shape[0], device=desc_q.device)
        ok &= torch.argmin(back, dim=-1) == rows
    return _compact(ok, best, best_idx, cfg.max_matches)
