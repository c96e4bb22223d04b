"""Plain PyTorch reference of two-image descriptor matching.

The dense squared-L2 distance matrix |a|^2 + |b|^2 - 2 a.b^T in float32
(one product, TF32 off; `tf32_products` rounds its operands to TF32
instead), invalid rows and columns pushed to 1e30, the first-occurrence
best and second per row, Lowe's ratio test on squared distances, the
mutual check against each column's first best, and the accepted rows
compacted smallest distance first into `max_matches` slots.
"""

from __future__ import annotations

import torch

from portbench.reference.sift_lowe import EXACT, Precision, tf32, top_k_stable

BIG = 1e30


def distances(desc_a: torch.Tensor, desc_b: torch.Tensor,
              prec: Precision = EXACT) -> torch.Tensor:
    """(Na, Nb) squared L2 distances, clamped at 0."""
    a, b = desc_a.to(torch.float32), desc_b.to(torch.float32)
    a2 = (a * a).sum(dim=-1, keepdim=True)
    b2 = (b * b).sum(dim=-1, keepdim=True).T
    if prec.tf32_products:
        a, b = tf32(a), tf32(b)
    return torch.clamp_min(a2 + b2 - 2.0 * (a @ b.T), 0.0)


def match(desc_a, valid_a, desc_b, valid_b, cfg: dict,
          prec: Precision = EXACT) -> dict:
    """Matches of `cfg` (MatchConfig fields; metric "l2"): a dict of
    (M,) tensors idx_a, idx_b (int64), distance, valid."""
    if cfg.get("metric", "l2") != "l2":
        raise ValueError("the reference matches on the l2 metric")
    d = distances(desc_a, desc_b, prec)
    d = torch.where(valid_b[None, :], d, BIG)
    d = torch.where(valid_a[:, None], d, BIG)
    best_idx = torch.argmin(d, dim=1)
    best = d.gather(1, best_idx[:, None])[:, 0]
    second = d.scatter(1, best_idx[:, None], (best + BIG)[:, None]).amin(dim=1)
    ok = (best < cfg["ratio"] ** 2 * second) & valid_a & (best < BIG)
    if cfg["mutual"]:
        back = torch.argmin(d, dim=0)
        ok &= back[best_idx] == torch.arange(d.shape[0], device=d.device)
    m = cfg["max_matches"]
    score = torch.where(ok, -best, -BIG)
    k = min(m, score.shape[0])
    top, idx_a = top_k_stable(score, k)
    valid = top > -BIG
    if k < m:
        pad = m - k
        idx_a = torch.nn.functional.pad(idx_a, (0, pad))
        top = torch.nn.functional.pad(top, (0, pad), value=-BIG)
        valid = torch.nn.functional.pad(valid, (0, pad))
    return dict(idx_a=idx_a, idx_b=best_idx[idx_a],
                distance=torch.where(valid, -top, BIG), valid=valid)
