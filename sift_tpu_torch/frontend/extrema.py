"""Scale-space extrema detection with a per-octave cap (counterpart of
`sift_tpu/frontend/extrema.py`, lowe mode, exact selection).

Strict 26-neighbour test plus a DoG contrast pre-threshold over the
interior levels and pixels; candidates are ranked by |DoG| and the
strongest `cfg.octave_cap(o)` kept. Ties keep the lower flat index first,
as `lax.top_k` does: a stable descending sort, then a slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sift_tpu_torch.config import SiftConfig


def _window_extreme(x: torch.Tensor, is_max: bool) -> torch.Tensor:
    """3x3 windowed max/min of a (..., H, W) map (outside reads -/+inf)."""
    op = torch.maximum if is_max else torch.minimum
    init = float("-inf") if is_max else float("inf")
    xp = F.pad(x, (1, 1, 1, 1), value=init)
    h, w = x.shape[-2], x.shape[-1]
    out = None
    for dy in range(3):
        for dx in range(3):
            s = xp[..., dy:dy + h, dx:dx + w]
            out = s if out is None else op(out, s)
    return out


def top_k_stable(x: torch.Tensor, k: int):
    """Largest k along the last axis, lower index first among ties."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def detect_extrema_octave(dogs: torch.Tensor, cfg: SiftConfig, octave: int = 0):
    """dogs: (B, L, H, W). Returns (x, y, level, score, valid), each (B, K)
    with K = cfg.octave_cap(octave), and n_pruned (B,) int32: candidates
    beyond the cap."""
    if cfg.mode != "lowe":
        raise NotImplementedError("parity mode is not ported")
    if cfg.extrema_topk != "exact":
        raise NotImplementedError('extrema_topk="approx" is not ported')
    B, L, H, W = dogs.shape
    K = cfg.octave_cap(octave)
    wmax = _window_extreme(dogs, is_max=True)
    wmin = _window_extreme(dogs, is_max=False)
    interior = torch.zeros((H, W), dtype=torch.bool, device=dogs.device)
    interior[1:-1, 1:-1] = True
    thresh = 0.5 * cfg.contrast_threshold * cfg.image_max / max(L - 2, 1)

    masks, scores = [], []
    for i in range(1, L - 1):
        c = dogs[:, i]
        # own 3x3 window includes the centre: "max <= centre" is the
        # non-strict own-level test; adjacent levels are strict.
        is_max = ((wmax[:, i] <= c) & (wmax[:, i - 1] < c)
                  & (wmax[:, i + 1] < c) & (c > thresh))
        is_min = ((wmin[:, i] >= c) & (wmin[:, i - 1] > c)
                  & (wmin[:, i + 1] > c) & (c < -thresh))
        masks.append((is_max | is_min) & interior)
        scores.append(c.abs())

    mask = torch.stack(masks, dim=1)                          # (B, L-2, H, W)
    flat_score = torch.where(mask, torch.stack(scores, dim=1),
                             -1.0).reshape(B, -1)
    k_eff = min(K, flat_score.shape[1])
    top_scores, top_idx = top_k_stable(flat_score, k_eff)
    if k_eff < K:
        top_scores = F.pad(top_scores, (0, K - k_eff), value=-1.0)
        top_idx = F.pad(top_idx, (0, K - k_eff))
    valid = top_scores >= 0.0
    n_cand = mask.reshape(B, -1).sum(dim=1)
    n_pruned = (n_cand - valid.sum(dim=1)).clamp_min(0).to(torch.int32)

    lvl = top_idx // (H * W) + 1
    rem = top_idx % (H * W)
    return ((rem % W).to(torch.float32), (rem // W).to(torch.float32),
            lvl.to(torch.int32), top_scores, valid, n_pruned)
