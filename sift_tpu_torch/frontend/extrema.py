"""Scale-space extrema detection with a per-octave cap (counterpart of
`sift_tpu/frontend/extrema.py`, exact selection).

lowe: strict 26-neighbour test plus a DoG contrast pre-threshold over the
interior levels and pixels, ranked by |DoG|, the strongest
`cfg.octave_cap(o)` kept.

parity: the reference's end-exclusive `subarray(x-1, y-1 -> x+1, y+1)`
makes each neighbourhood the 2x2 up-left quadrant ending at the pixel, on
the three levels, and the test allows ties; candidates are ranked by
|DoG - 128| and the flat `cfg.max_keypoints_per_octave` kept.

Ties keep the lower flat index first, as `lax.top_k` does: a stable
descending sort, then a slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sift_tpu_torch.config import SiftConfig
from sift_tpu_torch.frontend.pyramid import Pyramid
from sift_tpu_torch.utils.device import constant


def _window_extreme(x: torch.Tensor, is_max: bool,
                    quadrant: bool = False) -> torch.Tensor:
    """Windowed max/min of a (..., H, W) map (outside reads -/+inf): the
    3x3 window centred on the pixel, or with `quadrant` the 2x2 window
    ending at it."""
    op = torch.maximum if is_max else torch.minimum
    init = float("-inf") if is_max else float("inf")
    xp = F.pad(x, (1, 1, 1, 1), value=init)
    h, w = x.shape[-2], x.shape[-1]
    offs = [(0, 0), (0, 1), (1, 0), (1, 1)] if quadrant else \
        [(dy, dx) for dy in range(3) for dx in range(3)]
    out = None
    for dy, dx in offs:
        s = xp[..., dy:dy + h, dx:dx + w]
        out = s if out is None else op(out, s)
    return out


def top_k_stable(x: torch.Tensor, k: int):
    """Largest k along the last axis, lower index first among ties."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def detect_extrema_octave(dogs: torch.Tensor, cfg: SiftConfig, octave: int = 0):
    """dogs: (B, L, H, W). Returns (x, y, level, score, valid), each (B, K)
    with K = cfg.octave_cap(octave) (parity: cfg.max_keypoints_per_octave),
    and n_pruned (B,) int32: candidates beyond the cap. The selection is
    the exact top-K under either `extrema_topk`: the JAX package's "approx"
    (`lax.approx_max_k`) is a TPU partial sort and computes the exact top-K
    everywhere else."""
    parity = cfg.mode == "parity"
    B, L, H, W = dogs.shape
    K = cfg.max_keypoints_per_octave if parity else cfg.octave_cap(octave)
    wmax = _window_extreme(dogs, is_max=True, quadrant=parity)
    wmin = _window_extreme(dogs, is_max=False, quadrant=parity)
    interior = torch.zeros((H, W), dtype=torch.bool, device=dogs.device)
    interior[1:-1, 1:-1] = True
    thresh = 0.5 * cfg.contrast_threshold * cfg.image_max / max(L - 2, 1)

    masks, scores = [], []
    for i in range(1, L - 1):
        c = dogs[:, i]
        if parity:
            # the centre lies in its own quadrant: ties allowed throughout
            is_max = ((wmax[:, i] <= c) & (wmax[:, i - 1] <= c)
                      & (wmax[:, i + 1] <= c))
            is_min = ((wmin[:, i] >= c) & (wmin[:, i - 1] >= c)
                      & (wmin[:, i + 1] >= c))
            scores.append((c - 128.0).abs())
        else:
            # own 3x3 window includes the centre: "max <= centre" is the
            # non-strict own-level test; adjacent levels are strict.
            is_max = ((wmax[:, i] <= c) & (wmax[:, i - 1] < c)
                      & (wmax[:, i + 1] < c) & (c > thresh))
            is_min = ((wmin[:, i] >= c) & (wmin[:, i - 1] > c)
                      & (wmin[:, i + 1] > c) & (c < -thresh))
            scores.append(c.abs())
        masks.append((is_max | is_min) & interior)

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


def detect_extrema(pyr: Pyramid, cfg: SiftConfig) -> dict:
    """`detect_extrema_octave` over every octave of a `Pyramid`, the
    buffers concatenated: a dict of (B, octaves * K) tensors x, y, octave,
    level, scale (the recorded DoG sigma of the keypoint's level), score,
    valid, and n_dropped (B,) int32, the candidates beyond the caps summed
    over the octaves."""
    fields = {f: [] for f in ("x", "y", "octave", "level", "scale", "score",
                              "valid")}
    dropped = None
    for o in range(pyr.num_octaves):
        x, y, lvl, score, valid, n_drop = detect_extrema_octave(
            pyr.dogs[o], cfg, o)
        table = constant(pyr.dog_sigmas[o], lvl.device)
        for f, v in (("x", x), ("y", y), ("octave", torch.full_like(lvl, o)),
                     ("level", lvl), ("scale", table[lvl]), ("score", score),
                     ("valid", valid)):
            fields[f].append(v)
        dropped = n_drop if dropped is None else dropped + n_drop
    out = {f: torch.cat(v, dim=1) for f, v in fields.items()}
    out["n_dropped"] = dropped
    return out
