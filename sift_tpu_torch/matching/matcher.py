"""Brute-force descriptor matching (counterpart of
`sift_tpu/matching/matcher.py`).

All-pairs distances under `MatchConfig.metric`, masked top-2 per row for
Lowe's ratio test, an optional mutual-nearest check, and compaction to a
fixed-capacity `Matches` buffer sorted by distance. Invalid rows and
columns are pushed out of every reduction by +1e30 distances, not by
gathering, so every shape is fixed.

Two formulations of the top-2, chosen by `MatchConfig.impl`
(`_use_streaming`): the dense one builds the (Na, Nb) distance matrix with
one f32 `torch.matmul` (TF32 off, as the JAX package computes it outside
any kernel); the streaming one calls `kernels/cuda/match.py::
streaming_top2`, the hand kernel on the card (its plain version on the
CPU), and runs it a second time with the sides swapped for the mutual
check. Ties keep the lower index first throughout: first-occurrence
argmins, and a stable descending sort for the compaction (`lax.top_k`).
"""

from __future__ import annotations

import torch

from sift_tpu_torch.config import MatchConfig
from sift_tpu_torch.frontend.extrema import top_k_stable
from sift_tpu_torch.kernels.cuda import match as match_kernel
from sift_tpu_torch.types import Keypoints, Matches

_BIG = 1e30
_STREAMING_MIN_PAIRS = 4096 * 4096


def _check_f32_matmul(x: torch.Tensor) -> None:
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("matching needs full f32 products: "
                           "torch.backends.cuda.matmul.allow_tf32 is on")


def pairwise_sqdist(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances (Na, Nb) = |a|^2 + |b|^2 - 2 a.b^T, clamped at 0."""
    _check_f32_matmul(desc_a)
    a2 = (desc_a * desc_a).sum(dim=-1, keepdim=True)             # (Na, 1)
    b2 = (desc_b * desc_b).sum(dim=-1, keepdim=True).T           # (1, Nb)
    ab = desc_a @ desc_b.T
    return torch.clamp_min(a2 + b2 - 2.0 * ab, 0.0)


def _quantize_int8(desc: torch.Tensor):
    """Symmetric per-tensor int8 quantization: returns (q, scale), q as
    int8-valued float32 (exact, and the cross term of 128 such products
    stays below 2^24, so an f32 product of them is exact too).

    Callers zero invalid rows first (`_mask_rows`): the scale is a max over
    the whole buffer, so padding contents must not reach it."""
    amax = torch.clamp_min(desc.abs().max(), 1e-12)
    scale = amax / 127.0
    q = torch.clamp(torch.round(desc / scale), -127, 127)
    return q, scale


def _mask_rows(desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Zero invalid descriptor rows."""
    return torch.where(valid[:, None], desc, 0.0)


def _unit(desc: torch.Tensor) -> torch.Tensor:
    norm = torch.linalg.vector_norm(desc, dim=-1, keepdim=True)
    return desc / torch.clamp_min(norm, 1e-12)


def _distances(desc_a: torch.Tensor, desc_b: torch.Tensor,
               metric: str) -> torch.Tensor:
    """All-pairs distance matrix under `MatchConfig.metric`.

    "l2":   squared Euclidean distance on raw descriptors.
    "dot":  cosine distance 2 - 2 a.b / (|a||b|) (squared L2 on the unit
            sphere, so the ratio test keeps its meaning).
    "l2q8": squared L2 from int8-quantized descriptors.
    """
    if metric == "l2q8":
        _check_f32_matmul(desc_a)
        qa, sa = _quantize_int8(desc_a)
        qb, sb = _quantize_int8(desc_b)
        ab = (qa @ qb.T) * (sa * sb)
        a2 = ((qa * sa) ** 2).sum(dim=-1, keepdim=True)
        b2 = ((qb * sb) ** 2).sum(dim=-1, keepdim=True).T
        return torch.clamp_min(a2 + b2 - 2.0 * ab, 0.0)
    if metric == "dot":
        _check_f32_matmul(desc_a)
        ab = _unit(desc_a) @ _unit(desc_b).T
        return torch.clamp_min(2.0 - 2.0 * ab, 0.0)
    if metric != "l2":
        raise ValueError(f"unknown match metric {metric!r}")
    return pairwise_sqdist(desc_a, desc_b)


def _masked_distances(desc_a, valid_a, desc_b, valid_b, metric: str):
    if metric == "l2q8":
        desc_a = _mask_rows(desc_a, valid_a)
        desc_b = _mask_rows(desc_b, valid_b)
    d = _distances(desc_a, desc_b, metric)
    d = torch.where(valid_b[None, :], d, _BIG)
    return torch.where(valid_a[:, None], d, _BIG)


def _top2_min(d: torch.Tensor):
    """Per-row (best, second) minimum distances and first best index; the
    second adds BIG at the best index, as the JAX one-hot does."""
    best_idx = torch.argmin(d, dim=-1)
    best = d.gather(-1, best_idx[..., None])[..., 0]
    second = d.scatter(-1, best_idx[..., None], (best + _BIG)[..., None])
    return best, second.amin(dim=-1), best_idx


def _compact(ok: torch.Tensor, best: torch.Tensor, best_idx: torch.Tensor,
             m: int) -> Matches:
    """Compact accepted rows to fixed capacity m, smallest distance first."""
    score = torch.where(ok, -best, -_BIG)
    k = min(m, score.shape[0])
    top_scores, idx_a = top_k_stable(score, k)
    valid = top_scores > -_BIG
    if k < m:
        pad = m - k
        idx_a = torch.nn.functional.pad(idx_a, (0, pad))
        top_scores = torch.nn.functional.pad(top_scores, (0, pad), value=-_BIG)
        valid = torch.nn.functional.pad(valid, (0, pad))
    return Matches(
        idx_a=idx_a.to(torch.int32),
        idx_b=best_idx.long()[idx_a].to(torch.int32),
        distance=torch.where(valid, -top_scores, _BIG),
        valid=valid,
    )


def _use_streaming(cfg: MatchConfig, desc_a: torch.Tensor, nb: int) -> bool:
    """Resolve MatchConfig.impl: "auto" takes the streaming kernel for CUDA
    tensors above 4096^2 pairs (on the CPU it stays dense, as the JAX
    package does off the TPU); "pallas" forces the streaming formulation;
    both need D % 128 == 0 and a metric other than "l2q8"."""
    na, d = desc_a.shape
    if cfg.impl not in ("auto", "xla", "pallas"):
        raise ValueError(f"unknown match impl {cfg.impl!r}")
    if cfg.impl == "xla" or d % 128 != 0 or cfg.metric == "l2q8":
        return False
    if cfg.impl == "pallas":
        return True
    return desc_a.is_cuda and na * nb > _STREAMING_MIN_PAIRS


def _streaming_inputs(desc_a, desc_b, metric: str):
    if metric == "dot":
        return _unit(desc_a).contiguous(), _unit(desc_b).contiguous()
    if metric != "l2":
        raise ValueError(f"unknown match metric {metric!r}")
    return (desc_a.to(torch.float32).contiguous(),
            desc_b.to(torch.float32).contiguous())


def top2_masked(desc_a: torch.Tensor, valid_a: torch.Tensor,
                desc_b: torch.Tensor, valid_b: torch.Tensor,
                cfg: MatchConfig):
    """Masked per-row (best, second, best_idx) under `cfg.metric`/`cfg.impl`
    (invalid rows and columns saturate to ~1e30)."""
    if _use_streaming(cfg, desc_a, desc_b.shape[0]):
        a, b = _streaming_inputs(desc_a, desc_b, cfg.metric)
        return match_kernel.streaming_top2(a, valid_a, b, valid_b)
    return _top2_min(_masked_distances(desc_a, valid_a, desc_b, valid_b,
                                       cfg.metric))


def _accept(best, second, best_idx, valid_a, best_back, cfg: MatchConfig):
    # Lowe ratio on L2 distances: d1 < r * d2  <=>  d1^2 < r^2 * d2^2.
    ok = best < (cfg.ratio * cfg.ratio) * second
    ok &= valid_a & (best < _BIG)
    if cfg.mutual:
        # b's nearest a must be this a.
        rows = torch.arange(best.shape[0], device=best.device)
        ok &= best_back.long()[best_idx.long()] == rows
    return _compact(ok, best, best_idx, cfg.max_matches)


def match_descriptors(desc_a: torch.Tensor, valid_a: torch.Tensor,
                      desc_b: torch.Tensor, valid_b: torch.Tensor,
                      cfg: MatchConfig) -> Matches:
    """Ratio-test (and optionally mutual) matches between two descriptor sets.

    desc_a: (Na, D) float, valid_a: (Na,) bool; desc_b: (Nb, D), valid_b:
    (Nb,). Runs where the tensors lie. Returns a capacity-`cfg.max_matches`
    `Matches` sorted by ascending distance; invalid slots hold index 0 and
    distance 1e30.
    """
    if _use_streaming(cfg, desc_a, desc_b.shape[0]):
        return _match_streaming(desc_a, valid_a, desc_b, valid_b, cfg)
    d = _masked_distances(desc_a, valid_a, desc_b, valid_b, cfg.metric)
    best, second, best_idx = _top2_min(d)
    best_back = torch.argmin(d, dim=0) if cfg.mutual else None
    return _accept(best, second, best_idx, valid_a, best_back, cfg)


def _match_streaming(desc_a, valid_a, desc_b, valid_b,
                     cfg: MatchConfig) -> Matches:
    """Large-N path: the streaming top-2 (no distance matrix), forward and,
    for the mutual check, with the sides swapped; ratio, mutual and
    compaction as on the dense path."""
    a, b = _streaming_inputs(desc_a, desc_b, cfg.metric)
    best, second, best_idx = match_kernel.streaming_top2(a, valid_a, b, valid_b)
    best_back = None
    if cfg.mutual:
        _, _, best_back = match_kernel.streaming_top2(b, valid_b, a, valid_a)
    return _accept(best, second, best_idx, valid_a, best_back, cfg)


def match_descriptors_guided(desc_a, valid_a, desc_b, valid_b,
                             uv_pred_a, has_pred_a, uv_b,
                             radius: float, cfg: MatchConfig) -> Matches:
    """Spatially-guided matching: rows with a position prior only consider
    candidates within `radius` pixels of the prediction.

    uv_pred_a: (Na, 2) predicted positions; has_pred_a: (Na,) bool (rows
    without a prior are unrestricted); uv_b: (Nb, 2) keypoint positions.
    Always dense.
    """
    d = _masked_distances(desc_a, valid_a, desc_b, valid_b, cfg.metric)
    dist2 = ((uv_pred_a[:, None, :] - uv_b[None, :, :]) ** 2).sum(dim=-1)
    near = dist2 <= radius * radius
    spatial_ok = torch.where(has_pred_a[:, None], near, True)
    d = torch.where(spatial_ok, d, _BIG)
    best, second, best_idx = _top2_min(d)
    best_back = torch.argmin(d, dim=0) if cfg.mutual else None
    return _accept(best, second, best_idx, valid_a, best_back, cfg)


def match_keypoints(kp_a: Keypoints, kp_b: Keypoints,
                    cfg: MatchConfig) -> Matches:
    """Convenience wrapper over two single-image `Keypoints` with
    descriptors."""
    if kp_a.desc is None or kp_b.desc is None:
        raise ValueError("match_keypoints needs keypoints with descriptors")
    return match_descriptors(kp_a.desc, kp_a.valid, kp_b.desc, kp_b.valid, cfg)


def matched_coords(kp_a: Keypoints, kp_b: Keypoints, matches: Matches,
                   subpixel: bool = False):
    """Matched original-image (x, y) pairs: returns (M, 2), (M, 2), (M,)."""
    ax, ay = kp_a.to_image_xy(subpixel)
    bx, by = kp_b.to_image_xy(subpixel)
    ia = matches.idx_a.long()
    ib = matches.idx_b.long()
    pa = torch.stack([ax[ia], ay[ia]], dim=-1)
    pb = torch.stack([bx[ib], by[ib]], dim=-1)
    return pa, pb, matches.valid
