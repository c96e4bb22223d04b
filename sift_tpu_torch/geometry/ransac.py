"""Fixed-batch RANSAC (counterpart of `sift_tpu/geometry/ransac.py`).

A fixed batch of hypotheses runs in parallel: draw `num_hypotheses` minimal
samples at once (Gumbel top-k gives distinct indices among the valid
matches without a rejection loop), solve all of them with a batched
minimal solver, score all hypotheses against all matches as one (H, N)
masked reduction, take the argmax, and optionally refit on its inliers.

The JAX package draws its Gumbel noise with `jax.random.gumbel(key, (H,
N))`, a stream torch cannot reproduce. So the port takes `noise`: either
that (H, N) tensor itself (the tests make it with JAX and hand it to both
packages) or a `torch.Generator`, from which the port draws its own.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from sift_tpu_torch.config import RansacConfig
from sift_tpu_torch.frontend.extrema import top_k_stable
from sift_tpu_torch.types import TwoViewEstimate

_NEG = -1e30

Noise = Union[torch.Tensor, torch.Generator]


def gumbel(generator: torch.Generator, shape, device) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(U)), U uniform in [tiny, 1), drawn
    from `generator` on its own device and moved to `device`."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    u = torch.clamp_min(u, torch.finfo(torch.float32).tiny)
    return (-torch.log(-torch.log(u))).to(device)


def sample_minimal_sets(noise: Noise, valid: torch.Tensor,
                        num_hypotheses: int, sample_size: int) -> torch.Tensor:
    """(H, S) distinct indices drawn uniformly from the valid entries.

    Per hypothesis, iid Gumbel noise on a 0/-inf validity score, then the
    top S (ties lower index first, as `lax.top_k`)."""
    n = valid.shape[0]
    if isinstance(noise, torch.Generator):
        noise = gumbel(noise, (num_hypotheses, n), valid.device)
    if noise.shape != (num_hypotheses, n):
        raise ValueError(f"noise shape {tuple(noise.shape)} != "
                         f"{(num_hypotheses, n)}")
    scores = torch.where(valid[None, :], noise.to(valid.device), _NEG)
    _, idx = top_k_stable(scores, sample_size)
    return idx


def ransac(noise: Noise,
           pa: torch.Tensor, pb: torch.Tensor, valid: torch.Tensor,
           solve_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
           error_fn: Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                              torch.Tensor],
           sample_size: int,
           cfg: RansacConfig,
           refit_fn: Optional[Callable] = None) -> TwoViewEstimate:
    """Generic fixed-batch RANSAC.

    pa, pb: (N, 2) matched point coordinates; valid: (N,) bool.
    solve_fn: batched minimal solver (H, S, 2) x (H, S, 2) -> (H, 3, 3).
    error_fn: models (H, 3, 3) or (3, 3), (N, 2), (N, 2) -> (H, N) or (N,)
              squared pixel errors.
    refit_fn: optional weighted refit ((N, 2), (N, 2), (N,) weights) ->
              (3, 3), applied to the best hypothesis's inliers.
    """
    idx = sample_minimal_sets(noise, valid, cfg.num_hypotheses, sample_size)
    models = solve_fn(pa[idx], pb[idx])                         # (H, 3, 3)
    errors = error_fn(models, pa, pb)                           # (H, N)

    thresh2 = cfg.inlier_threshold * cfg.inlier_threshold
    inlier_mask = (errors < thresh2) & valid[None, :]
    counts = inlier_mask.sum(dim=-1)

    # Tie-break equal counts by total inlier error (lower is better).
    err_sum = torch.where(inlier_mask, errors, 0.0).sum(dim=-1)
    order = counts.to(torch.float32) - err_sum / (err_sum.max() + 1.0)
    best = torch.argmax(order)

    model = models[best]
    inliers = inlier_mask[best]
    num_inliers = counts[best]

    if cfg.refit and refit_fn is not None:
        refit_model = refit_fn(pa, pb, inliers.to(pa.dtype))
        refit_inliers = (error_fn(refit_model, pa, pb) < thresh2) & valid
        refit_count = refit_inliers.sum()
        better = refit_count >= num_inliers
        model = torch.where(better, refit_model, model)
        inliers = torch.where(better, refit_inliers, inliers)
        num_inliers = torch.where(better, refit_count, num_inliers)

    return TwoViewEstimate(
        model=model,
        inliers=inliers,
        num_inliers=num_inliers.to(torch.int32),
        success=num_inliers >= cfg.min_inliers,
    )
