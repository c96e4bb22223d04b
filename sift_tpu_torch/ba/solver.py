"""Levenberg-Marquardt loop of Schur-complement bundle adjustment
(counterpart of `sift_tpu/ba/solver.py`).

The JAX package runs one `lax.while_loop` while iterations <
max_iterations and damping < damping_max. A Python `while` on that
condition would read it on the host, a sync per iteration. Here all
`max_iterations` steps run and a mask freezes the state once the condition
fails; the body is branch-free (`torch.where` on the accept decision), so
the result and the counters are the JAX package's, and on the card the
solver makes no host sync between its first launch and the caller's read.

Gauge: callers pass `fixed_cam_mask` (first camera, or first two for
monocular scale); updates of fixed cameras are structurally zero.

Distributed (`dist/ba_dist.py`), the same loop runs on every rank over its
observation shard: block sums, costs and the median histogram are
all-reduced over `axis_name`, so every decision is the same on every rank
and every rank issues the same collectives in the same order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sift_tpu_torch.ba.residuals import cost_parts, reprojection_residuals
from sift_tpu_torch.ba.schur import (back_substitute, build_system,
                                     dense_schur_solve, pcg, schur_rhs)
from sift_tpu_torch.config import BAConfig
from sift_tpu_torch.dist.mesh import psum_many
from sift_tpu_torch.geometry import lie
from sift_tpu_torch.utils.device import check_f32_matmul, constant

# Log-spaced histogram edges of the approximate median residual (the
# graduated robust loss below): 0.01..10^4 px at better than 13% per bin.
_MED_EDGES = np.geomspace(1e-2, 1e4, 97).astype(np.float32)


@dataclasses.dataclass
class BAState:
    poses: torch.Tensor        # (C, 6)
    landmarks: torch.Tensor    # (L, 3)
    cost: torch.Tensor         # () robust cost
    rmse: torch.Tensor         # () reprojection RMSE (pixels)
    damping: torch.Tensor      # () current LM lambda
    iterations: torch.Tensor   # () int32 iterations executed
    cg_iters: torch.Tensor     # () int32 total CG iterations

    def replace(self, **kw) -> "BAState":
        return dataclasses.replace(self, **kw)


def _median_residual(poses, intrinsics, landmarks, obs_cam, obs_lm, obs_uv,
                     obs_valid, axis_name=None) -> torch.Tensor:
    """Approximate median |r| over valid observations, from a fixed
    log-bin histogram (exact counts, all-reduced over `axis_name`, so the
    same on every mesh shape)."""
    r, _ = reprojection_residuals(poses, intrinsics, landmarks, obs_cam,
                                  obs_lm, obs_uv)
    rn = torch.linalg.vector_norm(r, dim=-1)
    rn = torch.where(torch.isfinite(rn), rn, 1e6)
    edges = constant(_MED_EDGES, rn.device)
    # Number of edges <= |r|, as the JAX package's sum of (|r| >= edge).
    bidx = torch.searchsorted(edges, rn, right=True)
    v = obs_valid.to(torch.float32)
    counts = torch.zeros(edges.shape[0] + 1, dtype=torch.float32,
                         device=rn.device).index_add_(0, bidx, v)
    counts, cnt = psum_many(axis_name, counts, v.sum())
    cum = torch.cumsum(counts, dim=0)
    med_bin = torch.argmax((cum >= 0.5 * cnt).to(torch.uint8))
    return edges.index_select(0, torch.clamp(med_bin, 0, edges.shape[0] - 1)
                              .reshape(1))[0]


def run_ba(poses, intrinsics, landmarks, obs_cam, obs_lm, obs_uv, obs_valid,
           cfg: BAConfig, fixed_cam_mask, axis_name=None, landmark_axis=None,
           v_mode: str = "psum") -> BAState:
    """Optimize poses and landmarks where the tensors lie; returns the
    final `BAState`.

    Distributed, obs_* are this rank's shard and `axis_name` is the
    process group of the shards (JAX's mesh axis); poses, landmarks and
    intrinsics are replicated, and so is the result. `landmark_axis` and
    `v_mode`: `build_system`'s."""
    check_f32_matmul(poses, "run_ba")
    obs = (obs_cam, obs_lm, obs_uv, obs_valid)

    def total_cost(p, l, delta):
        c, sq, cnt = cost_parts(p, intrinsics, l, *obs, delta, cfg.loss)
        if axis_name is not None:
            # The squared sum and the count separately, so that shards
            # with uneven valid counts weigh by their count.
            c, sq, cnt = psum_many(axis_name, c, sq, cnt.to(sq.dtype))
        return c, torch.sqrt(sq / torch.clamp_min(cnt, 1))

    med0 = _median_residual(poses, intrinsics, landmarks, *obs, axis_name)
    c0, rmse0 = total_cost(poses, landmarks, cfg.huber_delta)
    dev = poses.device
    st = BAState(
        poses=poses, landmarks=landmarks, cost=c0, rmse=rmse0,
        damping=torch.full((), cfg.damping_init, dtype=torch.float32,
                           device=dev),
        iterations=torch.zeros((), dtype=torch.int32, device=dev),
        cg_iters=torch.zeros((), dtype=torch.int32, device=dev),
    )
    use_dense = cfg.solver == "dense" or \
        (cfg.solver == "auto" and poses.shape[0] <= 16)
    fixed = fixed_cam_mask[:, None]

    for it in range(cfg.max_iterations):
        active = (st.iterations < cfg.max_iterations) & \
            (st.damping < cfg.damping_max)
        # Graduated robust loss (GNC schedule): the kernel starts at
        # robust_anneal x the initial median residual and halves every
        # iteration down to huber_delta, so a bad start is first solved
        # quasi-quadratically. While the state is active, its iteration
        # count is `it`, so 0.5^iterations is the exact 0.5 ** it. The
        # accept test compares old and new cost at the same delta_eff.
        if cfg.loss != "none" and cfg.robust_anneal > 0.0:
            delta_eff = torch.clamp_min(cfg.robust_anneal * med0 * 0.5 ** it,
                                        cfg.huber_delta)
        else:
            delta_eff = cfg.huber_delta
        sys = build_system(st.poses, intrinsics, st.landmarks, *obs,
                           delta_eff, st.damping, fixed_cam_mask, cfg.loss,
                           axis_name, landmark_axis, v_mode)
        b = schur_rhs(sys)
        if use_dense:
            dc = dense_schur_solve(sys, b)
            cg_iters = st.cg_iters
        else:
            dc, k = pcg(sys, b, cfg.cg_iterations, cfg.cg_tol,
                        jacobi=cfg.jacobi_precond)
            cg_iters = st.cg_iters + torch.where(active, k, 0)
        dc = torch.where(fixed, 0.0, dc)
        dl = back_substitute(sys, dc)
        # Non-finite updates (degenerate blocks at f32) must not poison
        # the state: the robust cost masks NaN observations, so a
        # poisoned-but-"accepted" step would otherwise slip through.
        dc = torch.where(torch.isfinite(dc), dc, 0.0)
        dl = torch.where(torch.isfinite(dl), dl, 0.0)

        new_poses = lie.boxplus(st.poses, dc)      # manifold retraction
        new_lms = st.landmarks + dl
        old_cost, _ = total_cost(st.poses, st.landmarks, delta_eff)
        new_cost, new_rmse = total_cost(new_poses, new_lms, delta_eff)

        accept = new_cost < old_cost
        keep = active & accept
        st = BAState(
            poses=torch.where(keep, new_poses, st.poses),
            landmarks=torch.where(keep, new_lms, st.landmarks),
            cost=torch.where(keep, new_cost, st.cost),
            rmse=torch.where(keep, new_rmse, st.rmse),
            damping=torch.where(active, torch.where(
                accept, torch.clamp_min(st.damping * (1.0 / 3.0),
                                        cfg.damping_min),
                st.damping * 4.0), st.damping),
            iterations=st.iterations + active.to(torch.int32),
            cg_iters=cg_iters,
        )
    return st


def run_ba_map(state, cfg: BAConfig, fixed_cam_mask, axis_name=None):
    """Optimize a `sift_tpu_torch.types.MapState`; returns (new_state,
    BAState)."""
    st = run_ba(state.poses, state.intrinsics, state.landmarks,
                state.obs_cam, state.obs_lm, state.obs_uv, state.obs_valid,
                cfg, fixed_cam_mask, axis_name)
    return state.replace(poses=st.poses, landmarks=st.landmarks), st
