"""Pose-graph optimization on SE(3) and Sim(3) (counterpart of
`sift_tpu/slam/pose_graph.py`, single device).

Nodes are keyframe poses (world-from-keyframe tangents); edges carry
relative measurements z_e ~ log(T_i^-1 T_j) with scalar information
weights. The residual of edge e is

    r_e = log( exp(z_e)^-1 · exp(xi_i)^-1 · exp(xi_j) )

and Levenberg-Marquardt solves the normal equations matrix-free: per-edge
Jacobian blocks with respect to local right-perturbations of both nodes
(forward mode, `torch.func.jvp` batched over the basis directions by
`torch.func.vmap`, as the JAX package's `vmap(jacfwd)`), H x assembled by
two segment sums over the edges, and block-Jacobi preconditioned CG.

The JAX package runs LM and CG as `lax.while_loop`s that stop early (CG
once |r|^2 <= tol^2 |b|^2, LM once the damping reaches 1e8). Here every
step of both loops runs and a mask freezes the state once its loop's
condition fails, so the result is the early-exit loop's and a solve makes
no host sync. Segment sums are the accumulating `index_put_` of
`ba/schur.py` (no float atomics on the card), so two card runs are
bit-identical.

Everything is fixed-shape: edge lists are capacity buffers with weight 0
on padding, and fixed (gauge) nodes get zeroed Jacobians.
"""

from __future__ import annotations

import dataclasses

import torch

from sift_tpu_torch.ba.schur import _bmv, _btv, _gram, _seg_sum
from sift_tpu_torch.geometry import lie, sim3
from sift_tpu_torch.utils.linalg import inv_or_nan

# Damping at which the JAX package's LM loop stops.
_DAMPING_STOP = 1e8


@dataclasses.dataclass
class PoseGraph:
    """Fixed-capacity pose graph.

    poses:     (N, 6) se(3) world-from-keyframe, or (N, 7) sim(3)
               (omega, v, sigma) in a `Sim3Graph`.
    edge_i/j:  (E,) int node indices.
    edge_z:    (E, D) measured relative pose log(T_i^-1 T_j).
    edge_w:    (E,) scalar information weights (0 = invalid edge).
    fixed:     (N,) bool gauge mask.
    """

    poses: torch.Tensor
    edge_i: torch.Tensor
    edge_j: torch.Tensor
    edge_z: torch.Tensor
    edge_w: torch.Tensor
    fixed: torch.Tensor

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class Sim3Graph(PoseGraph):
    """Fixed-capacity Sim(3) pose graph (layout of `PoseGraph`, D = 7)."""


# Each group: (exp, inverse, compose, log) on tuples of group elements.
_SE3 = (lie.se3_exp, lie.se3_inverse, lie.se3_compose, lie.se3_log)
_SIM3 = (sim3.sim3_exp, sim3.sim3_inverse, sim3.sim3_compose, sim3.sim3_log)


def _relative_residual(ops, Si, Sj, Szi):
    """log(Z^-1 S_i^-1 S_j) for group elements given as tuples."""
    _, inv, comp, log = ops
    Sij = comp(*inv(*Si), *Sj)
    return log(*comp(*Szi, *Sij))


def edge_residual(xi_i, xi_j, z):
    """r = log(exp(z)^-1 exp(xi_i)^-1 exp(xi_j)) (..., 6)."""
    exp, inv = _SE3[0], _SE3[1]
    return _relative_residual(_SE3, exp(xi_i), exp(xi_j), inv(*exp(z)))


def sim3_edge_residual(xi_i, xi_j, z):
    """r = log(exp(z)^-1 exp(xi_i)^-1 exp(xi_j)) in R^7."""
    exp, inv = _SIM3[0], _SIM3[1]
    return _relative_residual(_SIM3, exp(xi_i), exp(xi_j), inv(*exp(z)))


def _group_of(graph: PoseGraph):
    return _SIM3 if graph.poses.shape[-1] == 7 else _SE3


def _residuals(graph: PoseGraph, poses: torch.Tensor) -> torch.Tensor:
    """(E, D) sqrt-weighted residuals at `poses` (the cost's terms)."""
    ops = _group_of(graph)
    exp, inv = ops[0], ops[1]
    r = _relative_residual(ops, exp(poses[graph.edge_i]),
                           exp(poses[graph.edge_j]), inv(*exp(graph.edge_z)))
    return r * torch.sqrt(torch.clamp_min(graph.edge_w, 0.0))[:, None]


def _linearize(graph: PoseGraph, poses: torch.Tensor):
    """Per-edge residuals (E, D) and Jacobians (E, D, D) with respect to
    local right-perturbations of nodes i and j (manifold linearization,
    immune to the tangent chart's singularity at rotation angle pi)."""
    ops = _group_of(graph)
    exp, inv, comp, _ = ops
    E, D = graph.edge_z.shape
    Si, Sj = exp(poses[graph.edge_i]), exp(poses[graph.edge_j])
    Szi = inv(*exp(graph.edge_z))

    def f(di, dj):
        return _relative_residual(ops, comp(*Si, *exp(di)),
                                  comp(*Sj, *exp(dj)), Szi)

    # Forward mode over the 2D basis directions, batched by vmap (what
    # `jacfwd` does), each direction pushed through every edge at once.
    # (`vmap` of `jacfwd` over the edges would run the Lie maps on 0-dim
    # tensors, whose forward-mode tangents PyTorch promotes to float64.)
    zero = torch.zeros((E, D), dtype=poses.dtype, device=poses.device)

    def column(v):
        return torch.func.jvp(f, (zero, zero),
                              (v[:D].expand(E, D), v[D:].expand(E, D)))[1]

    basis = torch.eye(2 * D, dtype=poses.dtype, device=poses.device)
    cols = torch.func.vmap(column)(basis)            # (2D, E, D)
    J = cols.permute(1, 2, 0)                        # (E, D, 2D)
    sw = torch.sqrt(torch.clamp_min(graph.edge_w, 0.0))[:, None, None]
    # Gauge: zero the Jacobians of fixed nodes.
    free_i = 1.0 - graph.fixed[graph.edge_i].to(J.dtype)
    free_j = 1.0 - graph.fixed[graph.edge_j].to(J.dtype)
    return (_residuals(graph, poses), J[..., :D] * sw * free_i[:, None, None],
            J[..., D:] * sw * free_j[:, None, None])


def _h_matvec(Ji, Jj, ei, ej, n, x, damping):
    """(J^T J + damping I) x via two edge sweeps. x: (N, D)."""
    t = _bmv(Ji, x[ei]) + _bmv(Jj, x[ej])             # (E, D) = J_e x
    out = _seg_sum(_btv(Ji, t), ei, n) + _seg_sum(_btv(Jj, t), ej, n)
    return out + damping * x


def _cg_solve(graph, Ji, Jj, b, damping, cg_iterations, cg_tol):
    """Block-Jacobi preconditioned CG, all `cg_iterations` steps, frozen
    by mask once |r|^2 <= cg_tol^2 |b|^2 (the JAX loop's exit)."""
    n, D = b.shape
    ei, ej = graph.edge_i, graph.edge_j
    eye = torch.eye(D, dtype=b.dtype, device=b.device)
    Dm = _seg_sum(_gram(Ji), ei, n) + _seg_sum(_gram(Jj), ej, n) + \
        damping * eye
    M_inv = inv_or_nan(Dm)

    def dot(a, c):
        return (a * c).sum()

    x = torch.zeros_like(b)
    r = b
    p = _bmv(M_inv, b)
    rz = dot(b, p)
    threshold = cg_tol ** 2 * torch.clamp_min(dot(b, b), 1e-30)
    for _ in range(cg_iterations):
        active = dot(r, r) > threshold
        Ap = _h_matvec(Ji, Jj, ei, ej, n, p, damping)
        alpha = rz / torch.clamp_min(dot(p, Ap), 1e-30)
        x_new = x + alpha * p
        r_new = r - alpha * Ap
        z = _bmv(M_inv, r_new)
        rz_new = dot(r_new, z)
        p_new = z + (rz_new / torch.clamp_min(rz, 1e-30)) * p
        x = torch.where(active, x_new, x)
        r = torch.where(active, r_new, r)
        p = torch.where(active, p_new, p)
        rz = torch.where(active, rz_new, rz)
    return x


def _optimize(graph: PoseGraph, boxplus, iterations, cg_iterations, cg_tol,
              damping_init):
    n = graph.poses.shape[0]
    ei, ej = graph.edge_i, graph.edge_j

    def total_cost(poses):
        r = _residuals(graph, poses)
        return (r * r).sum()

    poses = graph.poses
    cost = total_cost(poses)
    damping = torch.full((), damping_init, dtype=torch.float32,
                         device=poses.device)
    for _ in range(iterations):
        active = damping < _DAMPING_STOP
        r, Ji, Jj = _linearize(graph, poses)
        grad = _seg_sum(_btv(Ji, r), ei, n) + _seg_sum(_btv(Jj, r), ej, n)
        dx = _cg_solve(graph, Ji, Jj, -grad, damping, cg_iterations, cg_tol)
        dx = torch.where(graph.fixed[:, None], 0.0, dx)
        poses_new = boxplus(poses, dx)               # manifold retraction
        cost_new = total_cost(poses_new)
        accept = cost_new < cost
        keep = active & accept
        poses = torch.where(keep, poses_new, poses)
        cost = torch.where(keep, cost_new, cost)
        damping = torch.where(active, torch.where(
            accept, torch.clamp_min(damping / 3.0, 1e-9), damping * 4.0),
            damping)
    return graph.replace(poses=poses)


def optimize_pose_graph(graph: PoseGraph, iterations: int = 20,
                        cg_iterations: int = 64, cg_tol: float = 1e-6,
                        damping_init: float = 1e-4) -> PoseGraph:
    """Levenberg-Marquardt on the SE(3) graph where its tensors lie."""
    return _optimize(graph, lie.boxplus, iterations, cg_iterations, cg_tol,
                     damping_init)


def optimize_pose_graph_sim3(graph: Sim3Graph, iterations: int = 20,
                             cg_iterations: int = 64, cg_tol: float = 1e-6,
                             damping_init: float = 1e-4) -> Sim3Graph:
    """Levenberg-Marquardt on the Sim(3) graph where its tensors lie."""
    return _optimize(graph, sim3.boxplus, iterations, cg_iterations, cg_tol,
                     damping_init)
