"""Bundle adjustment of the PyTorch port (counterpart of `sift_tpu.ba`).

Schur-complement Levenberg-Marquardt: per-observation residuals and
Jacobian blocks (the observation list is the sparsity structure), camera
and landmark Hessian blocks by segment sums over observations (the same
from run to run on the card), and the reduced camera system solved by
matrix-free PCG or, for window-sized problems, a dense Cholesky. Every
loop has a fixed trip count and freezes its state by mask, so `run_ba`
makes no host sync on the card. Distributed (`dist/ba_dist.py`), each
rank holds a shard of the observations and every segment sum is
all-reduced over the `axis_name` process group.
"""

from sift_tpu_torch.ba.residuals import linearize, reprojection_residuals
from sift_tpu_torch.ba.schur import SchurSystem, build_system, pcg, schur_matvec
from sift_tpu_torch.ba.solver import BAState, run_ba, run_ba_map

__all__ = [
    "reprojection_residuals",
    "linearize",
    "SchurSystem",
    "build_system",
    "schur_matvec",
    "pcg",
    "BAState",
    "run_ba",
    "run_ba_map",
]
