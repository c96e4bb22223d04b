"""Trajectory evaluation of the PyTorch port (a copy of `sift_tpu.eval`)."""

from sift_tpu_torch.eval.ate import ate_rmse, rpe_rmse, umeyama_alignment

__all__ = ["umeyama_alignment", "ate_rmse", "rpe_rmse"]
