"""Two-view geometry of the PyTorch port: fixed-batch RANSAC
(`geometry/ransac.py`) and the homography model."""

from sift_tpu_torch.geometry.homography import (
    fit_homography,
    ransac_homography,
    symmetric_transfer_error,
)

__all__ = ["fit_homography", "ransac_homography", "symmetric_transfer_error"]
