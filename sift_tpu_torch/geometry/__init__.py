"""Multi-view geometry of the PyTorch port (counterpart of
`sift_tpu.geometry`): Lie groups, the pinhole camera, fixed-batch RANSAC
(`geometry/ransac.py`), homographies, epipolar geometry and triangulation.
Every solver takes leading batch axes; RANSAC is a fixed hypothesis batch
scored by one masked reduction."""

from sift_tpu_torch.geometry import lie
from sift_tpu_torch.geometry.camera import backproject, project
from sift_tpu_torch.geometry.epipolar import (
    decompose_essential,
    estimate_relative_pose,
    fit_fundamental_8pt,
    ransac_essential,
)
from sift_tpu_torch.geometry.homography import (
    decompose_homography,
    fit_homography,
    ransac_homography,
    symmetric_transfer_error,
)
from sift_tpu_torch.geometry.triangulation import triangulate_dlt

__all__ = [
    "lie",
    "project",
    "backproject",
    "fit_homography",
    "ransac_homography",
    "symmetric_transfer_error",
    "decompose_homography",
    "fit_fundamental_8pt",
    "ransac_essential",
    "decompose_essential",
    "estimate_relative_pose",
    "triangulate_dlt",
]
