"""PyTorch/CUDA port of sift_tpu: the SIFT frontend, two-image matching
(`matching`, `cli match`), two-view geometry (`geometry`, `cli twoview`)
and bundle adjustment (`ba`).

Imports torch and numpy only, never JAX or the `sift_tpu` package. Entry
points run on the card unless the caller passes `device="cpu"` or CPU
tensors.
"""

from sift_tpu_torch.config import (BAConfig, MatchConfig, RansacConfig,
                                   SiftConfig, config_from_dict)
from sift_tpu_torch.frontend.sift import extract, extract_batch
from sift_tpu_torch.types import Keypoints, MapState, Matches, TwoViewEstimate

__all__ = ["SiftConfig", "MatchConfig", "RansacConfig", "BAConfig",
           "config_from_dict", "extract", "extract_batch", "Keypoints",
           "Matches", "TwoViewEstimate", "MapState"]
