"""PyTorch/CUDA port of sift_tpu: the SIFT frontend and two-image matching
(`matching`, `geometry`, `cli match`).

Imports torch and numpy only, never JAX or the `sift_tpu` package. Entry
points run on the card unless the caller passes `device="cpu"` or CPU
tensors.
"""

from sift_tpu_torch.config import (MatchConfig, RansacConfig, SiftConfig,
                                   config_from_dict)
from sift_tpu_torch.frontend.sift import extract, extract_batch
from sift_tpu_torch.types import Keypoints, Matches, TwoViewEstimate

__all__ = ["SiftConfig", "MatchConfig", "RansacConfig", "config_from_dict",
           "extract", "extract_batch", "Keypoints", "Matches",
           "TwoViewEstimate"]
