"""PyTorch/CUDA port of sift_tpu's SIFT frontend.

Imports torch and numpy only, never JAX or the `sift_tpu` package. Entry
points run on the card unless the caller passes `device="cpu"`.
"""

from sift_tpu_torch.config import SiftConfig, config_from_dict
from sift_tpu_torch.frontend.sift import extract, extract_batch
from sift_tpu_torch.types import Keypoints

__all__ = ["SiftConfig", "config_from_dict", "extract", "extract_batch",
           "Keypoints"]
