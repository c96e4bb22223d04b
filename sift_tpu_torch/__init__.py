"""PyTorch/CUDA port of sift_tpu: the SIFT frontend in lowe and parity
modes (`extract`, `extract_batch`, `cli extract`), two-image matching
(`matching`, `cli match`), two-view geometry (`geometry`, `cli twoview`),
bundle adjustment (`ba`), and the single-device SfM/SLAM loop with loop
closure, the pose graph, chunked tracking, asynchronous window BA and
stereo (`slam`, `cli sfm`), the feature service (`serve`), the IVF-Flat
approximate matcher (`matching.ann`), checkpoints, native decoding and
debug utilities (`io`, `utils`).

Imports torch and numpy only, never JAX or the `sift_tpu` package. Entry
points run on the card unless the caller passes `device="cpu"` or CPU
tensors.
"""

from sift_tpu_torch.config import (BAConfig, MatchConfig, PipelineConfig,
                                   RansacConfig, SiftConfig, config_from_dict)
from sift_tpu_torch.frontend.sift import extract, extract_batch
from sift_tpu_torch.types import Keypoints, MapState, Matches, TwoViewEstimate

__version__ = "0.1.0"

__all__ = ["SiftConfig", "MatchConfig", "RansacConfig", "BAConfig",
           "PipelineConfig", "config_from_dict", "extract", "extract_batch",
           "Keypoints", "Matches", "TwoViewEstimate", "MapState",
           "__version__"]
