"""SLAM layer of the PyTorch port: the incremental SfM pipeline's default
path (`slam/pipeline.py`); the pose graph is not ported yet."""

from sift_tpu_torch.slam.pipeline import Keyframe, SfmPipeline

__all__ = ["SfmPipeline", "Keyframe"]
