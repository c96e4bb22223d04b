"""SLAM layer of the PyTorch port: the incremental SfM pipeline
(`slam/pipeline.py`) and the SE(3) / Sim(3) pose graph
(`slam/pose_graph.py`)."""

from sift_tpu_torch.slam.pipeline import Keyframe, SfmPipeline

__all__ = ["SfmPipeline", "Keyframe"]
