"""SLAM layer of the PyTorch port: the incremental SfM pipeline
(`slam/pipeline.py`) and the SE(3) / Sim(3) pose graph
(`slam/pose_graph.py`)."""

from sift_tpu_torch.slam.pipeline import Keyframe, SfmPipeline
from sift_tpu_torch.slam.pose_graph import PoseGraph, optimize_pose_graph

__all__ = ["SfmPipeline", "Keyframe", "PoseGraph", "optimize_pose_graph"]
