"""Descriptor matching of the PyTorch port: brute force (`matcher.py`) and
the IVF-Flat approximate index (`ann.py`)."""

from sift_tpu_torch.matching.ann import (
    IvfIndex,
    build_ivf,
    ivf_index_from_numpy,
    match_descriptors_ann,
    search_ivf,
)
from sift_tpu_torch.matching.matcher import (
    match_descriptors,
    match_descriptors_guided,
    match_keypoints,
    matched_coords,
    pairwise_sqdist,
    top2_masked,
)

__all__ = [
    "match_descriptors",
    "match_descriptors_guided",
    "match_keypoints",
    "matched_coords",
    "pairwise_sqdist",
    "top2_masked",
    "IvfIndex",
    "build_ivf",
    "ivf_index_from_numpy",
    "match_descriptors_ann",
    "search_ivf",
]
