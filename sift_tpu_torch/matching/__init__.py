"""Descriptor matching of the PyTorch port (brute force; the IVF index of
`sift_tpu.matching.ann` is not ported yet)."""

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
]
