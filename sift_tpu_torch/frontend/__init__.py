"""SIFT frontend of the PyTorch port, in lowe and parity modes."""

from sift_tpu_torch.frontend.pyramid import Pyramid, build_pyramid
from sift_tpu_torch.frontend.sift import extract, extract_batch

__all__ = ["build_pyramid", "Pyramid", "extract", "extract_batch"]
