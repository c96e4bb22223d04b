"""Pixel operations and the hand-written CUDA kernels of the port."""

from sift_tpu_torch.kernels.derivatives import scale_space_gradient_hessian
from sift_tpu_torch.kernels.dog import dog
from sift_tpu_torch.kernels.gaussian import gaussian_blur, gaussian_kernel_1d
from sift_tpu_torch.kernels.gradients import gradient_magnitude_orientation
from sift_tpu_torch.kernels.histogram import parabola_vertex, weighted_histogram
from sift_tpu_torch.kernels.resize import (downsample_half, resize_nearest,
                                           upsample_double)

__all__ = ["gaussian_kernel_1d", "gaussian_blur", "resize_nearest",
           "downsample_half", "upsample_double", "dog",
           "gradient_magnitude_orientation", "weighted_histogram",
           "parabola_vertex", "scale_space_gradient_hessian"]
