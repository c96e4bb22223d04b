"""Elementwise transcendental functions whose CPU result does not depend on
where an element sits.

PyTorch's CPU kernels run an elementwise op through a vector loop and
finish each thread's range with a scalar loop, and for `exp`, `atan2`,
`sin`, `cos` and `pow` the two loops (SIMD polynomials, libm) can round
an input differently. Which elements fall in a scalar tail depends on the
tensor's size and on how the work is split across threads. On tensors
that flatten keypoints across the images of a batch, the same keypoint
would then round differently at another batch size. NumPy's loops for
these functions compute every element, the remainder included (masked
vector loads), by the same code on one thread, so `lanewise` runs them
through NumPy on the CPU. On the card there is no such split, and the op
runs as it is.
"""

from __future__ import annotations

import numpy as np
import torch

_NUMPY = {torch.exp: np.exp, torch.atan2: np.arctan2, torch.sin: np.sin,
          torch.cos: np.cos, torch.pow: np.power}


def lanewise(fn, *xs: torch.Tensor) -> torch.Tensor:
    """`fn(*xs)` for one of the elementwise functions above, broadcasting
    the inputs; on the CPU every element is computed by the same code
    wherever it sits."""
    if xs[0].is_cuda:
        return fn(*xs)
    args = [np.ascontiguousarray(x.detach().numpy()) for x in xs]
    return torch.from_numpy(np.ascontiguousarray(_NUMPY[fn](*args)))
