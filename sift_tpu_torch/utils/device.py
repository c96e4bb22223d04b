"""Host constants placed on a device without a stream sync.

`torch.tensor(values, device="cuda")` copies from pageable host memory,
and PyTorch synchronizes the stream after such a copy: the host waits for
all queued device work. `constant` makes each table once per (values,
dtype, device), copying it from pinned memory with `non_blocking=True`, and
hands the same tensor to every later caller (who must not write to it).
The pinned source stays cached beside it, so it outlives the copy. A lock
makes the first miss of a key the only one, so threads that dispatch
concurrently (the feature service's) share one copy; it lands before any
later work on the stream that every thread issues to.
"""

from __future__ import annotations

import functools
import threading

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _constant(values, dtype: torch.dtype, device: str):
    host = torch.from_numpy(np.asarray(values)).to(dtype)
    if torch.device(device).type != "cuda":
        return host.to(device), None
    pinned = host.pin_memory()
    return pinned.to(device, non_blocking=True), pinned


_constant_lock = threading.Lock()


def constant(values, device, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """`values` (a float, or a flat sequence of floats) as a `dtype`
    tensor on `device`: 0-d for a float, 1-d for a sequence. Cached: do not
    write to the result."""
    key = float(values) if np.ndim(values) == 0 else \
        tuple(float(v) for v in np.asarray(values).reshape(-1))
    with _constant_lock:
        return _constant(key, dtype, str(torch.device(device)))[0]


def check_f32_matmul(x: torch.Tensor, what: str) -> None:
    """Refuse to run `what` on the card with TF32 matrix products on: the
    JAX package computes these products in full f32."""
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(f"{what} needs full f32 products: "
                           "torch.backends.cuda.matmul.allow_tf32 is on")

