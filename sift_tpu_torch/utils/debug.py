"""Debugging and numerical-safety utilities of the PyTorch port
(counterpart of `sift_tpu/utils/debug.py`): NaN detection and run-to-run
determinism checks over nested containers of tensors and arrays."""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, List, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode


class _NanCheck(TorchDispatchMode):
    """Raises after the first operator whose floating output holds a NaN,
    naming the operator. Reads every output on the host: a sync per
    operator."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor) and (
                    t.is_floating_point() or t.is_complex()) and \
                    bool(torch.isnan(t).any()):
                raise FloatingPointError(
                    f"{func} produced {int(torch.isnan(t).sum())} NaN "
                    f"values (shape {tuple(t.shape)}, dtype {t.dtype})")
        return out


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Scoped NaN detection, as `jax_debug_nans`: inside the block, the
    first operator that produces a NaN raises `FloatingPointError` naming
    it. Infinities pass, as in JAX: the port's paths use +-inf as masking
    sentinels. Expensive (a host sync per operator): tests and debugging
    only. The previous dispatch modes are restored on exit."""
    if not enable:
        yield
        return
    with _NanCheck():
        yield


def _flatten(tree: Any) -> Tuple[List[Any], list]:
    """Leaves and structure of a nest of dicts, lists, tuples and
    dataclasses."""
    leaves, spec = pytree.tree_flatten(tree)
    out, specs = [], [spec]
    for leaf in leaves:
        if dataclasses.is_dataclass(leaf) and not isinstance(leaf, type):
            sub, sub_spec = _flatten({f.name: getattr(leaf, f.name)
                                      for f in dataclasses.fields(leaf)})
            out.extend(sub)
            specs.append((type(leaf), sub_spec))
        else:
            out.append(leaf)
    return out, specs


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.cpu().numpy()
    return np.asarray(leaf)


def check_finite(tree: Any, name: str = "pytree") -> None:
    """Host-side assertion that every floating leaf of `tree` is finite."""
    leaves, _ = _flatten(tree)
    for i, leaf in enumerate(leaves):
        arr = _host(leaf)
        if arr.dtype.kind == "f" and not np.isfinite(arr).all():
            bad = int((~np.isfinite(arr)).sum())
            raise FloatingPointError(
                f"{name}: leaf {i} has {bad} non-finite values "
                f"(shape {arr.shape}, dtype {arr.dtype})")


def assert_trees_equal(a: Any, b: Any, atol: float = 0.0,
                       name: str = "trees") -> None:
    """Determinism assertion: two states (e.g. reruns, or the card and the
    CPU) must have one structure and leaves equal to `atol`."""
    la, sa = _flatten(a)
    lb, sb = _flatten(b)
    if sa != sb:
        raise AssertionError(f"{name}: structure mismatch")
    for i, (x, y) in enumerate(zip(la, lb)):
        np.testing.assert_allclose(_host(x), _host(y), atol=atol,
                                   err_msg=f"{name}: leaf {i}")
