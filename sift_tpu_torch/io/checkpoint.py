"""Checkpoint / resume of the PyTorch port (counterpart of
`sift_tpu/io/checkpoint.py`; the format is the port's own, orbax is not
read).

A state is any nest of dicts, lists, tuples and dataclasses (`BAState`,
`MapState`, pipeline dicts) whose leaves are tensors, numpy arrays or
Python scalars. It is written with `torch.save` as a tree of plain
containers plus a flat list of CPU tensors, so `torch.load(weights_only=
True)` reads it back without unpickling any class of this package. Every
write goes to a temporary name in the same directory and is moved into
place with `os.replace`, so a process killed mid-save leaves the last good
file as it was.

`restore_checkpoint(path, target=)` puts each leaf back into `target`'s
structure, on the device and with the dtype of `target`'s leaf; without a
target, dataclasses come back as dicts of their fields and tensors on the
CPU.
"""

from __future__ import annotations

import dataclasses
import os
import re
import tempfile
from typing import Any, List, Optional

import numpy as np
import torch

_FORMAT = "sift_tpu_torch.checkpoint/1"


def _encode(obj: Any, leaves: List[torch.Tensor]):
    """Plain-container structure of `obj`; tensors go to `leaves`."""
    if isinstance(obj, torch.Tensor):
        # A compact copy: saving a view would save its whole storage.
        leaves.append(obj.detach().cpu().clone())
        return {"tensor": len(leaves) - 1}
    if isinstance(obj, np.ndarray):
        leaves.append(torch.from_numpy(np.ascontiguousarray(obj)))
        return {"numpy": len(leaves) - 1}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {"dataclass": {f.name: _encode(getattr(obj, f.name), leaves)
                              for f in dataclasses.fields(obj)}}
    if isinstance(obj, dict):
        return {"dict": [(k, _encode(v, leaves)) for k, v in obj.items()]}
    if isinstance(obj, (list, tuple)):
        kind = "list" if isinstance(obj, list) else "tuple"
        return {kind: [_encode(v, leaves) for v in obj]}
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return {"value": obj}
    if isinstance(obj, np.generic):
        return {"value": obj.item()}
    raise TypeError(f"cannot checkpoint a {type(obj).__name__}")


def _decode(node, leaves):
    """The saved tree with no target: dataclasses as dicts, tensors on the
    CPU, numpy leaves as numpy."""
    (kind, val), = node.items()
    if kind == "tensor":
        return leaves[val]
    if kind == "numpy":
        return leaves[val].numpy()
    if kind == "dataclass":
        return {k: _decode(v, leaves) for k, v in val.items()}
    if kind == "dict":
        return {k: _decode(v, leaves) for k, v in val}
    if kind in ("list", "tuple"):
        out = [_decode(v, leaves) for v in val]
        return out if kind == "list" else tuple(out)
    return val


def _restore_into(target, node, leaves, where: str = "state"):
    """`target`'s structure filled from the saved tree, each leaf on the
    device and with the dtype of the target's leaf."""
    (kind, val), = node.items()

    def mismatch():
        return ValueError(f"checkpoint structure differs from the target at "
                          f"{where}: saved {kind}, target "
                          f"{type(target).__name__}")

    if isinstance(target, torch.Tensor):
        if kind not in ("tensor", "numpy"):
            raise mismatch()
        leaf = leaves[val]
        if tuple(leaf.shape) != tuple(target.shape):
            raise ValueError(f"{where}: saved shape {tuple(leaf.shape)}, "
                             f"target {tuple(target.shape)}")
        return leaf.to(device=target.device, dtype=target.dtype)
    if isinstance(target, np.ndarray):
        if kind not in ("tensor", "numpy"):
            raise mismatch()
        return leaves[val].numpy().astype(target.dtype, copy=False)
    if dataclasses.is_dataclass(target) and not isinstance(target, type):
        if kind != "dataclass":
            raise mismatch()
        names = [f.name for f in dataclasses.fields(target)]
        if sorted(names) != sorted(val):
            raise ValueError(f"{where}: saved fields {sorted(val)}, target "
                             f"{sorted(names)}")
        return dataclasses.replace(target, **{
            n: _restore_into(getattr(target, n), val[n], leaves,
                             f"{where}.{n}") for n in names})
    if isinstance(target, dict):
        if kind != "dict":
            raise mismatch()
        saved = dict(val)
        if set(saved) != set(target):
            raise ValueError(f"{where}: saved keys {sorted(map(str, saved))}, "
                             f"target {sorted(map(str, target))}")
        return {k: _restore_into(target[k], saved[k], leaves, f"{where}[{k!r}]")
                for k in target}
    if isinstance(target, (list, tuple)):
        if kind not in ("list", "tuple") or len(val) != len(target):
            raise mismatch()
        out = [_restore_into(t, v, leaves, f"{where}[{i}]")
               for i, (t, v) in enumerate(zip(target, val))]
        return out if isinstance(target, list) else type(target)(out)
    return _decode(node, leaves)


def _write(path: str, state: Any) -> None:
    leaves: List[torch.Tensor] = []
    payload = {"format": _FORMAT, "tree": _encode(state, leaves),
               "leaves": leaves}
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".tmp-", dir=d)
    try:
        with os.fdopen(fd, "wb") as fh:
            torch.save(payload, fh)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def _read(path: str):
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(payload, dict) or payload.get("format") != _FORMAT:
        raise ValueError(f"{path} is not a sift_tpu_torch checkpoint")
    return payload["tree"], payload["leaves"]


def save_checkpoint(path: str, state: Any, force: bool = True) -> None:
    """Write `state` to the file `path` atomically. With `force=False` an
    existing file is not overwritten (FileExistsError)."""
    if not force and os.path.exists(path):
        raise FileExistsError(path)
    _write(path, state)


def restore_checkpoint(path: str, target: Optional[Any] = None) -> Any:
    """Read a checkpoint. With `target` (a state of the saved structure),
    the leaves land in its structure, on its leaves' devices and dtypes;
    without it the raw saved tree comes back."""
    tree, leaves = _read(path)
    if target is None:
        return _decode(tree, leaves)
    return _restore_into(target, tree, leaves)


class CheckpointManager:
    """Step-numbered checkpoints in `directory` (`step_<n>.pt`), keeping
    the newest `max_to_keep`. Saves are synchronous, so `wait` and
    `close` have nothing to wait for."""

    _NAME = re.compile(r"^step_(\d+)\.pt$")

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{int(step)}.pt")

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in
                      map(self._NAME.match, os.listdir(self.directory)) if m)

    def save(self, step: int, state: Any) -> None:
        _write(self._path(step), state)
        steps = self.all_steps()
        for old in steps[:max(0, len(steps) - self.max_to_keep)]:
            os.remove(self._path(old))

    def restore(self, step: Optional[int] = None,
                target: Optional[Any] = None) -> Any:
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError("no checkpoint found")
        return restore_checkpoint(self._path(step), target)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def wait(self) -> None:
        pass

    def close(self) -> None:
        pass
