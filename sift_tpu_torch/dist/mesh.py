"""Process meshes and the collectives of the distribution layer
(counterpart of `sift_tpu/dist/mesh.py`).

The JAX package runs one program over N devices of one process
(`shard_map` over a `Mesh`). Here each device is a process of a
`torch.distributed` world: NCCL with one rank per card, or gloo on the CPU.
A mesh is a `DeviceMesh` named ("data", "model") over ranks
`arange(world).reshape(data, model)`, so the whole world's rank order is
the mesh's row-major order (the order of a tiled `all_gather` over every
mesh axis in JAX).

Where a JAX function takes `axis_name` (a mesh axis inside `shard_map`),
its counterpart takes the axis's process group, `mesh.get_group("data")`,
or None for one device. The helpers map JAX's collectives:

    lax.psum / lax.pmin             -> psum / pmin (`all_reduce` SUM / MIN)
    all_gather(..., tiled=True)     -> all_gather_tiled (dim 0)
    psum_scatter(..., tiled=True)   -> psum_scatter_tiled (dim 0)
    lax.axis_index / lax.axis_size  -> axis_index / axis_size
    collectives over mesh.axis_names -> mesh_group, mesh_index

With a group of one rank every collective is the identity, so a world of
one gives the single-device call's result bit for bit.

`shutdown_distributed` leaves the world (counterpart of
`jax.distributed.shutdown`); `init_distributed` also registers it to run
at exit. It exists because `destroy_process_group` alone does not end the
backend's worker threads: a `DeviceMesh` keeps its groups alive until the
mesh is freed, which for a mesh held to the end is while the interpreter
finalizes. A gloo worker that then drops the last reference to a tensor
of its last collective (Python let go of it first) needs the GIL, and
Python 3.12 ends a thread that asks for the GIL during finalization with
`pthread_exit`, whose unwinding through the worker's C++ frames calls
`std::terminate`: the rank aborts ("terminate called without an active
exception") after its work is done, more often the busier the machine.
"""

from __future__ import annotations

import atexit
import gc
import os
import weakref
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from sift_tpu_torch.config import MeshConfig


def init_distributed(device=None, init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> torch.device:
    """Join the process group (counterpart of `jax.distributed.initialize`)
    and return this rank's device.

    `device`: None or "cuda" joins with NCCL and binds `cuda:{local_rank}`
    (`LOCAL_RANK`, else the rank); "cpu" joins with gloo. There is no
    fall-back: without CUDA or NCCL a CUDA world raises. `init_method`,
    `rank`, `world_size`: as `torch.distributed.init_process_group`; None
    reads `torchrun`'s environment (`env://`: MASTER_ADDR, MASTER_PORT,
    RANK, WORLD_SIZE)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' for "
                               "a gloo world")
        if not dist.is_nccl_available():
            raise RuntimeError("this PyTorch has no NCCL")
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"unsupported device {dev}")
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=-1 if rank is None else rank,
                            world_size=-1 if world_size is None
                            else world_size)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                      dist.get_rank())))
        torch.cuda.set_device(dev)
    global _AT_EXIT
    if not _AT_EXIT:
        atexit.register(shutdown_distributed)
        _AT_EXIT = True
    return dev


# Meshes made by `make_mesh`, whose groups `shutdown_distributed` releases.
_MESHES: "weakref.WeakSet" = weakref.WeakSet()
_AT_EXIT = False


def shutdown_distributed() -> None:
    """Leave the world: destroy every process group, and release the groups
    that the meshes made by `make_mesh` still hold, so that the backend's
    worker threads end now, while the interpreter runs (the module
    docstring says why that matters). Idempotent; the meshes are unusable
    afterwards. `init_distributed` registers it with `atexit`, so a script
    that ends without it, or with `destroy_process_group` alone, is torn
    down the same way."""
    if dist.is_initialized():
        dist.destroy_process_group()
    for mesh in list(_MESHES):
        registry = getattr(mesh, "_pg_registry", None)
        if registry:
            registry.clear()
    gc.collect()


def make_mesh(cfg: Optional[MeshConfig] = None):
    """A (data, model) `DeviceMesh` over the whole world. With no config
    every rank goes on `data` (pure data parallel)."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if cfg is None:
        cfg = MeshConfig(data=world, model=1)
    if cfg.num_devices != world:
        raise ValueError(f"mesh {cfg} needs {cfg.num_devices} processes, "
                         f"the world has {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mesh = init_device_mesh(device_type, (cfg.data, cfg.model),
                            mesh_dim_names=tuple(cfg.axis_names))
    _MESHES.add(mesh)
    return mesh


def mesh_device(mesh) -> torch.device:
    """The device of this rank's part of `mesh`."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_size(mesh, name: str) -> int:
    """`lax.axis_size`: the mesh's extent along axis `name`."""
    return mesh.size(mesh.mesh_dim_names.index(name))


def axis_index(mesh, name: str) -> int:
    """`lax.axis_index`: this rank's coordinate along axis `name`."""
    return mesh.get_local_rank(name)


def mesh_index(mesh) -> int:
    """This rank's row-major index over every mesh axis."""
    idx = 0
    for name in mesh.mesh_dim_names:
        idx = idx * axis_size(mesh, name) + axis_index(mesh, name)
    return idx


def mesh_group(mesh):
    """The group of every rank of `mesh`, ranked in row-major mesh order:
    the world, which `make_mesh` lays out row-major."""
    if mesh.mesh.numel() != dist.get_world_size():
        raise ValueError("the mesh must span the whole world")
    return dist.group.WORLD


def _reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    if group is not None:
        dist.all_reduce(x, op=op, group=group)
    return x


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """`lax.psum` over `group` (None: one device), in place; returns x."""
    return _reduce(x, dist.ReduceOp.SUM, group)


def pmin(x: torch.Tensor, group) -> torch.Tensor:
    """`lax.pmin` over `group`, in place; returns x."""
    return _reduce(x, dist.ReduceOp.MIN, group)


def psum_many(group, *xs: torch.Tensor):
    """`psum` of several tensors of one dtype in one all-reduce; returns
    them in their shapes (the inputs as they are when `group` is None)."""
    if group is None:
        return xs
    flat = psum(torch.cat([x.reshape(-1) for x in xs]), group)
    return tuple(t.reshape(x.shape) for t, x in
                 zip(flat.split([x.numel() for x in xs]), xs))


def all_gather_tiled(x: torch.Tensor, group) -> torch.Tensor:
    """`all_gather(x, axis=0, tiled=True)`: the ranks' x concatenated
    along dim 0 in group-rank order, in x's memory layout. (A batched
    inverse is a batch of column-major matrices; the products that read it
    sum in an order that follows the layout, so a row-major copy would
    give other bits than on one device.)"""
    if group is None:
        return x
    # x with its trailing dims ordered by descending stride is contiguous.
    perm = [0] + sorted(range(1, x.dim()), key=lambda d: -x.stride(d))
    xp = x.permute(perm).contiguous()
    n = dist.get_world_size(group)
    out = torch.empty((n * xp.shape[0],) + tuple(xp.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, xp, group=group)
    return out.permute([perm.index(d) for d in range(x.dim())])


def psum_scatter_tiled(x: torch.Tensor, group) -> torch.Tensor:
    """`psum_scatter(x, scatter_dimension=0, tiled=True)`: the sum over
    the group, of which this rank keeps rows [r * n / size, (r + 1) * n /
    size)."""
    if group is None:
        return x
    n = dist.get_world_size(group)
    out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, x.contiguous(), group=group)
    return out


def pad_to_multiple(arr, multiple: int, axis: int = 0, fill=0):
    """Pad a numpy array or tensor so that shape[axis] is a multiple of
    `multiple`, with `fill`."""
    n = arr.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return arr
    if isinstance(arr, torch.Tensor):
        shape = list(arr.shape)
        shape[axis] = rem
        return torch.cat([arr, torch.full(shape, fill, dtype=arr.dtype,
                                          device=arr.device)], dim=axis)
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, rem)
    return np.pad(arr, pad, constant_values=fill)


def to_device(x, device) -> torch.Tensor:
    """A numpy array or tensor as a tensor on `device`."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device)


def shard_rows(x, index: int, count: int, device) -> torch.Tensor:
    """Rows [index * n / count, (index + 1) * n / count) of a numpy array
    or tensor (n divisible by count), as a tensor on `device`."""
    n = x.shape[0] // count
    return to_device(x[index * n:(index + 1) * n], device)
