"""Distributed bundle adjustment over a (data, model) process mesh
(counterpart of `sift_tpu/dist/ba_dist.py`).

Layout:
  * observations shard over the `data` axis: residuals, Jacobians and every
    J^T J block sum run on the rank's shard and are combined by one
    all-reduce a segment sum;
  * landmark-block inversion shards over the `model` axis: each rank
    inverts L / model damped 3x3 blocks, reassembled by an all-gather;
  * poses, intrinsics and landmarks are replicated: the small state.

The whole LM loop (`run_ba`) runs unchanged on every rank. Its loops have
fixed trip counts and freeze by mask, so every rank issues the same
collectives in the same order, and an all-reduce gives every rank the
same bits, so the result is replicated and identical on every rank.
"""

from __future__ import annotations

from typing import Optional

from sift_tpu_torch.ba.solver import BAState, run_ba
from sift_tpu_torch.config import BAConfig
from sift_tpu_torch.dist.mesh import (axis_index, axis_size, mesh_device,
                                      pad_to_multiple, shard_rows, to_device)


def run_ba_sharded(mesh, poses, intrinsics, landmarks,
                   obs_cam, obs_lm, obs_uv, obs_valid,
                   cfg: BAConfig, fixed_cam_mask,
                   data_axis: str = "data",
                   model_axis: Optional[str] = "model",
                   v_mode: str = "psum") -> BAState:
    """Run distributed LM bundle adjustment on a mesh; every rank passes
    the same whole arrays (numpy or tensors) and gets the same `BAState`.

    The observation buffers are padded here to a multiple of the data axis
    (masked slots) and this rank keeps its shard; the landmark capacity is
    the caller's to choose divisible by the model axis (and, with
    `v_mode="reduce_scatter"`, by the data axis)."""
    n_data = axis_size(mesh, data_axis)
    if model_axis is not None and axis_size(mesh, model_axis) == 1:
        model_axis = None
    if model_axis is not None and \
            landmarks.shape[0] % axis_size(mesh, model_axis) != 0:
        raise ValueError(f"landmark capacity {landmarks.shape[0]} must "
                         f"divide by model axis {axis_size(mesh, model_axis)}")
    if v_mode == "reduce_scatter" and landmarks.shape[0] % n_data != 0:
        raise ValueError(f"v_mode='reduce_scatter' requires landmark "
                         f"capacity {landmarks.shape[0]} divisible by data "
                         f"axis {n_data}")

    dev = mesh_device(mesh)
    d = axis_index(mesh, data_axis)
    obs = [shard_rows(pad_to_multiple(o, n_data), d, n_data, dev)
           for o in (obs_cam, obs_lm, obs_uv, obs_valid)]
    return run_ba(to_device(poses, dev), to_device(intrinsics, dev),
                  to_device(landmarks, dev), *obs, cfg,
                  to_device(fixed_cam_mask, dev),
                  axis_name=mesh.get_group(data_axis),
                  landmark_axis=(None if model_axis is None
                                 else mesh.get_group(model_axis)),
                  v_mode=v_mode)
