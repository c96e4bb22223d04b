"""Data-parallel SIFT extraction over a process mesh (counterpart of
`sift_tpu/dist/frontend_dist.py`).

Pure data parallel: the images split on the batch axis and each rank runs
the batched extractor (`extract_batch`, and with it the window, refine and
descriptor kernels on the card) on its B / world images, with no
communication. The extraction of an image does not depend on the other
images of its batch, so every mesh shape, and one `extract_batch` of the
whole batch, give the same bits.
"""

from __future__ import annotations

import torch

from sift_tpu_torch.config import SiftConfig
from sift_tpu_torch.dist.mesh import (all_gather_tiled, mesh_device,
                                      mesh_group, mesh_index, shard_rows)
from sift_tpu_torch.frontend.sift import extract_batch
from sift_tpu_torch.types import Keypoints


def extract_batch_sharded(mesh, imgs, cfg: SiftConfig,
                          with_descriptors: bool = True,
                          replicate: bool = False) -> Keypoints:
    """Extract over (B, H, W) with B split across every mesh axis in
    row-major order; every rank passes the same whole batch (numpy or a
    tensor) and copies only its B / world images to its device, uint8
    frames as they are (cast to f32 there).

    B must divide by the process count (pad with zero images and ignore
    their outputs). Returns this rank's images' `Keypoints`; with
    `replicate`, every field is all-gathered so that every rank holds the
    whole batch, as multi-process SLAM needs (every rank runs the same
    host tracking logic on it). The fields are f32, int32 and bool, which
    gloo and NCCL both take."""
    n = mesh.mesh.numel()
    if imgs.shape[0] % n != 0:
        raise ValueError(f"batch {imgs.shape[0]} must divide by the process "
                         f"count {n}")
    dev = mesh_device(mesh)
    local = shard_rows(imgs, mesh_index(mesh), n, dev).to(torch.float32)
    kp = extract_batch(local, cfg, with_descriptors, device=dev)
    if replicate:
        group = mesh_group(mesh)
        kp = kp.map(lambda a: all_gather_tiled(a, group))
    return kp
