"""Distribution layer of the PyTorch port (counterpart of `sift_tpu.dist`):
process meshes over `torch.distributed` (NCCL, one rank a card; gloo on
the CPU), sharded extraction and matching, and distributed bundle
adjustment and pose graphs, whose reductions are all-reduces over the
mesh's process groups. `dist.failure.Heartbeat` detects a dead peer
outside the collectives.

The exports load on first use: `ba/` and `slam/pose_graph.py` import the
collectives of `dist/mesh.py`, and `ba_dist.py` and `pose_graph_dist.py`
import those modules back, so importing them here would close the cycle.
"""

import importlib

_EXPORTS = {
    "make_mesh": "mesh",
    "pad_to_multiple": "mesh",
    "run_ba_sharded": "ba_dist",
    "extract_batch_sharded": "frontend_dist",
    "match_large_sharded": "matching_dist",
    "match_pairs_sharded": "matching_dist",
    "optimize_pose_graph_sharded": "pose_graph_dist",
    "optimize_pose_graph_sim3_sharded": "pose_graph_dist",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"),
                   name)


def __dir__():
    return sorted(list(globals()) + __all__)
