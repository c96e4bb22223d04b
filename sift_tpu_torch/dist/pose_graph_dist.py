"""Distributed pose-graph optimization: edges sharded over the mesh
(counterpart of `sift_tpu/dist/pose_graph_dist.py`).

The pattern of distributed BA (`ba_dist.py`): poses replicate, the edge
list shards over the `data` axis (padded with weight-0 edges), and every
per-node block sum of the Levenberg-Marquardt / CG solver gains one
all-reduce. SLAM pose graphs are edge-heavy (odometry, loop closures,
co-visibility), so the edges are what to split.
"""

from __future__ import annotations

from sift_tpu_torch.dist.mesh import (axis_index, axis_size, mesh_device,
                                      pad_to_multiple, shard_rows, to_device)
from sift_tpu_torch.slam.pose_graph import (PoseGraph, Sim3Graph,
                                            optimize_pose_graph,
                                            optimize_pose_graph_sim3)


def _sharded(mesh, graph: PoseGraph, optimize, iterations, cg_iterations,
             data_axis):
    n_data = axis_size(mesh, data_axis)
    dev = mesh_device(mesh)
    d = axis_index(mesh, data_axis)
    ei, ej, ez, ew = (shard_rows(pad_to_multiple(e, n_data), d, n_data, dev)
                      for e in (graph.edge_i, graph.edge_j, graph.edge_z,
                                graph.edge_w))   # padding has weight 0
    local = type(graph)(poses=to_device(graph.poses, dev), edge_i=ei,
                        edge_j=ej, edge_z=ez, edge_w=ew,
                        fixed=to_device(graph.fixed, dev))
    out = optimize(local, iterations=iterations, cg_iterations=cg_iterations,
                   axis_name=mesh.get_group(data_axis))
    return graph.replace(poses=out.poses)


def optimize_pose_graph_sharded(mesh, graph: PoseGraph,
                                iterations: int = 20,
                                cg_iterations: int = 64,
                                data_axis: str = "data") -> PoseGraph:
    """Distributed pose-graph LM: every rank passes the same whole graph
    and gets it back with the optimized poses (replicated, the same on
    every rank, on the mesh's device)."""
    return _sharded(mesh, graph, optimize_pose_graph, iterations,
                    cg_iterations, data_axis)


def optimize_pose_graph_sim3_sharded(mesh, graph: Sim3Graph,
                                     iterations: int = 20,
                                     cg_iterations: int = 64,
                                     data_axis: str = "data") -> Sim3Graph:
    """Distributed Sim(3) pose-graph LM (monocular scale-drift graphs):
    the edge sharding of the SE(3) version with 7-dof blocks."""
    return _sharded(mesh, graph, optimize_pose_graph_sim3, iterations,
                    cg_iterations, data_axis)
