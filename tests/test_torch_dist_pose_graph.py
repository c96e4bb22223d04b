"""Sharded pose graphs of the port (`dist.optimize_pose_graph_sharded`,
`optimize_pose_graph_sim3_sharded`, `slam/pose_graph.py`'s `axis_name`)
in a gloo world of 4 processes, against the JAX package's sharded graphs
on the same mesh shape (virtual CPU devices, in this process) and against
the port's single-device solve.

The graphs are the JAX suite's (`tests/multidevice/
test_sharded_pose_graph.py`): a 12-node loop with drift, lifted to Sim(3)
with scale drift; poses are held to its 1e-4. The edges are padded with
weight-0 edges to a multiple of the data axis. Every rank's poses must
equal rank 0's bit for bit; the (4, 1) and (2, 2) meshes cut the edges
into 4 and 2 shards, so they sum in other orders and agree to 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_tpu.config import MeshConfig as JaxMeshConfig
from sift_tpu.dist.mesh import make_mesh as jax_make_mesh
from sift_tpu.dist.pose_graph_dist import (
    optimize_pose_graph_sharded as jax_pg_sharded,
    optimize_pose_graph_sim3_sharded as jax_pg_sim3_sharded)
from sift_tpu.geometry import lie as jax_lie
from sift_tpu.geometry import sim3 as jax_sim3
from sift_tpu.slam.pose_graph import PoseGraph as JaxPoseGraph
from sift_tpu.slam.pose_graph import Sim3Graph as JaxSim3Graph

from sift_tpu_torch.slam.pose_graph import (PoseGraph, Sim3Graph,
                                            optimize_pose_graph,
                                            optimize_pose_graph_sim3)
from tests.torch_dist_world import World, one_torch_thread  # noqa: F401
from tests.unit.test_pose_graph import _compose_np, _make_loop

POSE_ATOL = 1e-4
# LM iterations: the JAX suite runs 15 and 12; each takes 64 CG steps, each
# step a collective, and fewer steps hold the port to JAX just as well.
ITERS = {6: 5, 7: 4}
FIELDS = ("poses", "edge_i", "edge_j", "edge_z", "edge_w", "fixed")

_BODY = '''
from sift_tpu_torch.config import MeshConfig
from sift_tpu_torch.dist import (make_mesh, optimize_pose_graph_sharded,
                                 optimize_pose_graph_sim3_sharded)
from sift_tpu_torch.slam.pose_graph import PoseGraph, Sim3Graph

FIELDS = ("poses", "edge_i", "edge_j", "edge_z", "edge_w", "fixed")
for shape in ((4, 1), (2, 2)):
    mesh = make_mesh(MeshConfig(data=shape[0], model=shape[1]))
    for D, cls, opt in ((6, PoseGraph, optimize_pose_graph_sharded),
                        (7, Sim3Graph, optimize_pose_graph_sim3_sharded)):
        g = cls(**{f: torch.from_numpy(IN[f"g{D}_{f}"]) for f in FIELDS})
        out = opt(mesh, g, iterations=int(IN[f"iters{D}"]))
        save(f"pg{D}_{shape[0]}x{shape[1]}", poses=out.poses.numpy())
'''


def _graphs():
    """{6: SE(3) graph, 7: Sim(3) graph} as numpy fields (the JAX suite's
    construction)."""
    gt, (ei, ej, z, w) = _make_loop(n=12, drift=0.03)
    n = gt.shape[0]
    init = [gt[0]]
    for k in range(n - 1):
        init.append(_compose_np(init[-1], z[k]).astype(np.float32))
    fixed = np.zeros(n, bool)
    fixed[0] = True
    g6 = dict(poses=np.stack(init), edge_i=ei, edge_j=ej, edge_z=z,
              edge_w=w, fixed=fixed)
    rng = np.random.default_rng(5)
    poses7 = np.concatenate(
        [g6["poses"], (rng.standard_normal((n, 1)) * 0.05).astype(np.float32)],
        -1)
    Rz, tz = jax_lie.se3_exp(jnp.asarray(z))
    ez7 = np.asarray(jax_sim3.sim3_log(jnp.ones((z.shape[0],), jnp.float32),
                                       Rz, tz))
    g7 = dict(g6, poses=poses7, edge_z=ez7)
    return {6: g6, 7: g7}


@pytest.fixture(scope="module")
def graphs():
    return _graphs()


@pytest.fixture(scope="module")
def world(graphs, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_pg")
    np.savez(tmp / "in.npz", iters6=ITERS[6], iters7=ITERS[7],
             **{f"g{D}_{f}": np.asarray(g[f]) for D, g in graphs.items()
                for f in FIELDS})
    return World(tmp, _BODY, 4)


@pytest.fixture(scope="module")
def jax_results(graphs, world, eight_devices):
    mesh = jax_make_mesh(JaxMeshConfig(data=4, model=1))
    out = {}
    for D, cls, opt in ((6, JaxPoseGraph, jax_pg_sharded),
                        (7, JaxSim3Graph, jax_pg_sim3_sharded)):
        g = cls(**{f: jnp.asarray(graphs[D][f]) for f in FIELDS})
        out[D] = np.asarray(opt(mesh, g, iterations=ITERS[D]).poses)
    world.wait(timeout=240)
    return out


def _port_single(g: dict, D: int) -> np.ndarray:
    cls, opt = (Sim3Graph, optimize_pose_graph_sim3) if D == 7 else \
        (PoseGraph, optimize_pose_graph)
    out = opt(cls(**{f: torch.tensor(g[f]) for f in FIELDS}),
              iterations=ITERS[D])
    return out.poses.numpy()


@pytest.mark.parametrize("D", [6, 7], ids=["se3", "sim3"])
def test_sharded_pose_graph_matches_jax_sharded(D, world, jax_results):
    got = world.assert_replicated(f"pg{D}_4x1")["poses"]
    np.testing.assert_allclose(got, jax_results[D], atol=POSE_ATOL)


@pytest.mark.parametrize("D", [6, 7], ids=["se3", "sim3"])
def test_sharded_pose_graph_matches_single_device(D, graphs, world,
                                                  jax_results):
    got = world.load(f"pg{D}_4x1")["poses"]
    ref = _port_single(graphs[D], D)
    np.testing.assert_allclose(got, ref, atol=POSE_ATOL)
    # The solve moved the poses: the loop closure spread the drift.
    assert np.abs(ref - graphs[D]["poses"]).max() > 10 * POSE_ATOL


@pytest.mark.parametrize("D", [6, 7], ids=["se3", "sim3"])
def test_sharded_pose_graph_mesh_shape_invariant(D, world, jax_results):
    a = world.load(f"pg{D}_4x1")["poses"]
    b = world.assert_replicated(f"pg{D}_2x2")["poses"]
    np.testing.assert_allclose(a, b, atol=POSE_ATOL)
