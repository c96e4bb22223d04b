"""Distributed bundle adjustment of the port (`dist.run_ba_sharded`,
`ba/`'s `axis_name`, `landmark_axis` and `v_mode`, `refine_intrinsics`'s
`axis_name`) in a gloo world of 4 processes, against the JAX package's
`run_ba_sharded` on the same mesh shapes (8 virtual CPU devices, in this
process) and against the port's single-device `run_ba`.

Each rank and JAX's one device each sum the observation shards in their
own order, so states are held to the JAX suite's tolerances
(`tests/multidevice/test_sharded_ba.py`): poses 1e-4, RMSE 1e-3. Every
rank's replicated result must equal rank 0's bit for bit. The scene has
1023 observations, which divides by no mesh here, so the padding runs.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_tpu.ba.intrinsics import refine_intrinsics as jax_refine_intrinsics
from sift_tpu.config import BAConfig as JaxBAConfig
from sift_tpu.config import MeshConfig as JaxMeshConfig
from sift_tpu.dist.ba_dist import run_ba_sharded as jax_run_ba_sharded
from sift_tpu.dist.mesh import make_mesh as jax_make_mesh
from sift_tpu.io.synthetic import make_scene, pad_observations

from sift_tpu_torch.ba.intrinsics import refine_intrinsics
from sift_tpu_torch.ba.solver import run_ba
from sift_tpu_torch.config import BAConfig, MeshConfig, config_from_dict
from tests.torch_dist_world import World, one_torch_thread  # noqa: F401

KEYS = ("poses_init", "intrinsics", "landmarks_init", "obs_cam", "obs_lm",
        "obs_uv", "obs_valid")
POSE_ATOL, RMSE_ATOL = 1e-4, 1e-3
# (mesh shape, v_mode, solver): the dense window solve (C = 6) on every
# layout, matrix-free PCG on two.
CASES = [((4, 1), "psum", "auto"), ((2, 2), "psum", "auto"),
         ((4, 1), "reduce_scatter", "auto"),
         ((2, 2), "reduce_scatter", "auto"),
         ((2, 2), "psum", "pcg"), ((4, 1), "reduce_scatter", "pcg")]
BA_ITERS, CG_ITERS = 8, 40
INTR_SCALE = np.float32([1.03, 0.98, 1.01, 0.99])     # perturbed (fx..cy)


def _label(case):
    (d, m), v_mode, solver = case
    return f"{d}x{m}_{v_mode}_{solver}"


_BODY = '''
from sift_tpu_torch.ba.intrinsics import refine_intrinsics
from sift_tpu_torch.config import BAConfig, MeshConfig
from sift_tpu_torch.dist import make_mesh, run_ba_sharded

KEYS = ("poses_init", "intrinsics", "landmarks_init", "obs_cam", "obs_lm",
        "obs_uv", "obs_valid")
args = [IN[k] for k in KEYS]
fixed = IN["fixed"]
meshes = {}
for d, m, v_mode, solver in zip(IN["case_d"], IN["case_m"], IN["case_v"],
                                IN["case_s"]):
    d, m = int(d), int(m)
    mesh = meshes.setdefault((d, m), make_mesh(MeshConfig(data=d, model=m)))
    cfg = BAConfig(max_iterations=int(IN["ba_iters"]),
                   cg_iterations=int(IN["cg_iters"]), solver=str(solver))
    st = run_ba_sharded(mesh, *args, cfg=cfg, fixed_cam_mask=fixed,
                        v_mode=str(v_mode))
    save(f"ba_{d}x{m}_{v_mode}_{solver}",
         **{f: getattr(st, f).numpy() for f in
            ("poses", "landmarks", "cost", "rmse", "damping", "iterations",
             "cg_iters")})

# The divisibility checks, before any collective.
mesh41 = meshes[(4, 1)]
refused = []
for mesh, n_lms, v_mode in ((meshes[(2, 2)], 161, "psum"),
                            (mesh41, 162, "reduce_scatter")):
    lms = np.resize(args[2], (n_lms, 3))
    try:
        run_ba_sharded(mesh, args[0], args[1], lms, *args[3:],
                       cfg=BAConfig(max_iterations=1), fixed_cam_mask=fixed,
                       v_mode=v_mode)
    except ValueError as e:
        refused.append(str(e))
save("refused", messages=np.array(refused))

# Intrinsics refinement on the observation shards of the (4, 1) mesh.
from sift_tpu_torch.dist.mesh import pad_to_multiple, shard_rows
group = mesh41.get_group("data")
r = mesh41.get_local_rank("data")
obs = [shard_rows(pad_to_multiple(o, 4), r, 4, "cpu") for o in args[3:]]
K, rmse = refine_intrinsics(torch.from_numpy(IN["intr_init"]),
                            torch.from_numpy(IN["poses_gt"]),
                            torch.from_numpy(IN["landmarks_gt"]), *obs,
                            axis_name=group)
save("intrinsics", K=K.numpy(), rmse=rmse.numpy())
'''


@pytest.fixture(scope="module")
def scene():
    s = make_scene(np.random.default_rng(7), num_cameras=6,
                   num_landmarks=160, pose_noise=0.02, landmark_noise=0.1)
    s = pad_observations(s, 1023)
    fixed = np.zeros(6, bool)
    fixed[:2] = True
    s["fixed"] = fixed
    s["intr_init"] = (s["intrinsics"] * INTR_SCALE).astype(np.float32)
    return s


@pytest.fixture(scope="module")
def world(scene, tmp_path_factory):
    """One world of 4 ranks runs every case while JAX runs its side."""
    tmp = tmp_path_factory.mktemp("dist_ba")
    np.savez(tmp / "in.npz", **{k: v for k, v in scene.items()
                                if isinstance(v, np.ndarray)},
             case_d=[c[0][0] for c in CASES], case_m=[c[0][1] for c in CASES],
             case_v=[c[1] for c in CASES], case_s=[c[2] for c in CASES],
             ba_iters=BA_ITERS, cg_iters=CG_ITERS)
    return World(tmp, _BODY, 4)


@pytest.fixture(scope="module")
def jax_results(scene, world, eight_devices):
    args = [jnp.asarray(scene[k]) for k in KEYS]
    fixed = jnp.asarray(scene["fixed"])
    out = {}
    for case in CASES:
        (d, m), v_mode, solver = case
        st = jax_run_ba_sharded(
            jax_make_mesh(JaxMeshConfig(data=d, model=m)), *args,
            cfg=JaxBAConfig(max_iterations=BA_ITERS, cg_iterations=CG_ITERS,
                            solver=solver),
            fixed_cam_mask=fixed, v_mode=v_mode)
        out[_label(case)] = (np.asarray(st.poses), float(st.rmse))
    world.wait(timeout=240)
    return out


def _port_single(scene, solver):
    cfg = BAConfig(max_iterations=BA_ITERS, cg_iterations=CG_ITERS,
                   solver=solver)
    return run_ba(*[torch.from_numpy(scene[k]) for k in KEYS], cfg,
                  torch.from_numpy(scene["fixed"]))


@pytest.mark.parametrize("case", CASES, ids=_label)
def test_sharded_ba_matches_jax_sharded(case, world, jax_results):
    got = world.assert_replicated(f"ba_{_label(case)}")
    poses, rmse = jax_results[_label(case)]
    np.testing.assert_allclose(got["poses"], poses, atol=POSE_ATOL)
    np.testing.assert_allclose(float(got["rmse"]), rmse, atol=RMSE_ATOL)


@pytest.mark.parametrize("case", CASES, ids=_label)
def test_sharded_ba_matches_single_device(case, scene, world, jax_results):
    got = world.load(f"ba_{_label(case)}")
    ref = _port_single(scene, case[2])
    np.testing.assert_allclose(got["poses"], ref.poses.numpy(),
                               atol=POSE_ATOL)
    np.testing.assert_allclose(float(got["rmse"]), float(ref.rmse),
                               atol=RMSE_ATOL)
    assert int(got["iterations"]) == int(ref.iterations)
    assert float(got["rmse"]) < 0.05          # converged from 2% pose noise


def test_divisibility_checks_refuse(world, jax_results):
    msgs = list(world.assert_replicated("refused")["messages"])
    assert msgs == [
        "landmark capacity 161 must divide by model axis 2",
        "v_mode='reduce_scatter' requires landmark capacity 162 divisible "
        "by data axis 4"]


def test_sharded_intrinsics_refinement(scene, world, jax_results):
    """`refine_intrinsics(axis_name=)` on four observation shards against
    the port's and JAX's single-device refinement from the same start."""
    got = world.assert_replicated("intrinsics")
    args = [scene[k] for k in ("intr_init", "poses_gt", "landmarks_gt",
                               "obs_cam", "obs_lm", "obs_uv", "obs_valid")]
    K, rmse = refine_intrinsics(*map(torch.from_numpy, args))
    jK, jrmse = jax_refine_intrinsics(*map(jnp.asarray, args))
    np.testing.assert_allclose(got["K"], K.numpy(), rtol=1e-5)
    np.testing.assert_allclose(got["K"], np.asarray(jK), rtol=1e-4)
    np.testing.assert_allclose(float(got["rmse"]), float(rmse), atol=RMSE_ATOL)
    np.testing.assert_allclose(float(got["rmse"]), float(jrmse),
                               atol=RMSE_ATOL)
    assert np.abs(got["K"] / scene["intrinsics"] - 1).max() < 1e-3


def test_mesh_config_matches_jax():
    assert ({f.name: f.default for f in dataclasses.fields(MeshConfig)}
            == {f.name: f.default for f in dataclasses.fields(JaxMeshConfig)})
    j = JaxMeshConfig(data=2, model=2)
    cfg = config_from_dict(dataclasses.asdict(j))
    assert cfg == MeshConfig(data=2, model=2) and cfg.num_devices == 4
