"""The port's SLAM pipeline on a process mesh (`SfmPipeline(mesh=)`,
`run_global_ba(mesh=)`), the heartbeat (`dist/failure.py`) and the
kill -> detect -> restart cycle, in gloo worlds on the CPU.

- Chunked tracking on 8 rendered frames (`chip_smoke.make_sfm_sequence`
  at 180x240, chunks of 4) in worlds of 1 and 2: the world of 1 must give
  the single-device pipeline's trajectory bit for bit (a one-rank
  collective is the identity); the world of 2 extracts 2 frames a rank,
  whose low bits may move, so it is held to the JAX loopback test's
  criterion (`tests/multidevice/test_distributed_loopback.py:160-166`):
  the same frames tracked, positions within 5e-3 m. Every rank's
  trajectory must equal rank 0's bit for bit.
- `run_global_ba(mesh=)` against `run_global_ba()` on the same map:
  bit-identical in the world of 1, poses within 1e-4 and RMSE within 1e-3
  in the world of 2 (the sharded-BA tolerances).
- `tests/multidevice/test_fault_injection.py`'s cycle on gloo: a 2-rank
  BA checkpoints (`io/checkpoint.py`), rank 1 dies, rank 0 sees it stale
  through the heartbeat and exits with its own code instead of hanging;
  a 1-rank world resumes from the checkpoint and must equal the
  uninterrupted run chunked at the same boundary.
"""

import os
import time

import numpy as np
import pytest

import chip_smoke
from sift_tpu_torch.dist.failure import Heartbeat
from tests.torch_dist_world import World, one_torch_thread  # noqa: F401

H, W, N_FRAMES, BATCH = 180, 240, 8, 4
INTR = (chip_smoke.SFM_INTRINSICS[0], chip_smoke.SFM_INTRINSICS[1],
        W / 2.0, H / 2.0)

_SLAM = '''
from sift_tpu_torch.config import PipelineConfig
from sift_tpu_torch.dist import make_mesh
from sift_tpu_torch.slam.pipeline import SfmPipeline


def run(mesh):
    cfg = PipelineConfig(chunked_tracking=True, kf_max_interval=4)
    pipe = SfmPipeline(tuple(IN["intr"]), cfg, device="cpu", mesh=mesh)
    pipe.process_sequence(list(IN["frames"]), batch=int(IN["batch"]))
    return pipe


def save_run(name, pipe, mesh):
    """The trajectory, then global BA with and without the mesh from the
    same map."""
    out = dict(pos=pipe.positions(),
               tracked=np.array([r["tracked"] for r in pipe.trajectory]),
               chunks=pipe.chunk_stats["chunks"],
               keyframes=len(pipe.keyframes))
    poses0 = [kf.pose.copy() for kf in pipe.keyframes]
    lms0 = pipe.landmarks.copy()
    for tag, m in (("mesh", mesh), ("single", None)):
        for kf, p in zip(pipe.keyframes, poses0):
            kf.pose = p.copy()
        pipe.landmarks = lms0.copy()
        res = pipe.run_global_ba(mesh=m)
        out.update({f"gba_{tag}_{k}": v for k, v in res.items()})
        out[f"gba_{tag}_poses"] = np.stack([kf.pose for kf in pipe.keyframes])
        out[f"gba_{tag}_landmarks"] = pipe.landmarks.copy()
    save(name, **out)


mesh = make_mesh()
save_run("slam", run(mesh), mesh)
if WORLD == 1:
    save_run("slam_plain", run(None), mesh)
'''

_FAULT = '''
import time
from sift_tpu_torch.config import BAConfig, MeshConfig
from sift_tpu_torch.dist import make_mesh, run_ba_sharded
from sift_tpu_torch.dist.failure import Heartbeat
from sift_tpu_torch.io.checkpoint import restore_checkpoint, save_checkpoint

mode = sys.argv[4]
mesh = make_mesh(MeshConfig(data=WORLD, model=1))
KEYS = ("intrinsics", "obs_cam", "obs_lm", "obs_uv", "obs_valid")
CHUNK1, CHUNK2 = 3, 5


def chunk(poses, lms, damping_init, iters):
    cfg = BAConfig(max_iterations=iters, cg_iterations=30,
                   damping_init=damping_init)
    return run_ba_sharded(mesh, poses, IN["intrinsics"], lms,
                          *[IN[k] for k in KEYS[1:]], cfg=cfg,
                          fixed_cam_mask=IN["fixed"])


ckpt = os.path.join(DIR, "ba_ckpt.pt")
if mode == "fault":
    hb = Heartbeat(os.path.join(DIR, "hb"), RANK).start()
    assert hb.wait_for_peers(WORLD), "peers never appeared"
    st = chunk(IN["poses_init"], IN["landmarks_init"], 1e-3, CHUNK1)
    if RANK == 0:
        save_checkpoint(ckpt, {"poses": st.poses, "landmarks": st.landmarks,
                               "damping": st.damping})
    if RANK == 1:
        # Die only once the checkpoint exists (the survivor is then in its
        # detection loop, outside any collective).
        deadline = time.time() + 30.0
        while not os.path.exists(ckpt) and time.time() < deadline:
            time.sleep(0.05)
        os._exit(13)
    # Rank 0: detect the death instead of hanging in the next collective;
    # os._exit skips the process group's teardown, which waits on the peer.
    deadline = time.time() + 20.0
    while time.time() < deadline:
        if 1 in hb.stale_peers(WORLD, timeout_s=1.5):
            os._exit(17)
        time.sleep(0.1)
    os._exit(3)
elif mode == "resume":
    z = restore_checkpoint(ckpt)
    st = chunk(z["poses"], z["landmarks"], float(z["damping"]), CHUNK2)
    save("resumed", poses=st.poses.numpy())
else:
    st1 = chunk(IN["poses_init"], IN["landmarks_init"], 1e-3, CHUNK1)
    st2 = chunk(st1.poses, st1.landmarks, float(st1.damping), CHUNK2)
    save("golden", poses=st2.poses.numpy())
'''


@pytest.fixture(scope="module")
def slam(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_slam")
    frames, _ = chip_smoke.make_sfm_sequence(n=N_FRAMES, h=H, w=W)
    np.savez(tmp / "in.npz", frames=frames, intr=np.float32(INTR),
             batch=BATCH)
    ws = {n: World(tmp, _SLAM, n) for n in (1, 2)}
    for w in ws.values():
        w.wait(timeout=300)
    return {n: w.assert_replicated("slam") for n, w in ws.items()} | \
        {"plain": ws[1].load("slam_plain")}


def test_world_of_one_is_the_single_device_run(slam):
    got, want = slam[1], slam["plain"]
    assert int(want["chunks"]) >= 1          # the chunk stage ran
    assert want["tracked"].mean() > 0.8
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_world_of_two_tracks_as_one(slam):
    a, b = slam[1], slam[2]
    np.testing.assert_array_equal(a["tracked"], b["tracked"])
    np.testing.assert_allclose(a["pos"], b["pos"], atol=5e-3)


@pytest.mark.parametrize("n", [1, 2])
def test_global_ba_on_the_mesh(n, slam):
    r = slam[n]
    assert int(r["gba_mesh_n_cams"]) >= 2 and int(r["gba_mesh_n_obs"]) >= 24
    for k in ("n_cams", "n_lms", "n_obs"):
        assert int(r[f"gba_mesh_{k}"]) == int(r[f"gba_single_{k}"])
    if n == 1:
        for k in ("rmse", "poses", "landmarks"):
            np.testing.assert_array_equal(r[f"gba_mesh_{k}"],
                                          r[f"gba_single_{k}"])
    else:
        np.testing.assert_allclose(r["gba_mesh_poses"], r["gba_single_poses"],
                                   atol=1e-4)
        np.testing.assert_allclose(float(r["gba_mesh_rmse"]),
                                   float(r["gba_single_rmse"]), atol=1e-3)


def test_heartbeat_detects_stale_and_live_peers(tmp_path):
    a = Heartbeat(str(tmp_path), 0, interval_s=0.05).start()
    b = Heartbeat(str(tmp_path), 1, interval_s=0.05).start()
    try:
        assert a.wait_for_peers(2, timeout_s=5.0)
        assert a.stale_peers(2, timeout_s=1.0) == []
        b.stop()
        time.sleep(1.2)
        assert a.stale_peers(2, timeout_s=1.0) == [1]
        # a peer that never beat counts as stale too
        assert set(a.stale_peers(3, timeout_s=1.0)) == {1, 2}
    finally:
        a.stop()
        b.stop()
    assert not a._thread.is_alive() and not b._thread.is_alive()


def test_kill_one_rank_then_restart_smaller_mesh(tmp_path):
    from sift_tpu_torch.io.synthetic import make_scene, pad_observations
    scene = pad_observations(
        make_scene(np.random.default_rng(31), num_cameras=5,
                   num_landmarks=96, pose_noise=0.02, landmark_noise=0.1),
        512)
    fixed = np.zeros(5, bool)
    fixed[:2] = True
    for d in ("fault", "golden"):
        os.makedirs(tmp_path / d)
        np.savez(tmp_path / d / "in.npz", fixed=fixed,
                 **{k: v for k, v in scene.items()
                    if isinstance(v, np.ndarray)})
    golden = World(tmp_path / "golden", _FAULT, 1, args=["golden"])
    fault = World(tmp_path / "fault", _FAULT, 2, args=["fault"])
    fault.wait(timeout=120, check=False)
    assert fault.returncodes == [17, 13], (fault.returncodes,
                                          fault.stderr[0][-2000:])
    assert (tmp_path / "fault" / "ba_ckpt.pt").exists()
    resumed = World(tmp_path / "fault", _FAULT, 1, args=["resume"])
    resumed.wait(timeout=120)
    golden.wait(timeout=120)
    np.testing.assert_allclose(resumed.load("resumed")["poses"],
                               golden.load("golden")["poses"], atol=5e-4)
