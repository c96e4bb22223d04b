"""Synthetic SfM scenes with known ground truth (a copy of
`sift_tpu/io/synthetic.py`, kept in the port so that it never imports the
JAX package; numpy and scipy only). The BA tests and `chip_smoke.py` build
their problems with it; the same seed gives the same scene as the JAX
package's copy."""
from __future__ import annotations

import numpy as np


def make_scene(rng: np.random.Generator,
               num_cameras: int = 6,
               num_landmarks: int = 200,
               image_size=(640, 480),
               intrinsics=(500.0, 500.0, 320.0, 240.0),
               pixel_noise: float = 0.0,
               pose_noise: float = 0.0,
               landmark_noise: float = 0.0,
               drop_rate: float = 0.0):
    """Cameras on an arc looking at a landmark cloud.

    Returns a dict of numpy arrays matching `sift_tpu_torch.ba.run_ba` inputs plus
    ground truth: poses are world-from-camera se(3) tangents; observations
    are all (camera, landmark) pairs that project inside the image, with
    optional Gaussian pixel noise; `poses_init`/`landmarks_init` carry the
    perturbed initial estimates.
    """
    from scipy.spatial.transform import Rotation

    w, h = image_size
    fx, fy, cx, cy = intrinsics

    # Landmarks in a box in front of the rig.
    X = np.stack([
        rng.uniform(-4, 4, num_landmarks),
        rng.uniform(-3, 3, num_landmarks),
        rng.uniform(8, 16, num_landmarks),
    ], -1)

    # Cameras along an x-arc, with small look-at rotations toward the cloud.
    poses_R, poses_t = [], []
    for i in range(num_cameras):
        t = np.array([-2.0 + 4.0 * i / max(num_cameras - 1, 1),
                      0.1 * np.sin(i), 0.0])
        yaw = -0.05 * (i - num_cameras / 2)
        R = Rotation.from_euler("y", yaw).as_matrix()
        poses_R.append(R)
        poses_t.append(t)
    poses_R = np.stack(poses_R)
    poses_t = np.stack(poses_t)

    # se(3) log (world-from-camera).
    def se3_log_np(R, t):
        rv = Rotation.from_matrix(R).as_rotvec()
        theta = np.linalg.norm(rv)
        if theta < 1e-8:
            Vinv = np.eye(3)
        else:
            K = np.array([[0, -rv[2], rv[1]], [rv[2], 0, -rv[0]],
                          [-rv[1], rv[0], 0]])
            half = theta / 2
            Vinv = (np.eye(3) - 0.5 * K +
                    (1 - half * np.cos(half) / np.sin(half)) / theta ** 2 * K @ K)
        return np.concatenate([rv, Vinv @ t])

    poses_gt = np.stack([se3_log_np(R, t) for R, t in zip(poses_R, poses_t)])

    # Observations: project everything, keep in-image ones.
    obs_cam, obs_lm, obs_uv = [], [], []
    for c in range(num_cameras):
        Xc = (X - poses_t[c]) @ poses_R[c]      # R^T (X - t)
        z = Xc[:, 2]
        u = fx * Xc[:, 0] / z + cx
        v = fy * Xc[:, 1] / z + cy
        ok = (z > 0.1) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
        if drop_rate > 0:
            ok &= rng.uniform(size=num_landmarks) > drop_rate
        idx = np.nonzero(ok)[0]
        obs_cam.append(np.full(idx.shape, c, np.int32))
        obs_lm.append(idx.astype(np.int32))
        uv = np.stack([u[idx], v[idx]], -1)
        if pixel_noise > 0:
            uv = uv + rng.normal(0, pixel_noise, uv.shape)
        obs_uv.append(uv)

    obs_cam = np.concatenate(obs_cam)
    obs_lm = np.concatenate(obs_lm)
    obs_uv = np.concatenate(obs_uv).astype(np.float32)

    poses_init = poses_gt + rng.normal(0, pose_noise, poses_gt.shape)
    poses_init[0] = poses_gt[0]                  # gauge camera stays exact
    if num_cameras > 1:
        poses_init[1] = poses_gt[1]              # monocular scale gauge
    landmarks_init = X + rng.normal(0, landmark_noise, X.shape)

    return dict(
        poses_gt=poses_gt.astype(np.float32),
        landmarks_gt=X.astype(np.float32),
        poses_init=poses_init.astype(np.float32),
        landmarks_init=landmarks_init.astype(np.float32),
        intrinsics=np.asarray(intrinsics, np.float32),
        obs_cam=obs_cam, obs_lm=obs_lm, obs_uv=obs_uv,
        obs_valid=np.ones(obs_cam.shape[0], bool),
        image_size=image_size,
    )


def make_corridor_scene(rng: np.random.Generator,
                        num_cameras: int = 256,
                        num_landmarks: int = 32768,
                        obs_per_camera: int = 1024,
                        image_size=(1241, 376),
                        intrinsics=(718.856, 718.856, 607.19, 185.22),
                        depth_range=(2.0, 40.0),
                        pixel_noise: float = 0.3,
                        pose_noise: float = 0.02,
                        landmark_noise: float = 0.2):
    """Forward-motion corridor at map scale (the KITTI-shaped BA problem).

    Cameras advance along +z at ~1 m/frame with mild yaw wander; landmarks
    populate a corridor around the trajectory, so each camera sees only a
    LOCAL subset (visibility window = in-image AND depth in `depth_range`)
    — the sparsity structure of a real odometry map, unlike `make_scene`'s
    everything-sees-everything arc. Observation count is capped per camera
    (nearest-by-depth) to hit a target problem size deterministically.

    Defaults produce ~256 cams / 32k landmarks / ~250k observations.
    Returns the same dict schema as `make_scene`.
    """
    from scipy.spatial.transform import Rotation

    w, h = image_size
    fx, fy, cx, cy = intrinsics
    length = num_cameras * 1.0               # meters of corridor

    # Landmarks: uniform along the corridor, lateral spread widening with
    # height/side walls (a box cross-section around the path).
    X = np.stack([
        rng.uniform(-12, 12, num_landmarks),
        rng.uniform(-4, 3, num_landmarks),
        rng.uniform(-5.0, length + depth_range[1], num_landmarks),
    ], -1)

    poses_R, poses_t = [], []
    yaw = 0.0
    for i in range(num_cameras):
        yaw += rng.normal(0.0, 0.004)        # mild heading wander
        R = Rotation.from_euler("y", yaw).as_matrix()
        t = np.array([4.0 * np.sin(i / 40.0), 0.0, float(i)])
        poses_R.append(R)
        poses_t.append(t)
    poses_R = np.stack(poses_R)
    poses_t = np.stack(poses_t)

    def se3_log_np(R, t):
        rv = Rotation.from_matrix(R).as_rotvec()
        theta = np.linalg.norm(rv)
        if theta < 1e-8:
            Vinv = np.eye(3)
        else:
            K = np.array([[0, -rv[2], rv[1]], [rv[2], 0, -rv[0]],
                          [-rv[1], rv[0], 0]])
            half = theta / 2
            Vinv = (np.eye(3) - 0.5 * K +
                    (1 - half * np.cos(half) / np.sin(half))
                    / theta ** 2 * K @ K)
        return np.concatenate([rv, Vinv @ t])

    poses_gt = np.stack([se3_log_np(R, t) for R, t in zip(poses_R, poses_t)])

    obs_cam, obs_lm, obs_uv = [], [], []
    for c in range(num_cameras):
        Xc = (X - poses_t[c]) @ poses_R[c]
        z = Xc[:, 2]
        u = fx * Xc[:, 0] / z + cx
        v = fy * Xc[:, 1] / z + cy
        ok = ((z > depth_range[0]) & (z < depth_range[1])
              & (u >= 0) & (u < w) & (v >= 0) & (v < h))
        idx = np.nonzero(ok)[0]
        if idx.shape[0] > obs_per_camera:
            idx = idx[np.argsort(z[idx])[:obs_per_camera]]
        obs_cam.append(np.full(idx.shape, c, np.int32))
        obs_lm.append(idx.astype(np.int32))
        uv = np.stack([u[idx], v[idx]], -1)
        if pixel_noise > 0:
            uv = uv + rng.normal(0, pixel_noise, uv.shape)
        obs_uv.append(uv)

    obs_cam = np.concatenate(obs_cam)
    obs_lm = np.concatenate(obs_lm)
    obs_uv = np.concatenate(obs_uv).astype(np.float32)

    # Drop landmarks with <2 observations (untriangulatable rows would be
    # pure padding in the V blocks) and compact ids.
    counts = np.bincount(obs_lm, minlength=num_landmarks)
    keep = counts >= 2
    remap = -np.ones(num_landmarks, np.int64)
    remap[keep] = np.arange(int(keep.sum()))
    sel = keep[obs_lm]
    obs_cam, obs_lm, obs_uv = obs_cam[sel], remap[obs_lm[sel]].astype(
        np.int32), obs_uv[sel]
    X = X[keep]

    poses_init = poses_gt + rng.normal(0, pose_noise, poses_gt.shape)
    poses_init[0] = poses_gt[0]
    if num_cameras > 1:
        poses_init[1] = poses_gt[1]
    landmarks_init = X + rng.normal(0, landmark_noise, X.shape)

    return dict(
        poses_gt=poses_gt.astype(np.float32),
        landmarks_gt=X.astype(np.float32),
        poses_init=poses_init.astype(np.float32),
        landmarks_init=landmarks_init.astype(np.float32),
        intrinsics=np.asarray(intrinsics, np.float32),
        obs_cam=obs_cam, obs_lm=obs_lm, obs_uv=obs_uv,
        obs_valid=np.ones(obs_cam.shape[0], bool),
        image_size=image_size,
    )


def pad_observations(scene: dict, capacity: int) -> dict:
    """Pad observation arrays to a fixed capacity (static shapes)."""
    o = scene["obs_cam"].shape[0]
    assert capacity >= o, (capacity, o)
    pad = capacity - o
    out = dict(scene)
    out["obs_cam"] = np.pad(scene["obs_cam"], (0, pad))
    out["obs_lm"] = np.pad(scene["obs_lm"], (0, pad))
    out["obs_uv"] = np.pad(scene["obs_uv"], ((0, pad), (0, 0)))
    out["obs_valid"] = np.pad(scene["obs_valid"], (0, pad))
    return out
