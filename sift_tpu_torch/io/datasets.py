"""Benchmark dataset loaders: TUM-RGBD and KITTI odometry (counterpart of
`sift_tpu/io/datasets.py`).

Host-side loaders that return frames + calibration + (when available)
ground-truth trajectories, in the formats the public benchmarks ship:

* TUM-RGBD: a sequence directory with `rgb.txt` / `depth.txt` /
  `groundtruth.txt` index files (timestamped relative paths) — frames are
  associated by nearest timestamp within a tolerance (the standard
  `associate.py` protocol from the TUM tools).
* KITTI odometry: `sequences/NN/image_0/*.png`, `sequences/NN/calib.txt`
  (P0 projection row), optional `poses/NN.txt` ground truth (3x4 row-major
  world-from-camera per line).

Images decode through `io/image.py` (PIL). The JAX package decodes depth
maps with its native library when that is built; PNG decoding is lossless,
so the arrays are the same either way.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

from sift_tpu_torch.io.image import load_image_gray

# TUM-RGBD FR1 default pinhole intrinsics (camera docs; rectified).
TUM_FR1_INTRINSICS = (517.3, 516.5, 318.6, 255.3)
TUM_FR2_INTRINSICS = (520.9, 521.0, 325.1, 249.7)
TUM_FR3_INTRINSICS = (535.4, 539.2, 320.1, 247.6)
TUM_DEPTH_SCALE = 5000.0         # depth png value -> meters divisor


@dataclass
class Frame:
    index: int
    timestamp: float
    gray: np.ndarray                      # (H, W) [0, 255]; uint8 when the
                                          # source is 8-bit gray, else f32
    depth: Optional[np.ndarray] = None    # (H, W) float32 meters (TUM)
    gray_right: Optional[np.ndarray] = None  # rectified right (KITTI stereo)
    gt_pose: Optional[np.ndarray] = None  # (4, 4) world-from-camera


@dataclass
class Sequence:
    frames: List[Frame]
    intrinsics: Tuple[float, float, float, float]
    name: str = ""
    baseline: Optional[float] = None      # stereo baseline, meters

    def __len__(self):
        return len(self.frames)

    def __iter__(self) -> Iterator[Frame]:
        return iter(self.frames)

    def gt_positions(self) -> Optional[np.ndarray]:
        if any(f.gt_pose is None for f in self.frames):
            return None
        return np.stack([f.gt_pose[:3, 3] for f in self.frames])

    def gt_poses(self) -> Optional[np.ndarray]:
        """(F, 4, 4) camera-to-world ground-truth poses, or None."""
        if any(f.gt_pose is None for f in self.frames):
            return None
        return np.stack([f.gt_pose for f in self.frames])


def _read_tum_index(path: str) -> List[Tuple[float, str]]:
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            out.append((float(parts[0]), parts[1]))
    return out


def _read_tum_groundtruth(path: str) -> List[Tuple[float, np.ndarray]]:
    """groundtruth.txt rows: ts tx ty tz qx qy qz qw -> (ts, 4x4)."""
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            v = [float(x) for x in line.split()]
            t = np.asarray(v[1:4])
            qx, qy, qz, qw = v[4:8]
            R = np.array([
                [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw),
                 2 * (qx * qz + qy * qw)],
                [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz),
                 2 * (qy * qz - qx * qw)],
                [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw),
                 1 - 2 * (qx * qx + qy * qy)],
            ])
            T = np.eye(4)
            T[:3, :3] = R
            T[:3, 3] = t
            out.append((v[0], T))
    return out


def _associate(a_ts: List[float], b_ts: List[float],
               max_dt: float) -> List[Tuple[int, int]]:
    """Greedy nearest-timestamp association (TUM associate.py protocol)."""
    pairs = []
    used = set()
    b_arr = np.asarray(b_ts)
    for i, t in enumerate(a_ts):
        if b_arr.size == 0:
            break
        j = int(np.argmin(np.abs(b_arr - t)))
        if abs(b_arr[j] - t) <= max_dt and j not in used:
            pairs.append((i, j))
            used.add(j)
    return pairs


def load_tum_rgbd(seq_dir: str,
                  intrinsics: Optional[Tuple[float, ...]] = None,
                  max_frames: Optional[int] = None,
                  stride: int = 1,
                  max_dt: float = 0.02,
                  with_depth: bool = True) -> Sequence:
    """Load a TUM-RGBD sequence directory."""
    if intrinsics is None:
        name = os.path.basename(os.path.normpath(seq_dir))
        if "freiburg2" in name:
            intrinsics = TUM_FR2_INTRINSICS
        elif "freiburg3" in name:
            intrinsics = TUM_FR3_INTRINSICS
        else:
            intrinsics = TUM_FR1_INTRINSICS

    rgb = _read_tum_index(os.path.join(seq_dir, "rgb.txt"))
    depth_path = os.path.join(seq_dir, "depth.txt")
    depth = _read_tum_index(depth_path) if (
        with_depth and os.path.exists(depth_path)) else []
    gt_path = os.path.join(seq_dir, "groundtruth.txt")
    gt = _read_tum_groundtruth(gt_path) if os.path.exists(gt_path) else []

    rgb_ts = [t for t, _ in rgb]
    d_pairs = dict(_associate(rgb_ts, [t for t, _ in depth], max_dt)) \
        if depth else {}
    g_pairs = dict(_associate(rgb_ts, [t for t, _ in gt], max_dt)) \
        if gt else {}

    frames = []
    for i in range(0, len(rgb), stride):
        ts, rel = rgb[i]
        gray = load_image_gray(os.path.join(seq_dir, rel), allow_uint8=True)
        d = None
        if i in d_pairs:
            d = load_image_gray(os.path.join(seq_dir, depth[d_pairs[i]][1]))
            d = d / TUM_DEPTH_SCALE
        gtp = gt[g_pairs[i]][1] if i in g_pairs else None
        frames.append(Frame(index=len(frames), timestamp=ts, gray=gray,
                            depth=d, gt_pose=gtp))
        if max_frames is not None and len(frames) >= max_frames:
            break
    return Sequence(frames=frames, intrinsics=tuple(intrinsics),
                    name=os.path.basename(os.path.normpath(seq_dir)))


def _read_kitti_calib(path: str):
    """calib.txt -> ((fx, fy, cx, cy), stereo_baseline_m or None).

    P0 is the left gray camera; P1's fourth column is -fx*baseline for the
    right gray camera of the rectified pair.
    """
    intr, baseline = None, None
    with open(path) as fh:
        for line in fh:
            if line.startswith("P0:"):
                v = [float(x) for x in line.split()[1:]]
                intr = (v[0], v[5], v[2], v[6])
            elif line.startswith("P1:"):
                v = [float(x) for x in line.split()[1:]]
                if v[0] != 0:
                    baseline = -v[3] / v[0]
    if intr is None:
        raise ValueError(f"no P0 entry in {path}")
    return intr, baseline


def load_kitti_odometry(root: str, sequence: str = "00",
                        max_frames: Optional[int] = None,
                        stride: int = 1,
                        stereo: bool = False) -> Sequence:
    """Load a KITTI odometry sequence (grayscale left camera, image_0;
    `stereo=True` also loads image_1 right frames)."""
    seq_dir = os.path.join(root, "sequences", sequence)
    img_dir = os.path.join(seq_dir, "image_0")
    right_dir = os.path.join(seq_dir, "image_1")
    files = sorted(f for f in os.listdir(img_dir) if f.endswith(".png"))
    intrinsics, baseline = _read_kitti_calib(
        os.path.join(seq_dir, "calib.txt"))

    # times.txt: one scientific-notation second per frame (real dialect);
    # fall back to a nominal 10 Hz when absent.
    times_path = os.path.join(seq_dir, "times.txt")
    times = None
    if os.path.exists(times_path):
        with open(times_path) as fh:
            times = [float(x) for x in fh.read().split()]

    poses_path = os.path.join(root, "poses", sequence + ".txt")
    gt_poses = []
    if os.path.exists(poses_path):
        with open(poses_path) as fh:
            for line in fh:
                v = [float(x) for x in line.split()]
                T = np.eye(4)
                T[:3, :4] = np.asarray(v).reshape(3, 4)
                gt_poses.append(T)

    frames = []
    for i in range(0, len(files), stride):
        gray = load_image_gray(os.path.join(img_dir, files[i]),
                               allow_uint8=True)
        gray_r = None
        if stereo:
            rp = os.path.join(right_dir, files[i])
            if os.path.exists(rp):
                gray_r = load_image_gray(rp, allow_uint8=True)
        gtp = gt_poses[i] if i < len(gt_poses) else None
        ts = times[i] if times is not None and i < len(times) \
            else float(i) * 0.1
        frames.append(Frame(index=len(frames), timestamp=ts,
                            gray=gray, gray_right=gray_r, gt_pose=gtp))
        if max_frames is not None and len(frames) >= max_frames:
            break
    return Sequence(frames=frames, intrinsics=intrinsics,
                    name=f"kitti-{sequence}", baseline=baseline)
