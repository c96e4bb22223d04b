"""Incremental monocular / RGB-D SfM pipeline (counterpart of
`sift_tpu/slam/pipeline.py`, its default path).

Architecture: *host orchestrates, device computes*. Every numeric stage —
extraction, matching, two-view bootstrap, pose-only tracking,
triangulation, sliding-window Schur BA — is a function of tensors on the
pipeline's device, padded to the static capacities of `PipelineConfig`;
the host does only bookkeeping (keyframe policy, landmark ids,
observation lists) in numpy. Each stage's inputs go up as ONE pinned
host-to-device copy (`_upload_many`) and its outputs come down as ONE
packed buffer (`_read`), so a frame that tracks against the cached local
map and is not promoted makes one host sync: the read of its (8,) result.

Pipeline states:
  bootstrap — accumulate frames against the first keyframe until parallax
              and match count allow a two-view initialization (E-vs-H
              RANSAC over `boot_attempts` draws, selected by
              triangulation health; map scale gauge |t| = 1), or, with a
              depth map, back-project the first frame (RGB-D).
  tracking  — per frame: guided matching against the local map and robust
              pose-only GN; on keyframe promotion: match the last keyframe,
              add observations, triangulate new landmarks, run
              sliding-window BA with the two oldest window cameras fixed.
              After `reloc_after_lost` lost frames, relocalize against the
              keyframes the global descriptor index votes for.

Randomness comes from one `torch.Generator` on the device, seeded by
`seed`. Every stage also takes its Gumbel noise as tensors (the JAX
package's draws, in the tests). Of the JAX stages' `vmap`s, the
relocalization and loop-closure probes' candidates are
`torch.func.vmap`ped and the bootstrap's attempts are a loop on the
device.

Loop closure: each promoted keyframe probes the old keyframes the global
index votes for (one batched stage), an accepted closure adds a loop edge
to the pose graph, fuses the old landmarks into the new keyframe's, and
optimizes the graph (SE(3), or Sim(3) with `pose_graph_sim3`) in one
stage with one packed read; landmarks follow their creating keyframe's
correction. Map maintenance: `compact_landmarks` (also every
`compact_interval_kf` promotions), `cull_keyframes`, `run_global_ba`,
`save_map` / `load_map`. Not ported (each raises `NotImplementedError`
naming the option): chunked tracking, asynchronous BA, stereo and meshes.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from sift_tpu_torch.ba.pose_only import pose_ransac_refine
from sift_tpu_torch.ba.solver import run_ba
from sift_tpu_torch.config import PipelineConfig
from sift_tpu_torch.frontend.sift import extract_batch
from sift_tpu_torch.geometry import lie, lie_np, sim3
from sift_tpu_torch.geometry.camera import project as project_cam
from sift_tpu_torch.geometry.epipolar import estimate_relative_pose
from sift_tpu_torch.geometry.homography import (decompose_homography,
                                                ransac_homography)
from sift_tpu_torch.geometry.ransac import Noise, gumbel
from sift_tpu_torch.geometry.triangulation import triangulate_dlt
from sift_tpu_torch.matching.matcher import (match_descriptors,
                                             match_descriptors_guided)
from sift_tpu_torch.slam.pose_graph import (PoseGraph, Sim3Graph,
                                            optimize_pose_graph,
                                            optimize_pose_graph_sim3)
from sift_tpu_torch.types import Keypoints, Matches
from sift_tpu_torch.utils.metrics import MetricsLogger

# Pose RANSAC hypotheses of promotions, relocalization and loop-closure
# probes (the JAX stages take `pose_ransac_refine`'s default).
_KF_HYPOTHESES = 8
# LM iterations of a pose-graph run (the JAX package's `_pgo_jit`).
_PGO_ITERATIONS = 15
# The loop probe's landmark table is padded to a multiple of this.
_LM_TABLE_PAD = 4096

_REFUSED_OPTIONS = (
    ("chunked_tracking", "device-resident chunked tracking"),
    ("ba_async", "asynchronous window BA"),
    ("ba_defer_kickoff", "the deferred window-BA kickoff"),
)


def _read(t: torch.Tensor) -> np.ndarray:
    """The stage's one device-to-host read."""
    return t.detach().cpu().numpy()


def _upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """One host array to `device`: from pinned memory with
    `non_blocking=True` on the card (a pageable copy would sync the
    stream), a private copy on the CPU."""
    t = torch.from_numpy(np.array(arr, copy=True, order="C"))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _np_kp(kp: Keypoints, subpixel: bool = False) -> Dict[str, np.ndarray]:
    """Host keypoint dict with (u, v) in original-image pixels.

    The small metadata fields come down packed in ONE read; the
    descriptors (and the validity mask, as `valid_t`) stay on the device,
    where every consumer of them runs."""
    packed = _read(torch.stack([kp.x, kp.y, kp.octave.to(torch.float32),
                                kp.valid.to(torch.float32)]))
    x, y = packed[0], packed[1]
    octave = packed[2].astype(np.int32)
    valid = packed[3] > 0.5
    d = dict(x=x, y=y, valid=valid, octave=octave, desc=kp.desc,
             valid_t=kp.valid)
    factor = np.exp2(octave.astype(np.float64))
    if subpixel:
        factor = factor / 2.0
    d["u"] = d["x"] * factor
    d["v"] = d["y"] * factor
    return d


# Host-side 6-dof pose arithmetic uses the numpy lie mirrors: a device
# call for a single (6,) op would cost a launch and a sync for nanoseconds
# of math.
def _se3_exp_np(xi):
    return lie_np.se3_exp(np.asarray(xi, np.float32))


def _se3_log_np(R, t):
    return lie_np.se3_log(np.asarray(R, np.float32),
                          np.asarray(t, np.float32))


class Keyframe:
    def __init__(self, frame_idx: int, pose: np.ndarray,
                 kp: Dict[str, np.ndarray]):
        self.frame_idx = frame_idx
        self.pose = pose.astype(np.float32)       # (6,) world-from-camera
        self.kp = kp                              # host keypoint arrays
        n = kp["x"].shape[0]
        self.kp_lm = np.full((n,), -1, np.int64)  # keypoint slot -> landmark


class SfmPipeline:
    """Incremental monocular / RGB-D SfM. Feed frames with
    `process_frame(gray)` or `process_sequence(frames)`."""

    def __init__(self, intrinsics, cfg: Optional[PipelineConfig] = None,
                 seed: int = 0, logger: Optional[MetricsLogger] = None,
                 frontend=None, device=None, stereo_baseline=None,
                 mesh=None):
        """`frontend`: optional callable gray -> `Keypoints` (tensors on
        `device`) replacing the SIFT extractor; it gets the frame as an f32
        tensor on `device`. `device`: where every stage runs; None means
        "cuda", which raises without a card (pass "cpu" for the plain
        path). `seed` seeds the pipeline's `torch.Generator` on that
        device."""
        self.cfg = cfg or PipelineConfig()
        for name, what in _REFUSED_OPTIONS:
            if getattr(self.cfg, name):
                raise NotImplementedError(
                    f"PipelineConfig.{name}=True ({what}) is not ported")
        if stereo_baseline is not None:
            raise NotImplementedError(
                "stereo_baseline (matching/stereo.py) is not ported")
        if mesh is not None:
            raise NotImplementedError("mesh (dist/frontend_dist.py) is not "
                                      "ported")
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run the plain PyTorch path")
        self.K = np.asarray(intrinsics, np.float32)    # fx, fy, cx, cy
        self._K = _upload(self.K, self.device)
        self.logger = logger
        self.frontend = frontend
        self._seed = seed
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

        self.keyframes: List[Keyframe] = []
        self.landmarks = np.zeros((0, 3), np.float32)
        self.lm_ref_kf = np.zeros((0,), np.int64)   # creating keyframe index
        self.trajectory: List[Dict] = []
        self.state = "bootstrap"
        self._frame_idx = -1
        self._frames_since_kf = 0
        self._frames_lost = 0

        # Pose graph: odometry edges between consecutive keyframes plus
        # loop-closure edges; optimized on every accepted closure.
        self.pose_edges: List[Dict] = []
        self.num_loop_closures = 0
        # Per-candidate loop-probe outcomes (host bookkeeping): every
        # probed candidate's gate values, to see which gate (n_has, n_inl,
        # rmse) sits closest to its threshold.
        self.loop_probe_log: List[Dict] = []

        # Local-map cache: rebuilt only when the observation graph changes
        # (promotion, landmark fusion, load), not every tracked frame.
        self._map_version = 0
        self._local_map_cache = None

        # Global descriptor index (lazy; built at the first keyframe).
        self._global_index = None

        self._ba_cfg_track = self.cfg.ba.replace(
            max_iterations=self.cfg.ba_tracking_iterations,
            cg_iterations=self.cfg.ba_tracking_cg) \
            if self.cfg.ba_tracking_iterations > 0 else self.cfg.ba
        self._uv_div = 2.0 if self.cfg.sift.subpixel else 1.0
        fx, fy = float(self.K[0]), float(self.K[1])
        self._focal = (fx + fy) * 0.5

    def _next_key(self) -> torch.Generator:
        return self._gen

    def _upload_many(self, *arrays) -> List[torch.Tensor]:
        """Several host arrays in ONE copy to the device, as f32, split back
        there: bool arrays come back bool, integer arrays int64 (exact below
        2^24, far above the ids here), float arrays f32."""
        arrays = [np.asarray(a) for a in arrays]
        flat = np.concatenate([a.astype(np.float32).ravel() for a in arrays])
        dev = _upload(flat, self.device)
        out, off = [], 0
        for a in arrays:
            t = dev[off:off + a.size].reshape(a.shape)
            off += a.size
            if a.dtype == bool:
                t = t > 0.5
            elif np.issubdtype(a.dtype, np.integer):
                t = t.to(torch.int64)
            out.append(t)
        return out

    # ------------------------------------------------------- device stages
    def _extract(self, gray: torch.Tensor) -> Keypoints:
        if self.frontend is not None:
            return self.frontend(gray)
        return self._extract_batch(gray[None]).map(lambda a: a[0])

    def _extract_batch(self, imgs: torch.Tensor) -> Keypoints:
        """(B, H, W) frames on the device, uint8 or f32; uint8 is cast to
        f32 on the device."""
        return extract_batch(imgs.to(torch.float32), self.cfg.sift, True,
                             device=self.device)

    def _match(self, da, va, db, vb) -> Matches:
        return match_descriptors(da, va, db, vb, self.cfg.match)

    def _guided_match(self, da, va, uv_pred, has_pred, db, vb, uv_b) -> Matches:
        return match_descriptors_guided(da, va, db, vb, uv_pred, has_pred,
                                        uv_b, self.cfg.guided_radius,
                                        self.cfg.match)

    def _project(self, pose, lms):
        return project_cam(pose, self._K, lms)

    def _uv_of(self, kp: Keypoints) -> torch.Tensor:
        """(N, 2) original-image pixel positions of device keypoints."""
        factor = torch.exp2(kp.octave.to(torch.float32)) / self._uv_div
        return torch.stack([kp.x * factor, kp.y * factor], -1)

    def _track_local(self, noise: Noise, init_pose, desc_ref, valid_ref,
                     lms_ref, kp: Keypoints) -> torch.Tensor:
        """Per-frame tracking: landmark projection -> guided matching ->
        robust pose refinement; returns ONE packed (8,) buffer [pose (6),
        inlier count, rmse]. `noise`: a generator or the (H, M) Gumbel
        draw of `pose_ransac_refine`."""
        cfg = self.cfg
        uv_pred, z = project_cam(init_pose, self._K, lms_ref)
        has_pred = valid_ref & (z > 1e-6)
        uv_b = self._uv_of(kp)
        m = match_descriptors_guided(
            desc_ref, valid_ref, kp.desc, kp.valid, uv_pred, has_pred, uv_b,
            cfg.guided_radius, cfg.match)
        lms = lms_ref[m.idx_a.long()]
        uv = uv_b[m.idx_b.long()]
        pose, inliers, rmse = pose_ransac_refine(
            noise, init_pose, self._K, lms, uv, m.valid,
            num_hypotheses=cfg.tracking_ransac_hypotheses,
            iters=cfg.tracking_gn_iters, delta=cfg.ransac.inlier_threshold)
        n_inl = inliers.sum().to(torch.float32)
        return torch.cat([pose, n_inl[None], rmse[None]])

    def _tri_pair(self, pose_a, pose_b, pa, pb) -> torch.Tensor:
        """(M,) pixel pairs -> (M, 4) [X | good] (shared by `_triangulate`
        and the fused promotion stage)."""
        cfg = self.cfg
        fx, fy, cx, cy = (float(v) for v in self.K)
        na = torch.stack([(pa[:, 0] - cx) / fx, (pa[:, 1] - cy) / fy], -1)
        nb = torch.stack([(pb[:, 0] - cx) / fx, (pb[:, 1] - cy) / fy], -1)

        def P_of(pose):
            R, t = lie.se3_exp(pose)
            Rt, tt = lie.se3_inverse(R, t)
            return torch.cat([Rt, tt[:, None]], 1)

        Pa, Pb = P_of(pose_a), P_of(pose_b)
        X = triangulate_dlt(Pa, Pb, na, nb)
        xa = X @ Pa[:, :3].T + Pa[:, 3]
        za = xa[:, 2]
        zb = (X @ Pb[:, :3].T + Pb[:, 3])[:, 2]
        ra = xa[:, :2] / torch.clamp_min(za[:, None], 1e-6) - na
        err_px = torch.linalg.vector_norm(ra, dim=-1) * self._focal
        _, ta = lie.se3_exp(pose_a)
        _, tb = lie.se3_exp(pose_b)
        da = X - ta
        db = X - tb
        cosang = (da * db).sum(-1) / torch.clamp_min(
            torch.linalg.vector_norm(da, dim=-1)
            * torch.linalg.vector_norm(db, dim=-1), 1e-9)
        ang_ok = cosang < float(np.cos(np.radians(
            cfg.min_triangulation_angle_deg)))
        good = (za > 1e-3) & (zb > 1e-3) & ang_ok & \
            (err_px < cfg.max_reproj_error_px)
        return torch.cat([X, good.to(torch.float32)[:, None]], -1)

    def _kf_track(self, guided: bool, noise: Noise, init_pose, pose_ref,
                  desc_a, valid_a, lms_a, has_lm_a, uv_a, desc_b, valid_b,
                  uv_b) -> torch.Tensor:
        """Fused keyframe match + localize + candidate triangulation
        (promotions, relocalization probes): one packed buffer —
        [idx_a (M), idx_b (M), match_valid (M), inliers (M), X|good (4M,
        triangulated from pose_ref and the accepted pose for match rows
        without landmarks), pose (6), n_inl, rmse]."""
        cfg = self.cfg
        uv_pred, z = project_cam(init_pose, self._K, lms_a)
        has_pred = valid_a & has_lm_a & (z > 1e-6)
        if guided:
            m = match_descriptors_guided(
                desc_a, valid_a, desc_b, valid_b, uv_pred, has_pred, uv_b,
                cfg.guided_radius, cfg.match)
        else:
            m = match_descriptors(desc_a, valid_a, desc_b, valid_b, cfg.match)
        ia, ib = m.idx_a.long(), m.idx_b.long()
        pv = m.valid & has_lm_a[ia]
        lms = lms_a[ia]
        uv = uv_b[ib]
        pose, inliers, rmse = pose_ransac_refine(
            noise, init_pose, self._K, lms, uv, pv,
            num_hypotheses=_KF_HYPOTHESES, delta=cfg.ransac.inlier_threshold)
        tri = self._tri_pair(pose_ref, pose, uv_a[ia], uv)
        no_lm = m.valid & ~has_lm_a[ia]
        tri = torch.cat([tri[:, :3], (tri[:, 3] * no_lm.to(torch.float32))
                         [:, None]], -1)
        f32 = torch.float32
        return torch.cat([
            m.idx_a.to(f32), m.idx_b.to(f32), m.valid.to(f32),
            inliers.to(f32), tri.reshape(-1), pose,
            inliers.sum().to(f32)[None], rmse[None]])

    def _reloc_probe(self, noise: Noise, desc_bank, desc_q,
                     packed) -> torch.Tensor:
        """All relocalization candidates probed in one batch (`_kf_track`
        unguided, `torch.func.vmap`ped over the rows of `desc_bank`).

        `packed` (device f32, one upload): [valid_bank K*N | lms_bank
        K*N*3 | has_bank K*N | uv_bank K*2N | poses K*6 | valid_q N |
        uv_q 2N]. `noise`: a generator or the (K, H, M) Gumbel draws of
        the candidates' pose RANSAC. Returns (K, 8*M + 8) payloads."""
        Kc, N = desc_bank.shape[0], desc_bank.shape[1]
        sizes = [Kc * N, Kc * N * 3, Kc * N, Kc * 2 * N, Kc * 6, N, 2 * N]
        parts = torch.split(packed, sizes)
        valid_q = parts[5] > 0.5
        uv_q = parts[6].reshape(N, 2)
        if isinstance(noise, torch.Generator):
            noise = gumbel(noise, (Kc, _KF_HYPOTHESES,
                                   self.cfg.match.max_matches), desc_q.device)

        def one(noise_k, pose_k, desc_k, valid_k, lms_k, has_k, uv_k):
            return self._kf_track(False, noise_k, pose_k, pose_k, desc_k,
                                  valid_k, lms_k, has_k, uv_k, desc_q,
                                  valid_q, uv_q)

        return torch.func.vmap(one)(
            noise, parts[4].reshape(Kc, 6), desc_bank,
            parts[0].reshape(Kc, N) > 0.5, parts[1].reshape(Kc, N, 3),
            parts[2].reshape(Kc, N) > 0.5, parts[3].reshape(Kc, N, 2))

    def _loop_probe(self, noise: Noise, new_pose, desc_bank, desc_q, packed,
                    lm_table) -> torch.Tensor:
        """All loop-closure candidates probed in one batch: match ->
        2D-3D gather -> robust localize, `torch.func.vmap`ped over the
        rows of `desc_bank`.

        `packed` (device f32, one upload): [kp_lm_bank K*N | valid_bank
        K*N | uv_q 2N | valid_q N | cand_ok K]; ids travel as f32 (exact
        below 2^24). `lm_table` (Lpad, 3): the landmark table padded to a
        multiple of 4096 rows. `noise`: a generator or the (K, H, M)
        Gumbel draws of the candidates' pose RANSAC. Returns (K, 9 +
        3*M): [pose 6 | n_has | n_inl | rmse | idx_b | lm_of | inlier] per
        candidate."""
        Kc, N = desc_bank.shape[0], desc_bank.shape[1]
        kp_lm, valid_bank, uv_q, valid_q, cand_ok = torch.split(
            packed, [Kc * N, Kc * N, 2 * N, N, Kc])
        kp_lm = kp_lm.reshape(Kc, N).to(torch.int64)
        valid_bank = valid_bank.reshape(Kc, N) > 0.5
        uv_q = uv_q.reshape(N, 2)
        valid_q = valid_q > 0.5
        cand_ok = cand_ok > 0.5
        Lpad = lm_table.shape[0]
        if isinstance(noise, torch.Generator):
            noise = gumbel(noise, (Kc, _KF_HYPOTHESES,
                                   self.cfg.match.max_matches), desc_q.device)

        def one(noise_k, desc_k, valid_k, kp_lm_k, ok_k):
            m = match_descriptors(desc_k, valid_k, desc_q, valid_q,
                                  self.cfg.match)
            lm_of = kp_lm_k[m.idx_a.long()]
            has = m.valid & (lm_of >= 0) & ok_k
            lms = lm_table[torch.clamp(lm_of, 0, Lpad - 1)]
            uv = uv_q[m.idx_b.long()]
            pose, inl, rmse = pose_ransac_refine(
                noise_k, new_pose, self._K, lms, uv, has,
                num_hypotheses=_KF_HYPOTHESES,
                delta=self.cfg.ransac.inlier_threshold)
            inl = inl & has
            f32 = torch.float32
            return torch.cat([
                pose, has.sum().to(f32)[None], inl.sum().to(f32)[None],
                rmse.to(f32)[None], m.idx_b.to(f32), lm_of.to(f32),
                inl.to(f32)])

        return torch.func.vmap(one)(noise, desc_bank, valid_bank, kp_lm,
                                    cand_ok)

    def _pgo(self, poses, ei, ej, ez, ew, fixed) -> torch.Tensor:
        """SE(3) pose-graph solve: (N, 6) optimized poses."""
        graph = PoseGraph(poses=poses, edge_i=ei, edge_j=ej, edge_z=ez,
                          edge_w=ew, fixed=fixed)
        return optimize_pose_graph(graph, iterations=_PGO_ITERATIONS).poses

    def _pgo_sim3(self, old6, ei, ej, ez6, sig, ew, fixed) -> torch.Tensor:
        """Sim(3) pose-graph stage: the edges' similarity logs from their
        SE(3) logs and scale sigmas, the solve from the SE(3) poses at
        sigma = 0, and each node's delta D = S_new S_old^-1. Returns ONE
        packed (N, 25) buffer [sd | Rd 9 | td 3 | R_new 9 | t_new 3]."""
        Rz, tz = lie.se3_exp(ez6)
        ez7 = sim3.sim3_log(torch.exp(sig), Rz, tz)
        old7 = sim3.from_se3(old6)
        graph = Sim3Graph(poses=old7, edge_i=ei, edge_j=ej, edge_z=ez7,
                          edge_w=ew, fixed=fixed)
        out = optimize_pose_graph_sim3(graph,
                                       iterations=_PGO_ITERATIONS).poses
        s_new, R_new, t_new = sim3.sim3_exp(out)
        sd, Rd, td = sim3.sim3_compose(
            s_new, R_new, t_new, *sim3.sim3_inverse(*sim3.sim3_exp(old7)))
        return torch.cat([sd[:, None], Rd.reshape(-1, 9), td,
                          R_new.reshape(-1, 9), t_new], -1)

    def _bootstrap(self, noise, pa, pb, valid):
        """Two-view initialization with H-vs-E model selection over
        `boot_attempts` independent draws, the best by triangulation health
        (n_good); the attempts run one after another on the device.
        `noise`: a generator, or the pair of (A, H, M) Gumbel draws of the
        attempts' essential and homography RANSAC. Returns (R, t, X, good,
        n_inl, success, use_h) of the best attempt, on the device."""
        cfg = self.cfg
        fx, fy, cx, cy = (float(v) for v in self.K)
        focal = self._focal
        na = torch.stack([(pa[:, 0] - cx) / fx, (pa[:, 1] - cy) / fy], -1)
        nb = torch.stack([(pb[:, 0] - cx) / fx, (pb[:, 1] - cy) / fy], -1)
        eye = torch.eye(3, 4, dtype=na.dtype, device=na.device)
        cfg_h = cfg.ransac.replace(
            inlier_threshold=cfg.ransac.inlier_threshold / focal)
        if isinstance(noise, torch.Generator):
            shape = (cfg.boot_attempts, cfg.ransac.num_hypotheses,
                     valid.shape[0])
            noise = (gumbel(noise, shape, na.device),
                     gumbel(noise, shape, na.device))

        def recon(R, t, inliers):
            """Triangulate and health-check one candidate motion."""
            P2 = torch.cat([R, t[:, None]], 1)
            X = triangulate_dlt(eye, P2, na, nb)          # world = camera A
            za = X[:, 2]
            zb = (X @ R.T + t)[:, 2]
            good = inliers & (za > 1e-3) & (zb > 1e-3)
            ra = X[:, :2] / torch.clamp_min(za[:, None], 1e-6) - na
            err_px = torch.linalg.vector_norm(ra, dim=-1) * focal
            return X, good & (err_px < cfg.max_reproj_error_px)

        def attempt(ne, nh):
            Re, te, est_e = estimate_relative_pose(ne, na, nb, valid,
                                                   cfg.ransac, focal=focal)
            est_h = ransac_homography(nh, na, nb, valid, cfg_h)
            Rh, th, _, _ = decompose_homography(
                est_h.model, na, nb, est_h.inliers.to(torch.float32))
            Xe, good_e = recon(Re, te, est_e.inliers)
            Xh, good_h = recon(Rh, th, est_h.inliers)
            ng_e = (good_e & est_e.success).sum()
            ng_h = (good_h & est_h.success).sum()
            use_h = ng_h.to(torch.float32) > 1.1 * ng_e.to(torch.float32)
            return (torch.where(use_h, Rh, Re), torch.where(use_h, th, te),
                    torch.where(use_h, Xh, Xe),
                    torch.where(use_h, good_h, good_e),
                    torch.where(use_h, est_h.num_inliers, est_e.num_inliers),
                    torch.where(use_h, est_h.success, est_e.success), use_h)

        outs = [torch.stack(f) for f in zip(*(
            attempt(ne, nh) for ne, nh in zip(*noise)))]
        score = torch.where(outs[5], outs[3].sum(dim=-1), -1)
        best = torch.argmax(score).reshape(1)
        return tuple(f.index_select(0, best)[0] for f in outs)

    def _localize(self, noise: Noise, pose_init, lms, uv, valid):
        return pose_ransac_refine(noise, pose_init, self._K, lms, uv, valid,
                                  delta=self.cfg.ransac.inlier_threshold)

    def _triangulate(self, pose_a, pose_b, pa, pb) -> torch.Tensor:
        """Fixed-capacity standalone triangulation: PACKED (N, 4) [X|good].
        Promotions get the same from `_kf_track`, against the pose it
        accepts."""
        return self._tri_pair(pose_a, pose_b, pa, pb)

    @staticmethod
    def _pack_ba(st) -> torch.Tensor:
        # one packed buffer per BA: poses | landmarks | rmse | iters
        f32 = torch.float32
        return torch.cat([st.poses.reshape(-1), st.landmarks.reshape(-1),
                          st.rmse.to(f32)[None], st.iterations.to(f32)[None]])

    def _window_ba(self, poses, lms, oc, ol, ouv, ov, fixed) -> torch.Tensor:
        """Window BA with the full `cfg.ba` budget (bootstrap)."""
        return self._pack_ba(run_ba(poses, self._K, lms, oc, ol, ouv, ov,
                                    self.cfg.ba, fixed))

    def _window_ba_track(self, poses, lms, oc, ol, ouv, ov,
                         fixed) -> torch.Tensor:
        """Window BA with the tracking budget (promotions)."""
        return self._pack_ba(run_ba(poses, self._K, lms, oc, ol, ouv, ov,
                                    self._ba_cfg_track, fixed))

    # ----------------------------------------------------------------- api
    def _frame_to_device(self, gray) -> torch.Tensor:
        """Upload one frame, in uint8 when it is uint8 and the built-in
        extractor runs (it casts to f32 on the device); injected frontends
        get f32."""
        gray = np.asarray(gray)
        if gray.dtype != np.uint8 or self.frontend is not None:
            gray = gray.astype(np.float32)
        return _upload(gray, self.device)

    def process_frame(self, gray: np.ndarray,
                      depth: Optional[np.ndarray] = None,
                      right: Optional[np.ndarray] = None) -> Dict:
        """Feed one grayscale frame ((H, W) [0, 255]); returns a dict with
        `pose` (6,), `tracked` (bool), `is_keyframe` (bool).

        `depth` (optional): metric depth that resolves the monocular scale
        gauge — an (H, W) map (RGB-D) or an (N,) per-keypoint array."""
        if right is not None:
            raise NotImplementedError("right= (stereo) is not ported")
        self._frame_idx += 1
        kp_dev = self._extract(self._frame_to_device(gray))
        if self.state == "bootstrap":
            kp = _np_kp(kp_dev, self.cfg.sift.subpixel)
            out = (self._bootstrap_rgbd(kp, depth) if depth is not None
                   else self._bootstrap_step(kp))
        else:
            out = self._tracking_step(kp_dev, depth)
        self._record(out)
        return out

    def _record(self, out: Dict) -> None:
        out["frame_idx"] = self._frame_idx
        self.trajectory.append(out)
        if self.logger is not None:
            self.logger.log("frame", **{k: v for k, v in out.items()
                                        if not isinstance(v, np.ndarray)})

    def _depth_at(self, kp: Dict[str, np.ndarray], depth: np.ndarray,
                  slots: np.ndarray) -> np.ndarray:
        """Per-keypoint depth (0 where invalid/out of range): samples a 2-D
        map at the keypoint pixels, or indexes a 1-D per-keypoint array."""
        if depth.ndim == 1:
            z = depth[slots]
        else:
            h, w = depth.shape
            u = np.clip(kp["u"][slots].astype(np.int64), 0, w - 1)
            v = np.clip(kp["v"][slots].astype(np.int64), 0, h - 1)
            z = depth[v, u]
        z = np.where(np.isfinite(z) & (z > self.cfg.depth_min)
                     & (z < self.cfg.depth_max), z, 0.0)
        return z

    def _backproject(self, kp, slots, z, pose) -> np.ndarray:
        """Keypoints + depth -> world points under `pose` (world-from-cam)."""
        fx, fy, cx, cy = self.K
        x = (kp["u"][slots] - cx) / fx * z
        y = (kp["v"][slots] - cy) / fy * z
        pts_c = np.stack([x, y, z], -1).astype(np.float32)
        R, t = _se3_exp_np(pose)
        return pts_c @ R.T + t

    def _bootstrap_rgbd(self, kp, depth: np.ndarray) -> Dict:
        """RGB-D bootstrap: landmarks from the first frame's depth map."""
        pose0 = np.zeros(6, np.float32)
        slots = np.nonzero(kp["valid"])[0]
        z = self._depth_at(kp, depth, slots)
        good = z > 0
        slots = slots[good]
        if slots.shape[0] < self.cfg.keyframe_min_inliers:
            return dict(pose=pose0, tracked=False, is_keyframe=False,
                        n_inliers=int(slots.shape[0]), state=self.state)
        self.landmarks = self._backproject(kp, slots, z[good], pose0)
        self.lm_ref_kf = np.zeros(slots.shape[0], np.int64)
        kf = Keyframe(self._frame_idx, pose0, kp)
        kf.kp_lm[slots] = np.arange(slots.shape[0])
        self.keyframes.append(kf)
        self._index_keyframe(len(self.keyframes) - 1, kf)
        self.state = "tracking"
        self._frames_since_kf = 0
        if self.logger is not None:
            self.logger.log("bootstrap_rgbd", n_landmarks=len(self.landmarks))
        return dict(pose=pose0, tracked=True, is_keyframe=True,
                    n_inliers=int(slots.shape[0]), state="tracking")

    def _chunk_to_device(self, chunk: List[np.ndarray],
                         batch: int) -> torch.Tensor:
        """Stack one chunk on the host (uint8 when every frame is uint8,
        else f32), pad it to `batch` frames with its last frame, and copy it
        to the device in one pinned, non-blocking copy."""
        chunk = [np.asarray(f) for f in chunk]
        if not all(f.dtype == np.uint8 for f in chunk):
            chunk = [f.astype(np.float32, copy=False) for f in chunk]
        imgs = np.stack(chunk + [chunk[-1]] * (batch - len(chunk)))
        return _upload(imgs, self.device)

    def process_sequence(self, frames, depths=None, rights=None,
                         batch: int = 8):
        """Process a frame sequence with batched extraction: the frontend
        runs over `batch`-frame chunks (one batched call each) and feeds
        the per-frame tracking logic from the chunk's keypoint tensors.

        frames: sequence of (H, W) arrays (equal shapes).
        depths: optional matching sequence of depth maps.
        Returns the list of per-frame result dicts."""
        if self.frontend is not None:
            raise ValueError("process_sequence uses the built-in extractor")
        if rights is not None:
            raise NotImplementedError("rights= (stereo) is not ported")
        cfg = self.cfg
        results = []
        n = len(frames)
        for start in range(0, n, batch):
            chunk = frames[start:start + batch]
            kp_batch = self._extract_batch(self._chunk_to_device(chunk, batch))
            for bi in range(len(chunk)):
                kp_i = kp_batch.map(lambda a, bi=bi: a[bi])
                self._frame_idx += 1
                depth = depths[start + bi] if depths is not None else None
                if self.state == "bootstrap":
                    kp = _np_kp(kp_i, cfg.sift.subpixel)
                    out = (self._bootstrap_rgbd(kp, depth)
                           if depth is not None
                           else self._bootstrap_step(kp))
                else:
                    out = self._tracking_step(kp_i, depth)
                self._record(out)
                results.append(out)
        self.finalize()
        return results

    def _decode_kf_payload(self, packed: np.ndarray, ref_kf: Keyframe):
        """Decode a `_kf_track` buffer on the host."""
        M = self.cfg.match.max_matches
        ia = packed[0:M].astype(np.int32)
        ib = packed[M:2 * M].astype(np.int32)
        valid = packed[2 * M:3 * M] > 0.5
        inl_slot = packed[3 * M:4 * M] > 0.5
        tri = packed[4 * M:8 * M].reshape(M, 4)
        pose = packed[8 * M:8 * M + 6].astype(np.float32)
        m = Matches(idx_a=ia, idx_b=ib,
                    distance=np.zeros((M,), np.float32), valid=valid)
        lm_of_match = ref_kf.kp_lm[ia]
        has_lm = valid & (lm_of_match >= 0)
        sel = np.nonzero(has_lm)[0]
        inliers = np.zeros((M,), bool)
        inliers[:sel.shape[0]] = inl_slot[sel]
        return pose, inliers, sel, m, lm_of_match, tri

    # ------------------------------------------------------ save / resume
    def save_map(self, path: str) -> None:
        """Serialize the SLAM state (keyframes, landmarks, pose graph,
        counters) to one .npz with the JAX package's array names; the
        generator's state takes the place of its `prng_key`. Every
        keyframe's descriptors come down in one read."""
        descs = _read(torch.stack([kf.kp["desc"] for kf in self.keyframes])) \
            if self.keyframes else []
        arrays = dict(
            landmarks=self.landmarks,
            lm_ref_kf=self.lm_ref_kf,
            intrinsics=self.K,
            generator_state=self._gen.get_state().numpy(),
            meta=np.asarray([self._frame_idx, self._frames_since_kf,
                             self._frames_lost, self.num_loop_closures,
                             1 if self.state == "tracking" else 0]),
            n_keyframes=np.asarray(len(self.keyframes)),
            edges_i=np.asarray([e["i"] for e in self.pose_edges], np.int32),
            edges_j=np.asarray([e["j"] for e in self.pose_edges], np.int32),
            edges_z=(np.stack([e["z"] for e in self.pose_edges])
                     if self.pose_edges else np.zeros((0, 6), np.float32)),
            edges_w=np.asarray([e["w"] for e in self.pose_edges], np.float32),
            edges_loop=np.asarray(
                [e.get("kind") == "loop" for e in self.pose_edges], bool),
            edges_sigma=np.asarray(
                [e.get("sigma", 0.0) for e in self.pose_edges], np.float32),
        )
        for i, kf in enumerate(self.keyframes):
            arrays[f"kf{i}_pose"] = kf.pose
            arrays[f"kf{i}_frame"] = np.asarray(kf.frame_idx)
            arrays[f"kf{i}_lm"] = kf.kp_lm
            for field in ("x", "y", "valid", "octave", "u", "v"):
                arrays[f"kf{i}_{field}"] = kf.kp[field]
            arrays[f"kf{i}_desc"] = descs[i]
        np.savez_compressed(path, **arrays)

    def load_map(self, path: str) -> None:
        """Restore state saved by `save_map` of either package (the
        configuration must match). A map the JAX package wrote carries a
        `prng_key` in place of the generator state: it is ignored and the
        generator reseeded from `seed`. Every keyframe's descriptors and
        validity go up in one copy."""
        z = np.load(path, allow_pickle=False)
        self.landmarks = z["landmarks"]
        self.lm_ref_kf = z["lm_ref_kf"]
        if "generator_state" in z.files:
            self._gen.set_state(torch.from_numpy(z["generator_state"]))
        else:
            self._gen.manual_seed(self._seed)
        meta = z["meta"]
        self._frame_idx = int(meta[0])
        self._frames_since_kf = int(meta[1])
        self._frames_lost = int(meta[2])
        self.num_loop_closures = int(meta[3])
        self.state = "tracking" if meta[4] else "bootstrap"
        n_kf = int(z["n_keyframes"])
        self.keyframes = []
        if n_kf:
            descs, valids = self._upload_many(
                np.stack([z[f"kf{i}_desc"] for i in range(n_kf)]),
                np.stack([z[f"kf{i}_valid"] for i in range(n_kf)]))
        for i in range(n_kf):
            kp = {f: z[f"kf{i}_{f}"]
                  for f in ("x", "y", "valid", "octave", "u", "v")}
            kp["desc"], kp["valid_t"] = descs[i], valids[i]
            kf = Keyframe(int(z[f"kf{i}_frame"]), z[f"kf{i}_pose"], kp)
            kf.kp_lm = z[f"kf{i}_lm"]
            self.keyframes.append(kf)
        self._map_version += 1
        self._local_map_cache = None
        self._global_index = None
        for i, kf in enumerate(self.keyframes):
            self._index_keyframe(i, kf)
        sig = z["edges_sigma"] if "edges_sigma" in z.files else \
            np.zeros(z["edges_i"].shape[0], np.float32)
        self.pose_edges = [
            dict(i=int(z["edges_i"][k]), j=int(z["edges_j"][k]),
                 z=z["edges_z"][k], w=float(z["edges_w"][k]),
                 kind="loop" if z["edges_loop"][k] else "odom",
                 sigma=float(sig[k]))
            for k in range(z["edges_i"].shape[0])]

    # ---------------------------------------------------------- trajectory
    def positions(self) -> np.ndarray:
        """Trajectory camera centers (F, 3) for evaluation."""
        out = []
        for rec in self.trajectory:
            _, t = _se3_exp_np(rec["pose"])
            out.append(t)
        return np.stack(out) if out else np.zeros((0, 3), np.float32)

    def poses_Rt(self):
        """Full trajectory poses: (F, 3, 3) rotations + (F, 3) centers,
        camera-to-world (the TUM trajectory convention; feed to
        io.trajectory.save_tum)."""
        Rs, ts = [], []
        for rec in self.trajectory:
            R, t = _se3_exp_np(rec["pose"])
            Rs.append(R)
            ts.append(t)
        if not Rs:
            return np.zeros((0, 3, 3), np.float32), np.zeros((0, 3),
                                                             np.float32)
        return np.stack(Rs), np.stack(ts)

    # ----------------------------------------------------------- bootstrap
    def _bootstrap_step(self, kp) -> Dict:
        pose0 = np.zeros(6, np.float32)
        if not self.keyframes:
            kf0 = Keyframe(self._frame_idx, pose0, kp)
            self.keyframes.append(kf0)
            self._index_keyframe(0, kf0)
            return dict(pose=pose0, tracked=True, is_keyframe=True,
                        n_inliers=0, state=self.state)

        kf0 = self.keyframes[0]
        m = self._match(kf0.kp["desc"], kf0.kp["valid_t"], kp["desc"],
                        kp["valid_t"])
        buf = _read(torch.stack([m.idx_a.to(torch.float32),
                                 m.idx_b.to(torch.float32),
                                 m.valid.to(torch.float32)]))
        ia, ib = buf[0].astype(np.int32), buf[1].astype(np.int32)
        valid = buf[2] > 0.5
        n_matches = int(valid.sum())
        if n_matches < self.cfg.min_bootstrap_matches:
            # Too little overlap: restart from this frame.
            if self._frame_idx - kf0.frame_idx > self.cfg.kf_max_interval:
                self.keyframes = [Keyframe(self._frame_idx, pose0, kp)]
                self._index_keyframe(0, self.keyframes[0])
            return dict(pose=pose0, tracked=False, is_keyframe=False,
                        n_inliers=n_matches, state=self.state)

        pa = np.stack([kf0.kp["u"][ia], kf0.kp["v"][ia]], -1)
        pb = np.stack([kp["u"][ib], kp["v"][ib]], -1)
        flow = np.linalg.norm(pa - pb, axis=-1)
        if np.median(flow[valid]) < self.cfg.min_bootstrap_parallax:
            return dict(pose=pose0, tracked=True, is_keyframe=False,
                        n_inliers=n_matches, state=self.state)

        pa_t, pb_t, valid_t = self._upload_many(pa, pb, valid)
        R, t, X, good, n_inl, success, use_h = self._bootstrap(
            self._next_key(), pa_t, pb_t, valid_t)
        M = valid.shape[0]
        buf = _read(torch.cat([
            R.reshape(-1), t, X.reshape(-1), good.to(torch.float32),
            torch.stack([n_inl.to(torch.float32), success.to(torch.float32),
                         use_h.to(torch.float32)])]))
        R, t = buf[:9].reshape(3, 3), buf[9:12]
        X = buf[12:12 + 3 * M].reshape(M, 3)
        good = buf[12 + 3 * M:12 + 4 * M] > 0.5
        n_inl = int(buf[-3])
        success, use_h = buf[-2] > 0.5, buf[-1] > 0.5
        # Acceptance gate: beyond RANSAC success, the map must be healthy —
        # most epipolar inliers must triangulate in front of both cameras
        # with low reprojection error.
        n_good = int(good.sum())
        if not success or n_good < max(
                self.cfg.min_bootstrap_matches // 2, int(0.5 * n_inl)):
            return dict(pose=pose0, tracked=False, is_keyframe=False,
                        n_inliers=n_inl, state=self.state)
        # A homography-selected bootstrap needs extra parallax: near the
        # gate H ~ I and its decomposition is noise. Deferred frames are
        # backfilled below once the bootstrap lands.
        if use_h and float(np.median(flow[valid])) < \
                self.cfg.h_parallax_factor * self.cfg.min_bootstrap_parallax:
            return dict(pose=pose0, tracked=True, is_keyframe=False,
                        n_inliers=n_inl, state=self.state)
        # World = first camera; second pose world-from-camera = (R^T, -R^T t).
        pose1 = _se3_log_np(R.T, -R.T @ t)

        sel = np.nonzero(good)[0]
        lm_ids = np.arange(sel.shape[0])
        self.landmarks = X[sel].astype(np.float32)
        self.lm_ref_kf = np.zeros(sel.shape[0], np.int64)
        kf1 = Keyframe(self._frame_idx, pose1, kp)
        kf0.kp_lm[ia[sel]] = lm_ids
        kf1.kp_lm[ib[sel]] = lm_ids
        self.keyframes.append(kf1)
        self._index_keyframe(1, kf1)
        self._add_odometry_edge(0, 1)

        self._run_window_ba(fix_first_n=2)
        self.state = "tracking"
        self._frames_since_kf = 0
        # Backfill bootstrap-pending frames along the accepted two-view
        # motion (they recorded identity poses while waiting).
        pose_new = self.keyframes[-1].pose
        r0, f1_ = kf0.frame_idx, self._frame_idx
        if f1_ - r0 > 1:
            rel = self._rel_pose(kf0.pose, pose_new)
            for rec in self.trajectory:
                fi = rec.get("frame_idx", -1)
                if r0 < fi < f1_:
                    frac = (fi - r0) / (f1_ - r0)
                    rec["pose"] = lie_np.boxplus(
                        kf0.pose, (frac * rel).astype(np.float32)
                    ).astype(np.float32)
                    rec["backfilled"] = True
        if self.logger is not None:
            self.logger.log("bootstrap", n_landmarks=len(self.landmarks),
                            n_inliers=n_inl)
        return dict(pose=self.keyframes[-1].pose, tracked=True,
                    is_keyframe=True, n_inliers=n_inl, state="tracking")

    # ------------------------------------------------------------ tracking
    def _match_and_localize(self, kp, ref_kf: Keyframe, init_pose,
                            guided: bool = False):
        """Match `kp` against a reference keyframe and localize on the 2D-3D
        correspondences: one upload, one fused stage, one packed read.
        Returns (pose, inliers, rmse, m, sel, lm_of_match, n_inl, tri)."""
        n_ref = ref_kf.kp["x"].shape[0]
        has = ref_kf.kp_lm >= 0
        if self.landmarks.shape[0] > 0:
            lms_a = self.landmarks[np.clip(ref_kf.kp_lm, 0,
                                           self.landmarks.shape[0] - 1)]
        else:
            lms_a = np.zeros((n_ref, 3), np.float32)
            has = np.zeros((n_ref,), bool)
        use_guided = bool(guided and self.cfg.guided_radius > 0 and
                          has.any())
        uv_a = np.stack([ref_kf.kp["u"], ref_kf.kp["v"]], -1)
        uv_b = np.stack([kp["u"], kp["v"]], -1)
        init_t, ref_t, lms_t, has_t, uv_a_t, uv_b_t = self._upload_many(
            np.asarray(init_pose, np.float32), ref_kf.pose,
            lms_a.astype(np.float32), has, uv_a.astype(np.float32),
            uv_b.astype(np.float32))
        packed = _read(self._kf_track(
            use_guided, self._next_key(), init_t, ref_t, ref_kf.kp["desc"],
            ref_kf.kp["valid_t"], lms_t, has_t, uv_a_t, kp["desc"],
            kp["valid_t"], uv_b_t))

        M = self.cfg.match.max_matches
        n_inl = int(packed[8 * M + 6])
        rmse = float(packed[8 * M + 7])
        pose, inliers, sel, m, lm_of_match, tri = \
            self._decode_kf_payload(packed, ref_kf)
        return pose, inliers, rmse, m, sel, lm_of_match, n_inl, tri

    def _index_keyframe(self, idx: int, kf: Keyframe) -> None:
        """Add a keyframe's descriptors to the global place-recognition
        index (lazily built to `max_pose_graph_nodes` keyframes)."""
        if not self.cfg.use_global_index:
            return
        if self._global_index is None:
            from sift_tpu_torch.matching.global_index import \
                GlobalDescriptorIndex
            self._global_index = GlobalDescriptorIndex(
                self.cfg.max_pose_graph_nodes, kf.kp["x"].shape[0],
                device=self.device)
        self._global_index.add(idx, kf.kp["desc"], kf.kp["valid_t"])

    def _candidate_keyframes(self, kp, k: int,
                             exclude_from: Optional[int] = None,
                             min_votes: int = 1) -> np.ndarray:
        """Relocalization candidate keyframe indices: descriptor-vote
        ranking from the global index when available, uniform probing
        otherwise (most recent first)."""
        n = len(self.keyframes)
        if self._global_index is not None:
            cand = self._global_index.top_candidates(
                kp["desc"], kp["valid_t"], k, exclude_from=exclude_from,
                min_votes=min_votes)
            return cand[cand < n]
        hi = (n if exclude_from is None else min(exclude_from, n)) - 1
        if hi < 0:
            return np.zeros((0,), int)
        return np.unique(np.linspace(0, hi,
                                     min(k, hi + 1)).astype(int))[::-1]

    def _attempt_relocalization(self, kp):
        """Probe the voted keyframes for a confident re-fix, all in one
        batched stage with one upload and one read; the decode keeps the
        best-candidate-first order. Returns (ref_kf_index, pose, m,
        inliers, sel, lm_of_match, tri) or None."""
        cfg = self.cfg
        cand = [int(oi) for oi in
                self._candidate_keyframes(kp, cfg.reloc_candidates)]
        cand = cand[:cfg.reloc_candidates]
        if not cand:
            return None
        Kc = len(cand)
        N = kp["x"].shape[0]
        valid_bank = np.zeros((Kc, N), np.float32)
        lms_bank = np.zeros((Kc, N, 3), np.float32)
        has_bank = np.zeros((Kc, N), np.float32)
        uv_bank = np.zeros((Kc, N, 2), np.float32)
        poses = np.zeros((Kc, 6), np.float32)
        for s, oi in enumerate(cand):
            ref = self.keyframes[oi]
            has = ref.kp_lm >= 0
            if self.landmarks.shape[0] > 0:
                lms_bank[s] = self.landmarks[np.clip(
                    ref.kp_lm, 0, self.landmarks.shape[0] - 1)]
            else:
                has = np.zeros_like(has)
            valid_bank[s] = ref.kp["valid"].astype(np.float32)
            has_bank[s] = has.astype(np.float32)
            uv_bank[s, :, 0] = ref.kp["u"]
            uv_bank[s, :, 1] = ref.kp["v"]
            poses[s] = ref.pose
        desc_bank = torch.stack([self.keyframes[oi].kp["desc"] for oi in cand])
        uv_q = np.stack([kp["u"], kp["v"]], -1).astype(np.float32)
        (packed_in,) = self._upload_many(np.concatenate([
            valid_bank.ravel(), lms_bank.ravel(), has_bank.ravel(),
            uv_bank.ravel(), poses.ravel(),
            kp["valid"].astype(np.float32), uv_q.ravel()]))
        out = _read(self._reloc_probe(self._next_key(), desc_bank,
                                      kp["desc"], packed_in))

        M = cfg.match.max_matches
        for s, oi in enumerate(cand):       # best-candidate first
            row = out[s]
            n_inl = int(row[8 * M + 6])
            rmse = float(row[8 * M + 7])
            if n_inl >= cfg.keyframe_min_inliers and \
                    rmse <= 2.0 * cfg.loop_max_rmse:
                pose, inl, sel, m, lm_of, tri = \
                    self._decode_kf_payload(row, self.keyframes[oi])
                if self.logger is not None:
                    self.logger.log("relocalized", ref_kf=int(oi),
                                    inliers=n_inl, rmse=rmse)
                return int(oi), pose, m, inl, sel, lm_of, tri
        return None

    def _build_local_map(self):
        """Deduplicated (descriptor, landmark-id) union of the window's
        keyframe observations, recent-first, padded to the static
        `local_map_size`. Returns (desc (M, D) on the device, valid (M,),
        lm_ids (M,), valid (M,) on the device), or None.

        Descriptors never touch the host: the window's per-keyframe
        descriptor tensors are concatenated and the deduplicated rows
        selected with one gather by a host-computed index vector. Cached
        until the map version changes (promotion)."""
        cfg = self.cfg
        if self._local_map_cache is not None and \
                self._local_map_cache[0] == self._map_version:
            return self._local_map_cache[1]

        window = self.keyframes[-cfg.window_size:]
        ids, rows = [], []
        for wi, kf in enumerate(reversed(window)):   # recent wins dedup
            slots = np.nonzero(kf.kp_lm >= 0)[0]
            n = kf.kp["x"].shape[0]
            ids.append(kf.kp_lm[slots])
            rows.append(wi * n + slots)              # rows into the concat
        result = None
        if ids:
            ids = np.concatenate(ids)
            rows = np.concatenate(rows)
            if ids.shape[0] > 0:
                # first occurrence == most recent observation per landmark
                _, first = np.unique(ids, return_index=True)
                first = np.sort(first)[:cfg.local_map_size]
                M = cfg.local_map_size
                k = first.shape[0]
                sel_rows = np.zeros((M,), np.int64)
                sel_rows[:k] = rows[first]
                out_ids = np.zeros((M,), np.int64)
                out_ids[:k] = ids[first]
                out_valid = np.zeros((M,), bool)
                out_valid[:k] = True
                window_desc = torch.cat([kf.kp["desc"]
                                         for kf in reversed(window)], dim=0)
                sel_t, valid_t = self._upload_many(sel_rows, out_valid)
                out_desc = window_desc.index_select(0, sel_t)
                result = (out_desc, out_valid, out_ids, valid_t)
        self._local_map_cache = (self._map_version, result)
        return result

    def _localize_local_map(self, kp_dev: Keypoints, init_pose):
        """Guided association against the local map; returns
        (pose, n_inliers, rmse) or None when no local map exists. One
        upload (the prediction and the current landmark positions), one
        fused stage and ONE packed (8,) read."""
        local = self._build_local_map()
        if local is None:
            return None
        desc_ref, _, lm_ids, valid_ref = local
        lms_ref = self.landmarks[np.clip(lm_ids, 0,
                                         max(self.landmarks.shape[0] - 1, 0))]
        pose_t, lms_t = self._upload_many(
            np.asarray(init_pose, np.float32), lms_ref.astype(np.float32))
        packed = _read(self._track_local(self._next_key(), pose_t, desc_ref,
                                         valid_ref, lms_t, kp_dev))
        return packed[:6].astype(np.float32), int(packed[6]), float(packed[7])

    def _predicted_pose(self) -> np.ndarray:
        """Constant-velocity prediction: advance the last tracked pose by the
        last inter-frame motion."""
        tracked = [r for r in self.trajectory if r.get("tracked")]
        if len(tracked) < 2:
            return self.keyframes[-1].pose
        p2 = np.asarray(tracked[-1]["pose"], np.float32)
        p1 = np.asarray(tracked[-2]["pose"], np.float32)
        vel = self._rel_pose(p1, p2)
        return lie_np.boxplus(p2, vel).astype(np.float32)

    def _tracking_step(self, kp_dev: Keypoints,
                       depth: Optional[np.ndarray] = None) -> Dict:
        """`kp_dev` holds the frame's keypoints on the device. The host
        keypoint dict is read lazily: a frame that tracks against the
        cached local map and is not promoted reads only its packed (8,)
        result."""
        kp_cache: Dict = {}

        def kp():
            if "v" not in kp_cache:
                kp_cache["v"] = _np_kp(kp_dev, self.cfg.sift.subpixel)
            return kp_cache["v"]

        kf = self.keyframes[-1]
        pred = self._predicted_pose()
        kf_assoc = None          # lazy: only promotions need the kf match
        hit = self._localize_local_map(kp_dev, pred) \
            if self.cfg.use_local_map else None
        if hit is not None:
            pose, n_inl, rmse = hit
        else:
            pose, inliers, rmse, m, sel, lm_of_match, n_inl, tri = \
                self._match_and_localize(kp(), kf, pred, guided=True)
            kf_assoc = (m, inliers, sel, lm_of_match, tri)
        tracked = n_inl >= self.cfg.keyframe_min_inliers // 2
        self._frames_since_kf += 1

        if not tracked:
            self._frames_lost += 1
            if self._frames_lost >= self.cfg.reloc_after_lost:
                hit = self._attempt_relocalization(kp())
                if hit is not None:
                    oi, pose, m, inliers, sel, lm_of_match, tri = hit
                    n_inl = int(inliers.sum())
                    # Promote immediately against the reloc reference so
                    # subsequent frames track from a fresh keyframe.
                    self._promote_keyframe(kp(), pose, m, inliers, sel,
                                           lm_of_match, tri, depth,
                                           ref_kf=self.keyframes[oi])
                    self._frames_since_kf = 0
                    self._frames_lost = 0
                    return dict(pose=self.keyframes[-1].pose, tracked=True,
                                is_keyframe=True, n_inliers=n_inl,
                                rmse=rmse, state=self.state)
        else:
            self._frames_lost = 0

        is_kf = tracked and (
            n_inl < self.cfg.kf_min_tracked or
            self._frames_since_kf >= self.cfg.kf_max_interval)
        if is_kf:
            if kf_assoc is None:
                # Local-map tracking: the promotion bookkeeping needs the
                # keyframe-aligned match; run it now, seeded by the
                # local-map pose.
                pose, inliers, rmse, m, sel, lm_of_match, _, tri = \
                    self._match_and_localize(kp(), kf, pose, guided=True)
            else:
                m, inliers, sel, lm_of_match, tri = kf_assoc
            self._promote_keyframe(kp(), pose, m, inliers, sel, lm_of_match,
                                   tri, depth)
            self._frames_since_kf = 0
            pose = self.keyframes[-1].pose
        return dict(pose=pose.astype(np.float32), tracked=tracked,
                    is_keyframe=is_kf, n_inliers=n_inl, rmse=float(rmse),
                    state=self.state)

    def _promote_keyframe(self, kp, pose, m, inliers, sel, lm_of_match,
                          tri: np.ndarray,
                          depth: Optional[np.ndarray] = None,
                          ref_kf: Optional[Keyframe] = None):
        """`ref_kf`: the keyframe the match `m` was computed against
        (defaults to the last keyframe; relocalization passes its hit).
        `tri`: (M, 4) [X | good] per match slot from the fused `_kf_track`
        stage, triangulated against the accepted pose."""
        kf_prev = ref_kf if ref_kf is not None else self.keyframes[-1]
        valid = np.asarray(m.valid)
        ia, ib = np.asarray(m.idx_a), np.asarray(m.idx_b)

        new_kf = Keyframe(self._frame_idx, pose, kp)
        # Carry over tracked landmark associations (inlier 2D-3D matches).
        inl_sel = sel[inliers[:sel.shape[0]]]
        new_kf.kp_lm[ib[inl_sel]] = lm_of_match[inl_sel]

        # New landmarks from unassociated 2D-2D matches.
        nsel = np.nonzero(valid & (kf_prev.kp_lm[ia] < 0))[0]
        gsel = np.nonzero(tri[nsel, 3] > 0.5)[0]
        if gsel.shape[0] > 0:
            base = self.landmarks.shape[0]
            new_ids = base + np.arange(gsel.shape[0])
            self.landmarks = np.concatenate(
                [self.landmarks, tri[nsel[gsel], :3].astype(np.float32)])
            kf_prev.kp_lm[ia[nsel[gsel]]] = new_ids
            new_kf.kp_lm[ib[nsel[gsel]]] = new_ids

        if depth is not None:
            # RGB-D: any still-unassociated keypoint with valid depth spawns
            # a metric landmark (no parallax requirement).
            free = np.nonzero(kp["valid"] & (new_kf.kp_lm < 0))[0]
            z = self._depth_at(kp, depth, free)
            good = z > 0
            free = free[good]
            if free.shape[0] > 0:
                base = self.landmarks.shape[0]
                self.landmarks = np.concatenate(
                    [self.landmarks,
                     self._backproject(kp, free, z[good], pose)])
                new_kf.kp_lm[free] = base + np.arange(free.shape[0])

        new_idx = len(self.keyframes)
        self.keyframes.append(new_kf)
        # Landmarks created this promotion reference the new keyframe.
        created = self.landmarks.shape[0] - self.lm_ref_kf.shape[0]
        if created > 0:
            self.lm_ref_kf = np.concatenate(
                [self.lm_ref_kf, np.full(created, new_idx, np.int64)])
        self._map_version += 1         # invalidate the local-map cache
        self._index_keyframe(new_idx, new_kf)
        self._add_odometry_edge(new_idx - 1, new_idx)
        if self.cfg.enable_loop_closure:
            self._try_loop_closure(new_idx)
        if self.cfg.compact_interval_kf and \
                (new_idx + 1) % self.cfg.compact_interval_kf == 0:
            self.compact_landmarks()
        self._run_window_ba(fix_first_n=2)
        if self.logger is not None:
            self.logger.log("keyframe", frame=self._frame_idx,
                            n_keyframes=len(self.keyframes),
                            n_landmarks=len(self.landmarks))

    def _rel_pose(self, xi_i: np.ndarray, xi_j: np.ndarray) -> np.ndarray:
        """log(T_i^-1 T_j) as numpy (6,) — host math, no device work."""
        return lie_np.rel_pose(np.asarray(xi_i, np.float32),
                               np.asarray(xi_j, np.float32))

    def _add_odometry_edge(self, i: int, j: int, weight: float = 1.0):
        # z is refreshed from the current poses at every optimization
        # (window BA keeps improving relative poses after the edge is
        # made); only loop edges keep their measured constraint.
        self.pose_edges.append(dict(
            i=i, j=j, kind="odom",
            z=self._rel_pose(self.keyframes[i].pose, self.keyframes[j].pose),
            w=weight))

    # ------------------------------------------------- pose graph / loops
    def _try_loop_closure(self, new_idx: int):
        """Probe old keyframes outside the covisible window for a 2D-3D
        re-localization of keyframe `new_idx`, all candidates in one
        batched stage (one upload, one packed read); the decode keeps the
        best-candidate-first order. The first accepted candidate adds a
        loop edge, fuses the old landmarks and optimizes the pose graph;
        at most one closure per keyframe."""
        cfg = self.cfg
        old_max = new_idx - cfg.window_size
        if old_max < 1 or self.landmarks.shape[0] == 0:
            return
        new_kf = self.keyframes[new_idx]
        cand_idx = self._candidate_keyframes(
            new_kf.kp, cfg.loop_candidates, exclude_from=old_max,
            min_votes=cfg.loop_min_inliers)
        new_lms = new_kf.kp_lm[new_kf.kp_lm >= 0]
        # Covisibility gate: sharing landmarks with the candidate means it
        # is a tracked neighbour, not a loop.
        cands: List[int] = []
        for oi in cand_idx:
            old_lms = self.keyframes[oi].kp_lm[self.keyframes[oi].kp_lm >= 0]
            if np.intersect1d(new_lms, old_lms).size > 10:
                continue
            cands.append(int(oi))
        cands = cands[:cfg.loop_candidates]
        if not cands:
            return

        # The batch is padded to `loop_candidates` rows (cand_ok = 0).
        Kc = cfg.loop_candidates
        N = new_kf.kp["x"].shape[0]
        kp_lm_bank = np.zeros((Kc, N), np.float32)
        valid_bank = np.zeros((Kc, N), np.float32)
        cand_ok = np.zeros((Kc,), np.float32)
        for s, oi in enumerate(cands):
            kf = self.keyframes[oi]
            kp_lm_bank[s] = kf.kp_lm.astype(np.float32)
            valid_bank[s] = kf.kp["valid"].astype(np.float32)
            cand_ok[s] = 1.0
        desc_list = [self.keyframes[oi].kp["desc"] for oi in cands]
        desc_bank = torch.stack(desc_list + [desc_list[0]] *
                                (Kc - len(desc_list)))
        uv_q = np.stack([new_kf.kp["u"], new_kf.kp["v"]],
                        -1).astype(np.float32)
        Ln = self.landmarks.shape[0]
        Lpad = -(-Ln // _LM_TABLE_PAD) * _LM_TABLE_PAD
        lm_table = np.zeros((Lpad, 3), np.float32)
        lm_table[:Ln] = self.landmarks
        pose_t, packed_t, lm_t = self._upload_many(
            new_kf.pose, np.concatenate([
                kp_lm_bank.ravel(), valid_bank.ravel(), uv_q.ravel(),
                new_kf.kp["valid"].astype(np.float32), cand_ok]), lm_table)
        out = _read(self._loop_probe(self._next_key(), pose_t, desc_bank,
                                     new_kf.kp["desc"], packed_t, lm_t))

        Mcap = cfg.match.max_matches
        for s, oi in enumerate(cands):
            old_kf = self.keyframes[oi]
            row = out[s]
            n_has = int(row[6])
            n_inl = int(row[7])
            rmse = float(row[8])
            # `rmse <= max`: a degenerate candidate's NaN rmse rejects.
            accept = (n_has >= cfg.loop_min_inliers
                      and n_inl >= cfg.loop_min_inliers
                      and rmse <= cfg.loop_max_rmse)
            self.loop_probe_log.append(dict(
                kf=new_idx, old=int(oi), n_has=n_has, n_inl=n_inl,
                rmse=rmse, accepted=bool(accept)))
            if not accept:
                continue
            pose = row[:6].astype(np.float32)
            ib_all = row[9:9 + Mcap].astype(np.int64)
            lm_all = row[9 + Mcap:9 + 2 * Mcap].astype(np.int64)
            inl_mask = row[9 + 2 * Mcap:9 + 3 * Mcap] > 0.5
            ib_inl = ib_all[inl_mask]
            lm_inl = lm_all[inl_mask]
            # Scale drift across the loop (Sim(3) graphs only): Umeyama of
            # the new keyframe's duplicate landmark estimates onto the old
            # map's points for the same features. Its scale s_u maps local
            # -> old, and the landmark re-anchor applies S_new S_old^-1,
            # so the edge carries sigma_z = log(s_u).
            sigma = 0.0
            if cfg.pose_graph_sim3:
                cur_ids = new_kf.kp_lm[ib_inl]
                dup = (cur_ids >= 0) & (cur_ids != lm_inl)
                if dup.sum() >= 8:
                    from sift_tpu_torch.eval.ate import umeyama_alignment
                    src = self.landmarks[cur_ids[dup]].astype(np.float64)
                    dst = self.landmarks[lm_inl[dup]].astype(np.float64)
                    s_u, _, _ = umeyama_alignment(src, dst, with_scale=True)
                    s_u = float(np.clip(float(s_u), 0.2, 5.0))
                    sigma = float(np.log(s_u))

            # Edge: old -> new with the re-localized pose.
            self.pose_edges.append(dict(
                i=int(oi), j=new_idx, kind="loop",
                z=self._rel_pose(old_kf.pose, pose),
                w=cfg.loop_weight, sigma=sigma))
            self.num_loop_closures += 1
            # The accepted inliers tie new-keyframe keypoints to old map
            # points: adopt or merge, so window BA constrains the loop
            # through shared observations too.
            self._fuse_loop_landmarks(new_kf, ib_inl, lm_inl)
            if self.logger is not None:
                self.logger.log("loop_closure", old=int(oi), new=new_idx,
                                inliers=n_inl, rmse=rmse)
            self._run_pose_graph()
            break

    def _fuse_loop_landmarks(self, new_kf: Keyframe, new_slots: np.ndarray,
                             old_lm_ids: np.ndarray) -> None:
        """Adopt or merge landmark identities across a loop closure: a
        slot with no landmark adopts the old id; a slot carrying a
        duplicate has every reference to the duplicate remapped, through
        a union-find that merges towards the smaller (older) id."""
        self._map_version += 1         # kp_lm changes invalidate the cache
        cur = new_kf.kp_lm[new_slots]
        adopt = cur < 0
        new_kf.kp_lm[new_slots[adopt]] = old_lm_ids[adopt]

        dup_pairs = [(int(d), int(o))
                     for d, o in zip(cur[~adopt], old_lm_ids[~adopt])
                     if d != o]
        if not dup_pairs:
            return
        remap = np.arange(self.landmarks.shape[0], dtype=np.int64)

        def find(i):
            while remap[i] != i:
                remap[i] = remap[remap[i]]   # path halving
                i = remap[i]
            return i

        for d, o in dup_pairs:
            rd, ro = find(d), find(o)
            if rd != ro:
                remap[max(rd, ro)] = min(rd, ro)
        # Flatten to roots (each pass doubles the resolved depth).
        flat = remap[remap]
        while not np.array_equal(flat, remap):
            remap, flat = flat, flat[flat]
        remap = flat
        for kf in self.keyframes:
            has = kf.kp_lm >= 0
            kf.kp_lm[has] = remap[kf.kp_lm[has]]
        if self.logger is not None:
            self.logger.log("landmark_fusion", merged=len(dup_pairs),
                            adopted=int(adopt.sum()))

    def _run_pose_graph(self):
        """Optimize every keyframe pose over the edge set, padded to the
        graph's static capacities (skipped when they are exceeded), node 0
        fixed as the gauge; then re-anchor each landmark by its creating
        keyframe's correction. One upload, one stage, one packed read."""
        cfg = self.cfg
        N = cfg.max_pose_graph_nodes
        E = cfg.max_pose_graph_edges
        n = len(self.keyframes)
        if n > N or len(self.pose_edges) > E:
            return

        old_poses = np.stack([kf.pose for kf in self.keyframes])
        poses = np.zeros((N, 6), np.float32)
        poses[:n] = old_poses
        # Refresh the odometry constraints to the current relative poses.
        for e in self.pose_edges:
            if e.get("kind") == "odom":
                e["z"] = self._rel_pose(self.keyframes[e["i"]].pose,
                                        self.keyframes[e["j"]].pose)
        ei = np.zeros(E, np.int32)
        ej = np.zeros(E, np.int32)
        ez = np.zeros((E, 6), np.float32)
        ew = np.zeros(E, np.float32)
        sig = np.zeros(E, np.float32)
        for k, e in enumerate(self.pose_edges):
            ei[k], ej[k], ez[k], ew[k] = e["i"], e["j"], e["z"], e["w"]
            sig[k] = float(e.get("sigma", 0.0))
        fixed = np.ones(N, bool)
        fixed[1:n] = False              # node 0 is the gauge

        if cfg.pose_graph_sim3:
            self._run_pose_graph_sim3(
                _read(self._pgo_sim3(*self._upload_many(
                    poses, ei, ej, ez, sig, ew, fixed)))[:n], n)
        else:
            out = _read(self._pgo(*self._upload_many(poses, ei, ej, ez, ew,
                                                     fixed)))
            # Keyframe poses, then landmarks by the rigid delta of their
            # creating keyframe (T_new T_old^-1).
            Rd, td = lie_np.pose_deltas(poses, out)
            for k in range(n):
                self.keyframes[k].pose = out[k]
            ref = self.lm_ref_kf
            self.landmarks = np.einsum("lij,lj->li", Rd[ref],
                                       self.landmarks) + td[ref]
        if self.logger is not None:
            self.logger.log("pose_graph", nodes=n,
                            edges=len(self.pose_edges),
                            sim3=bool(cfg.pose_graph_sim3))

    def _run_pose_graph_sim3(self, packed: np.ndarray, n: int):
        """Apply a Sim(3) solve (`_pgo_sim3`'s buffer, first `n` rows):
        keyframes take the (R, t) part of their new similarity, and
        landmarks the full delta of their creating keyframe (X' = s_d R_d
        X + t_d); the next window BA polishes the seam."""
        sd = packed[:, 0]
        Rd = packed[:, 1:10].reshape(n, 3, 3)
        td = packed[:, 10:13]
        R_new = packed[:, 13:22].reshape(n, 3, 3)
        t_new = packed[:, 22:25]
        for k in range(n):
            self.keyframes[k].pose = _se3_log_np(R_new[k], t_new[k])
        ref = self.lm_ref_kf
        self.landmarks = (sd[ref, None] *
                          np.einsum("lij,lj->li", Rd[ref], self.landmarks)
                          + td[ref]).astype(np.float32)

    # ----------------------------------------------------- map maintenance
    def run_global_ba(self, mesh=None, cfg_ba=None,
                      fix_first_n: int = 2) -> Dict[str, float]:
        """Full-map bundle adjustment over every keyframe pose and
        landmark, the first `fix_first_n` keyframes fixed. Buffers are
        padded to multiples (cameras 8, landmarks 512, observations 2048);
        one upload, one solve, one packed read. Updates keyframe poses and
        landmarks in place; returns {"rmse", "n_obs", "n_cams", "n_lms"}."""
        if mesh is not None:
            raise NotImplementedError(
                "run_global_ba(mesh=...) (dist/ba_dist.py) is not ported")
        C = len(self.keyframes)
        if C < 2:
            return dict(rmse=0.0, n_obs=0, n_cams=C, n_lms=0)

        oc, ol, ouv = [], [], []
        for ci, kf in enumerate(self.keyframes):
            slots = np.nonzero(kf.kp_lm >= 0)[0]
            oc.append(np.full(slots.shape[0], ci, np.int32))
            ol.append(kf.kp_lm[slots])
            ouv.append(np.stack([kf.kp["u"][slots], kf.kp["v"][slots]], -1))
        oc = np.concatenate(oc)
        ol = np.concatenate(ol).astype(np.int64)
        ouv = np.concatenate(ouv).astype(np.float32)
        uniq, inv = np.unique(ol, return_inverse=True)
        L, O = uniq.shape[0], oc.shape[0]
        if L < 8 or O < 24:
            return dict(rmse=0.0, n_obs=O, n_cams=C, n_lms=L)

        def pad_to(n, mult):
            return -(-n // mult) * mult

        Ccap, Lcap, Ocap = pad_to(C, 8), pad_to(L, 512), pad_to(O, 2048)
        poses = np.zeros((Ccap, 6), np.float32)
        poses[:C] = np.stack([kf.pose for kf in self.keyframes])
        lms = np.zeros((Lcap, 3), np.float32)
        lms[:L] = self.landmarks[uniq]
        obs_cam = np.zeros(Ocap, np.int32)
        obs_lm = np.zeros(Ocap, np.int32)
        obs_uv = np.zeros((Ocap, 2), np.float32)
        obs_valid = np.zeros(Ocap, bool)
        obs_cam[:O] = oc
        obs_lm[:O] = inv
        obs_uv[:O] = ouv
        obs_valid[:O] = True
        fixed = np.zeros(Ccap, bool)
        fixed[:min(fix_first_n, C)] = True
        fixed[C:] = True                     # padding cameras pinned

        bcfg = cfg_ba if cfg_ba is not None else self.cfg.ba
        p, lm, o_c, o_l, o_uv, o_v, fx = self._upload_many(
            poses, lms, obs_cam, obs_lm, obs_uv, obs_valid, fixed)
        packed = _read(self._pack_ba(run_ba(p, self._K, lm, o_c, o_l, o_uv,
                                            o_v, bcfg, fx)))
        new_poses = packed[:Ccap * 6].reshape(Ccap, 6)
        new_lms = packed[Ccap * 6:Ccap * 6 + Lcap * 3].reshape(Lcap, 3)
        for ci, kf in enumerate(self.keyframes):
            kf.pose = new_poses[ci].astype(np.float32)
        self.landmarks[uniq] = new_lms[:L].astype(np.float32)
        self._map_version += 1
        rmse = float(packed[-2])
        if self.logger is not None:
            self.logger.log("global_ba", rmse=rmse, n_obs=O, n_cams=C,
                            n_lms=L)
        return dict(rmse=rmse, n_obs=int(O), n_cams=int(C), n_lms=int(L))

    def cull_keyframes(self, redundancy: float = 0.9,
                       min_other_refs: int = 3) -> Dict[str, int]:
        """Remove redundant keyframes outside the newest BA window: those
        whose associated landmarks are, for at least `redundancy` of them,
        observed by `min_other_refs` other keyframes. Keyframe 0 (the
        gauge) and loop-edge endpoints are never culled.

        Keyframes are renumbered; odometry edges are rebuilt over the
        surviving consecutive pairs, loop edges keep their measurement with
        remapped endpoints, `lm_ref_kf` re-anchors each landmark to the
        nearest surviving keyframe at or before its creator, and the global
        descriptor index is rebuilt."""
        n_kf = len(self.keyframes)
        window_start = max(0, n_kf - self.cfg.window_size)
        if window_start <= 1:
            return dict(culled=0, kept=n_kf)

        refs = np.zeros(max(self.landmarks.shape[0], 1), np.int64)
        for kf in self.keyframes:
            np.add.at(refs, kf.kp_lm[kf.kp_lm >= 0], 1)
        protected = {0}
        for e in self.pose_edges:
            if e.get("kind") != "odom":
                protected.add(e["i"])
                protected.add(e["j"])

        cull = []
        for i in range(1, window_start):
            if i in protected:
                continue
            ids = self.keyframes[i].kp_lm
            ids = ids[ids >= 0]
            if ids.size and np.mean(
                    refs[ids] >= min_other_refs + 1) < redundancy:
                continue
            cull.append(i)
            np.subtract.at(refs, ids, 1)  # removal affects later decisions
        if not cull:
            return dict(culled=0, kept=n_kf)

        culled = set(cull)
        keep = [i for i in range(n_kf) if i not in culled]
        remap = {old: new for new, old in enumerate(keep)}
        # Nearest surviving keyframe at or before each old index (old 0
        # always survives).
        anchor = np.zeros(n_kf, np.int64)
        cur = 0
        for old in range(n_kf):
            if old in remap:
                cur = remap[old]
            anchor[old] = cur
        self.keyframes = [self.keyframes[i] for i in keep]
        self.lm_ref_kf = anchor[np.clip(self.lm_ref_kf, 0, n_kf - 1)]

        loop_edges = []
        for e in self.pose_edges:
            if e.get("kind") == "odom":
                continue
            e2 = dict(e)
            e2["i"], e2["j"] = remap[e["i"]], remap[e["j"]]
            loop_edges.append(e2)
        self.pose_edges = [
            dict(i=k, j=k + 1, kind="odom",
                 z=self._rel_pose(self.keyframes[k].pose,
                                  self.keyframes[k + 1].pose), w=1.0)
            for k in range(len(self.keyframes) - 1)] + loop_edges

        self._global_index = None
        for i, kf in enumerate(self.keyframes):
            self._index_keyframe(i, kf)
        self._map_version += 1
        self._local_map_cache = None
        if self.logger is not None:
            self.logger.log("cull_keyframes", culled=len(cull),
                            kept=len(keep))
        return dict(culled=len(cull), kept=len(keep))

    def compact_landmarks(self, min_refs: int = 1) -> Dict[str, int]:
        """Drop landmarks referenced by fewer than `min_refs` keyframe
        slots and renumber the rest (landmark array, `lm_ref_kf`, every
        keyframe's `kp_lm`). `min_refs=1` is result-neutral: the dropped
        rows (duplicates left behind by loop fusion) are unreachable from
        any keyframe."""
        n = self.landmarks.shape[0]
        refs = np.zeros(n, np.int64)
        for kf in self.keyframes:
            np.add.at(refs, kf.kp_lm[kf.kp_lm >= 0], 1)
        keep = refs >= min_refs
        kept = int(keep.sum())
        remap = np.full(n, -1, np.int64)
        remap[keep] = np.arange(kept)
        self.landmarks = self.landmarks[keep]
        self.lm_ref_kf = self.lm_ref_kf[keep]
        for kf in self.keyframes:
            has = kf.kp_lm >= 0
            kf.kp_lm[has] = remap[kf.kp_lm[has]]
        self._map_version += 1
        if self.logger is not None:
            self.logger.log("compact", kept=kept, dropped=n - kept)
        return dict(kept=kept, dropped=n - kept)

    # ------------------------------------------------------------ window BA
    def _run_window_ba(self, fix_first_n: int = 2):
        """Sliding-window BA over the last `window_size` keyframes, the
        first `fix_first_n` fixed: observations remapped to window-local
        landmarks and padded to bucketed static capacities on the host, one
        upload, the solve, one packed read."""
        cfg = self.cfg
        window = self.keyframes[-cfg.window_size:]
        C = cfg.window_size

        oc, ol, ouv = [], [], []
        for ci, kf in enumerate(window):
            slots = np.nonzero(kf.kp_lm >= 0)[0]
            oc.append(np.full(slots.shape[0], ci, np.int32))
            ol.append(kf.kp_lm[slots])
            ouv.append(np.stack([kf.kp["u"][slots], kf.kp["v"][slots]], -1))
        oc = np.concatenate(oc) if oc else np.zeros(0, np.int32)
        ol = np.concatenate(ol) if ol else np.zeros(0, np.int64)
        ouv = (np.concatenate(ouv) if ouv else
               np.zeros((0, 2), np.float32)).astype(np.float32)

        # Window-local landmark remap, capped to static capacity.
        uniq, inv = np.unique(ol, return_inverse=True)
        Lcap, Ocap = cfg.ba_max_landmarks, cfg.ba_max_observations
        if uniq.shape[0] > Lcap:
            # Keep the most-observed landmarks.
            counts = np.bincount(inv)
            keep = np.argsort(-counts)[:Lcap]
            keep_mask = np.isin(inv, keep)
            oc, ol, ouv, inv = (oc[keep_mask], ol[keep_mask], ouv[keep_mask],
                                inv[keep_mask])
            uniq, inv = np.unique(ol, return_inverse=True)
        if oc.shape[0] > Ocap:
            pick = np.random.default_rng(0).permutation(oc.shape[0])[:Ocap]
            oc, ol, ouv, inv = oc[pick], ol[pick], ouv[pick], inv[pick]
            uniq, inv = np.unique(ol, return_inverse=True)

        L = uniq.shape[0]
        O = oc.shape[0]
        if L < 8 or O < 24:
            return

        # Bucketed capacities: pad to the smallest of three shapes that
        # fits (the window problem is usually far below the ceilings).
        for frac in (8, 2, 1):
            if L <= Lcap // frac and O <= Ocap // frac:
                Lcap, Ocap = max(Lcap // frac, 8), max(Ocap // frac, 32)
                break

        lms = np.zeros((Lcap, 3), np.float32)
        lms[:L] = self.landmarks[uniq]
        obs_cam = np.zeros(Ocap, np.int32)
        obs_lm = np.zeros(Ocap, np.int32)
        obs_uv = np.zeros((Ocap, 2), np.float32)
        obs_valid = np.zeros(Ocap, bool)
        obs_cam[:O] = oc
        obs_lm[:O] = inv
        obs_uv[:O] = ouv
        obs_valid[:O] = True

        poses = np.zeros((C, 6), np.float32)
        for ci, kf in enumerate(window):
            poses[ci] = kf.pose
        fixed = np.zeros(C, bool)
        fixed[:min(fix_first_n, len(window))] = True
        fixed[len(window):] = True          # unused slots pinned

        ba_fn = (self._window_ba_track if self.state == "tracking"
                 else self._window_ba)
        packed = _read(ba_fn(*self._upload_many(
            poses, lms, obs_cam, obs_lm, obs_uv, obs_valid, fixed)))
        self._apply_ba_result(packed, window, uniq, L, O)

    def _apply_ba_result(self, packed: np.ndarray, window, uniq, L, O):
        """`packed`: the BA stage's single buffer [poses | landmarks | rmse
        | iters]."""
        C = self.cfg.window_size
        # The landmark capacity is bucketed per solve; recover it from the
        # buffer layout [poses C*6 | lms Lcap*3 | rmse | iters].
        Lcap = (packed.shape[0] - C * 6 - 2) // 3
        new_poses = packed[:C * 6].reshape(C, 6).astype(np.float32)
        new_lms = packed[C * 6:C * 6 + Lcap * 3].reshape(Lcap, 3)
        for ci, kf in enumerate(window):
            kf.pose = new_poses[ci]
        self.landmarks[uniq] = new_lms[:L].astype(np.float32)
        if self.logger is not None:
            self.logger.log("window_ba", rmse=float(packed[-2]),
                            iters=int(packed[-1]), n_obs=O, n_lms=L)

    def finalize(self):
        """Call at sequence end. The port runs every window BA
        synchronously, so nothing is deferred."""
