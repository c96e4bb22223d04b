"""Configuration of the PyTorch port.

Copies of `sift_tpu.config.SiftConfig`, `MatchConfig`, `AnnConfig`,
`RansacConfig`, `BAConfig` and `PipelineConfig` (same fields, defaults and checks), kept here so that
importing the port never imports the JAX package. The system has no learned weights: the
configuration, and the blur operators and sigma tables derived from it,
are all that crosses from the JAX package. `config_from_dict` takes
`dataclasses.asdict` of a `sift_tpu` config.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class SiftConfig:
    """SIFT frontend configuration (field names follow the reference CLI)."""

    sigma: float = 1.6            # base blur
    k: float = math.sqrt(2.0)     # scale step
    octaves: int = 4
    dogs_per_epoch: int = 3       # DoGs per octave
    subpixel: bool = False        # 2x upsample input first

    # "lowe" = Lowe-2004 pipeline; "parity" = reference quirks.
    mode: str = "lowe"

    # Static-shape budget: octave o keeps max_keypoints_per_octave >> o
    # candidates (floor 64); the output holds max_keypoints.
    max_keypoints_per_octave: int = 512
    max_keypoints: int = 1024

    def octave_cap(self, octave: int) -> int:
        return max(self.max_keypoints_per_octave >> octave, 64)

    contrast_threshold: float = 0.03   # on [0,1]-normalized DoG values
    edge_r: float = 10.0
    ori_peak_rel: float = 0.8
    descriptor_max_component: float = 0.2
    rootsift: bool = False

    image_max: float = 255.0

    # Carried for field parity with the JAX package. The port runs its
    # hand kernels whenever the tensors lie on the card; "off" with a CUDA
    # device is refused by the entry points.
    pallas: str = "auto"
    # Gradient maps are cast to this type before the window gather.
    window_dtype: str = "bfloat16"
    # Only "exact" is ported ("approx" was a TPU partial sort; parity
    # mode is exact either way).
    extrema_topk: str = "exact"

    def __post_init__(self):
        assert self.octaves > 0, "octaves must be positive"
        assert self.dogs_per_epoch >= 3, "dogsPerEpoch >= 3"
        assert self.mode in ("lowe", "parity")
        assert self.pallas in ("auto", "on", "off")
        assert self.window_dtype in ("float32", "bfloat16")
        assert self.extrema_topk in ("exact", "approx")

    @property
    def gaussians_per_octave(self) -> int:
        return self.dogs_per_epoch + 1

    def replace(self, **kw) -> "SiftConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class MatchConfig:
    """Brute-force descriptor matching (dense distances + ratio test)."""

    ratio: float = 0.8            # Lowe ratio test threshold
    mutual: bool = True           # require mutual nearest neighbours
    max_matches: int = 1024       # static output size (masked)
    metric: str = "l2"            # "l2" | "dot" | "l2q8"
    # Top-2 backend, named as in the JAX package: "auto" takes the
    # streaming top-2 kernel for large sets of CUDA tensors; "pallas"
    # forces the streaming formulation (kernel on the card, its plain
    # version on the CPU); "xla" forces the dense path.
    impl: str = "auto"

    def replace(self, **kw) -> "MatchConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class AnnConfig:
    """IVF-Flat approximate matching (`matching/ann.py`).

    Recall is controlled by `nprobe` (== `n_clusters` degenerates to
    exact). `bucket_capacity` must hold the largest cluster: size it ~4x
    the mean occupancy N/n_clusters and check `IvfIndex.n_overflow` == 0.
    `MatchConfig.impl="auto"` never routes here.
    """

    n_clusters: int = 256
    nprobe: int = 8
    bucket_capacity: int = 512
    kmeans_iters: int = 10
    query_tile: int = 256         # search working set = tile x cap x D

    def replace(self, **kw) -> "AnnConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class RansacConfig:
    """Batched-hypothesis RANSAC (no data-dependent loop: fixed batch+argmax)."""

    num_hypotheses: int = 512
    inlier_threshold: float = 2.0   # pixels (model-dependent interpretation)
    min_inliers: int = 15
    refit: bool = True              # weighted least-squares refit on inliers
    essential_solver: str = "5pt"   # "5pt" minimal | "8pt" linear

    def replace(self, **kw) -> "RansacConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class BAConfig:
    """Schur-complement bundle adjustment."""

    max_iterations: int = 20
    cg_iterations: int = 50
    cg_tol: float = 1e-6
    damping_init: float = 1e-3
    damping_min: float = 1e-9
    damping_max: float = 1e6
    huber_delta: float = 3.0        # pixels; robust loss scale
    loss: str = "huber"             # "huber" | "cauchy" | "none"
    # Graduated robust loss: effective delta = max(huber_delta,
    # robust_anneal * initial median residual * 0.5^iteration); 0 disables.
    robust_anneal: float = 3.0
    jacobi_precond: bool = True
    # Reduced-camera-system solver: "pcg" (matrix-free), "dense" (Cholesky
    # of the 6C x 6C Schur complement), or "auto" (dense when C <= 16).
    solver: str = "auto"

    def replace(self, **kw) -> "BAConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Top-level SLAM/SfM pipeline configuration (every field is honoured
    on one device; meshes are not ported)."""

    sift: SiftConfig = SiftConfig()
    match: MatchConfig = MatchConfig()
    ransac: RansacConfig = RansacConfig()
    ba: BAConfig = BAConfig()

    window_size: int = 8            # sliding BA window (keyframes)
    keyframe_min_inliers: int = 30

    # Window-BA static capacities (window observations/landmarks are
    # padded up to these, in three buckets).
    ba_max_landmarks: int = 2048
    ba_max_observations: int = 8192

    # Tracking-time window BA budget (promotions warm-start from the
    # previous window's solution); the full cfg.ba budget runs at
    # bootstrap. 0 = the full budget everywhere.
    ba_tracking_iterations: int = 8
    ba_tracking_cg: int = 20

    # Per-frame tracking localization budget (pose_ransac_refine):
    # hypothesis count and GN iterations per fit.
    tracking_ransac_hypotheses: int = 8
    tracking_gn_iters: int = 8

    # Deferred (asynchronous) window BA.
    ba_async: bool = False
    # Device-resident chunked tracking.
    chunked_tracking: bool = False
    # Extraction of the next chunk right after the current chunk's read.
    extract_ahead: bool = True
    # Deferred window-BA kickoff of the chunked tracker.
    ba_defer_kickoff: bool = False

    # Bootstrap / keyframe policy.
    min_bootstrap_matches: int = 40
    min_bootstrap_parallax: float = 8.0   # px, median flow before two-view init
    # Independent H-vs-E RANSAC attempts per bootstrap try, selected by
    # triangulation health.
    boot_attempts: int = 4
    # A homography-selected bootstrap must see this multiple of the
    # parallax gate before being trusted.
    h_parallax_factor: float = 2.0
    kf_min_tracked: int = 60              # new keyframe when tracked lms drop below
    kf_max_interval: int = 10             # ... or this many frames elapsed
    min_triangulation_angle_deg: float = 0.5
    max_reproj_error_px: float = 3.0

    # RGB-D: accepted depth range in meters.
    depth_min: float = 0.1
    depth_max: float = 25.0

    # Local-map tracking: associate each frame against the deduplicated
    # union of landmarks observed by the last `window_size` keyframes.
    use_local_map: bool = True
    local_map_size: int = 2048

    # Guided matching radius during tracking, pixels (0 disables).
    guided_radius: float = 40.0

    # Relocalization after tracking loss.
    reloc_after_lost: int = 3         # failed frames before attempting
    reloc_candidates: int = 6         # keyframes probed per attempt

    # Global descriptor index (matching/global_index.py): candidate
    # keyframes ranked by descriptor votes.
    use_global_index: bool = True
    global_index_sim: float = 0.85    # cosine vote threshold

    # Loop closure / pose-graph SLAM (the global index holds
    # max_pose_graph_nodes keyframes; a graph over capacity is skipped).
    enable_loop_closure: bool = False
    pose_graph_sim3: bool = False
    loop_candidates: int = 4
    loop_min_inliers: int = 40
    loop_max_rmse: float = 1.0        # px; relocalization accepts 2x this
    loop_weight: float = 10.0
    max_pose_graph_nodes: int = 256
    max_pose_graph_edges: int = 1024

    # Landmark compaction every N promotions (0 = off).
    compact_interval_kf: int = 0
    # Capacity audit of the chunked tracker (carried for field parity).
    track_saturation: bool = False

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)


_CONFIGS = (SiftConfig, MatchConfig, AnnConfig, RansacConfig, BAConfig,
            PipelineConfig)
_NESTED = {"sift": SiftConfig, "match": MatchConfig, "ransac": RansacConfig,
           "ba": BAConfig}


def config_from_dict(d: dict):
    """Build a port config from `dataclasses.asdict` of a JAX-package
    config: the one of `SiftConfig`, `MatchConfig`, `AnnConfig`,
    `RansacConfig`, `BAConfig`, `PipelineConfig` whose fields hold every key (their field
    names are disjoint). A `PipelineConfig`'s nested configs may be dicts
    too."""
    for cls in _CONFIGS:
        if set(d) <= {f.name for f in dataclasses.fields(cls)}:
            if cls is PipelineConfig:
                d = {k: (_NESTED[k](**v) if k in _NESTED and isinstance(v, dict)
                         else v) for k, v in d.items()}
            return cls(**d)
    raise ValueError(f"no port config has all of the fields {sorted(d)}")
