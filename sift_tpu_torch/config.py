"""Configuration of the PyTorch port.

Copies of `sift_tpu.config.SiftConfig`, `MatchConfig`, `RansacConfig` and
`BAConfig` (same fields, defaults and checks), kept here so that
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
    subpixel: bool = False        # 2x upsample input first (not in the port yet)

    # "lowe" = Lowe-2004 pipeline; "parity" = reference quirks (not ported).
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
    # Only "exact" is ported ("approx" was a TPU partial sort).
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


_CONFIGS = (SiftConfig, MatchConfig, RansacConfig, BAConfig)


def config_from_dict(d: dict):
    """Build a port config from `dataclasses.asdict` of a JAX-package
    config: the one of `SiftConfig`, `MatchConfig`, `RansacConfig`,
    `BAConfig` whose fields hold every key (their field names are
    disjoint)."""
    for cls in _CONFIGS:
        if set(d) <= {f.name for f in dataclasses.fields(cls)}:
            return cls(**d)
    raise ValueError(f"no port config has all of the fields {sorted(d)}")
