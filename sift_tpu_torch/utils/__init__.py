"""Small helpers of the PyTorch port: device constants, metrics logging
and profiling (`utils/metrics.py`), NaN and determinism checks
(`utils/debug.py`)."""

from sift_tpu_torch.utils.metrics import MetricsLogger, profile_trace, stage

__all__ = ["MetricsLogger", "stage", "profile_trace"]
