"""Metrics, structured logging, and profiling hooks (counterpart of
`sift_tpu/utils/metrics.py`).

* `MetricsLogger` — structured per-stage metrics as JSONL (keyframes/s,
  keypoints/frame, match inlier ratios, BA residuals, ATE), cheap enough to
  leave on in production; a copy of the JAX package's;
* `stage(name)` — wall-clock timing context that also opens a
  `torch.profiler.record_function` range, so the same stage names show up
  in profiler traces;
* `profile_trace(dir)` — whole-program `torch.profiler` trace (CPU and,
  where there is one, CUDA activity) written to `dir` as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional, TextIO


class MetricsLogger:
    """Append-only JSONL metrics sink (stdout when path is None)."""

    def __init__(self, path: Optional[str] = None, echo: bool = False):
        self.path = path
        self.echo = echo
        self._fh: Optional[TextIO] = None
        if path is not None:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a")

    def log(self, event: str, **fields) -> None:
        rec = {"ts": time.time(), "event": event, **fields}
        line = json.dumps(rec, default=float)
        if self._fh is not None:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self.echo or self._fh is None:
            print(line)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


@contextlib.contextmanager
def stage(name: str, logger: Optional[MetricsLogger] = None, **fields):
    """Time a pipeline stage; annotate profiler traces with the same name."""
    import torch

    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
    dt = time.perf_counter() - t0
    if logger is not None:
        logger.log("stage", name=name, wall_s=dt, **fields)


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture a profiler trace of the block into `log_dir/trace.json`
    (view in Perfetto or chrome://tracing)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
