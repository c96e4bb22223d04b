"""Metrics, structured logging, program spans and profiling hooks
(counterpart of `sift_tpu/utils/metrics.py`).

* `MetricsLogger` — structured per-stage metrics as JSONL (keyframes/s,
  keypoints/frame, match inlier ratios, BA residuals, ATE), cheap enough to
  leave on in production; a copy of the JAX package's;
* `stage(name, logger, **fields)` — a span of the program. Off (no
  recorder, no logger, no profiler) it costs one check and returns a shared
  null context. With a logger it writes the JAX package's JSONL record;
  while a torch profiler runs it opens a `record_function` range of the
  same name; while a recorder runs it records the span;
* `recording()` — a process-local `Recorder` of every span that opens
  while it runs: name, parent, thread, `time.time_ns()` at entry and exit
  (the clock of the profiler's CUPTI timestamps), fields and counters. It
  reads no device and writes nothing until read;
* `count(name, n)` — adds to a counter of the innermost open span while a
  recorder runs;
* `profiled()` — the recording of the last torch profiler session: a
  profiler that starts while no recorder runs gets one of its own, which
  also marks each span boundary on the current CUDA stream (a kernel named
  `MARKER_KERNEL`), so that a trace holding only device activity can be
  split by the span that launched each activity;
* `profile_trace(dir)` — whole-program `torch.profiler` trace (CPU and,
  where there is one, CUDA activity) written to `dir` as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
import time
from typing import Dict, List, Optional, TextIO

import torch

# the kernel of `torch.cuda._sleep`, which launches nothing else: a spin
# of zero cycles marks a span boundary on the stream
MARKER_KERNEL = "spin_kernel"
ALLOCATOR_COUNTS = ("num_device_alloc", "num_device_free", "num_alloc_retries")

_profiling = torch.autograd._profiler_enabled


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


@dataclasses.dataclass
class Span:
    """One recorded span: `parent` indexes the recorder's `spans` (-1 for
    a root), `thread` is the OS thread id, `t0`/`t1` `time.time_ns()` at
    entry and exit (`t1` None while open)."""

    name: str
    parent: int
    thread: int
    t0: int
    t1: Optional[int]
    fields: dict
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)


class Recorder:
    """The spans of one recording, in the order they opened. `marks`: each
    span boundary also launches a marker kernel on the current CUDA
    stream. `allocator`: the CUDA caching allocator's `ALLOCATOR_COUNTS`
    when the recording began and ended (empty without CUDA)."""

    def __init__(self, marks: bool = False, profiler: bool = False):
        self.spans: List[Span] = []
        self.marks = marks
        self.profiler = profiler          # opened by a profiler session
        self.outer: Optional[Recorder] = None
        self.allocator: List[Dict[str, int]] = []
        self._stacks: Dict[int, List[int]] = {}
        self._lock = threading.Lock()

    def _stack(self) -> List[int]:
        return self._stacks.setdefault(threading.get_ident(), [])

    def _allocator_counts(self) -> None:
        if torch.cuda.is_initialized():
            stats = torch.cuda.memory_stats()
            self.allocator.append({k: int(stats.get(k, 0))
                                   for k in ALLOCATOR_COUNTS})


_REC: Optional[Recorder] = None        # the recorder spans go to
_PROFILED: Optional[Recorder] = None   # the last profiler session's


def _mark() -> None:
    torch.cuda._sleep(0)


def _start(rec: Recorder) -> Recorder:
    global _REC
    rec.outer, _REC = _REC, rec
    rec._allocator_counts()
    return rec


def _stop(rec: Recorder) -> None:
    global _REC
    rec._allocator_counts()
    _REC = rec.outer


def _recorder(profiling: bool) -> Optional[Recorder]:
    """The recorder a span opening now goes to: a profiler session that
    runs without one gets one, which ends with the session."""
    global _PROFILED
    rec = _REC
    if rec is not None and rec.profiler and not profiling:
        _stop(rec)
        rec = _REC
    if rec is None and profiling:
        rec = _PROFILED = _start(Recorder(marks=torch.cuda.is_initialized(),
                                          profiler=True))
    return rec


class _Stage:
    __slots__ = ("name", "logger", "fields", "rec", "index", "rf", "t0")

    def __init__(self, name, logger, fields, rec, profiling):
        self.name, self.logger, self.fields = name, logger, fields
        self.rec = rec
        self.rf = torch.profiler.record_function(name) if profiling else None

    def __enter__(self):
        rec = self.rec
        if rec is not None:
            stack = rec._stack()
            span = Span(self.name, stack[-1] if stack else -1,
                        threading.get_native_id(), time.time_ns(), None,
                        self.fields)
            with rec._lock:
                self.index = len(rec.spans)
                rec.spans.append(span)
            stack.append(self.index)
            if rec.marks:
                _mark()
        if self.rf is not None:
            self.rf.__enter__()
        if self.logger is not None:
            self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        if self.logger is not None:
            self.logger.log("stage", name=self.name,
                            wall_s=time.perf_counter() - self.t0,
                            **self.fields)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        rec = self.rec
        if rec is not None:
            if rec.marks:
                _mark()
            rec.spans[self.index].t1 = time.time_ns()
            rec._stack().pop()
        return False


class _Null:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def stage(name: str, logger: Optional[MetricsLogger] = None, **fields):
    """A span of the program named `name`; `fields` go to the logger's
    record and the recorder's. Off, one check and a shared null context."""
    if _REC is None and logger is None and not _profiling():
        return _NULL
    profiling = _profiling()
    rec = _recorder(profiling)
    if rec is None and logger is None and not profiling:
        return _NULL
    return _Stage(name, logger, fields, rec, profiling)


@contextlib.contextmanager
def recording():
    """Record every span that opens in this process while the block runs;
    yields the `Recorder`."""
    rec = _start(Recorder())
    try:
        yield rec
    finally:
        _stop(rec)


def count(name: str, n: int = 1) -> None:
    """Add `n` to counter `name` of this thread's innermost open span,
    while a recorder runs."""
    rec = _REC
    if rec is None:
        return
    stack = rec._stacks.get(threading.get_ident())
    if stack:
        counts = rec.spans[stack[-1]].counts
        counts[name] = counts.get(name, 0) + n


def profiled() -> Optional[Recorder]:
    """The recording of the running or last torch profiler session that
    ran without a recorder of its own (None if there was none)."""
    return _PROFILED


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture a profiler trace of the block into `log_dir/trace.json`
    (view in Perfetto or chrome://tracing)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
