#!/usr/bin/env python3
"""What the program's spans (`sift_tpu_torch/utils/metrics.py`) cost and
change on the card, for one cell, in one process.

    python3 portbench/spancost.py --workload <cell> [--steps 60] \
        [--seed N]

Prints one JSON line each:
- `stage_off_ns`: host ns a `with stage(...)` takes with no recorder and no
  profiler (best of five rounds of 100,000); `stage_recorded_ns` the same
  under `metrics.recording()` (no profiler, no markers; rounds of 10,000);
- `identical`: a warm step's outputs under the benchmark's profiler
  session, the spans recorded and their boundaries marked on the stream,
  against the same step unrecorded, bit for bit (NaN equal);
- `syncs`: host syncs of one warm step by program span path, as torch
  reports them under `set_sync_debug_mode("warn")` (`metrics.count`);
- `traced`: steps/s of `--steps` steps under the benchmark's CUDA-only
  profiler session, with the program's spans as a profiler session runs
  them (`on`: recorded, marked, named by `record_function`), kept off
  (`off`: the program's profiler check patched to read false), named only
  (`ranges`: no recorder) or recorded and marked only (`recorded`: no
  `record_function`), in the order of `SIDES` and back.
Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
import warnings
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1])]

# traced windows: the program's spans off, as a profiler session runs them
# (recorded, marked and named), named only (`record_function`), recorded
# and marked only
SIDES = ("off", "on", "ranges", "recorded")


def _same(a, b) -> bool:
    import torch
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        if a.dtype != b.dtype or a.shape != b.shape:
            return False
        if a.is_floating_point():
            return bool(((a == b) | (a.isnan() & b.isnan())).all())
        return torch.equal(a, b)
    return a == b


def _copy(out):
    return {k: v.clone() for k, v in out.items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--seed", type=int, default=2**31 + 4242)
    args = p.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("spancost: no CUDA card", file=sys.stderr)
        return 2
    from portbench.lib import cells
    from portbench.lib.harness import WARM_STEPS, Spans, window
    from portbench.lib.tracing import Session
    from sift_tpu_torch.utils import metrics

    torch.set_num_threads(1)
    dev = torch.device("cuda")

    def emit(**kw):
        print(json.dumps({"workload": args.workload, **kw}), flush=True)

    best = float("inf")
    for _ in range(5):
        t = time.perf_counter()
        for _ in range(100_000):
            with metrics.stage("x"):
                pass
        best = min(best, (time.perf_counter() - t) / 100_000)
    emit(stage_off_ns=best * 1e9)
    best = float("inf")
    with metrics.recording():
        for _ in range(5):
            t = time.perf_counter()
            for _ in range(10_000):
                with metrics.stage("x"):
                    pass
            best = min(best, (time.perf_counter() - t) / 10_000)
    emit(stage_recorded_ns=best * 1e9)

    cell = cells.resolve(args.workload)
    cfg = cell.config
    gen = cells.load_module("inputs", cfg["scene"]["generator"])
    step_mod = cells.load_module("steps", cell.step_kind)
    h, w = cfg["image"]["height"], cfg["image"]["width"]
    scene = gen.make(cfg["scene"], h, w, args.seed, dev)
    step = step_mod.Step(cfg, cell.traffic, scene, args.seed, dev)
    off = Spans("off")
    for i in range(WARM_STEPS):
        step.run(i, off)
    torch.cuda.synchronize()

    plain = _copy(step.run(0, off))
    with Session():
        marked = _copy(step.run(0, off))
    rec = metrics.profiled()
    emit(identical=_same(plain, marked), spans=len(rec.spans),
         marks=rec.marks)

    def count_sync(message, *a, **k):
        if "synchroniz" in str(message):
            metrics.count("syncs")

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        old = warnings.showwarning
        warnings.showwarning = count_sync
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with metrics.recording() as rec:
                step.run(1, off)
        finally:
            torch.cuda.set_sync_debug_mode("default")
            warnings.showwarning = old
    syncs = {}
    for s in rec.spans:
        if s.counts.get("syncs"):
            path, j = [s.name], s.parent
            while j >= 0:
                path.append(rec.spans[j].name)
                j = rec.spans[j].parent
            key = "/".join(reversed(path))
            syncs[key] = syncs.get(key, 0) + s.counts["syncs"]
    emit(syncs=syncs)

    profiling, recorder = metrics._profiling, metrics._recorder
    record_function = torch.profiler.record_function

    class _NoRange:
        def __init__(self, name):
            pass

        def __enter__(self):
            return None

        def __exit__(self, *exc):
            return False

    rates = {side: [] for side in SIDES}
    for side in SIDES + SIDES[::-1]:
        if side == "off":
            metrics._profiling = lambda: False
        elif side == "ranges":
            metrics._recorder = lambda profiling: None
        elif side == "recorded":
            torch.profiler.record_function = _NoRange
        gc.collect()
        try:
            with Session():
                got = window(step, None, args.steps, Spans("timed"))
        finally:
            metrics._profiling, metrics._recorder = profiling, recorder
            torch.profiler.record_function = record_function
        with metrics.stage("close"):      # ends the session's recording
            pass
        rates[side].append(got.steps / got.window_s)
        rec = metrics.profiled()
        emit(traced=side, steps_per_s=got.steps / got.window_s,
             recorded=len(rec.spans) if side in ("on", "recorded") else 0)
    emit(device=torch.cuda.get_device_name(dev), rates=rates)
    return 0


if __name__ == "__main__":
    sys.exit(main())
