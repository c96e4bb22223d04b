"""One run of one cell: set-up, a timed window, the metrics, the check.

`run(cell, seed, seconds, trace, device)` returns the result line (a
dict) and the numbers compared with their limits. `run.py` refuses to
start without enough CUDA cards; tests call `run` on the CPU at small
sizes with `overrides`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import random
import subprocess
import sys
import time
import warnings
from bisect import bisect_right
from typing import Callable, Dict, List, Optional

import torch

from portbench.lib import cells, stats
from portbench.lib.context import Context
from portbench.lib.seeds import stream_seed
from portbench.lib.tracing import Session, short_name

WARM_STEPS = 2           # steps run in set-up, every shape of the cell
BANNED = ("jax", "jaxlib", "flax", "sift_tpu")
BREAKDOWN = 10


def process_age_s(fallback_t0: float) -> float:
    """Seconds since this process started (the kernel's start time), or
    since `fallback_t0` (perf_counter) where /proc cannot say."""
    try:
        with open("/proc/self/stat") as fh:
            start = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            up = float(fh.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - fallback_t0


def banned_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in BANNED})


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


class Spans:
    """Spans of the timed step. Off: nothing. `timed`: each span ends with
    a device sync and is recorded on the profiler's clock. `counting`:
    no sync; host syncs that torch reports inside a span are counted
    under its name."""

    def __init__(self, mode: str = "off"):
        self.mode = mode
        self.step = 0
        self.records = []
        self.current = None
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.mode == "off":
            yield
            return
        if self.mode == "counting":
            prev, self.current = self.current, name
            self.counts.setdefault(name, 0)
            try:
                yield
            finally:
                self.current = prev
            return
        t0 = time.time_ns()
        yield
        torch.cuda.synchronize()
        self.records.append((self.step, name, t0, time.time_ns()))


def count_syncs(step, index: int, device) -> Dict[str, int]:
    """Host syncs of one warm step by span, under
    `torch.cuda.set_sync_debug_mode("warn")`."""
    spans = Spans("counting")

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message) and spans.current is not None:
            spans.counts[spans.current] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        old = warnings.showwarning
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step.run(index, spans)
        finally:
            torch.cuda.set_sync_debug_mode("default")
            warnings.showwarning = old
    torch.cuda.synchronize(device)
    return spans.counts


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def breakdown(ctx: Context) -> dict:
    """The device operations that took most time, and the idle time of
    the device by the host span it fell in."""
    by_op: Dict[str, float] = {}
    for name, s, e in ctx.events:
        k = short_name(name)
        by_op[k] = by_op.get(k, 0.0) + (e - s) * 1e-9
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:BREAKDOWN]
    lo, hi = ctx.window_ns
    spans = sorted((s, e, n) for _, n, s, e in ctx.spans)
    starts = [s for s, _, _ in spans]
    idle: Dict[str, float] = {}
    for s, e in stats.gaps([(a, b) for _, a, b in ctx.events], lo, hi):
        mid = (s + e) // 2
        j = bisect_right(starts, mid) - 1
        name = spans[j][2] if j >= 0 and spans[j][1] > mid else "between steps"
        idle[name] = idle.get(name, 0.0) + (e - s) * 1e-9
    gaps_ = sorted(idle.items(), key=lambda kv: -kv[1])[:BREAKDOWN]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[f"idle in {k}", v] for k, v in gaps_]}


@dataclasses.dataclass
class Window:
    steps: int
    window_s: float               # first dispatch to the last step's end
    w0_ns: int                    # its start on the profiler's clock
    latencies_s: List[float]
    failed: int
    kept: Dict[int, tuple]        # scene item -> (step, inputs, outputs)
    step_stats: List[dict]


def window(step, seconds: Optional[float], steps: Optional[int], spans,
           rng: Optional[random.Random] = None,
           stats: bool = False) -> Window:
    """The closed loop from step 0: for `seconds`, or `steps` steps where
    given. With `rng`, keeps one step's inputs and outputs for each scene
    item, drawn uniformly among that item's steps (a reservoir each);
    with `stats`, each step's work counts (`step.stats`, taken once an
    item: a step's work is its input's)."""
    dev = step.device
    latencies: List[float] = []
    failed = 0
    seen: Dict[int, int] = {}
    kept: Dict[int, tuple] = {}
    stats_of: Dict[int, dict] = {}
    step_stats: List[dict] = []
    _sync(dev)
    w0_ns = time.time_ns()
    w0 = time.perf_counter()
    i = 0
    while True:
        spans.step = i
        ts = time.perf_counter()
        out = step.run(i, spans)
        te = time.perf_counter()
        latencies.append(te - ts)
        failed += int(step.failed(out))
        item = step.item(i)
        if stats:
            if item not in stats_of:
                stats_of[item] = step.stats(out)
            step_stats.append(stats_of[item])
        if rng is not None:
            seen[item] = seen.get(item, 0) + 1
            if rng.randrange(seen[item]) == 0:
                kept[item] = (i, step.inputs(i), step.keep(out))
        i += 1
        if (te - w0 >= seconds) if steps is None else i >= steps:
            break
    return Window(steps=i, window_s=te - w0, w0_ns=w0_ns,
                  latencies_s=latencies, failed=failed, kept=kept,
                  step_stats=step_stats)


def choose_kept(kept: Dict[int, tuple], n: int,
                rng: random.Random) -> List[tuple]:
    """`n` kept steps of distinct scene items, the items drawn from the
    seed: where the window saw two items or more, the check covers two
    steps that were handed different inputs."""
    items = rng.sample(sorted(kept), min(n, len(kept)))
    return [kept[t] for t in sorted(items)]


@dataclasses.dataclass
class Outcome:
    line: dict                    # the result line
    checks: Dict[str, dict]       # number -> {"value", "limit"}
    info: Dict[str, float]        # numbers printed, not compared
    ok: bool


def judge_items(cell, judge, kept: List[tuple], device,
                program: Optional[Callable] = None) -> tuple:
    """The judge's numbers over the checked steps (the largest of each),
    and its info numbers. `program(inputs)` stands in for the program's
    outputs where given (the control)."""
    numbers: Dict[str, float] = {}
    info: Dict[str, float] = {}
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        for _, inputs, out in kept:
            prog = program(inputs) if program is not None else out
            ref = judge.reference(cell.config, inputs)
            got = judge.numbers(cell.config, inputs, prog, ref)
            for k, v in got.items():
                v = float(v) if v is not None and math.isfinite(v) else math.inf
                numbers[k] = max(numbers.get(k, -math.inf), v)
            for k, v in judge.info(cell.config, inputs, prog).items():
                info[k] = max(info.get(k, -math.inf), float(v))
            del ref, prog
            _sync(device)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    return numbers, info


def checks_of(cell, judge, numbers: Dict[str, float]) -> tuple:
    """({number: {"value", "limit"}}, all within their limits)."""
    out, ok = {}, True
    for k in judge.NUMBERS:
        v = numbers.get(k, math.inf)
        lim = cell.limits.get(k)
        good = lim is not None and math.isfinite(v) and v <= lim
        ok &= good
        out[k] = {"value": v, "limit": lim}
    return out, ok


def run(name: str, seed: int, seconds: float, trace: bool, device="cuda",
        overrides: dict = None, t0: float = None, steps: int = None,
        program: Optional[Callable] = None, log=sys.stderr) -> Outcome:
    """One run of cell `name`. `steps` fixes the window's step count
    instead of its length (tests); `program` replaces the program's
    outputs of the checked steps by its own (the control)."""
    t0 = time.perf_counter() if t0 is None else t0
    dev = torch.device(device)
    cell = cells.resolve(name, overrides=overrides)
    cfg = cell.config
    gen_mod = cells.load_module("inputs", cfg["scene"]["generator"])
    step_mod = cells.load_module("steps", cell.step_kind)
    judge = cells.load_module("judges", cell.step_kind)

    # ---- set-up: inputs from the seed, the program, every shape warm
    h, w = cfg["image"]["height"], cfg["image"]["width"]
    scene = gen_mod.make(cfg["scene"], h, w, seed, dev)
    step = step_mod.Step(cfg, cell.traffic, scene, seed, dev)
    off = Spans("off")
    for i in range(WARM_STEPS):
        step.run(i, off)
    _sync(dev)
    setup_s = process_age_s(t0)
    print(f"set-up {setup_s:.3f} s", file=log, flush=True)

    # ---- the window, and with --trace 1 the same steps again, traced
    rng = random.Random(stream_seed(seed, "check"))
    timed = window(step, seconds, steps, Spans("off"), rng=rng)
    kept = choose_kept(timed.kept, cell.traffic["check"]["items"], rng)
    ctx = Context(cell=cell.workload, config=cfg, traffic=cell.traffic,
                  batch=step.batch, steps=timed.steps,
                  window_s=timed.window_s, latencies_s=timed.latencies_s,
                  setup_s=setup_s)
    n_steps, failed = timed.steps, timed.failed
    if trace:
        spans = Spans("timed")
        session = Session()
        with session:
            traced = window(step, None, timed.steps, spans, stats=True)
        n_steps += traced.steps
        failed += traced.failed
        ctx.step_stats = traced.step_stats
        ctx.spans = spans.records
        ctx.window_ns = (traced.w0_ns,
                         traced.w0_ns + int(traced.window_s * 1e9))
        t_read = time.perf_counter()
        lo, hi = ctx.window_ns
        ctx.events = [e for e in session.device_events()
                      if e[2] > lo and e[1] < hi]
        print(f"trace: {len(ctx.events)} device activities in the window, "
              f"read in {time.perf_counter() - t_read:.3f} s", file=log,
              flush=True)
        ctx.counters = {f"syncs.{k}": float(v) for k, v in
                        count_syncs(step, timed.steps, dev).items()}

    # ---- metrics
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = cells.load_module("metrics" if trace else "e2e", m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    lat = sorted(timed.latencies_s)
    q = [lat[min(len(lat) - 1, int(f * len(lat)))] * 1e3
         for f in (0.25, 0.5, 0.75)]
    print(f"window {timed.window_s:.3f} s, {timed.steps} steps, "
          f"{timed.failed} failed; step ms quartiles {q[0]:.3f} {q[1]:.3f} "
          f"{q[2]:.3f}, max {lat[-1] * 1e3:.3f}, mean "
          f"{timed.window_s / timed.steps * 1e3:.3f}", file=log, flush=True)
    if trace:
        print(f"traced window {ctx.traced_window_s():.3f} s, "
              f"{traced.steps} steps", file=log, flush=True)

    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": 1,
                   "memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                         if dev.type == "cuda" else 0),
                   "power_limit_w": (power_limit_w()
                                     if dev.type == "cuda" else None)}
    line = {"correct": False, "attempted": n_steps, "failed": failed,
            "metrics": metrics, "device": device_info}
    if trace:
        device_info.update(busy_s=ctx.busy_s(),
                           window_s=ctx.traced_window_s())
        line["breakdown"] = breakdown(ctx)

    # ---- the check, with the program's state freed
    step.release()
    del step
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers, info = judge_items(cell, judge, kept, dev, program)
    checks, ok = checks_of(cell, judge, numbers)
    print(f"check {time.perf_counter() - t_check:.3f} s over steps "
          f"{sorted(k[0] for k in kept)}; "
          + ", ".join(f"{k} {v:.6g}" for k, v in sorted(info.items())),
          file=log, flush=True)
    line["correct"] = ok
    line["checks"] = checks
    return Outcome(line=line, checks=checks, info=info, ok=ok)
