"""The traced window's device time and idle gaps by the program's own
spans (`sift_tpu_torch/utils/metrics.py`).

While a torch profiler runs, the program records its spans on the
profiler's clock (`time.time_ns()`) and marks each span boundary on the
current CUDA stream with a kernel named `MARKER_KERNEL`. The program
works on one stream, so the device runs its activities in launch order:
walking the window's activities by start time, the k-th marker is the
k-th span boundary of the stepping thread, and every other activity
belongs to the innermost program span open at that point of the walk.
An activity launched outside every program span falls, on the device, in
the benchmark span that launched it (each ends with a device sync). An
idle gap goes to the innermost program span open, in that order, at the
activity that ends it (the span the host was in when it launched that
activity), or else to the benchmark span at the gap's midpoint.

Where device times are set against host spans, they are first moved by
the offset of the trace's clock from the host's. That offset drifts over
a window (by a millisecond and more in 30 s on an H100), so it is taken a
step at a time, from the step's markers, which bound it from both sides:
an entry marker starts after the host entered its span, and a marker has
ended when the benchmark span that holds it returns from its sync.

`of(ctx)` reads the program's recording once for a run and prints the
split on standard error; without a recording (a program that keeps none,
or a run on the CPU, where nothing marks the stream), or with markers
that do not pair off with the boundaries, it returns None and the
readers give no value.
"""

from __future__ import annotations

import bisect
import dataclasses
import sys
import threading
import traceback
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

from portbench.lib.tracing import short_name

DENSE = ("pyramid", "extrema", "gradients")
KEYPOINT = ("refine", "orientation", "descriptor", "select")
BETWEEN = "(between steps)"
MARKERS = "(markers)"
TOP = 10

Path = Tuple[str, ...]


class Unaligned(ValueError):
    """The window's markers do not pair off with the recorded boundaries."""


@dataclasses.dataclass
class Split:
    """Sums over the traced window. Keys are program span paths (tuples of
    names from the root), `("[read]",)`-style benchmark spans, `BETWEEN`
    and `MARKERS` (one-element tuples)."""

    steps: int
    device_s: Dict[Path, float]       # device seconds by innermost path
    launches: Dict[Path, int]         # activities by path (markers apart)
    syncs: Dict[Path, int]            # copies the host waits for, by path
    idle_s: Dict[Path, float]         # idle seconds by innermost path
    kernels: Dict[Tuple[Path, str], float]   # device seconds by path, name
    markers: int
    offset_ns: Tuple[int, int]        # trace - host: least, largest step's
    crossed: int      # steps whose offset bounds cross
    width_ns: int     # the median step's bounds, high less low
    escaped: int      # ran in a benchmark extract span under every offset
                      # its step's bounds allow, outside the program's extract
    allocator: Dict[str, float]       # allocator counts a step

    def _sum(self, table, pred) -> float:
        return sum(v for k, v in table.items() if pred(k))

    def leaf_ms(self, names: Sequence[str]) -> float:
        """Device ms a step of the activities whose innermost program span
        is one of `names`."""
        prog = self._sum(self.device_s, lambda k: k[-1] in names
                         and not k[0].startswith(("[", "(")))
        return 1e3 * prog / self.steps

    def under(self, table, root: str) -> float:
        """A step's share of `table` under the program's root span `root`."""
        return self._sum(table, lambda k: k[0] == root) / self.steps

    def coverage(self) -> float:
        total = self._sum(self.device_s, lambda k: k != (MARKERS,))
        between = self.device_s.get((BETWEEN,), 0.0)
        return 1.0 - between / total if total else 0.0


def boundaries(spans, idxs: Sequence[int]) -> List[Tuple[bool, int]]:
    """(entry?, span index) of one thread's spans in the order they
    happened: `idxs` in entry order, each span's parent opened before it."""
    out: List[Tuple[bool, int]] = []
    stack: List[int] = []
    for i in idxs:
        while stack and stack[-1] != spans[i].parent:
            out.append((False, stack.pop()))
        out.append((True, i))
        stack.append(i)
    while stack:
        out.append((False, stack.pop()))
    return out


def _path(spans, i: int) -> Path:
    names = []
    while i >= 0:
        names.append(spans[i].name)
        i = spans[i].parent
    return tuple(reversed(names))


def host_waits(name: str) -> bool:
    """A copy the host waits for: any device-to-host copy, and a
    host-to-device copy from pageable memory (the stream drains first)."""
    return "DtoH" in name or ("HtoD" in name and "Pageable" in name)


def _offset(low: Optional[int], high: Optional[int]) -> int:
    """A step's offset from its bounds: their middle, or the one there is."""
    if low is not None and high is not None:
        return (low + high) // 2
    return low if low is not None else (high if high is not None else 0)


class _Bench:
    """The benchmark spans ((step, name, t0, t1) on the host's clock)."""

    def __init__(self, bench_spans):
        self.items = sorted((t0, t1, step, f"[{name}]")
                            for step, name, t0, t1 in bench_spans)
        self.starts = [it[0] for it in self.items]

    def holder(self, t: int) -> int:
        """Index of the span open at host time t, or -1."""
        j = bisect.bisect_right(self.starts, t) - 1
        return j if j >= 0 and t < self.items[j][1] else -1

    def label(self, t: int) -> str:
        j = self.holder(t)
        return self.items[j][3] if j >= 0 else BETWEEN


def split(events, bench_spans, window: Tuple[int, int], spans,
          thread: int, marker: str, steps: int,
          allocator: Optional[Dict[str, float]] = None) -> Split:
    """Attribute `events` ((name, start, end) on the profiler's clock) to
    the program `spans` of `thread` (records with name, parent, thread,
    t0, t1) by the markers among them, and to `bench_spans` ((step, name,
    t0, t1)) where no program span was open. Raises `Unaligned` where the
    markers and boundaries do not pair off."""
    lo, hi = window
    idxs = [i for i, s in enumerate(spans) if s.thread == thread
            and s.t1 is not None and lo <= s.t0 and s.t1 <= hi]
    bounds = boundaries(spans, idxs)
    evs = sorted(events, key=lambda e: (e[1], e[2]))
    marks = [(a, b) for name, a, b in evs if marker in name]
    if len(marks) != len(bounds):
        raise Unaligned(f"{len(marks)} markers in the window against "
                        f"{len(bounds)} span boundaries")
    paths = {i: _path(spans, i) for i in idxs}
    bench = _Bench(bench_spans)

    # each boundary's step, and each step's bounds on trace less host time
    step_at: List[Optional[int]] = []
    lows: Dict[Optional[int], int] = {}
    highs: Dict[Optional[int], int] = {}
    for (entry, i), (a, b) in zip(bounds, marks):
        j = bench.holder(spans[i].t0)
        st = bench.items[j][2] if j >= 0 else None
        step_at.append(st)
        if entry:
            highs[st] = min(highs.get(st, a - spans[i].t0), a - spans[i].t0)
        elif j >= 0 and spans[i].t1 <= bench.items[j][1]:
            end = b - bench.items[j][1]
            lows[st] = max(lows.get(st, end), end)
    offsets = {st: _offset(lows.get(st), highs.get(st))
               for st in set(lows) | set(highs)}
    widths = sorted(highs[st] - lows[st] for st in lows if st in highs)
    crossed = sum(1 for w in widths if w < 0)
    extract_spans = sorted((t0, t1) for _, name, t0, t1 in bench_spans
                           if name == "extract")
    ex_t0 = [t0 for t0, _ in extract_spans]

    device_s: Dict[Path, float] = {}
    kernels: Dict[Tuple[Path, str], float] = {}
    launches: Dict[Path, int] = {}
    syncs: Dict[Path, int] = {}
    idle_s: Dict[Path, float] = {}
    stack: List[int] = []
    k = 0
    escaped = 0
    step = step_at[0] if step_at else None
    off = offsets.get(step, 0)
    busy = lo                          # the device is busy up to here
    for name, s, e in evs:
        if busy < hi and s > busy:     # an idle gap, ended by this activity
            g1 = min(s, hi)
            key = (paths[stack[-1]] if stack
                   else (bench.label((busy + g1) // 2 - off),))
            idle_s[key] = idle_s.get(key, 0.0) + (g1 - busy) * 1e-9
        busy = max(busy, e)
        if marker in name:
            entry, i = bounds[k]
            step = step_at[k]
            off = offsets.get(step, off)
            k += 1
            if entry:
                stack.append(i)
            else:
                stack.pop()
            key: Path = (MARKERS,)
            device_s[key] = device_s.get(key, 0.0) + (e - s) * 1e-9
            continue
        key = paths[stack[-1]] if stack else (bench.label(s - off),)
        device_s[key] = device_s.get(key, 0.0) + (e - s) * 1e-9
        kk = (key, short_name(name, 48))
        kernels[kk] = kernels.get(kk, 0.0) + (e - s) * 1e-9
        launches[key] = launches.get(key, 0) + 1
        if host_waits(name):
            syncs[key] = syncs.get(key, 0) + 1
        if key[0] != "extract":
            # certainly in a benchmark extract span: under both bounds
            early, late = highs.get(step, off), lows.get(step, off)
            if late > early:
                early = late = off
            j = bisect.bisect_right(ex_t0, s - early) - 1
            if j >= 0 and s - late < extract_spans[j][1]:
                escaped += 1
    if busy < hi:
        key = (bench.label((busy + hi) // 2 - off),)
        idle_s[key] = idle_s.get(key, 0.0) + (hi - busy) * 1e-9
    offs = list(offsets.values()) or [0]
    return Split(steps=steps, device_s=device_s, launches=launches,
                 syncs=syncs, idle_s=idle_s, kernels=kernels,
                 markers=len(marks), offset_ns=(min(offs), max(offs)),
                 crossed=crossed,
                 width_ns=widths[len(widths) // 2] if widths else 0,
                 escaped=escaped,
                 allocator=allocator or {})


def _label(path: Path) -> str:
    return "/".join(path)


def _top(table, n: int = TOP):
    return sorted(table.items(), key=lambda kv: -kv[1])[:n]


def report(sp: Split, ctx, log=None) -> None:
    """The split on standard error: device and idle time by stage, the
    copies the host waits for a step in each program span, the checks
    against the program's extract span and the benchmark's."""
    log = log or sys.stderr
    total = sum(v for k, v in sp.device_s.items() if k != (MARKERS,))
    mk = sp.device_s.get((MARKERS,), 0.0)
    print(f"stages: {sp.markers} markers paired with the span boundaries; "
          f"their device time {mk:.6f} s ({mk / max(sp.markers, 1) * 1e6:.3f}"
          f" us each)", file=log)
    prog = sum(v for k, v in sp.device_s.items()
               if not k[0].startswith(("[", "(")))
    print(f"stages: device time attributed {100 * sp.coverage():.4f}% "
          f"(program spans {100 * prog / max(total, 1e-30):.4f}%, benchmark "
          f"spans the rest); run in a benchmark extract span outside the "
          f"program's: "
          f"{sp.escaped}; trace clock less host clock, by step, from "
          f"{sp.offset_ns[0] / 1e3:.3f} to {sp.offset_ns[1] / 1e3:.3f} us "
          f"(bounds {sp.width_ns / 1e3:.3f} us apart in the median step, "
          f"crossed in {sp.crossed})", file=log)
    ext = 1e3 * sp.under(sp.device_s, "extract")
    stages_ms = sp.leaf_ms(DENSE) + sp.leaf_ms(KEYPOINT)
    bench_ms = ctx.span_mean_ms("extract")
    print(f"stages: a step: dense {sp.leaf_ms(DENSE):.4f} ms + per-keypoint "
          f"{sp.leaf_ms(KEYPOINT):.4f} ms = {stages_ms:.4f} ms of the "
          f"program's extract {ext:.4f} ms "
          f"({100 * stages_ms / ext if ext else 0:.3f}%); the benchmark's "
          f"extract span {bench_ms or 0:.4f} ms; "
          f"{sp.under(sp.launches, 'extract'):.2f} activities under extract",
          file=log)
    print("stages: device_by_stage " + ", ".join(
        f"{_label(k)} {v:.6f}" for k, v in _top(sp.device_s)), file=log)
    for k, _ in _top(sp.device_s, 5):
        top = _top({n: v for (p, n), v in sp.kernels.items() if p == k}, 3)
        print(f"stages: in {_label(k)}: " + ", ".join(
            f"{n} {v:.6f}" for n, v in top), file=log)
    print("stages: idle_by_stage " + ", ".join(
        f"{_label(k)} {v:.6f}" for k, v in _top(sp.idle_s)), file=log)
    waits = ", ".join(f"{_label(k)} {v / sp.steps:.3f}"
                      for k, v in _top(sp.syncs, 64)
                      if not k[0].startswith(("[", "(")))
    counted = ", ".join(f"{k} {v:g}" for k, v in sorted(ctx.counters.items()))
    print(f"stages: copies the host waits for, a step by program span "
          f"{waits or 'none'}; host syncs of one warm step by benchmark span "
          f"{counted or 'none'}", file=log)
    if sp.allocator:
        print("stages: allocator a step over the traced window " + ", ".join(
            f"{k} {v:.3f}" for k, v in sp.allocator.items()), file=log)
    log.flush()


_cache: Tuple[Optional[weakref.ref], Optional[Split]] = (None, None)


def of(ctx) -> Optional[Split]:
    """The split of the run whose context is `ctx`, computed and printed
    once; None without the program's recording of the traced window."""
    global _cache
    ref, sp = _cache
    if ref is not None and ref() is ctx:
        return sp
    sp = None
    rec, marker = _recording()
    if rec is not None and ctx.events and ctx.window_ns and ctx.steps:
        alloc = {}
        if len(rec.allocator) == 2:
            a, b = rec.allocator
            alloc = {k: (b[k] - a[k]) / ctx.steps for k in a}
        try:
            sp = split(ctx.events, ctx.spans, ctx.window_ns, rec.spans,
                       threading.get_native_id(), marker, ctx.steps, alloc)
            report(sp, ctx)
        except Unaligned as err:
            print(f"stages: no split: {err}", file=sys.stderr, flush=True)
            sp = None
        except Exception:       # the readers give no value; the run goes on
            print("stages: no split:", file=sys.stderr)
            traceback.print_exc()
            sp = None
    _cache = (weakref.ref(ctx), sp)
    return sp


def _recording():
    """(the program's recording of the last profiler session, its marker
    kernel's name), where the program keeps one with markers. It is read
    from the program's module as the run's steps loaded it: the yardstick
    imports nothing of the program (`tests/test_portbench_imports.py`)."""
    metrics = sys.modules.get("sift_tpu_torch.utils.metrics")
    profiled = getattr(metrics, "profiled", None)
    rec = profiled() if profiled is not None else None
    if rec is None or not getattr(rec, "marks", False):
        return None, None
    return rec, metrics.MARKER_KERNEL
