"""What a metric reader reads: the run's records."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from portbench.lib import stats
from portbench.lib.tracing import Event


@dataclasses.dataclass
class Context:
    """cell: the `workloads` entry; config, traffic: their files' JSON;
    batch: images a step extracts; steps: steps in the window; window_s:
    first dispatch to the last step's end; latencies_s: each step's
    dispatch-to-host time; setup_s; with --trace 1 also, from the same
    steps run again under the profiler, spans: (step, name, start ns, end
    ns) on the profiler's clock, events: device activities, window_ns:
    the traced window on that clock, counters, and per-step `stats` that
    steps report for work formulas."""

    cell: dict
    config: dict
    traffic: dict
    batch: int
    steps: int
    window_s: float
    latencies_s: List[float]
    setup_s: float
    spans: List[Tuple[int, str, int, int]] = dataclasses.field(default_factory=list)
    events: List[Event] = dataclasses.field(default_factory=list)
    window_ns: Optional[Tuple[int, int]] = None
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)
    step_stats: List[dict] = dataclasses.field(default_factory=list)

    @property
    def image(self) -> Tuple[int, int]:
        return self.config["image"]["height"], self.config["image"]["width"]

    def kernel_seconds(self, names: Sequence[str]) -> Tuple[float, int]:
        """(device seconds, launches) of the kernels whose name holds one
        of `names`."""
        secs, n = 0.0, 0
        for name, s, e in self.events:
            if any(k in name for k in names):
                secs += (e - s) * 1e-9
                n += 1
        return secs, n

    def busy_s(self) -> float:
        """Seconds of the traced window in which some device activity ran
        (overlaps counted once)."""
        lo, hi = self.window_ns
        return stats.union_length((max(s, lo), min(e, hi))
                                  for _, s, e in self.events) * 1e-9

    def traced_window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) * 1e-9

    def span_mean_ms(self, name: str) -> Optional[float]:
        d = [(e - s) * 1e-6 for _, n, s, e in self.spans if n == name]
        return sum(d) / len(d) if d else None
