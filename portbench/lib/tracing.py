"""The device timeline of a traced window, read from the profiler's CUPTI
records.

`Session` runs `torch.profiler` with CUDA activity only (no operator
records on the host, so the trace stays small and the host's pace close
to an untraced run's). After the window it waits `WAIT_S` before it stops:
on the H100 a session that stops right after its last kernel can lack its
last records. Timestamps are the profiler's wall clock in ns, the clock of
`time.time_ns()`, so host spans map onto the device timeline.
"""

from __future__ import annotations

import time
from typing import List, Tuple

import torch

WAIT_S = 5.0

Event = Tuple[str, int, int]       # (name, start ns, end ns)


class Session:
    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])

    def __enter__(self):
        self._prof.start()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        time.sleep(WAIT_S)
        self._prof.stop()
        return False

    def device_events(self) -> List[Event]:
        """Every device activity of the session: kernels, copies, sets."""
        out = []
        for ev in self._prof.profiler.kineto_results.events():
            if ev.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            start = ev.start_ns()
            out.append((ev.name(), start, start + ev.duration_ns()))
        return out


def short_name(name: str, limit: int = 96) -> str:
    """A kernel's name without its return type and argument list (the
    last parenthesised group), at most `limit` chars."""
    n = name.strip()
    if n.endswith(")"):
        depth = 0
        for i in range(len(n) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(n[i], 0)
            if depth == 0:
                n = n[:i].rstrip()
                break
    if n.startswith("void "):
        n = n[5:]
    return n[:limit] or name[:limit]
