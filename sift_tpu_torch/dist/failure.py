"""Multi-process failure detection (counterpart of
`sift_tpu/dist/failure.py`, a copy: that module imports no JAX, but its
package does).

A `torch.distributed` world has no elasticity: when a process dies
mid-collective, the surviving processes hang in the collective (gloo or
NCCL) until its timeout ends them too. Recovery is therefore detect ->
checkpoint -> restart on a smaller mesh, and the detection lives OUTSIDE
the collectives. This module is the standard shared-filesystem heartbeat:

  * every process runs a `Heartbeat` daemon thread stamping a per-process
    file (local disk for one host, a shared filesystem across hosts: the
    same mechanism either way);
  * anyone can ask `stale_peers()` between device dispatches; a stale peer
    means the job should stop cleanly at the next step boundary and be
    restarted from the last checkpoint (`io/checkpoint.py`) with a smaller
    mesh (tests/test_torch_dist_pipeline.py runs the kill -> detect ->
    restart -> resume cycle).

It is not built on the process group's own liveness (a peer's death shows
only as a collective that never returns): the heartbeat detects at step
granularity with no collective.
"""

from __future__ import annotations

import os
import threading
import time
from typing import List, Optional


class Heartbeat:
    """File-based heartbeat for one process of a multi-process job."""

    def __init__(self, directory: str, process_id: int,
                 interval_s: float = 0.25):
        self.directory = directory
        self.process_id = process_id
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    def _path(self, pid: int) -> str:
        return os.path.join(self.directory, f"heartbeat_{pid}")

    def beat_once(self) -> None:
        """Stamp this process's heartbeat file (atomic rename)."""
        p = self._path(self.process_id)
        tmp = p + ".tmp"
        with open(tmp, "w") as f:
            f.write(repr(time.time()))
        os.replace(tmp, p)

    def start(self) -> "Heartbeat":
        self.beat_once()

        def loop():
            while not self._stop.wait(self.interval_s):
                self.beat_once()

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def last_seen(self, pid: int) -> Optional[float]:
        """Wall-clock timestamp of `pid`'s last beat, None if never seen."""
        try:
            with open(self._path(pid)) as f:
                return float(f.read())
        except (OSError, ValueError):
            return None

    def stale_peers(self, num_processes: int,
                    timeout_s: float = 2.0) -> List[int]:
        """Process ids (excluding self) whose last beat is older than
        `timeout_s`. A peer that has NEVER beaten counts as stale
        immediately — call `wait_for_peers` once at job start so slow
        starters are not mistaken for dead ones."""
        now = time.time()
        stale = []
        for pid in range(num_processes):
            if pid == self.process_id:
                continue
            seen = self.last_seen(pid)
            if seen is None or now - seen > timeout_s:
                stale.append(pid)
        return stale

    def wait_for_peers(self, num_processes: int,
                       timeout_s: float = 30.0) -> bool:
        """Block until every peer has beaten at least once (job start
        barrier); False on timeout."""
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            if all(self.last_seen(p) is not None
                   for p in range(num_processes)):
                return True
            time.sleep(0.05)
        return False

    def __enter__(self) -> "Heartbeat":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
