#!/usr/bin/env python3
"""The benchmark of `sift_tpu_torch`: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with the CUDA cards the cell
asks for; without them it exits with code 2 and prints no result. The
last line of standard output is the result as one JSON object; the last
lines of standard error are the numbers compared, each beside its limit.
Exit code 0 when the run completed (whether or not `correct`), 3 when
JAX or the JAX package was loaded, 2 when the cards are missing.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Every cache of the program and of the libraries under it stays inside
# the checkout, at fixed paths (the hand kernels build into build/ of the
# checkout by themselves).
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / "portbench" / sub)
sys.path[:0] = [str(ROOT)]


def finite(obj):
    """`obj` with every non-finite float as null (strict JSON)."""
    if isinstance(obj, dict):
        return {k: finite(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [finite(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    return obj


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from portbench.lib import cells
    cell = cells.resolve(args.workload)
    import torch
    # load from one process with one host thread: the pool's spinning
    # workers would share the host's cores with the dispatching thread
    torch.set_num_threads(1)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {chips} CUDA card(s), this machine "
              f"has {n}", file=sys.stderr, flush=True)
        return 2

    from portbench.lib import harness
    torch.cuda.set_device(0)
    out = harness.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", t0=T0)
    banned = harness.banned_modules()
    if banned:
        print(f"portbench: the run loaded {banned}; no result",
              file=sys.stderr, flush=True)
        return 3
    for k, c in out.checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(finite(out.line)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
