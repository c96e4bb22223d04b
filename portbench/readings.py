#!/usr/bin/env python3
"""Readings that the limits of a cell's check are set from, in one process.

    python3 portbench/readings.py --workload <cell> --seeds 12 \
        --control-seeds 3 [--seconds 3] [--first-seed N]

For each of `--seeds` seeds, a short window of the program at the cell's
own load, then the check as a run makes it; for each of
`--control-seeds` seeds, each control: the reference in the program's
place at the nearest precision below the stated one
(`reference.sift_lowe.CONTROLS`: `control`, a bfloat16 pyramid, TF32
products and float32 fits; `control_tf32`, TF32 products alone), on as
many steps as a run checks. Prints one JSON line a reading and, last,
for each number the largest program reading and each control's smallest
reading. Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import io
import json
import math
import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1])]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--first-seed", type=int, default=2**31 + 101)
    args = p.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 2
    from portbench.lib import cells, harness
    from portbench.reference.sift_lowe import CONTROLS
    cell = cells.resolve(args.workload)
    judge = cells.load_module("judges", cell.step_kind)
    quiet = io.StringIO()
    lower = {}
    upper = {name: {} for name in CONTROLS}
    for n in range(args.seeds):
        seed = args.first_seed + 7919 * n
        out = harness.run(args.workload, seed, args.seconds, False, "cuda",
                          log=quiet)
        got = {k: c["value"] for k, c in out.checks.items()}
        print(json.dumps({"side": "program", "seed": seed, **got,
                          **out.info}), flush=True)
        for k, v in got.items():
            lower[k] = max(lower.get(k, -math.inf), v)
    for name, prec in CONTROLS.items():
        for n in range(args.control_seeds):
            seed = args.first_seed + 7919 * n

            def control(inputs):
                return judge.reference(cell.config, inputs, prec)
            out = harness.run(args.workload, seed, 0, False, "cuda",
                              log=quiet, steps=cell.traffic["check"]["items"],
                              program=control)
            got = {k: c["value"] for k, c in out.checks.items()}
            print(json.dumps({"side": name, "seed": seed, **got,
                              **out.info}), flush=True)
            for k, v in got.items():
                upper[name][k] = min(upper[name].get(k, math.inf), v)
    print(json.dumps({"lower": lower, "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
