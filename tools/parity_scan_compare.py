"""The parity scan kernel (`sift_tpu_torch/csrc/parity_scan.cu`) of one or
more checkouts, side by side on one CUDA card.

Each checkout named by `--root` runs in its own process, in the order
given, with its own `sift_tpu_torch` and `chip_smoke.py` imported. It
records the scan call of `extract_batch` in parity mode on phase 13b's
488x600 frame (`chip_smoke.parity_frame`, B = 1) and on phase 17a's B=8
batch of it rolled, then, on these cells:

- "frame" and "batch": the two calls;
- "batch[:b]" for b = 1, 2, 4: the batch's first b images alone;
- "batch, image 0's slots": the batch's maps and table with every slot
  of images 1-7 without ok (one image's walk in the B=8 maps);
- "batch, 256 slots an image": the batch with every slot past each
  image's 256th without ok (eight short walks side by side, on few
  bytes);
- "batch[:1] after the batch's zeros": batch[:1], each call after a
  memset of as many bytes as the batch's seen (what a B=8 call zeroes
  just before its walk; the memset is in the device ms, not the kernel
  ms);

checks the kernel against `parity_scan_plain` bit for bit (NaN-equal,
seen and maps), and times a call of `parity_scan` (20 calls each): the
hand kernel's CUPTI ms (`utils/timing.kernel_trace`); every device
operation's CUPTI ms and their count (the index lists, seen's zeros and
the kernel); the stream ms (`event_ms`); the host's enqueue ms (the
calls issued without a sync); and the host syncs of a call
(`chip_smoke.count_syncs`). It prints the ok slots and the longest
plane (ok slots of one Gaussian plane: the steps of a walk that takes a
plane's slots one after another, so the kernel's ms over it is the time
a step of such a walk). It uses only the public `parity_scan` and
`parity_scan_plain`, so it runs any checkout since they came in; phase
17c of `chip_smoke.py` prints the tile lists. For the frame and the
batch it writes the profiler's table of one call's operators (host and
device) to `chiprun_out/parity_scan_profile_<checkout>_<cell>_<pid>.txt`.

Run from the repository root on a machine with a card, a parent commit
unpacked beside it (`git archive <commit> chip_smoke.py sift_tpu_torch |
tar -x -C build/parent`):

    python3 tools/parity_scan_compare.py --root build/parent --root . \\
        --root . --root build/parent

Prints one JSON line a (checkout, cell) and the card's name and power
limit, and writes the rows to `chiprun_out/parity_scan_compare.json`.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 20


def child(root: str) -> int:
    """Record, check and time one checkout's kernel; one JSON line a
    cell."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from sift_tpu_torch import SiftConfig, extract_batch
    from sift_tpu_torch.kernels.cuda import parity_scan as ps
    from torch.profiler import ProfilerActivity
    from sift_tpu_torch.utils.timing import (event_ms, kernel_trace,
                                             profiled, whole_trace)

    def device_trace(fn):
        """(ms, operations) a call of `fn` on the device: every kernel,
        memset and copy of its CUPTI trace (`whole_trace`'s retakes)."""
        def session(wait):
            def run():
                for _ in range(REPS):
                    fn()
                torch.cuda.synchronize()
                time.sleep(wait)
            _, events = profiled(run, [ProfilerActivity.CUDA])
            dev = [e for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA]
            return (sum(e.self_device_time_total for e in dev),
                    sum(e.count for e in dev))
        fn()
        torch.cuda.synchronize()
        ms, ops, _ = whole_trace(session, REPS, None)
        return ms, ops

    cfg = SiftConfig(mode="parity", max_keypoints_per_octave=cs.PARITY_CAPS[0],
                     max_keypoints=cs.PARITY_CAPS[1])
    frame = cs.parity_frame(torch)
    batch = np.stack([np.roll(frame, (cs.PARITY_ROLL[0] * i,
                                      cs.PARITY_ROLL[1] * i), axis=(0, 1))
                      for i in range(cs.BATCH)])
    recorded = {}
    for label, imgs in (("frame", frame[None]), ("batch", batch)):
        with cs.scan_recording() as calls:
            extract_batch(torch.from_numpy(imgs).cuda(), cfg)
            torch.cuda.synchronize()
        recorded[label] = calls[0]
    cells = dict(recorded)
    for b in (1, 2, 4):
        cells[f"batch[:{b}]"] = tuple(t[:b].contiguous()
                                      for t in recorded["batch"])
    maps, wtl, ori, table = recorded["batch"]
    one = table.clone()
    one[1:, :, 4] = 0
    cells["batch, image 0's slots"] = (maps, wtl, ori, one)
    few = table.clone()
    few[:, 256:, 4] = 0
    cells["batch, 256 slots an image"] = (maps, wtl, ori, few)
    B, N = table.shape[:2]
    zeros = torch.empty(B * N * 2 * 16 * 16, device=maps.device)
    cells["batch[:1] after the batch's zeros"] = cells["batch[:1]"]

    for label, (maps, wtl, ori, table) in cells.items():
        B, O, Lg = maps.shape[:3]
        ok = table[..., 4] != 0
        plane = ((torch.arange(B, device=maps.device)[:, None] * O
                  + table[..., 0]) * Lg + table[..., 1])[ok]
        longest_plane = int(torch.bincount(plane).max()) if plane.numel() \
            else 0
        got_maps, want_maps = maps.clone(), maps.clone()
        got = ps.parity_scan(got_maps, wtl, ori, table)
        want = ps.parity_scan_plain(want_maps, wtl, ori, table)
        same = cs.nan_equal(got, want) and cs.nan_equal(got_maps, want_maps)
        work = maps.clone()

        def call(first=label.endswith("the batch's zeros")):
            if first:
                zeros.zero_()
            return ps.parity_scan(work, wtl, ori, table)
        ms, _, _ = kernel_trace(call, "parity_scan_kernel", REPS)
        device_ms, device_ops = device_trace(call)
        syncs = cs.count_syncs(torch, call)
        ms_stream = event_ms(call, REPS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(REPS):
            call()
        host_ms = (time.perf_counter() - t0) / REPS * 1e3
        torch.cuda.synchronize()
        if label in ("frame", "batch"):
            _, events = profiled(lambda: (call(), torch.cuda.synchronize()),
                                 [ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA])
            name = (f"parity_scan_profile_{os.path.basename(root)}_{label}_"
                    f"{os.getpid()}.txt")
            with open(os.path.join(REPO, "chiprun_out", name), "w") as f:
                f.write(events.table(sort_by="self_cpu_time_total",
                                     row_limit=40))
        print(json.dumps({
            "root": root, "cell": label, "bit_identical": same,
            "slots": int(ok.sum()), "longest_plane": longest_plane,
            "ms": ms, "device_ms": device_ms, "device_ops": device_ops,
            "ms_stream": ms_stream, "host_ms": host_ms,
            "syncs": syncs}), flush=True)
        if not same:
            return 1
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", action="append", default=None,
                    help="a checkout's root; repeat to run several in turn")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args.child)
    import torch
    if not torch.cuda.is_available():
        print("parity_scan_compare: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        f"nvidia-smi failed: {smi.stderr.strip()}"
    rows, rc = [], 0
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    for root in map(os.path.abspath, args.root or [REPO]):
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--child", root],
                           capture_output=True, text=True, cwd=root)
        for line in p.stdout.splitlines():
            if line.startswith("{"):
                rows.append(json.loads(line))
                print(line, flush=True)
        if p.returncode != 0:
            print(f"{root}: rc {p.returncode}\n{p.stderr[-4000:]}",
                  file=sys.stderr, flush=True)
            rc = 1
    out = os.path.join(REPO, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "parity_scan_compare.json"), "w") as f:
        json.dump({"card": card, "rows": rows}, f, indent=1)
    print(f"card: {card}", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
