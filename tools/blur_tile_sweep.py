"""Tile sweep of the port's blur kernel (`sift_tpu_torch/csrc/blur.cu`) on
a CUDA card.

Records the blur calls that `extract_batch` makes on three of
`chip_smoke.py`'s cells (phase 5's B=8 488x600 lowe batch, phase 6's
2400x3200 pair, phase 13b's 488x600 parity frame), then times each cell's
calls at fixed tile shapes, each with the staged rows in strips under
`blur.SMEM_TARGET` and in one strip up to the card's opt-in shared
memory (where that differs), and at what `blur.tile_plan` picks. Every
result is checked bit for bit against the plain stencil first. Times are CUPTI kernel time a
cell (the sum of its calls, `utils/timing.kernel_trace`, 20 repetitions);
"not whole" where no trace held every launch.

Run from the repository root on a machine with a card:

    python3 tools/blur_tile_sweep.py

Prints one line a (cell, plan) and the card's name and power limit, and
writes the rows to `chiprun_out/blur_tile_sweep.json`.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

TILES = [(TH, TW) for TH in (16, 32, 64) for TW in (32, 64, 128)]
REPS = 20


def fixed_plan(bk, H: int, W: int, r: int, TH: int, TW: int, budget: int):
    """`tile_plan`'s plan with the tile forced to TH x TW (clamped to the
    plane as `tile_plan` clamps) and the staged rows in strips that fit
    `budget` bytes; None if one staged row does not fit in the card's
    opt-in shared memory."""
    TH = min(TH, bk.P * math.ceil(H / bk.P))
    TW = min(TW, bk.P * math.ceil(W / bk.P))
    row = 4 * ((TW + 2 * r) | 1)
    S = min(TH + 2 * r, (budget - bk.smem_bytes(TH, TW, 0, r)) // row)
    if S < 1:
        S = min(TH + 2 * r,
                (bk.SMEM_MAX - bk.smem_bytes(TH, TW, 0, r)) // row)
    if S < 1:
        return None
    return TH, TW, S, bk.smem_bytes(TH, TW, S, r)


def _blocks(img, plan) -> int:
    H, W = img.shape[-2], img.shape[-1]
    return (img.numel() // (H * W) * math.ceil(H / plan[0])
            * math.ceil(W / plan[1]))


def launch(torch, bk, build, img, taps, plan):
    """One launch of the kernel at `plan` (the wrapper's launch, without
    its plan or its launch count)."""
    out = torch.empty_like(img)
    H, W = img.shape[-2], img.shape[-1]
    TH, TW, S, smem = plan
    rc = bk._fn()(img.data_ptr(), out.data_ptr(), taps.ctypes.data,
                  taps.size, img.numel() // (H * W), H, W, TH, TW, S, smem,
                  torch.cuda.current_stream().cuda_stream)
    build.check(rc, "blur")
    return out


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("blur_tile_sweep: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from sift_tpu_torch import SiftConfig, extract_batch
    from sift_tpu_torch.kernels import build
    from sift_tpu_torch.kernels.cuda import blur as bk
    from sift_tpu_torch.kernels.gaussian import gaussian_kernel_1d
    from sift_tpu_torch.utils.timing import kernel_trace

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    cells = {
        "batch": (torch.from_numpy(cs.make_frames(cs.BATCH)).cuda(),
                  SiftConfig()),
        "pair": (torch.from_numpy(cs.match_pair()[0].copy()).cuda(),
                 SiftConfig(max_keypoints=cs.MATCH_FEATURES,
                            max_keypoints_per_octave=cs.MATCH_FEATURES)),
        "parity": (torch.from_numpy(cs.parity_frame(torch))[None].cuda(),
                   SiftConfig(mode="parity",
                              max_keypoints_per_octave=cs.PARITY_CAPS[0],
                              max_keypoints=cs.PARITY_CAPS[1])),
    }
    gen = torch.Generator(device="cuda").manual_seed(27)
    # parity's largest radius on phase 6's plane, alone
    r27 = (torch.rand((1, 2400, 3200), generator=gen, device="cuda") * 255,
           np.asarray(gaussian_kernel_1d(9.0, radius=27), np.float32))
    calls = {}
    for label, (imgs, cfg) in cells.items():
        with cs.recording({"blur": (bk, "blur")}) as (rec, _):
            extract_batch(imgs, cfg)
        calls[label] = [(img, np.ascontiguousarray(taps, np.float32))
                        for img, taps in rec["blur"]]
    calls["r27"] = [r27]
    torch.cuda.synchronize()

    rows = []
    for label, cell in calls.items():
        planes = {"tile_plan": [
            bk.tile_plan(i.shape[-2], i.shape[-1], (t.size - 1) // 2,
                         i.numel() // (i.shape[-2] * i.shape[-1]))
            for i, t in cell]}
        for TH, TW in TILES:
            for strips, budget in (("strips", bk.SMEM_TARGET),
                                   ("one strip", bk.SMEM_MAX)):
                planes[f"{TH}x{TW} {strips}"] = [
                    fixed_plan(bk, i.shape[-2], i.shape[-1],
                               (t.size - 1) // 2, TH, TW, budget)
                    for i, t in cell]
        seen = set()
        for name, plans in planes.items():
            if any(p is None for p in plans) or tuple(plans) in seen:
                continue                    # a plan no card takes, or timed
            seen.add(tuple(plans))
            for (img, taps), plan in zip(cell, plans):
                got = launch(torch, bk, build, img, taps, plan)
                if not cs.same_bits(got, bk.blur_plain(img, taps)):
                    raise SystemExit(f"{label} {name}: plan {plan} differs "
                                     f"from the stencil at "
                                     f"{tuple(img.shape)}, {taps.size} taps")
            ms, per_call, wait = kernel_trace(
                lambda: [launch(torch, bk, build, i, t, p)
                         for (i, t), p in zip(cell, plans)],
                cs.KERNEL_SYMBOLS["blur"], REPS, launches=len(cell))
            blocks = sum(_blocks(i, p) for (i, _), p in zip(cell, plans))
            row = {"cell": label, "plan": name, "calls": len(cell),
                   "ms": ms, "launches_per_call": per_call,
                   "cupti_wait_s": wait, "blocks": blocks,
                   "strips": sum(p[2] < p[0] + t.size - 1
                                 for (_, t), p in zip(cell, plans)),
                   "smem_max": max(p[3] for p in plans), "card": card}
            rows.append(row)
            print(f"{label:7s} {name:18s} "
                  + (f"{ms:.4f} ms" if ms is not None else "not whole")
                  + f", {blocks} blocks, {row['strips']} calls in strips, "
                  f"smem <= {row['smem_max']} B", flush=True)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "blur_tile_sweep.json"),
              "w") as f:
        json.dump(rows, f, indent=1)
    print(f"card {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
