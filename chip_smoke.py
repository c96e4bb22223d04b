#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (`sift_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from `sift_tpu_torch/csrc/` (one nvcc each, in
     parallel) and print the build time;
  3. drive the main path once — `extract_batch` on B=8 frames of 488x600
     with the default `SiftConfig()` — with the launch counters set to 0
     just before and read just after; every kernel must have launched
     (8 window gathers, 4 refine walks, 4 descriptor passes per batch).
     The kernels' arguments are recorded on the way;
  4. call each kernel again on the recorded arguments and hold it against
     its plain PyTorch version on the card: gathers and refine walks must
     be bit-identical, descriptors within `descriptor.TOLERANCE`; time
     kernel and plain version;
  5. check the output (shapes, finite values, keypoints found) and hold
     image 0 against the port's plain path on the CPU; time the batch and
     print keyframes/s.
Then it prints one `kernels` JSON line, the card line, and as its last
line {"ok": true, "device": {...}}. It imports nothing of JAX or of the
`sift_tpu` package, and exits non-zero without a result when there is no
CUDA card or no `sift_tpu_torch` beside it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

BATCH, HEIGHT, WIDTH = 8, 488, 600
EXPECTED_LAUNCHES = {"gather_windows": 8, "refine_walk": 4,
                     "descriptor_accumulate": 4}
SOURCES = {
    "gather_windows": ("sift_tpu_torch/csrc/windows.cu",
                       "sift_tpu/kernels/pallas/windows.py:216"),
    "refine_walk": ("sift_tpu_torch/csrc/refine.cu",
                    "sift_tpu/kernels/pallas/refine.py:153"),
    "descriptor_accumulate": ("sift_tpu_torch/csrc/descriptor.cu",
                              "sift_tpu/kernels/pallas/descriptor.py:151"),
}
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and f32
# (non-tensor-core) FLOP/s.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# f32 operations per window pixel of the descriptor pass, both peaks:
# magnitude + angle ~20 (atan2 counted as ~12), and per peak: u, v 6,
# Gaussian weight 6, orientation bins 10, tents 16, and 2x2 cells x 2 bins
# x 3 (product, weight, add) = 24 for the non-zero votes -> 20 + 2*62.
DESC_OPS_PER_PIXEL = 144
OUT_DIR = "chiprun_out"


def make_frames(batch: int, h: int = HEIGHT, w: int = WIDTH) -> np.ndarray:
    """VGA-class synthetic frames in [0, 255] (the repo benchmark's
    fallback recipe: a sin*cos texture plus noise, then per-frame
    brightness shifts)."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = (128 + 60 * np.sin(xx / 7.0) * np.cos(yy / 11.0)
            + 40 * rng.standard_normal((h, w))).clip(0, 255).astype(np.float32)
    rng = np.random.default_rng(1)
    shifts = rng.uniform(-2.0, 2.0, size=(batch, 1, 1)).astype(np.float32)
    return np.clip(base[None] + shifts, 0.0, 255.0).astype(np.float32)


def make_textured(h: int = HEIGHT, w: int = WIDTH) -> np.ndarray:
    """A dense-texture frame (box-smoothed uniform noise, stretched to
    [0, 255]) that yields hundreds of keypoints, for the CPU comparison:
    the benchmark frames above yield only a few."""
    rng = np.random.default_rng(2)
    noise = rng.uniform(0.0, 255.0, (h + 4, w + 4))
    img = sum(noise[dy:dy + h, dx:dx + w] for dy in range(5)
              for dx in range(5)) / 25.0
    img = (img - img.min()) / (img.max() - img.min()) * 255.0
    return img.astype(np.float32)[None]


def fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


def event_ms(torch, fn, reps: int) -> float:
    """Mean stream time per call, CUDA events around `reps` calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(torch, fn, reps: int, kernel_name: str):
    """Mean device time per call of the CUDA kernels whose name contains
    `kernel_name`, from the profiler's CUPTI trace; None if the trace shows
    no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for ev in prof.key_averages():
        if kernel_name in ev.key:
            total_us += getattr(ev, "device_time_total",
                                getattr(ev, "cuda_time_total", 0.0))
    return total_us / reps / 1e3 if total_us > 0 else None


def bound(nbytes: float, nops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def work_of(name: str, args) -> tuple[float, float]:
    """(bytes, f32 ops) that one call must move and do on these inputs."""
    if name == "gather_windows":
        maps, gl, y0, x0, d = args
        K, C = gl.shape[0], maps.shape[0]
        return K * C * d * d * (maps.element_size() + 4) + K * 12, 0.0
    if name == "refine_walk":
        patches, start = args
        K, L = patches.shape[:2]
        return K * (L * 256 * 4 + 32) + K * (27 * 4 + 16), K * 6 * 150.0
    wins, scal = args
    K, _, d, _ = wins.shape
    return (K * (2 * d * d * 4 + scal.shape[1] * 4 + 2 * 128 * 4),
            K * d * d * float(DESC_OPS_PER_PIXEL))


def match_keypoints(a, b, i: int):
    """Fraction of image i's valid keypoints in `a` with a counterpart in
    `b` (same octave and level, position within 0.01 px, orientation within
    0.1 deg), and the largest descriptor difference over those pairs."""
    va = np.flatnonzero(a.valid[i])
    vb = np.flatnonzero(b.valid[i])
    matched, worst = 0, 0.0
    for s in va:
        cand = vb[(b.octave[i, vb] == a.octave[i, s])
                  & (b.level[i, vb] == a.level[i, s])
                  & (np.abs(b.x[i, vb] - a.x[i, s]) < 1e-2)
                  & (np.abs(b.y[i, vb] - a.y[i, s]) < 1e-2)]
        dori = np.abs((b.orientation[i, cand] - a.orientation[i, s]
                       + 180.0) % 360.0 - 180.0)
        cand = cand[dori < 0.1]
        if cand.size:
            matched += 1
            worst = max(worst, float(np.abs(
                b.desc[i, cand] - a.desc[i, s]).max(axis=1).min()))
    return matched / max(va.size, 1), worst


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs the card",
              file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        import sift_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: sift_tpu_torch not found beside the script: {e}",
              file=sys.stderr)
        return 2
    from sift_tpu_torch import SiftConfig, extract_batch
    from sift_tpu_torch.kernels import build
    from sift_tpu_torch.kernels import cuda as kcuda
    from sift_tpu_torch.kernels.cuda import descriptor, refine, windows

    os.makedirs(os.path.join(here, OUT_DIR), exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        f"nvidia-smi failed: {smi.stderr.strip()}"
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    paths = build.build()
    print(f"build: {len(paths)} kernels in {time.perf_counter() - t0:.1f} s",
          flush=True)

    # 3. the main path, counted, with the kernels' arguments recorded
    modules = {"gather_windows": (windows, "gather_windows"),
               "refine_walk": (refine, "refine_walk"),
               "descriptor_accumulate": (descriptor, "descriptor_accumulate")}
    recorded = {name: [] for name in modules}
    originals = {}
    for name, (mod, attr) in modules.items():
        originals[name] = getattr(mod, attr)

        def recorder(*args, _name=name):
            recorded[_name].append(args)
            return originals[_name](*args)
        setattr(mod, attr, recorder)

    cfg = SiftConfig()
    frames_np = make_frames(BATCH)
    frames = torch.from_numpy(frames_np).cuda()
    try:
        kcuda.reset_launch_counts()
        kp = extract_batch(frames, cfg)
        torch.cuda.synchronize()
        launches = kcuda.launch_counts()
    finally:
        for name, (mod, attr) in modules.items():
            setattr(mod, attr, originals[name])
    print(f"main path launches: {launches}", flush=True)
    if launches != EXPECTED_LAUNCHES:
        return fail(f"launch counts {launches} != {EXPECTED_LAUNCHES}")

    # 4. each kernel against its plain version, on the recorded arguments
    plain = {"gather_windows": windows.gather_windows_plain,
             "refine_walk": refine.refine_walk_plain,
             "descriptor_accumulate": descriptor.descriptor_accumulate_plain}
    kernel_symbol = {"gather_windows": "gather_windows_kernel",
                     "refine_walk": "refine_walk_kernel",
                     "descriptor_accumulate": "descriptor_kernel"}
    rows = []
    for name, calls in recorded.items():
        kern = originals[name]
        err = rel = 0.0
        ms = ms_events = plain_ms = bytes_total = ops_total = 0.0
        device_seen = True
        for args in calls:
            got, want = kern(*args), plain[name](*args)
            torch.cuda.synchronize()
            if name == "descriptor_accumulate":
                e = float((got - want).abs().max())
                scale = float(want.abs().max())
                if e > descriptor.TOLERANCE * max(scale, 1e-30):
                    return fail(f"{name}: max diff {e} over max {scale}")
                rel = max(rel, e / max(scale, 1e-30))
            else:
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                e = max(float((g.double() - w.double()).abs().max())
                        if g.numel() else 0.0 for g, w in zip(got, want))
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    return fail(f"{name}: kernel differs from plain ({e})")
            err = max(err, e)
            reps = 20
            ms_events += event_ms(torch, lambda: kern(*args), reps)
            dev = device_ms(torch, lambda: kern(*args), reps,
                            kernel_symbol[name])
            if dev is None:
                device_seen = False
            else:
                ms += dev
            plain_ms += event_ms(torch, lambda: plain[name](*args), 3)
            b, o = work_of(name, args)
            bytes_total += b
            ops_total += o
        bound_ms, bound_by = bound(bytes_total, ops_total)
        src, replaces = SOURCES[name]
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": err,
            "ms": ms if device_seen else ms_events,
            "ms_stream": ms_events,
            "timing": "cupti" if device_seen else "events",
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,
        })
        print(f"{name}: {len(calls)} calls ok, max_abs_err {err:.3g} "
              f"(relative to the largest output {rel:.3g}), "
              f"{rows[-1]['ms']:.4f} ms/batch ({rows[-1]['timing']}), stream "
              f"{ms_events:.4f} ms, plain {plain_ms:.3f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by})", flush=True)

    # 5. output checks, CPU plain path on image 0, throughput
    kpn = kp.to_numpy()
    n = kpn.valid.sum(axis=1)
    print(f"valid keypoints per image: {n.tolist()}, n_dropped "
          f"{kpn.n_dropped.tolist()}, n_cand_pruned "
          f"{kpn.n_cand_pruned.tolist()}", flush=True)
    if kpn.x.shape != (BATCH, cfg.max_keypoints) or \
            kpn.desc.shape != (BATCH, cfg.max_keypoints, 128):
        return fail(f"shapes x {kpn.x.shape} desc {kpn.desc.shape}")
    if (n == 0).any():
        return fail("an image has no valid keypoints")
    for f in ("x", "y", "scale", "orientation", "desc"):
        a = getattr(kpn, f)[kpn.valid]
        if not np.isfinite(a).all():
            return fail(f"non-finite {f}")
    textured = make_textured()
    for label, card_kp, img in (
            ("benchmark image 0", kpn, frames_np[:1]),
            ("textured image", extract_batch(textured, cfg).to_numpy(),
             textured)):
        cpu = extract_batch(img, cfg, device="cpu").to_numpy()
        fwd, worst_fwd = match_keypoints(cpu, card_kp, 0)
        back, worst_back = match_keypoints(card_kp, cpu, 0)
        worst = max(worst_fwd, worst_back)
        print(f"{label} vs CPU plain path: {int(cpu.valid[0].sum())} vs "
              f"{int(card_kp.valid[0].sum())} valid, matched {fwd:.4f} / "
              f"{back:.4f}, max desc diff {worst:.3g}", flush=True)
        if min(fwd, back) < 0.99 or worst > 2e-3:
            return fail(f"card and CPU plain path disagree on the {label}")

    reps = 20
    extract_batch(frames, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        extract_batch(frames, cfg)
    torch.cuda.synchronize()
    batch_s = (time.perf_counter() - t0) / reps
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        extract_batch(frames, cfg)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t1
    table = prof.key_averages().table(sort_by="device_time_total",
                                      row_limit=40)
    with open(os.path.join(here, OUT_DIR, "chip_smoke_profile.txt"), "w") as fh:
        fh.write(f"card: {card}\n{table}\n")
    # Device busy time: the kernels' own events only (the operator rows
    # repeat their kernels' time).
    busy_us = sum(getattr(ev, "self_device_time_total",
                          getattr(ev, "self_cuda_time_total", 0.0))
                  for ev in prof.key_averages()
                  if ev.device_type == torch.autograd.DeviceType.CUDA)
    print(f"extract_batch B={BATCH} {HEIGHT}x{WIDTH}: {batch_s * 1e3:.3f} "
          f"ms/batch, {BATCH / batch_s:.2f} kf/s; profiled batch device busy "
          f"{busy_us / 1e3:.3f} ms of {prof_wall * 1e3:.3f} ms wall; "
          f"card {card}", flush=True)

    print(json.dumps({"kernels": rows}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
