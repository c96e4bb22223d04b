#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (`sift_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from `sift_tpu_torch/csrc/` (one nvcc each, in
     parallel), print the build time, and fail if the descriptor kernel's
     SASS (`cuobjdump -sass`) holds an atomic instruction;
  3. drive the main path once — `extract_batch` on B=8 frames of 488x600
     with the default `SiftConfig()` — with the launch counters set to 0
     just before and read just after; every kernel must have launched
     (4 window gathers of the gradient maps, 4 refine walks that read the
     DoG stack themselves, 4 descriptor passes per batch). The kernels'
     arguments are recorded on the way;
  4. call each kernel again on the recorded arguments and hold it against
     its plain PyTorch version on the card: gathers and refine walks must
     be bit-identical, descriptors within `descriptor.TOLERANCE` and
     bit-identical over two launches; time kernel and plain version; hold
     the window gather on the recorded f32 DoG stacks at d = 16 (the
     main path now gathers only bf16 maps); hold the refine kernel
     against its plain version, bit for bit, on edge cases (L = 3, 4, 7
     and 15, so both block sizes and a staged window of levels; octaves
     under 16 px; all borders); hold the descriptor kernel against its
     plain version on edge cases (d = 16, 30, 48; K = 1 and odd counts;
     zero windows; orientation-bin and cell edges; two identical peaks);
  5. check the output (shapes, finite values, keypoints found) and hold
     image 0 against the port's plain path on the CPU; count the host
     syncs of a warm batch under `torch.cuda.set_sync_debug_mode("warn")`
     and fail on any; time the batch and print keyframes/s;
  6. drive the two-image matching path at full width (COLMAP's defaults:
     max_image_size 3200, max_num_features 8192, ratio 0.8, cross check):
     a 2400x3200 frame and its warp by a known homography go through
     `extract_batch`, `match_descriptors` (impl "auto"), `matched_coords`
     and `ransac_homography`, with the counters set to 0 just before and
     read just after; `streaming_top2` must launch exactly twice (forward
     and mutual), and RANSAC must recover the homography within 1 px at
     the corners with at least half the matches as inliers. Every kernel
     of the path is then held against its plain version on the recorded
     arguments (the descriptor also over two launches; descriptor and
     refine walk timed at these shapes; the top-2 also on 16384x16384
     random unit descriptors and on edge cases: ragged edges, uneven
     column ranges, all-invalid columns, exact ties), and the top-2
     kernel's `Matches` against the dense path's; kernel, plain and
     dense top-2 are timed, and the path end to end (pairs/s, and one
     profiled pair whose operator table goes to
     `chiprun_out/chip_smoke_match_profile.txt`).
     The card's extraction of the pair is held against the CPU plain
     path as sets (phase 5's criteria), and its host syncs are counted as
     in phase 5;
  7. drive the `twoview` command's path (`cli.twoview_extract`,
     `twoview_match`, `twoview_pose`, configured by the command's parser)
     on the TUM-RGBD fixture pair at 640x480 with TUM's freiburg1
     intrinsics, launches 8/8/8/0; the pose must succeed with half the
     matches as inliers, rotation within 0.1 deg and t within 2 deg of the
     ground truth, the pose step on the card and on the CPU (same points,
     same Gumbel noise) within TWOVIEW_R_DEG / TWOVIEW_T_DEG, and the CPU
     plain path end to end must succeed too; time a pair by step;
  8. run `run_ba` at the sizes users run: window BA at the pipeline's
     capacities (8 keyframes, 2048 landmarks, 8192 observations, default
     `BAConfig`, dense solver) and map-scale BA as benchmarks/ba_scale.py
     sets it (256 cameras, 32768 landmarks, ~262k observations, PCG with
     50 steps and Jacobi, huber, 10 LM iterations). The first card run is
     made under `set_sync_debug_mode("error")`, so a host sync inside
     `run_ba` fails the phase; the RMSE must fall tenfold; a second card
     run must be bit-identical, and the CPU plain path (all iterations
     for the window, 2 for the map) must agree within the BA_*
     tolerances; time an LM iteration and a CG matvec with CUDA events,
     and write each case's profiled run to OUT_DIR.
  9. drive the SfM loop: (a) `cli.main(["sfm", <TUM fixture>, "--format",
     "tum", "--traj", ...])` on the card (10 RGB-D frames at 640x480):
     rc 0, 10 trajectory rows, se3-aligned ATE < 0.05 m, launches 8/8/8/0;
     (b) `SfmPipeline(TUM freiburg1 intrinsics, PipelineConfig(), seed=0)
     .process_sequence(frames, batch=8)` on a rendered 96-frame 640x480
     monocular uint8 sequence (`make_sfm_sequence`: the TUM fixture's two
     planes at 2.0 and 3.5 m, 3 cm a frame along x), launches 48/48/48/0;
     the state must be "tracking", the tracked share, sim3 ATE and
     keyframe count within the bounds set from the JAX package's run on
     the same frames (SFM_JAX_*); a keyframe's keypoints must relocalize
     against itself through the global index and the batched probe; the
     first chunk's kernel calls are held against their plain versions as
     in phase 4; a warm second pass gives
     frames/s, the median ms of a tracked frame that is not promoted and
     of a promotion, and extraction ms a chunk; a third pass counts each
     tracked frame's host syncs (`count_syncs`, printed, no threshold),
     counts the operator calls of one tracking stage, and profiles one
     warm chunk (device busy share; operator table in
     `chiprun_out/chip_smoke_sfm_profile.txt`).
  10. loop closure and map maintenance: (a) `process_sequence(batch=8)` on
     a rendered 92-frame out-and-back sequence (48 frames out at 3 cm, 44
     back, phase 9b's scene) with loop closure, the Sim(3) graph and
     compaction every 10 keyframes on, then `run_global_ba()`, launches
     48/48/48/0: the keyframe count within 20%, the closures and
     pose-graph runs, and the sim3 ATE held to the JAX package's CPU run
     on the same frames (LOOP_JAX_*); the first chunk's kernel calls held
     against their plain versions; frames/s; (b) keyframe 0's keypoints
     as a new keyframe with fresh slots must close a loop through the
     Sim(3) graph and, again, through the SE(3) graph (ms per closure and
     its promotion's window BA, host syncs per closure); (c) both pose
     graphs at capacity (256 nodes, 1024 edges, 15 LM x 64 CG steps)
     under `set_sync_debug_mode("error")`: two card runs bit-identical,
     the CPU plain path within PGO_CPU_TOL, ms per run, a profiled run's
     busy share (operator tables in OUT_DIR); (d) `save_map` ->
     `load_map` on the card gives the same state.
  11. chunked tracking with asynchronous window BA (the JAX repo's SLAM
     configuration): (a) phase 9b's 96 frames with chunked_tracking,
     ba_async and extract_ahead, `process_sequence(batch=8)`, launches
     48/48/48/0: bootstrap frame, state, keyframes within 20%, chunk
     counts and fused promotions, and sim3 ATE held to the JAX package's
     CPU run (CHUNK_JAX_*); frames/s and ms per chunk; the first chunk's
     kernel calls held against their plain versions; (b) the first 48
     frames at batch 16 with kf_max_interval 6: some chunk must promote
     twice, ATE held to JAX's; (c) (a)'s first 48 frames with
     extract_ahead off: positions bit-identical; each chunk's host syncs,
     the event waits of applied window-BA results counted, with and
     without a promotion; a warm chunk profiled (busy share;
     `chiprun_out/chip_smoke_chunk_profile.txt`); (d) one chunk stage on
     recorded inputs and fixed noise: no host sync before its read under
     `set_sync_debug_mode("error")`, two card runs bit-identical, against
     the CPU plain path inlier counts and promote_at exactly, poses within
     CHUNK_CPU_POSE_TOL; ms of a stage and of its promotion slot.
  12. stereo: (a) `cli sfm --stereo --batch 4` on the KITTI fixture: rc 0,
     ATE < 0.1 m, launches 18/24/24/0; (b) phase 9b's scene with a right
     camera 0.12 m to the right, 48 pairs: `process_sequence(rights=)`
     within 1e-3 m of per-frame `process_frame(right=)`, keyframes and
     se3-aligned ATE (no scale fit) held to the JAX run's (STEREO_JAX_*),
     launches 48/48/48/0, first chunk's kernels against plain; (c)
     `stereo_depths` on that chunk, card against the CPU plain path.
  13. parity mode and subpixel input: (a) every reference golden
     (`tests/parity/golden_refsim.npz` x3, `golden_grid.npz` x10, the
     configs and caps of `tests/parity/test_golden*.py`) through parity
     `extract` on the card: keypoint sets identical to the golden's and
     to the CPU plain path's, scales within 1e-4, descriptors within 2e-3
     (+1e-3 relative against the golden), none dropped, the parity scan
     launched once and no TPU kernel's port; (b) `cli.main(
     ["extract", <png>, "-r", "1", ...])` in parity mode on a 488x600
     frame (PARITY_ZOOM) at the caps 20480/2048: rc 0, no warning, a
     table row and an overlay per keypoint, the parity scan launched once;
     the card's set equal to the CPU run's, none dropped; the warm
     extraction's ms, the descriptor stage's ms and kernel launches, the
     host syncs of the path (printed; phase 17 holds them); (c) lowe
     `extract_batch` with `subpixel=True` on
     phase 5's B=8 frames (976x1200 inside): launches 4/4/4/0, each
     kernel held against its plain version (phase 4's criteria) and
     timed at these shapes, image 0 against the CPU plain path (phase 5's
     criteria), no host sync under `"warn"`, kf/s.
  14. the feature service (`sift_tpu_torch.serve`): (a) a service built
     from `python -m sift_tpu_torch.serve`'s parser at its defaults
     (480x640, lowe, 1024 keypoints, a 2 ms window, batches of 8) behind
     its HTTP front on 127.0.0.1:0, requests carrying TUM fixture frames
     as base64 PNG: /healthz, /extract of frame 0 (launches 4/4/4/0; held
     against the CPU service as sets, phase 5's criteria, descriptors
     within 2e-3 plus one q8 step), /match of frames 0 and 9 (8/8/8/0),
     /twoview with freiburg1's intrinsics (8/8/8/0; success, R within 0.1
     deg and t within 2 deg of the ground truth), /stats; every answer
     200; the host syncs of each request (two bulk reads an /extract, one
     a /match; /twoview's printed); 20 single requests' p50/p99; (b) 32
     /extract from 8 clients at a 50 ms window: at most 16 dispatches, an
     image identical in every slot; six images co-batched against a
     window-0 service (valid equal, x within 1e-4, descriptors within one
     q8 step; bit equality printed); `extract_batch` of a frame at B=1
     against B=8 (printed);
     requests/s, mean batch, /stats phases and a profiled co-batched
     dispatch's busy share; (c) a
     service at 2400x3200 and 8192 keypoints matches phase 6's pair
     (launches 8/8/8/2; median transfer error under 1 px), and every
     kernel call recorded in (a) and (c) is held against its plain
     version; (d) one /extract of a `--mode parity` service, the CPU
     service's keypoints exactly, the parity scan launched once; (e) `cli
     match --match-impl ivf` on
     phase 6's pair; with the same init noise, the IVF matches of the card
     and the CPU agree on 99%; with nprobe = n_clusters they are the exact
     matcher's (phase 6's near-tie criteria); build and search ms beside
     the exact matchers'; (f) `ransac_homography` and `fit_homography` on
     every phase-10a bootstrap attempt's points and on (e)'s pair, card
     against the CPU: H within HOMOGRAPHY_RTOL, inlier sets equal; (g)
     phase 8's window-BA state through `save_checkpoint` and
     `restore_checkpoint(target=)` onto the card, bit-identical.
  15. the distribution layer (`sift_tpu_torch.dist`) in a one-rank NCCL
     world (`init_distributed` on tcp://localhost, a free port; NCCL
     refuses two ranks on one card, and a one-rank collective is the
     identity, so every result must equal the single-device call's bit for
     bit): (a) `extract_batch_sharded(replicate=True)` on phase 5's B=8
     frames (launches 4/4/4/0) against `extract_batch`; (b)
     `match_large_sharded` on phase 6's 8192-feature pair (launches
     0/0/0/2) against `match_descriptors`; (c) `run_ba_sharded` on phase
     8's window and map scenes, `v_mode` "psum" and "reduce_scatter",
     against `run_ba`, with ms per LM iteration sharded and single in
     turns and the collectives per LM iteration counted; (d) both sharded
     pose graphs at 256/1024 against phase 10c's single-device solves;
     (e) `SfmPipeline(mesh=)` chunked with async BA on phase 9b's first 48
     frames (launches 24/24/24/0) against the pipeline without a mesh,
     then `run_global_ba(mesh=)` against `run_global_ba()`. Every kernel
     call of (a), (b) and (e) is held against its plain version; ms of a
     sharded extraction batch and of a sharded 8192^2 match beside the
     single-device calls'.
  16. (run right after phase 6) the blur kernel
     (`csrc/blur.cu`; it replaces no TPU kernel) and
     extraction independent of the batch: (a) every blur call of phase
     5's batch, 13c's subpixel batch, phase 6's pair and 13b's parity
     frame, tiny planes whose radius reaches past their size and edge
     planes of the kernel's tile plan (`BLUR_EDGE`: radii up to 3000;
     past the 500 whose taps go by value, the line path), against the
     plain stencil bit for bit; (b) `extract_batch` of phase 5's
     frames at B = 1, 2 and 4 against B = 8, every field bit for bit
     (NaN-equal), in lowe, lowe with `subpixel` and parity; (c) phase 5's
     batch card against the CPU (images equal in every bit printed; phase
     5's criteria on every image); (d) the blur's calls and the kernel
     launches of their CUPTI trace (one a call), CUPTI ms, bound, plain ms
     and library ms (reflect pad + 2-D convolution) per
     batch and per pair, beside phase 5's kf/s and phase 6's pairs/s.
  17. (run right after phase 13) parity as one batched pass and the
     parity scan kernel (`csrc/parity_scan.cu`; it replaces no TPU
     kernel): (a) a B=8 parity batch of 13b's frame rolled by i x
     PARITY_ROLL pixels, counted: the scan exactly once, the blur at
     least once, no TPU kernel's port; every image bit-identical to its
     B=1 extraction; ms a batch and a frame; host syncs, none at
     `frontend/parity.py` or `kernels/cuda/parity_scan.py`; (b) the kernel
     (tile lists walked per pixel) against `parity_scan_plain` bit for
     bit (NaN-equal), `seen` and the mutated maps, on every recorded scan
     call of 13a, 13b and (a) and on three synthetic tables: overlap-heavy
     (SCAN_SYNTH), every slot on one window (the longest tile lists) and
     windows on the tile corners at the far edges of ragged maps
     (SCAN_FAR); the longest tile list of each; (c) of 13b's call and the
     batch's: the kernel's CUPTI ms (one kernel launch a call), the whole
     call's stream ms (tile lists built), the tile lists and the longest,
     bound and plain ms.
  18. (run right after phase 16) the public frontend API on phase 5's
     batch, each call counted: (a) `gather_window` on image 0's octave-0
     gradient map at its valid keypoints and 64 starts on and past every
     edge and corner, one window-kernel launch, bit-identical to plain;
     (b) `descriptors_from_windows` on the main path's 48x48 windows of
     those keypoints, one descriptor-kernel launch, within 1e-3 of plain
     and bit-identical to `descriptors_from_windows_multi`'s peak 0; (c)
     `detect_extrema` on the batch's pyramid, card against CPU bit for
     bit; each launch's CUPTI ms, stream, bound and plain ms.
Every path's launch counts are read by `hold_launches`: the four TPU
kernels' ports and the parity scan exactly as each phase expects (the
scan once a parity batch, never in lowe mode), and the blur at least once
on every path that extracts.
Then it prints each phase's seconds, one `kernels` JSON line (with each
kernel's launches on
the twoview path as `launches_twoview`, on phase 9b's sequence as
`launches_sfm`, on phase 10a's as `launches_loop`, on phase 11a's as
`launches_chunked`, on phase 12b's as `launches_stereo` and on phase
13c's as `launches_subpixel`, with 13c's times as `*_subpixel`, and on
phase 14a's three requests and 14c's match as `launches_serve`, and on
phase 15's dist paths (a), (b) and (e) as `launches_dist`, and on phase
18's calls as `launches_public`, with 18's times as `*_public`; the blur's
row, its times per phase 5 batch and per phase 6 pair; the parity
scan's row last, its times per phase 17's batch and 13b's frame), the
card line, and as its last
line {"ok": true, "device": {...}}. It imports nothing of JAX or of the
`sift_tpu` package, and exits non-zero without a result when there is no
CUDA card or no `sift_tpu_torch` beside it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
try:
    from sift_tpu_torch.utils.roofline import bound_ms as bound
    from sift_tpu_torch.utils.roofline import (covered_cells, kernel_work,
                                               walk_cells)
    from sift_tpu_torch.utils.timing import (busy_share, event_ms,
                                             kernel_trace, profiled)
    _PORT_MISSING = None
except ImportError as _e:       # reported by main(), after the CUDA check
    _PORT_MISSING = _e

BATCH, HEIGHT, WIDTH = 8, 488, 600
EXPECTED_LAUNCHES = {"gather_windows": 4, "refine_walk": 4,
                     "descriptor_accumulate": 4, "streaming_top2": 0}
# Phase 6: COLMAP's SiftExtractionOptions (max_image_size=3200,
# max_num_features=8192) and SiftMatchingOptions (max_ratio=0.8,
# cross_check=true); the repo's large-matching size (16384 x 128).
MATCH_HEIGHT, MATCH_WIDTH, MATCH_FEATURES = 2400, 3200, 8192
MATCH_LAUNCHES = {"gather_windows": 4, "refine_walk": 4,
                  "descriptor_accumulate": 4, "streaming_top2": 2}
LARGE_N = 16384
SOURCES = {
    "gather_windows": ("sift_tpu_torch/csrc/windows.cu",
                       "sift_tpu/kernels/pallas/windows.py:216"),
    "refine_walk": ("sift_tpu_torch/csrc/refine.cu",
                    "sift_tpu/kernels/pallas/refine.py:153"),
    "descriptor_accumulate": ("sift_tpu_torch/csrc/descriptor.cu",
                              "sift_tpu/kernels/pallas/descriptor.py:151"),
    "streaming_top2": ("sift_tpu_torch/csrc/match.cu",
                       "sift_tpu/kernels/pallas/match.py:106"),
}
EXTRACTION_KERNELS = ("gather_windows", "refine_walk", "descriptor_accumulate")
KERNEL_SYMBOLS = {"gather_windows": "gather_windows_kernel",
                  "refine_walk": "refine_walk_kernel",
                  "descriptor_accumulate": "descriptor_kernel",
                  "blur": "blur_fused_kernel",
                  "parity_scan": "parity_scan_kernel"}
OUT_DIR = "chiprun_out"
# (K, d) of the descriptor's random edge cases: d = 16, 30 and 48 (any
# even d = 2 * min(24, H // 2, W // 2) reaches the kernel), one keypoint,
# and counts that are a multiple of nothing the kernel tiles by.
DESC_EDGE_SHAPES = [(1, 16), (37, 30), (1001, 48), (1, 48), (300, 16)]
# (B, L, H, W) of the refine walk's edge cases: levels that move (L > 3),
# 32 keypoints a block (L <= 6) and 16 (L >= 7), a window of 13 staged
# levels out of 15, octaves under 16 px. 97 keypoints an image fill no
# block evenly.
REFINE_EDGE_SHAPES = [(3, 4, 40, 48), (2, 7, 36, 30), (3, 15, 24, 20),
                      (3, 3, 12, 10), (1, 7, 9, 20)]
# Extraction's host syncs per batch before their repair: the blocking
# host-to-device copies of small constants (frontend/extrema.py,
# refine.py, sift.py, orientation.py, kernels/gaussian.py), counted by
# `count_syncs` on the parent commit 716d9ef's package on an H100 (PERF.md).
SYNCS_BEFORE_REPAIR = {"488x600": 29, "2400x3200": 37}
# Phase 7: the `twoview` command on the TUM-RGBD fixture pair, frames 0 and
# 9 (3 cm a frame along x), with TUM's freiburg1 intrinsics.
TUM_DIR = os.path.join("tests", "fixtures", "tum_mini",
                       "rgbd_dataset_freiburg1_mini")
TUM_PAIR = ("1305031100.000000", "1305031100.300000")
TUM_FR1_INTRINSICS = (517.3, 516.5, 318.6, 255.3)
TWOVIEW_LAUNCHES = {"gather_windows": 8, "refine_walk": 8,
                    "descriptor_accumulate": 8, "streaming_top2": 0}
# Tolerances of the two-view pose, card against the CPU plain path on the
# same matched points and noise (degrees).
TWOVIEW_R_DEG, TWOVIEW_T_DEG = 0.02, 0.1
# Phase 8: window BA at the pipeline's static capacities
# (sift_tpu/config.py:215-221: window of 8 keyframes, 2048 landmarks, 8192
# observations) and map-scale global BA as benchmarks/ba_scale.py sets it
# (256 cameras, 32768 landmarks, 1024 observations a camera).
WINDOW_C, WINDOW_L, WINDOW_O = 8, 2048, 8192
MAP_C, MAP_L, MAP_OBS_PER_CAM = 256, 32768, 1024
# BA states, card against the CPU plain path: RMSE to BA_RMSE_RTOL
# relative, poses and landmarks to BA_STATE_RTOL of their largest
# coordinate (at least 1; the map's corridor is 256 m long), iterations
# exactly, CG steps within BA_CG_SLACK per LM iteration. The two devices
# add f32 sums in other orders, so once the cost has converged the LM
# accept tests turn on rounding and the runs may stop at other points of
# the optimum's flat valley (window BA after 20 iterations: poses up to
# 1.3e-4 of the largest coordinate apart at equal RMSE). Two card runs
# must be bit-identical (`ba/schur.py` sums segments without atomics).
BA_RMSE_RTOL, BA_STATE_RTOL, BA_CG_SLACK = 1e-4, 1e-3, 2
BA_KEYS = ("poses_init", "intrinsics", "landmarks_init", "obs_cam", "obs_lm",
           "obs_uv", "obs_valid")
# Phase 9: the SfM loop. (a) `cli sfm` on the TUM fixture (10 RGB-D frames,
# 640x480; ATE bound of tests/e2e/test_real_format_fixtures.py). (b) a
# rendered monocular sequence at 640x480 with TUM freiburg1 intrinsics:
# the fixture's scene (planes at 2.0 and 3.5 m, 3 cm a frame along x),
# 96 frames, default PipelineConfig, process_sequence(batch=8).
SFM_CLI_LAUNCHES = {"gather_windows": 8, "refine_walk": 8,
                    "descriptor_accumulate": 8, "streaming_top2": 0}
SFM_CLI_ATE = 0.05
SFM_FRAMES, SFM_H, SFM_W, SFM_BATCH = 96, 480, 640, 8
SFM_INTRINSICS = TUM_FR1_INTRINSICS
SFM_Z_TOP, SFM_Z_BOT, SFM_STEP = 2.0, 3.5, 0.03
SFM_LAUNCHES = {"gather_windows": 48, "refine_walk": 48,
                "descriptor_accumulate": 48, "streaming_top2": 0}
# The reference: the JAX package's SfmPipeline (default PipelineConfig,
# seed 0, process_sequence with batch 8) on the same 96 frames, run once
# on a CPU (JAX_PLATFORMS=cpu): state "tracking", bootstrap at frame 2,
# keyframes at frames 0, 2, 12, 22, ..., 92, 1186 landmarks, and the
# sim3-aligned ATE against the rendered ground truth below.
SFM_JAX_ATE, SFM_JAX_TRACKED, SFM_JAX_KEYFRAMES = 0.00026056717071732235, \
    1.0, 11
SFM_PROFILED_CHUNK = 5          # the chunk of frames 40-47, warm
# Phase 10: loop closure and map maintenance. (a) An out-and-back
# monocular sequence rendered as phase 9b's (same scene, intrinsics and
# 640x480): 48 frames out at 3 cm a frame, 44 back to x = 6 cm (the shape
# of tests/e2e/test_long_loop.py), with that test's loop settings on the
# default PipelineConfig: loop closure, the Sim(3) graph, compaction every
# 10 keyframes, loop_min_inliers 25, loop_max_rmse 2.0 px; then
# run_global_ba().
LOOP_XS = [SFM_STEP * i for i in range(48)] + \
    [SFM_STEP * (45 - i) for i in range(44)]
LOOP_LAUNCHES = {"gather_windows": 48, "refine_walk": 48,
                 "descriptor_accumulate": 48, "streaming_top2": 0}
# The reference: the JAX package's SfmPipeline with that configuration
# (seed 0, process_sequence with batch 8, then run_global_ba) on the same
# 92 frames, run once on a CPU (JAX_PLATFORMS=cpu): state "tracking",
# every frame tracked, bootstrap at frame 2, keyframes at frames 0, 2, 12,
# ..., 82, one compaction, no loop probed (the return leg keeps
# re-observing the outbound landmarks, so the covisibility gate drops the
# only old enough candidates), so no closure and no pose-graph run; 1006
# landmarks; global BA over 10 cameras, 1006 landmarks, 4519 observations
# to 0.04985828 px; the sim3-aligned ATE of the trajectory.
LOOP_JAX_KEYFRAMES, LOOP_JAX_CLOSURES, LOOP_JAX_PGO_RUNS = 10, 0, 0
LOOP_JAX_ATE = 0.00048009346063800383
LOOP_JAX_GBA_RMSE = 0.04985828325152397
# (c) The pose graph at the pipeline's capacities (PipelineConfig's
# max_pose_graph_nodes 256 and max_pose_graph_edges 1024) and LM budget
# (15 iterations of 64 CG steps); card against the CPU plain path within
# PGO_CPU_TOL of the largest coordinate (translations reach 3.6 m): the
# two devices sum in other orders, and after 15 LM steps the Sim(3) graph
# ends 1.13e-4 apart in absolute terms (3e-5 relative; SE(3) 1.2e-6).
PGO_NODES, PGO_EDGES, PGO_PAD = 256, 1024, 64
PGO_ITERATIONS, PGO_CPU_TOL, PGO_REPS = 15, 1e-4, 3
# Phase 11: chunked tracking with asynchronous window BA, the JAX repo's
# SLAM configuration (benchmarks/slam_bench.py:90-116): phase 9b's 96
# frames, PipelineConfig(chunked_tracking=True, ba_async=True) with
# extract_ahead (on by default), process_sequence(batch=8); (b) the same
# on the first 48 frames at batch 16 with kf_max_interval 6, so that
# chunks promote twice (cut from 96 frames to keep the whole script near
# ten minutes).
CHUNK_LAUNCHES = SFM_LAUNCHES
# (c) runs the first 48 frames with extract_ahead off (cut from 96 to keep
# the whole script near ten minutes).
CHUNK_AHEAD_FRAMES = 48
CHUNK16_FRAMES = 48
CHUNK16_LAUNCHES = {"gather_windows": 12, "refine_walk": 12,
                    "descriptor_accumulate": 12, "streaming_top2": 0}
# The reference: the JAX package's SfmPipeline with those configurations
# (seed 0) on the same frames, run once on a CPU (JAX_PLATFORMS=cpu): (a)
# state "tracking", every frame tracked, bootstrap at frame 2, keyframes
# at frames 0, 2, 12, ..., 92, 1186 landmarks, 11 chunks through the
# chunk stage with 9 fused promotions, and the sim3 ATE below; (b)
# bootstrap at frame 2, 8 keyframes (0, 2, 8, 14, ..., 38), 2 chunks with
# 4 fused promotions.
CHUNK_JAX_BOOT, CHUNK_JAX_KEYFRAMES = 2, 11
CHUNK_JAX_STATS = {"chunks": 11, "fused_promotions": 9}
CHUNK_JAX_ATE = 0.0008025062666482943
CHUNK16_JAX_KEYFRAMES = 8
CHUNK16_JAX_STATS = {"chunks": 2, "fused_promotions": 4}
CHUNK16_JAX_ATE = 0.00039958289050680284
# (d) one chunk stage, card against the CPU plain path on the same inputs
# and noise: poses within the CPU tests' TRACK_POSE of each coordinate.
CHUNK_CPU_POSE_TOL = 2e-4
# Phase 12: stereo. (a) `cli sfm` on the KITTI fixture with --stereo
# --batch 4 (10 pairs at 120x400; the ATE bound of
# tests/e2e/test_real_format_fixtures.py:75); (b) phase 9b's scene at
# 640x480 with a right camera STEREO_BASELINE (4 steps) to the right of
# each of STEREO_FRAMES left positions, default PipelineConfig:
# process_sequence(rights=, batch=8) against per-frame process_frame(
# right=) within 1e-3 m (tests/e2e/test_image_sfm.py:318's bound).
STEREO_CLI_ATE = 0.1
# Three chunks of two batches: the fourth octave of a 120x400 frame (15x50)
# is too small for a gradient window (frontend/sift.py), so it gathers
# none.
STEREO_CLI_LAUNCHES = {"gather_windows": 18, "refine_walk": 24,
                       "descriptor_accumulate": 24, "streaming_top2": 0}
STEREO_FRAMES, STEREO_BASELINE = 48, 4 * SFM_STEP
STEREO_LAUNCHES = {"gather_windows": 48, "refine_walk": 48,
                   "descriptor_accumulate": 48, "streaming_top2": 0}
STEREO_BATCHED_TOL = 1e-3
# The reference: the JAX package's SfmPipeline(stereo_baseline=0.12) on the
# same pairs, batched (seed 0), run once on a CPU: state "tracking",
# bootstrap at frame 0 (stereo depth), keyframes at frames 0, 10, 20, 30,
# 40, 1004 landmarks, and the se3-aligned (no scale fit) ATE below.
STEREO_JAX_KEYFRAMES = 5
STEREO_JAX_ATE = 0.0001641923357768493
# (c) stereo_depths on one chunk, card against the CPU plain path: at
# least this share of the left keypoints with the same accept flag and,
# where both accept, the depth within 1e-5 relative (a near-tie of the
# ratio test can fall either side of f32 rounding).
STEREO_CPU_AGREE = 0.995
# Phase 13: parity mode and subpixel input. (a) every reference golden
# with the configs and caps of tests/parity/test_golden.py and
# test_golden_grid.py; (b) `cli extract -r 1` at the caps
# tests/parity/test_viz_golden.py gives a 488x600 photograph (parrot.jpg:
# 1445 keypoints, none dropped), on a `make_textured` texture of 1/8 the
# size zoomed 8x, a photograph's density (the full-rate texture has more
# than 20480 ties-allowed extrema an octave and truncates); (c) lowe with
# `subpixel` on phase 5's frames: kernels 1-3 on the 976x1200 internal
# frame.
GOLDEN_REFSIM = [("s0_sub0", False), ("s1_sub0", False), ("s5_sub1", True)]
GOLDEN_GRID = ["d4", "d5", "o2", "o5", "s10", "s20", "k12", "real_sub",
               "real_d4", "d4_o5"]
GOLDEN_GRID_CAPS = {"real_sub": 4096, "real_d4": 2048, "d4_o5": 2048}
PARITY_CAPS = (20480, 2048)
PARITY_ZOOM = 8
# The launches of one parity extraction batch at any B: none of the TPU
# kernels' ports, the parity scan once (the batched pass).
PARITY_LAUNCHES = {"gather_windows": 0, "refine_walk": 0,
                   "descriptor_accumulate": 0, "streaming_top2": 0,
                   "parity_scan": 1}
# Phase 17: a B=8 parity batch, image i 13b's frame rolled by i times
# PARITY_ROLL pixels (rows, columns); and synthetic tables (B, O, Lg, H,
# W, N): SCAN_SYNTH's slots crowd few planes and a corner of each, one
# plane holding most of them; its "one window" table puts every slot of
# an image on one window across a tile corner (4 lists of N entries, the
# longest a table can give, more than the kernel stages at a time);
# SCAN_FAR's maps have sides that are multiples of no tile, and its slots
# sit on the tile corners nearest the far edges and on the far edges.
PARITY_ROLL = (61, 73)
SCAN_SYNTH = (2, 4, 6, 128, 160, 3000)
SCAN_FAR = (2, 3, 4, 133, 171, 2000)
PARITY_SCAN_REPLACES = ("none: sift_tpu/frontend/parity.py:120 carries "
                        "this walk as a lax.scan (no pallas_call)")
PARITY_SCAN_LIBRARY = ("none: no PyTorch call adds in a fixed order per "
                       "pixel and returns each slot's snapshot")
# Phase 14: the feature service. (a) `python -m sift_tpu_torch.serve`'s
# defaults (480x640, lowe, 1024 keypoints, a 2 ms window, batches of 8)
# behind its HTTP front, on the TUM fixture's frames: /extract launches
# EXPECTED_LAUNCHES, /match and /twoview TWOVIEW_LAUNCHES; (c) a service at
# phase 6's shape matches phase 6's pair: two B=1 extractions and the
# streaming top-2 forward and mutual.
SERVE_LARGE_LAUNCHES = {"gather_windows": 8, "refine_walk": 8,
                        "descriptor_accumulate": 8, "streaming_top2": 2}
# (f) `fit_homography` and homography RANSAC, card against the CPU: H to
# this share of its largest entry, inlier sets equal.
HOMOGRAPHY_RTOL = 1e-4
# Phase 15: the dist paths' launches in a one-rank world: (a) one sharded
# extraction batch, (b) one sharded 8192^2 match (forward and mutual), (e)
# the mesh pipeline on phase 9b's first 48 frames, 6 chunks of 8.
DIST_FRAMES = 48
DIST_LAUNCHES = {
    "extract": EXPECTED_LAUNCHES,
    "match": {"gather_windows": 0, "refine_walk": 0,
              "descriptor_accumulate": 0, "streaming_top2": 2},
    "sfm": {"gather_windows": 24, "refine_walk": 24,
            "descriptor_accumulate": 24, "streaming_top2": 0}}
DIST_REPS = 3
# Phase 16: the blur kernel. (shape, sigma) of tiny planes whose radius
# (round(3 sigma)) reaches past their size, so the mirror index folds more
# than once; n == 1 included.
BLUR_TINY = [((3, 1, 5), 4.0), ((2, 4, 3), 2.5), ((1, 2, 1), 1.6),
             ((2, 7, 6), 6.0), ((1, 1, 1), 1.0)]
# (shape, sigma, radius or None for round(3 sigma)) of planes at the edges
# of the fused kernel's plan (`blur.tile_plan`): sides that are multiples
# of no tile, one row, one column, phase 6's 2400x3200 plane at parity's
# r = 27 (two strips of staged rows), radii past the tile's 64 rows, the
# largest radius whose taps go by value (the plan's opt-in shared
# memory), and past it: r = 501 (taps from a device buffer), 1000
# (16-column tiles) and 3000, past what shared memory holds beside one
# staged row of an 8 x 8 tile (the line path, two launches).
BLUR_EDGE = [((3, 67, 93), 1.6, None), ((2, 1, 300), 3.3, None),
             ((2, 300, 1), 3.3, None), ((1, 2400, 3200), 9.0, 27),
             ((2, 200, 260), 25.0, 75), ((1, 130, 170), 70.0, 200),
             ((1, 61, 75), 170.0, 500), ((2, 65, 129), 2.2627417, None),
             ((1, 61, 75), 167.0, 501), ((2, 40, 50), 333.3, 1000),
             ((1, 33, 41), 1000.0, 3000)]
BLUR_REPLACES = ("none: sift_tpu/kernels/gaussian.py:72,128 blurs by XLA's "
                 "conv_general_dilated or einsum (no pallas_call)")
KP_FIELDS = ("x", "y", "octave", "level", "scale", "score", "orientation",
             "valid", "desc", "n_dropped", "n_cand_pruned")
# Phase 18: the public frontend API on phase 5's batch. (a) `gather_window`
# (r = 8) on image 0's octave-0 gradient map: every valid keypoint of
# image 0 at its octave-0 pixel, and the 8 x 8 = 64 starts of
# `public_edges` (rows x columns).
# The descriptor's f32 operations a window pixel for one peak: magnitude
# and angle 20, the peak's 62 (utils/roofline.py's DESC_OPS_PER_PIXEL
# counts 20 + 2 x 62 for the kernel's two).
DESC_OPS_ONE_PEAK = 82
# Each phase 18 call launches one hand kernel, or none.
PUBLIC_LAUNCHES = {"gather_window": "gather_windows",
                   "descriptors_from_windows": "descriptor_accumulate",
                   "detect_extrema": None}


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


def parity_frame(torch) -> np.ndarray:
    """Phase 13b's 488x600 parity frame: `make_textured` at 1/PARITY_ZOOM
    size zoomed bilinearly (the full-rate texture has over 20480
    candidates an octave and truncates)."""
    import torch.nn.functional as F
    small = torch.from_numpy(make_textured(HEIGHT // PARITY_ZOOM + 1,
                                           WIDTH // PARITY_ZOOM + 1))
    return F.interpolate(small[None], size=(HEIGHT, WIDTH), mode="bilinear",
                         align_corners=True)[0, 0].numpy()


def make_sfm_sequence(n: int = SFM_FRAMES, h: int = SFM_H, w: int = SFM_W,
                      xs=None):
    """Phase 9's monocular sequence, rendered as `tools/gen_fixtures.py`'s
    `_render` renders the TUM fixture: two fronto-parallel planes (top half
    at SFM_Z_TOP, bottom half at SFM_Z_BOT metres), the camera at x =
    SFM_STEP * i metres in frame i (or at `xs[i]`, a list of positions
    that are multiples of SFM_STEP, when given), each plane's texture
    shifted by fx * tx / z pixels with linear interpolation. The textures
    are two row bands of one `make_textured` image, wide enough for the
    whole motion. Returns (uint8 frames (len, h, w), ground-truth centres
    (len, 3))."""
    fx = SFM_INTRINSICS[0]
    if xs is None:
        xs = [SFM_STEP * i for i in range(n)]
        extent = SFM_STEP * n
    else:
        extent = max(xs) + SFM_STEP
    span = int(np.ceil(fx * extent / SFM_Z_TOP)) + w + 48
    tex = make_textured(2 * (h - h // 2) + 16, span)[0].astype(np.float64)
    bands = (tex[:h // 2], tex[-(h - h // 2):])
    frames = np.empty((len(xs), h, w), np.uint8)
    for i, tx in enumerate(xs):
        rows = []
        for band, z in zip(bands, (SFM_Z_TOP, SFM_Z_BOT)):
            cols = np.clip(np.arange(w) + fx * tx / z + 40.0, 0,
                           band.shape[1] - 2)
            c0 = np.floor(cols).astype(int)
            f = cols - c0
            rows.append(band[:, c0] * (1 - f) + band[:, c0 + 1] * f)
        frames[i] = np.clip(np.round(np.concatenate(rows)), 0, 255)
    gt = np.zeros((len(xs), 3))
    gt[:, 0] = xs
    return frames, gt


def true_homography(h: int, w: int) -> np.ndarray:
    """Rotation 4 deg and scale 0.95 about the centre, a shift of (35, -22)
    px and a perspective term of about 1e-5 per px: B = H(A)."""
    th, s = np.deg2rad(4.0), 0.95
    P = np.eye(3)
    P[:2, :2] = s * np.array([[np.cos(th), -np.sin(th)],
                              [np.sin(th), np.cos(th)]])
    P[2, :2] = [1.0e-5, -0.6e-5]
    c = np.array([w / 2.0, h / 2.0])
    to_c, from_c = np.eye(3), np.eye(3)
    to_c[:2, 2] = -c
    from_c[:2, 2] = c + np.array([35.0, -22.0])
    return from_c @ P @ to_c


def warp_homography(img: np.ndarray, Hm: np.ndarray,
                    fill: float = 128.0) -> np.ndarray:
    """B(x, y) = A(H^-1 (x, y)), bilinear; pixels from outside A get
    `fill`."""
    h, w = img.shape
    Hi = np.linalg.inv(Hm)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    den = Hi[2, 0] * xx + Hi[2, 1] * yy + Hi[2, 2]
    sx = (Hi[0, 0] * xx + Hi[0, 1] * yy + Hi[0, 2]) / den
    sy = (Hi[1, 0] * xx + Hi[1, 1] * yy + Hi[1, 2]) / den
    x0, y0 = np.floor(sx), np.floor(sy)
    fx, fy = sx - x0, sy - y0
    inside = (x0 >= 0) & (y0 >= 0) & (x0 < w - 1) & (y0 < h - 1)
    x0 = np.clip(x0, 0, w - 2).astype(np.int64)
    y0 = np.clip(y0, 0, h - 2).astype(np.int64)
    v = (img[y0, x0] * (1 - fx) * (1 - fy) + img[y0, x0 + 1] * fx * (1 - fy)
         + img[y0 + 1, x0] * (1 - fx) * fy + img[y0 + 1, x0 + 1] * fx * fy)
    return np.where(inside, v, fill).astype(np.float32)


@functools.lru_cache(maxsize=1)
def match_pair():
    """Phase 6's 2400x3200 pair (a texture and its warp by
    `true_homography`) and the homography; made once, read-only."""
    h, w = MATCH_HEIGHT, MATCH_WIDTH
    frame_a = make_textured(h, w)[0]
    H_true = true_homography(h, w)
    pair = np.stack([frame_a, warp_homography(frame_a, H_true)])
    pair.setflags(write=False)
    return pair, H_true


def map_points(Hm: np.ndarray, pts: np.ndarray) -> np.ndarray:
    q = np.c_[pts, np.ones(len(pts))] @ np.asarray(Hm, np.float64).T
    return q[:, :2] / q[:, 2:]


def _run_counted(fn):
    """Marks, on the stack, the calls whose syncs `count_syncs` counts."""
    return fn()


def _sync_sites(torch, fn, counted) -> list:
    """Run `fn` under `torch.cuda.set_sync_debug_mode("warn")`; return one
    "file:line" per host sync whose warning `counted(frames)` accepts
    (frames: the issuing thread's stack): the innermost frame of the
    repo's own code on that stack (the innermost frame of all, where the
    repo's code is not on the stack)."""
    import traceback
    import warnings
    here = os.path.dirname(os.path.abspath(__file__))
    me = os.path.abspath(__file__)
    sites = []

    def record(message, category, filename, lineno, file=None, line=None):
        frames = [f for f in traceback.extract_stack()[:-1]
                  if f.filename != warnings.__file__]
        if "synchroniz" not in str(message) or not counted(frames):
            return
        own = [f for f in frames if f.filename.startswith(here + os.sep)
               and os.path.abspath(f.filename) != me]
        f = own[-1] if own else frames[-1]
        sites.append(f"{os.path.relpath(f.filename, here)}:{f.lineno}")

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sites


def count_syncs(torch, fn) -> list:
    """The host syncs made inside `fn` (`_sync_sites`). Syncs outside `fn`
    (the mode switch itself, finalizers) are not counted."""
    me = os.path.abspath(__file__)
    return _sync_sites(torch, lambda: _run_counted(fn), lambda frames: any(
        f.name == "_run_counted" and os.path.abspath(f.filename) == me
        for f in frames))


def count_syncs_any_thread(torch, fn) -> list:
    """The host syncs that threads other than the caller's make while `fn`
    runs (the service's batcher worker and HTTP handlers); the caller's
    own, such as the mode switch, are not counted. Nothing else may run on
    the card meanwhile."""
    import threading
    caller = threading.get_ident()
    return _sync_sites(torch, fn,
                       lambda frames: threading.get_ident() != caller)


def hold_syncs(torch, fn, label: str) -> int:
    """Count the host syncs of a warm call of `fn` and fail on any."""
    fn()
    torch.cuda.synchronize()
    sites = count_syncs(torch, fn)
    before = SYNCS_BEFORE_REPAIR.get(label)
    print(f"extract_batch host syncs per batch at {label}: {len(sites)} "
          f"{sorted(set(sites))}"
          + (f" (before the repair: {before})" if before is not None else ""),
          flush=True)
    if sites:
        raise Failed(f"extract_batch syncs the host at {label}: {sites}")
    return len(sites)


def hold_launches(label: str, launches: dict, expected: dict) -> None:
    """The ports of the four TPU kernels launched exactly `expected` times
    on path `label`, and the parity scan exactly as `expected` says (0
    where it does not say); and where the path extracts (launches an
    extraction kernel or the parity scan), the blur, which every pyramid
    runs, at least once."""
    expected = {"parity_scan": 0, **expected}
    extracts = any(expected[k]
                   for k in EXTRACTION_KERNELS + ("parity_scan",))
    if {k: launches[k] for k in expected} != expected or \
            (extracts and not launches["blur"]):
        raise Failed(f"{label} launch counts {launches} != {expected}"
                     + (" with at least one blur" if extracts else ""))


def fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


def profile_busy(torch, fn, table_name: str, card: str):
    """Run `fn` (which ends synchronised) once under the profiler
    (`timing.busy_share`); write the operator table to OUT_DIR/table_name
    and return (device busy ms, wall ms)."""
    busy_ms, wall_ms, table = busy_share(fn)
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, OUT_DIR, table_name), "w") as fh:
        fh.write(f"card: {card}\n{table}\n")
    return busy_ms, wall_ms


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


def extraction_kernels() -> dict:
    """{name: (module, wrapper attribute)} of the extraction kernels."""
    from sift_tpu_torch.kernels.cuda import descriptor, refine, windows
    return {"gather_windows": (windows, "gather_windows"),
            "refine_walk": (refine, "refine_walk"),
            "descriptor_accumulate": (descriptor, "descriptor_accumulate")}


def extraction_plain() -> dict:
    """{name: plain PyTorch version} of the extraction kernels."""
    from sift_tpu_torch.kernels.cuda import descriptor, refine, windows
    return {"gather_windows": windows.gather_windows_plain,
            "refine_walk": refine.refine_walk_plain,
            "descriptor_accumulate": descriptor.descriptor_accumulate_plain}


class Failed(Exception):
    """A failed check."""


@contextlib.contextmanager
def recording(targets: dict):
    """Wrap each `targets[name] = (module, attr)` so that its calls record
    their arguments; yields ({name: [args, ...]}, {name: original})."""
    recorded = {name: [] for name in targets}
    originals = {name: getattr(mod, attr)
                 for name, (mod, attr) in targets.items()}
    for name, (mod, attr) in targets.items():
        def recorder(*args, _name=name):
            recorded[_name].append(args)
            return originals[_name](*args)
        setattr(mod, attr, recorder)
    try:
        yield recorded, originals
    finally:
        for name, (mod, attr) in targets.items():
            setattr(mod, attr, originals[name])


def hold_extraction_kernel(torch, tolerance: float, name: str, got, want):
    """An extraction kernel's output against its plain version's: gathers
    and refine walks bit for bit, descriptors within `tolerance` of the
    largest bin. Returns (max abs err, err relative to the largest
    output)."""
    if name == "descriptor_accumulate":
        e = float((got - want).abs().max()) if got.numel() else 0.0
        scale = max(float(want.abs().max()) if want.numel() else 0.0, 1e-30)
        if e > tolerance * scale:
            raise Failed(f"{name}: max diff {e} over max {scale}")
        return e, e / scale
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    e = max(float((g.double() - w.double()).abs().max())
            if g.numel() else 0.0 for g, w in zip(got, want))
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise Failed(f"{name}: kernel differs from plain ({e})")
    return e, 0.0


def top2_check(torch, mk, got, want, args):
    """Hold the kernel's (best, second, arg) against the plain version's:
    best and second within RTOL of an + bn (the row's norm plus the largest
    valid column norm), arg identical on every row whose plain second - best
    exceeds that. Returns (max abs err, rows checked, near ties)."""
    a, va, b, vb = args
    an = mk.masked_norms(a, va)
    bn_max = float(mk.masked_norms(b, vb)[vb].max()) if bool(vb.any()) else 0.0
    tol = mk.RTOL * (an + bn_max)
    (kb, ks, ka), (pb, ps, pa) = got, want
    has = va & (pb < 1e29)
    if not torch.equal(has, va & (kb < 1e29)):
        raise Failed("kernel and plain disagree on which rows have a match")
    if not bool(((ka >= 0) & (ka < b.shape[0])).all()):
        raise Failed("kernel arg out of range")
    err_b = torch.where(kb == pb, 0.0, (kb - pb).abs())[has]
    err_s = torch.where(ks == ps, 0.0, (ks - ps).abs())[has]  # inf == inf
    if bool((err_b > tol[has]).any()) or bool((err_s > tol[has]).any()):
        raise Failed(f"best/second differ beyond {mk.RTOL} of an+bn: "
                     f"{float(err_b.max())}, {float(err_s.max())}")
    clear = has & ((ps - pb) > tol)
    if not torch.equal(ka[clear], pa[clear]):
        n = int((ka[clear] != pa[clear]).sum())
        raise Failed(f"arg differs on {n} rows without a near tie")
    err = max(float(err_b.max()) if err_b.numel() else 0.0,
              float(err_s.max()) if err_s.numel() else 0.0)
    return err, int(has.sum()), int((has & ~clear).sum())


# (Na, Nb) of the top-2 edge cases: the JAX kernel tests' shapes (ragged
# edges, column ranges of one tile, one range only), a single row or
# column, and column ranges that do not divide the tiles evenly.
TOP2_EDGE_SHAPES = [(1024, 1024), (2048, 1536), (700, 900), (100, 60),
                    (1, 300), (300, 1), (2560, 3000)]


def top2_edge_cases(torch, mk, kernel) -> int:
    """The kernel against its plain version on `TOP2_EDGE_SHAPES` (random
    descriptors of scale 10, 20% invalid), on all-invalid columns, and on
    columns that come in identical pairs, where every row's best is an
    exact tie that the lower column must win with second == best. Returns
    the number of cases."""
    g = torch.Generator(device="cuda").manual_seed(5)

    def case(na, nb, invalid=0.2):
        a = torch.randn((na, 128), device="cuda", generator=g) * 10.0
        b = torch.randn((nb, 128), device="cuda", generator=g) * 10.0
        va = torch.rand((na,), device="cuda", generator=g) > invalid
        vb = torch.rand((nb,), device="cuda", generator=g) > invalid
        va[0] = vb[0] = True
        return a, va, b, vb

    cases = [case(na, nb) for na, nb in TOP2_EDGE_SHAPES]
    a, va, b, _ = case(256, 256)
    cases.append((a, va, b, torch.zeros_like(va)))
    for args in cases:
        got = kernel(*args)
        top2_check(torch, mk, got, mk.streaming_top2_plain(*args), args)
        if not bool(args[3].any()) and not bool((got[0] >= 1e29).all()):
            raise Failed("all-invalid columns gave a candidate")
    # Duplicate columns: the plain version on the distinct columns says
    # which column pair must win, away from near ties between pairs.
    a, va, b, _ = case(1000, 700)
    vb = torch.ones(700, dtype=torch.bool, device="cuda")
    pbest, psecond, parg = mk.streaming_top2_plain(a, va, b, vb)
    best, second, arg = kernel(a, va, b.repeat_interleave(2, 0),
                               vb.repeat_interleave(2))
    tol = mk.RTOL * (mk.masked_norms(a, va)
                     + float(mk.masked_norms(b, vb).max()))
    clear = va & ((psecond - pbest) > tol)
    if not (bool((arg % 2 == 0).all()) and torch.equal(best, second)
            and torch.equal(arg[clear] // 2, parg[clear])):
        raise Failed("exact ties between duplicate columns broken")
    return len(cases) + 1


def sass_atomics(lib_path) -> list:
    """The opcodes of the atomic instructions (ATOM, ATOMS, ATOMG, RED) in
    a built library's SASS, one per instruction. `cuobjdump` is taken from
    the toolkit that built it, beside `nvcc`; raises Failed if it is not
    there."""
    import re
    from pathlib import Path
    from sift_tpu_torch.kernels import build
    tool = Path(build._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        raise Failed(f"no cuobjdump beside nvcc ({tool}): the descriptor "
                     "kernel's SASS cannot be checked for atomics")
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    found = (re.search(r"\b(?:ATOMS?|ATOMG|RED)\.[A-Z0-9_.]*", ln)
             for ln in sass.splitlines())
    return [m.group(0) for m in found if m]


def descriptor_edge_cases(torch, dk, kernel) -> int:
    """The descriptor kernel against its plain version (within
    `dk.TOLERANCE`) and against itself over two launches (bit for bit) on:
    random windows at `DESC_EDGE_SHAPES`; all-zero windows, whose
    histograms must be all zero; gradients along the axes with peak
    orientations on orientation-bin edges; offsets and widths that put u
    and v exactly on cell centres and cell edges; two identical peaks,
    whose histograms must be equal. Returns the number of cases."""
    g = torch.Generator(device="cuda").manual_seed(7)

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, device="cuda", generator=g)

    def scal_of(oy0, ox0, inv_hw, ori0, ori1):
        cols = [oy0, ox0, inv_hw]
        for ori in (ori0, ori1):
            th = ori.double() * (np.pi / 180.0)
            cols += [torch.cos(th).float(), torch.sin(th).float(), ori / 45.0]
        return torch.stack(cols, dim=1).float().contiguous()

    def random_case(K, d):
        wins = torch.randn((K, 2, d, d), device="cuda", generator=g) * 20.0
        scal = scal_of(uniform(-d / 2 - 0.5, -d / 2 + 0.5, K),
                       uniform(-d / 2 - 0.5, -d / 2 + 0.5, K),
                       1.0 / (3.0 * uniform(1.6, 3.2, K)),
                       uniform(0.0, 360.0, K), uniform(0.0, 360.0, K))
        return wins, scal

    cases = [random_case(K, d) for K, d in DESC_EDGE_SHAPES]
    # All-zero windows.
    zero = (torch.zeros((5, 2, 48, 48), device="cuda"), random_case(5, 48)[1])
    cases.append(zero)
    # Gradients along +x, +y, -x, -y; peaks every half bin (45 / 2 deg), so
    # each angle minus the peak falls on a bin edge or a bin centre.
    K, d = 64, 48
    axis = torch.randint(0, 4, (K, d, d), device="cuda", generator=g)
    mag = uniform(1.0, 50.0, K, d, d)
    ux = torch.tensor([1.0, 0.0, -1.0, 0.0], device="cuda")
    uy = torch.tensor([0.0, 1.0, 0.0, -1.0], device="cuda")
    wins = torch.stack([mag * ux[axis], mag * uy[axis]], dim=1).contiguous()
    half = torch.arange(K, device="cuda", dtype=torch.float32) % 16
    off = torch.full((K,), -d / 2, device="cuda")
    cases.append((wins, scal_of(off, off, torch.full((K,), 0.2, device="cuda"),
                                half * 22.5, ((half + 3) % 16) * 22.5)))
    # Peaks at multiples of 90 deg (cos, sin exact), integer offsets and
    # power-of-two widths: u and v land exactly on cell centres (-1.5 ..
    # 1.5) and on the grid's edges (+-2.5).
    K = 16
    wins = random_case(K, d)[0]
    quarter = (torch.arange(K, device="cuda") % 4).float()
    scal = scal_of(off[:K], off[:K],
                   0.5 ** (2 + torch.arange(K, device="cuda") % 3).float(),
                   quarter * 90.0, ((quarter + 1) % 4) * 90.0)
    c = torch.tensor([1.0, 0.0, -1.0, 0.0], device="cuda")
    s = torch.tensor([0.0, 1.0, 0.0, -1.0], device="cuda")
    q = quarter.long()
    scal[:, 3], scal[:, 4] = c[q], s[q]
    scal[:, 6], scal[:, 7] = c[(q + 1) % 4], s[(q + 1) % 4]
    cases.append((wins, scal))
    # Two identical peaks.
    wins, scal = random_case(50, 48)
    scal[:, 6:9] = scal[:, 3:6]
    cases.append((wins, scal))

    for wins, scal in cases:
        got, again = kernel(wins, scal), kernel(wins, scal)
        want = dk.descriptor_accumulate_plain(wins, scal)
        torch.cuda.synchronize()
        hold_extraction_kernel(torch, dk.TOLERANCE, "descriptor_accumulate",
                               got, want)
        if not torch.equal(got, again):
            raise Failed(f"descriptor kernel differs between two launches "
                         f"at {tuple(wins.shape)}")
    if bool(kernel(*zero).any()):
        raise Failed("zero windows gave a non-zero histogram")
    got = kernel(*cases[-1])
    if not torch.equal(got[:, 0], got[:, 1]):
        raise Failed("two identical peaks gave different histograms")
    return len(cases)


def hold_dog_gathers(torch, kern, refine_calls) -> int:
    """The window gather at d = 16 on the recorded f32 DoG stacks of the
    refine walk's calls, at its patch corners (images as the gather's level
    axis, as the walk was once fed), against its plain version, bit for
    bit. The main path gathers only bf16 maps, so this keeps the kernel's
    f32 branch held. Returns the number of windows."""
    from sift_tpu_torch.kernels.cuda import windows
    from sift_tpu_torch.kernels.cuda.refine import D, patch_corners
    n = 0
    for dogs, x, y, _ in refine_calls:
        B, _, H, W = dogs.shape
        _, _, x0, y0 = (t.reshape(-1) for t in patch_corners(x, y, H, W))
        gl = torch.arange(B, dtype=torch.int32, device=dogs.device
                          ).repeat_interleave(x.shape[1])
        args = (dogs.transpose(0, 1), gl, y0, x0, D)
        if not torch.equal(kern(*args), windows.gather_windows_plain(*args)):
            raise Failed(f"gather_windows f32 d={D} differs from plain on a "
                         f"DoG stack {tuple(dogs.shape)}")
        n += gl.numel()
    return n


def refine_edge_cases(torch, rk, kernel) -> int:
    """The refine kernel against its plain version, bit for bit, on smooth
    random DoG stacks at `REFINE_EDGE_SHAPES`: 97 candidates an image at
    any level of [1, L-2], a third of them on the four borders, four on
    the corners, some at fractional positions. Returns the number of
    cases."""
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(11)
    K = 97
    for B, L, H, W in REFINE_EDGE_SHAPES:
        noise = torch.randn((B * L, 1, H, W), device="cuda", generator=g)
        dogs = (F.avg_pool2d(noise, 3, stride=1, padding=1) * 40.0
                ).reshape(B, L, H, W).contiguous()
        x = torch.randint(0, W, (B, K), device="cuda", generator=g).float()
        y = torch.randint(0, H, (B, K), device="cuda", generator=g).float()
        side = torch.randint(0, 4, (B, K // 3), device="cuda", generator=g)
        x[:, :K // 3] = torch.where(side == 0, 0.0, torch.where(
            side == 1, W - 1.0, x[:, :K // 3]))
        y[:, :K // 3] = torch.where(side == 2, 0.0, torch.where(
            side == 3, H - 1.0, y[:, :K // 3]))
        x[:, -4:] = torch.tensor([0.0, W - 1.0, 0.0, W - 1.0], device="cuda")
        y[:, -4:] = torch.tensor([0.0, 0.0, H - 1.0, H - 1.0], device="cuda")
        x[:, K // 3:K // 2] += 0.99 * torch.rand(
            (B, K // 2 - K // 3), device="cuda", generator=g)
        level = torch.randint(1, L - 1, (B, K), device="cuda", generator=g,
                              dtype=torch.int32)
        args = (dogs, x, y, level)
        got, want = kernel(*args), rk.refine_walk_plain(*args)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise Failed(f"refine_walk differs from plain on a DoG stack "
                         f"{(B, L, H, W)}")
    return len(REFINE_EDGE_SHAPES)


def row_map(m) -> dict:
    v = m.valid.cpu().numpy()
    return dict(zip(m.idx_a.cpu().numpy()[v].tolist(),
                    zip(m.idx_b.cpu().numpy()[v].tolist(),
                        m.distance.cpu().numpy()[v].tolist())))


def match_phase(torch, card: str):
    """Phase 6; returns ({extraction kernel: max abs err at this path's
    shapes}, {"refine_walk" and "descriptor_accumulate": times and bound at
    these shapes}, the pair's two `Keypoints`, the `streaming_top2` row of
    the kernels line)."""
    from sift_tpu_torch import SiftConfig, extract_batch
    from sift_tpu_torch.config import MatchConfig, RansacConfig
    from sift_tpu_torch.geometry.homography import ransac_homography
    from sift_tpu_torch.kernels import cuda as kcuda
    from sift_tpu_torch.kernels.cuda import match as mk
    from sift_tpu_torch.matching.matcher import (match_descriptors,
                                                 matched_coords, top2_masked)

    h, w = MATCH_HEIGHT, MATCH_WIDTH
    t0 = time.perf_counter()
    pair_np, H_true = match_pair()
    pair = torch.from_numpy(pair_np).cuda()
    print(f"phase 6: {h}x{w} pair made in {time.perf_counter() - t0:.1f} s",
          flush=True)
    scfg = SiftConfig(max_keypoints=MATCH_FEATURES,
                      max_keypoints_per_octave=MATCH_FEATURES)
    mcfg = MatchConfig(ratio=0.8, mutual=True, max_matches=MATCH_FEATURES)
    rcfg = RansacConfig(inlier_threshold=3.0)

    def run_path(seed: int):
        kp = extract_batch(pair, scfg)
        ka, kb = kp.map(lambda t: t[0]), kp.map(lambda t: t[1])
        m = match_descriptors(ka.desc, ka.valid, kb.desc, kb.valid, mcfg)
        pa, pb, valid = matched_coords(ka, kb, m)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        est = ransac_homography(gen, pa, pb, valid, rcfg)
        return kp, ka, kb, m, est

    targets = dict(extraction_kernels(), streaming_top2=(mk, "streaming_top2"))
    with recording(targets) as (calls, originals):
        kcuda.reset_launch_counts()
        kp, ka, kb, m, est = run_path(0)
        torch.cuda.synchronize()
        launches = kcuda.launch_counts()
    recorded, original = calls.pop("streaming_top2"), originals["streaming_top2"]
    print(f"phase 6 launches: {launches}", flush=True)
    hold_launches("phase 6", launches, MATCH_LAUNCHES)

    n_kp = kp.count().tolist()
    n_match, n_in = int(m.count()), int(est.num_inliers)
    H_est = est.model.double().cpu().numpy()
    corners = np.array([[0, 0], [w, 0], [w, h], [0, h]], np.float64)
    gap = float(np.abs(map_points(H_est / H_est[2, 2], corners)
                       - map_points(H_true, corners)).max())
    print(f"keypoints {n_kp} (n_dropped {kp.n_dropped.tolist()}), matches "
          f"{n_match}, inliers {n_in} (success {bool(est.success)}), corner "
          f"error {gap:.4f} px", flush=True)
    if min(n_kp) != MATCH_FEATURES and min(n_kp) < MATCH_FEATURES // 2:
        raise Failed(f"too few keypoints: {n_kp}")
    if gap > 1.0:
        raise Failed(f"RANSAC homography off by {gap} px at the corners")
    if n_in * 2 < n_match or n_match == 0:
        raise Failed(f"{n_in} inliers of {n_match} matches")

    # The extraction kernels against their plain versions at this path's
    # shapes (phase 4 holds them at the extraction cell's).
    from sift_tpu_torch.kernels.cuda import descriptor
    plain = extraction_plain()
    extraction_err = {}
    timed = {name: dict(ms=0.0, ms_stream=0.0, bytes=0.0, ops=0.0, cells=0,
                        reads=0, device_seen=True)
             for name in ("refine_walk", "descriptor_accumulate")}
    for name in list(calls):
        err = 0.0
        kern = originals[name]
        for args in calls.pop(name):
            got, want = kern(*args), plain[name](*args)
            torch.cuda.synchronize()
            err = max(err, hold_extraction_kernel(
                torch, descriptor.TOLERANCE, name, got, want)[0])
            if name == "descriptor_accumulate" and \
                    not torch.equal(got, kern(*args)):
                raise Failed("descriptor kernel differs between two "
                             f"launches at {tuple(args[0].shape)}")
            if name in timed:
                t = timed[name]
                dev = kernel_trace(lambda: kern(*args), KERNEL_SYMBOLS[name],
                                   10)[0]
                t["device_seen"] &= dev is not None
                t["ms"] += dev or 0.0
                t["ms_stream"] += event_ms(lambda: kern(*args), 10)
                b, o = kernel_work(name, args)
                t["bytes"] += b
                t["ops"] += o
                if name == "refine_walk":
                    t["cells"] += covered_cells(*args[:3])
                    t["reads"] += walk_cells(*args)
            del got, want
        extraction_err[name] = err
        print(f"{name} at {h}x{w}: {launches[name]} calls ok, max_abs_err "
              f"{err:.3g}", flush=True)
    at_size = {}
    for name, t in timed.items():
        bms, by = bound(t["bytes"], t["ops"])
        at_size[name] = {
            "ms": t["ms"] if t["device_seen"] else t["ms_stream"],
            "ms_stream": t["ms_stream"], "bound_ms": bms,
            "timing": "cupti" if t["device_seen"] else "events"}
        note = "deterministic over two launches"
        if name == "refine_walk":
            at_size[name].update(walk_cells=t["reads"],
                                 covered_cells=t["cells"])
            note = (f"{t['reads']} DoG cells read by the walks, "
                    f"{t['cells']} covered by the patches")
        print(f"{name} at {h}x{w}: {note}, {at_size[name]['ms']:.4f} ms/pair "
              f"({at_size[name]['timing']}), stream {t['ms_stream']:.4f} ms, "
              f"bound {bms:.4f} ms ({by}); card {card}", flush=True)

    # The card's extraction against the CPU plain path at this size, as
    # sets (phase 5's criteria), and the host syncs of a batch.
    t0 = time.perf_counter()
    cpu = extract_batch(pair_np, scfg, device="cpu").to_numpy()
    cpu_s = time.perf_counter() - t0
    card_kp = kp.to_numpy()
    for i in range(2):
        fwd, worst_fwd = match_keypoints(cpu, card_kp, i)
        back, worst_back = match_keypoints(card_kp, cpu, i)
        worst = max(worst_fwd, worst_back)
        print(f"{h}x{w} image {i} vs CPU plain path ({cpu_s:.1f} s): "
              f"{int(cpu.valid[i].sum())} vs {int(card_kp.valid[i].sum())} "
              f"valid, matched {fwd:.4f} / {back:.4f}, max desc diff "
              f"{worst:.3g}", flush=True)
        if min(fwd, back) < 0.99 or worst > 2e-3:
            raise Failed(f"card and CPU plain path disagree on {h}x{w} "
                         f"image {i}")
    hold_syncs(torch, lambda: extract_batch(pair, scfg), f"{h}x{w}")

    # The kernel against its plain version on the recorded arguments, and
    # at the repo's large-matching size.
    g = torch.Generator(device="cuda").manual_seed(3)
    big = torch.randn((2, LARGE_N, 128), device="cuda", generator=g)
    big = big / torch.linalg.vector_norm(big, dim=-1, keepdim=True)
    bvalid = torch.rand((2, LARGE_N), device="cuda", generator=g) > 0.2
    cases = [("main path", args) for args in recorded]
    cases.append((f"{LARGE_N}^2", (big[0].contiguous(), bvalid[0],
                                   big[1].contiguous(), bvalid[1])))
    dense = mcfg.replace(impl="xla")
    tot = dict(ms=0.0, ms_stream=0.0, plain_ms=0.0, library_ms=0.0,
               bytes=0.0, ops=0.0, err=0.0)
    device_seen = True
    large = {}
    for label, args in cases:
        got, want = original(*args), mk.streaming_top2_plain(*args)
        torch.cuda.synchronize()
        err, rows, ties = top2_check(torch, mk, got, want, args)
        reps = 10
        stream = event_ms(lambda: original(*args), reps)
        dev = kernel_trace(lambda: original(*args),
                           ("top2_kernel", "merge_kernel"), reps,
                           launches=None)[0]
        plain = event_ms(lambda: mk.streaming_top2_plain(*args), 3)
        lib = event_ms(lambda: top2_masked(*args, dense), 3)
        b, o = kernel_work("streaming_top2", args)
        bms, _ = bound(b, o)
        print(f"streaming_top2 {label} {tuple(args[0].shape)}x"
              f"{tuple(args[2].shape)}: ok, max_abs_err {err:.3g}, {rows} "
              f"rows, {ties} near ties; kernel "
              f"{dev if dev is not None else float('nan'):.4f} ms (cupti), "
              f"stream {stream:.4f} ms, plain {plain:.3f} ms, dense top-2 "
              f"{lib:.3f} ms, bound {bms:.4f} ms", flush=True)
        if label != "main path":
            large = dict(ms=dev, ms_stream=stream, plain_ms=plain,
                         library_ms=lib, bound_ms=bms)
            continue
        if dev is None:
            device_seen = False
        else:
            tot["ms"] += dev
        tot["ms_stream"] += stream
        tot["plain_ms"] += plain
        tot["library_ms"] += lib
        tot["bytes"] += b
        tot["ops"] += o
        tot["err"] = max(tot["err"], err)

    n_edge = top2_edge_cases(torch, mk, original)
    print(f"streaming_top2 edge cases: {n_edge} ok (ragged edges, uneven "
          f"column ranges, all-invalid columns, exact ties)", flush=True)

    # The kernel's Matches against the dense path's, on the same card.
    m_dense = match_descriptors(ka.desc, ka.valid, kb.desc, kb.valid, dense)
    hold_matches_near_ties(torch, "Matches auto (kernel) vs xla (dense)",
                           ka, kb, mcfg, m, m_dense)

    # End to end: pairs/s, extraction and RANSAC alone.
    reps = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in range(reps):
        run_path(r)[4].num_inliers.item()
    pair_s = (time.perf_counter() - t0) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        extract_batch(pair, scfg)
    torch.cuda.synchronize()
    extract_s = (time.perf_counter() - t0) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        match_descriptors(ka.desc, ka.valid, kb.desc, kb.valid, mcfg)
    torch.cuda.synchronize()
    match_s = (time.perf_counter() - t0) / reps
    pa, pb, valid = matched_coords(ka, kb, m)
    t0 = time.perf_counter()
    for r in range(reps):
        gen = torch.Generator(device="cuda").manual_seed(r)
        ransac_homography(gen, pa, pb, valid, rcfg).num_inliers.item()
    ransac_s = (time.perf_counter() - t0) / reps
    busy_ms, wall_ms = profile_busy(torch, lambda: run_path(0)[4].num_inliers
                                    .item(), "chip_smoke_match_profile.txt",
                                    card)
    print(f"matching path {h}x{w} pair, {MATCH_FEATURES} features: "
          f"{1e3 * pair_s:.3f} ms/pair, {1 / pair_s:.3f} pairs/s; extract "
          f"{1e3 * extract_s:.3f} ms, match {1e3 * match_s:.3f} ms, RANSAC "
          f"{1e3 * ransac_s:.3f} ms; profiled pair device busy {busy_ms:.3f} "
          f"ms of {wall_ms:.3f} ms wall; card {card}", flush=True)

    bound_ms, bound_by = bound(tot["bytes"], tot["ops"])
    src, replaces = SOURCES["streaming_top2"]
    return extraction_err, at_size, (ka, kb), {
        "name": "streaming_top2", "route": "cuda", "source": src,
        "replaces": replaces, "launches": launches["streaming_top2"],
        "max_abs_err": tot["err"],
        "ms": tot["ms"] if device_seen else tot["ms_stream"],
        "ms_stream": tot["ms_stream"],
        "timing": "cupti" if device_seen else "events",
        "plain_ms": tot["plain_ms"], "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": tot["library_ms"],
        "library": "dense impl='xla' top-2: several PyTorch calls (matmul, "
                   "where, argmin, scatter, amin), not one",
        f"at_{LARGE_N}": large,
        "pairs_per_s": 1 / pair_s, "pair_ms": 1e3 * pair_s,
        "extract_ms": 1e3 * extract_s, "match_ms": 1e3 * match_s,
        "ransac_ms": 1e3 * ransac_s, "busy_ms": busy_ms, "wall_ms": wall_ms,
    }


def hold_matches_near_ties(torch, label: str, ka, kb, mcfg, m, m_ref):
    """Two `Matches` of one descriptor pair must differ only on rows near
    a tie or the ratio boundary of the dense top-2 (within the streaming
    kernel's RTOL of the norms), on at most 0.1% of the rows, with equal
    rows' distances within that tolerance."""
    from sift_tpu_torch.kernels.cuda import match as mk
    from sift_tpu_torch.matching.matcher import top2_masked
    dense = mcfg.replace(impl="xla")
    fwd = top2_masked(ka.desc, ka.valid, kb.desc, kb.valid, dense)
    back = top2_masked(kb.desc, kb.valid, ka.desc, ka.valid, dense)
    tol = mk.RTOL * (
        float(mk.masked_norms(ka.desc, ka.valid)[ka.valid].max())
        + float(mk.masked_norms(kb.desc, kb.valid)[kb.valid].max()))
    best, second, idx = fwd
    r2 = mcfg.ratio * mcfg.ratio
    back_tie = ((back[1] - back[0]) <= tol) & (back[0] < 1e29)
    flagged = ka.valid & (best < 1e29) & (
        ((second - best) <= tol) | ((best - r2 * second).abs() <= 2 * tol)
        | back_tie[idx.long()])
    flagged = flagged.cpu().numpy()
    ours, theirs = row_map(m), row_map(m_ref)
    differ = sorted(i for i in set(ours) | set(theirs)
                    if ours.get(i, (None,))[0] != theirs.get(i, (None,))[0])
    unexplained = [i for i in differ if not flagged[i]]
    d_err = max([abs(ours[i][1] - theirs[i][1]) for i in ours
                 if i in theirs and ours[i][0] == theirs[i][0]] or [0.0])
    print(f"{label}: {len(ours)} vs {len(theirs)} matches, {len(differ)} "
          f"rows differ (all near a tie or the ratio boundary: "
          f"{not unexplained}), {int(flagged.sum())} such rows in all, max "
          f"distance diff {d_err:.3g}", flush=True)
    if unexplained:
        raise Failed(f"{label}: Matches differ on rows {unexplained[:10]} "
                     "that are not near a tie or the ratio boundary")
    if len(differ) > 0.001 * ka.desc.shape[0]:
        raise Failed(f"{label}: {len(differ)} rows differ, more than 0.1%")
    if d_err > tol:
        raise Failed(f"{label}: distances differ by {d_err}")


def tum_relative_pose(here: str):
    """Ground-truth camera-B-from-camera-A (R, t) of the TUM pair from
    groundtruth.txt (world-from-camera tx ty tz qx qy qz qw rows)."""
    rows = np.loadtxt(os.path.join(here, TUM_DIR, "groundtruth.txt"),
                      comments="#")
    poses = []
    for stamp in TUM_PAIR:
        tx, ty, tz, qx, qy, qz, qw = rows[np.argmin(np.abs(
            rows[:, 0] - float(stamp))), 1:]
        R = np.array([
            [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw),
             2 * (qx * qz + qy * qw)],
            [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz),
             2 * (qy * qz - qx * qw)],
            [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw),
             1 - 2 * (qx * qx + qy * qy)]])
        poses.append((R, np.array([tx, ty, tz])))
    (Ra, pa), (Rb, pb) = poses
    return Rb.T @ Ra, Rb.T @ (pa - pb)


def rot_deg(R) -> float:
    """Rotation angle of R in degrees, from atan2(|skew|, cos): exact near
    zero, where arccos of the trace loses half the digits."""
    R = np.asarray(R, np.float64)
    s = np.linalg.norm([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                        R[1, 0] - R[0, 1]]) / 2.0
    return float(np.degrees(np.arctan2(s, (np.trace(R) - 1.0) / 2.0)))


def dir_deg(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    c = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def twoview_phase(torch, card: str) -> dict:
    """Phase 7: the `twoview` command's path on the TUM fixture pair at
    640x480 with its default `SiftConfig` (lowe, 4 octaves, top-K 1024,
    f32 windows); returns the launch counts of that run."""
    from sift_tpu_torch import cli
    from sift_tpu_torch.geometry.ransac import gumbel
    from sift_tpu_torch.io.image import load_image_gray
    from sift_tpu_torch.kernels import cuda as kcuda

    here = os.path.dirname(os.path.abspath(__file__))
    paths = [os.path.join(here, TUM_DIR, "rgb", f"{s}.png") for s in TUM_PAIR]
    intr = [f"--{k}={v}" for k, v in zip(("fx", "fy", "cx", "cy"),
                                         TUM_FR1_INTRINSICS)]
    args = cli.build_parser().parse_args(["twoview", *paths, *intr])
    cfg = cli._sift_config(args)
    grays = [load_image_gray(p) for p in paths]
    intrinsics = (args.fx, args.fy, args.cx, args.cy)

    def run(device="cuda", noise=None):
        kps = cli.twoview_extract(grays, cfg, device)
        m, pa, pb, valid = cli.twoview_match(kps, args.ratio)
        return (m, pa, pb, valid, *cli.twoview_pose(pa, pb, valid, intrinsics,
                                                    args.threshold, noise))

    kcuda.reset_launch_counts()
    m, pa, pb, valid, R, t, est = run()
    torch.cuda.synchronize()
    launches = kcuda.launch_counts()
    print(f"phase 7 launches: {launches}", flush=True)
    hold_launches("phase 7", launches, TWOVIEW_LAUNCHES)

    R_gt, t_gt = tum_relative_pose(here)
    n_match, n_in = int(m.count()), int(est.num_inliers)
    R, t = R.double().cpu().numpy(), t.double().cpu().numpy()
    r_err, t_err = rot_deg(R @ R_gt.T), dir_deg(t, t_gt)
    print(f"twoview {TUM_PAIR[0]} -> {TUM_PAIR[1]}: matches {n_match}, "
          f"inliers {n_in}, success {bool(est.success)}; rotation {r_err:.4f} "
          f"deg from the ground truth, t {np.round(t, 5).tolist()} "
          f"{t_err:.4f} deg from the ground-truth baseline", flush=True)
    if not bool(est.success) or n_in * 2 < n_match:
        raise Failed(f"twoview: {n_in} inliers of {n_match} matches")
    if r_err > 0.1 or t_err > 2.0:
        raise Failed(f"twoview pose off: rotation {r_err} deg, t {t_err} deg")

    # The pose step on the card and on the CPU, same points and noise.
    noise = gumbel(torch.Generator().manual_seed(0), (512, pa.shape[0]), "cpu")
    R1, t1, e1 = cli.twoview_pose(pa, pb, valid, intrinsics, args.threshold,
                                  noise.cuda())
    R2, t2, e2 = cli.twoview_pose(pa.cpu(), pb.cpu(), valid.cpu(), intrinsics,
                                  args.threshold, noise)
    dr = rot_deg(R1.double().cpu().numpy() @ R2.double().numpy().T)
    dt = dir_deg(t1.double().cpu().numpy(), t2.double().numpy())
    dn = abs(int(e1.num_inliers) - int(e2.num_inliers))
    print(f"twoview pose card vs CPU plain path (same points, same noise): "
          f"rotation {dr:.5f} deg, t {dt:.5f} deg, inliers "
          f"{int(e1.num_inliers)} vs {int(e2.num_inliers)}", flush=True)
    if dr > TWOVIEW_R_DEG or dt > TWOVIEW_T_DEG or dn > 0.01 * int(e2.num_inliers):
        raise Failed("twoview pose differs between the card and the CPU")
    # The whole path on the CPU, against the ground truth.
    mc, _, _, _, Rc, tc, ec = run("cpu")
    print(f"twoview CPU plain path: matches {int(mc.count())}, inliers "
          f"{int(ec.num_inliers)}, rotation {rot_deg(Rc.double().numpy() @ R_gt.T):.4f}"
          f" deg, t {dir_deg(tc.double().numpy(), t_gt):.4f} deg", flush=True)
    if not bool(ec.success) or abs(int(mc.count()) - n_match) > 0.05 * n_match:
        raise Failed("twoview: the CPU plain path disagrees with the card")

    # Time per pair, by step (CUDA events around each, after a warm run).
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    reps, ms = 5, np.zeros(3)
    for _ in range(reps):
        ev[0].record()
        kps = cli.twoview_extract(grays, cfg, "cuda")
        ev[1].record()
        m, pa, pb, valid = cli.twoview_match(kps, args.ratio)
        ev[2].record()
        cli.twoview_pose(pa, pb, valid, intrinsics, args.threshold)
        ev[3].record()
        ev[3].synchronize()
        ms += [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
    ms /= reps
    busy_ms, wall_ms = profile_busy(
        torch, lambda: cli.twoview_pose(pa, pb, valid, intrinsics,
                                        args.threshold)[0].cpu(),
        "chip_smoke_twoview_pose_profile.txt", card)
    print(f"twoview 640x480 pair: {ms.sum():.3f} ms/pair (CUDA events; "
          f"extraction {ms[0]:.3f} ms for both images, matching {ms[1]:.3f} "
          f"ms, relative pose {ms[2]:.3f} ms); profiled relative pose device "
          f"busy {busy_ms:.3f} ms of {wall_ms:.3f} ms wall; card {card}",
          flush=True)
    return launches


def ba_inputs(torch, scene: dict, device) -> list:
    return [torch.from_numpy(np.asarray(scene[k])).to(device) for k in BA_KEYS]


def hold_ba_states(a, b, label: str, lm_iters: int) -> None:
    """Two `BAState`s within the BA_* tolerances."""
    def rel(x, y):
        x, y = x.double().cpu(), y.double().cpu()
        return float((x - y).abs().max()) / max(float(y.abs().max()), 1.0)

    dp, dl = rel(a.poses, b.poses), rel(a.landmarks, b.landmarks)
    dr = abs(float(a.rmse) - float(b.rmse)) / max(float(b.rmse), 1e-12)
    dcg = abs(int(a.cg_iters) - int(b.cg_iters))
    print(f"{label}: poses {dp:.3g}, landmarks {dl:.3g}, rmse {dr:.3g} "
          f"relative; iterations {int(a.iterations)} vs {int(b.iterations)}, "
          f"cg_iters {int(a.cg_iters)} vs {int(b.cg_iters)}", flush=True)
    if (max(dp, dl) > BA_STATE_RTOL or dr > BA_RMSE_RTOL
            or int(a.iterations) != int(b.iterations)
            or dcg > BA_CG_SLACK * lm_iters):
        raise Failed(f"{label}: BA states differ beyond the tolerances")


def ba_case(torch, card: str, label: str, scene: dict, cfg, cpu_iters: int):
    """Run `run_ba` on the card (no host sync allowed inside), again for
    the time and card-to-card agreement, and on the CPU for `cpu_iters` LM
    iterations; print and check the result."""
    from sift_tpu_torch.ba.residuals import cost
    from sift_tpu_torch.ba.schur import build_system, schur_matvec
    from sift_tpu_torch.ba.solver import run_ba

    C = scene["poses_init"].shape[0]
    fixed = np.zeros(C, bool)
    fixed[:2] = True
    args = ba_inputs(torch, scene, "cuda")
    fixed_d = torch.from_numpy(fixed).cuda()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st = run_ba(*args, cfg, fixed_d)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    st2 = run_ba(*args, cfg, fixed_d)
    end.record()
    end.synchronize()
    run_ms = start.elapsed_time(end)

    _, rmse0 = cost(args[0], args[1], args[2], *args[3:], cfg.huber_delta)
    n_obs = int(args[6].sum())
    print(f"{label}: C={C}, L={scene['landmarks_init'].shape[0]}, O="
          f"{args[3].shape[0]} ({n_obs} valid); rmse {float(rmse0):.4f} -> "
          f"{float(st.rmse):.4f} px, iterations {int(st.iterations)}, cg_iters "
          f"{int(st.cg_iters)}; no host sync inside run_ba", flush=True)
    if not float(st.rmse) < 0.1 * float(rmse0):
        raise Failed(f"{label}: rmse {float(rmse0)} -> {float(st.rmse)}")
    if not bool(torch.isfinite(st.poses).all()):
        raise Failed(f"{label}: non-finite poses")
    fields = ("poses", "landmarks", "cost", "rmse", "damping", "iterations",
              "cg_iters")
    same = all(torch.equal(getattr(st, f), getattr(st2, f)) for f in fields)
    print(f"{label} card vs card: bit-identical {same}", flush=True)
    if not same:
        raise Failed(f"{label}: two card runs differ")

    want = run_ba(*ba_inputs(torch, scene, "cpu"),
                  cfg.replace(max_iterations=cpu_iters), torch.from_numpy(fixed))
    got = st if cpu_iters == cfg.max_iterations else run_ba(
        *args, cfg.replace(max_iterations=cpu_iters), fixed_d)
    hold_ba_states(got, want, f"{label} card vs CPU plain path "
                   f"({cpu_iters} LM iterations)", cpu_iters)

    busy_ms, wall_ms = profile_busy(
        torch, lambda: run_ba(*args, cfg, fixed_d).rmse.item(),
        f"chip_smoke_{label.split()[0]}_ba_profile.txt", card)
    out = {"ms_per_lm_iteration": run_ms / cfg.max_iterations,
           "run_ms": run_ms, "busy_ms": busy_ms, "wall_ms": wall_ms,
           "state": st}
    msg = (f"{run_ms / cfg.max_iterations:.3f} ms per LM iteration; profiled "
           f"run device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms wall")
    if cfg.solver == "pcg":
        system = build_system(*args[:7], cfg.huber_delta, cfg.damping_init,
                              fixed_d, cfg.loss)
        p = torch.randn((C, 6), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(0))
        out["ms_per_cg_matvec"] = event_ms(
            lambda: schur_matvec(system, p), 20)
        msg += f", {out['ms_per_cg_matvec']:.4f} ms per CG matvec"
    print(f"{label}: {msg} (CUDA events, {cfg.max_iterations} LM iterations, "
          f"all executed); card {card}", flush=True)
    return out


def ba_phase(torch, card: str) -> dict:
    """Phase 8: window BA at the pipeline's capacities and map-scale BA."""
    from sift_tpu_torch.config import BAConfig
    from sift_tpu_torch.io.synthetic import (make_corridor_scene, make_scene,
                                             pad_observations)

    window = make_scene(np.random.default_rng(0), num_cameras=WINDOW_C,
                        num_landmarks=WINDOW_L, pixel_noise=0.5,
                        pose_noise=0.02, landmark_noise=0.1, drop_rate=0.55)
    if window["obs_cam"].shape[0] > WINDOW_O:
        raise Failed(f"window scene has {window['obs_cam'].shape[0]} > "
                     f"{WINDOW_O} observations")
    window = pad_observations(window, WINDOW_O)
    t0 = time.perf_counter()
    corridor = make_corridor_scene(
        np.random.default_rng(0), num_cameras=MAP_C, num_landmarks=MAP_L,
        obs_per_camera=MAP_OBS_PER_CAM, pose_noise=0.02, landmark_noise=0.2)
    print(f"phase 8: corridor scene made in {time.perf_counter() - t0:.1f} s",
          flush=True)
    map_cfg = BAConfig(max_iterations=10, cg_iterations=50, solver="pcg",
                       loss="huber")
    return {
        "window": ba_case(torch, card, "window BA", window, BAConfig(),
                          cpu_iters=BAConfig().max_iterations),
        "map": ba_case(torch, card, "map-scale BA", corridor, map_cfg,
                       cpu_iters=2),
        "scenes": {"window": (window, BAConfig()), "map": (corridor, map_cfg)},
    }


def sfm_cli_phase(torch, here: str) -> dict:
    """Phase 9a: `cli sfm` on the TUM fixture on the card; returns the
    launch counts of that run."""
    import io
    from sift_tpu_torch import cli
    from sift_tpu_torch.kernels import cuda as kcuda

    traj = os.path.join(here, OUT_DIR, "chip_smoke_sfm_tum_traj.txt")
    out = io.StringIO()
    kcuda.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["sfm", os.path.join(here, TUM_DIR), "--format", "tum",
                       "--traj", traj])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = kcuda.launch_counts()
    text = out.getvalue()
    for line in text.splitlines():
        print(f"phase 9a cli sfm: {line}", flush=True)
    print(f"phase 9a: rc {rc} in {dt:.3f} s (first run, kernels built), "
          f"launches {launches}", flush=True)
    if rc != 0 or "ATE RMSE (se3-aligned)" not in text:
        raise Failed(f"cli sfm on the TUM fixture: rc {rc}")
    ate = float(text.split("ATE RMSE")[1].split(":")[1].split("m")[0])
    rows = np.loadtxt(traj)
    if rows.shape != (10, 3) or not np.isfinite(rows).all():
        raise Failed(f"cli sfm trajectory has shape {rows.shape}")
    if ate >= SFM_CLI_ATE:
        raise Failed(f"cli sfm ATE {ate} m >= {SFM_CLI_ATE} m")
    hold_launches("phase 9a", launches, SFM_CLI_LAUNCHES)
    return launches


def timed_tracking(torch, pipe, times: dict, syncs=None):
    """Wrap `pipe._tracking_step` to append each frame's wall seconds to
    times["promoted"], times["tracked"] (tracked, not promoted) or
    times["lost"]; with `syncs` (a list), count each frame's host syncs
    (`count_syncs`) and append (kind, sites)."""
    orig = pipe._tracking_step

    def step(kp_dev, depth=None):
        held = {}
        t0 = time.perf_counter()
        if syncs is None:
            held["out"] = orig(kp_dev, depth)
            sites = None
        else:
            sites = count_syncs(torch, lambda: held.setdefault(
                "out", orig(kp_dev, depth)))
        dt = time.perf_counter() - t0
        out = held["out"]
        kind = "promoted" if out["is_keyframe"] else \
            "tracked" if out["tracked"] else "lost"
        times.setdefault(kind, []).append(dt)
        if syncs is not None:
            syncs.append((kind, sites))
        return out

    pipe._tracking_step = step


def track_local_ops(torch, pipe, args) -> str:
    """Replay `pipe._track_local(*args)` under the profiler; count the
    outermost PyTorch operator calls, and those made inside
    `pose_ransac_refine`."""
    from torch.profiler import ProfilerActivity, profile, record_function
    import sift_tpu_torch.slam.pipeline as sp

    refine = sp.pose_ransac_refine

    def marked(*a, **k):
        with record_function("pose_ransac_refine"):
            return refine(*a, **k)

    sp.pose_ransac_refine = marked
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            pipe._track_local(*args).cpu()
    finally:
        sp.pose_ransac_refine = refine

    def inside(e, name):
        while e.cpu_parent is not None:
            e = e.cpu_parent
            if e.name == name:
                return True
        return False

    ops = [e for e in prof.events() if e.name.startswith("aten::") and not (
        e.cpu_parent is not None and e.cpu_parent.name.startswith("aten::"))]
    n_pose = sum(inside(e, "pose_ransac_refine") for e in ops)
    return f"{len(ops)}, {n_pose} of them in pose_ransac_refine"


def sfm_phase(torch, card: str) -> tuple:
    """Phase 9: the SfM loop on the card. (a) `cli sfm` on the TUM fixture;
    (b) `process_sequence` on the rendered 96-frame 640x480 monocular
    sequence with the default `PipelineConfig`. Returns (launch counts of
    (b), {kernel: max abs err on (b)'s first chunk})."""
    from sift_tpu_torch.config import PipelineConfig
    from sift_tpu_torch.eval.ate import ate_rmse
    from sift_tpu_torch.kernels import cuda as kcuda
    from sift_tpu_torch.kernels.cuda import descriptor
    from sift_tpu_torch.slam.pipeline import SfmPipeline

    here = os.path.dirname(os.path.abspath(__file__))
    sfm_cli_phase(torch, here)

    t0 = time.perf_counter()
    frames, gt = make_sfm_sequence()
    frames = list(frames)
    print(f"phase 9b: {len(frames)} frames of {SFM_H}x{SFM_W} rendered in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    cfg = PipelineConfig()
    pipe = SfmPipeline(SFM_INTRINSICS, cfg, seed=0)
    with recording(extraction_kernels()) as (recorded, originals):
        kcuda.reset_launch_counts()
        t0 = time.perf_counter()
        res = pipe.process_sequence(frames, batch=SFM_BATCH)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = kcuda.launch_counts()
        first_chunk = {name: calls[:4] for name, calls in recorded.items()}
        recorded.clear()
    tracked = float(np.mean([r["tracked"] for r in res]))
    est = pipe.positions()
    if est.shape != (SFM_FRAMES, 3) or not np.isfinite(est).all():
        raise Failed(f"sfm positions {est.shape} not finite")
    ate = ate_rmse(est, gt, align=True, with_scale=True)
    n_kf = len(pipe.keyframes)
    boot = next(i for i, r in enumerate(res) if r["state"] == "tracking")
    print(f"phase 9b: state {pipe.state}, bootstrap at frame {boot}, tracked "
          f"share {tracked:.4f} (JAX {SFM_JAX_TRACKED}), keyframes {n_kf} at "
          f"{[r['frame_idx'] for r in res if r['is_keyframe']]} (JAX "
          f"{SFM_JAX_KEYFRAMES}), landmarks {pipe.landmarks.shape[0]}, sim3 "
          f"ATE {ate:.6f} m (JAX {SFM_JAX_ATE:.6f} m); first pass {first_s:.3f}"
          f" s; launches {launches}", flush=True)
    if pipe.state != "tracking":
        raise Failed(f"sfm ended in state {pipe.state}")
    if tracked < max(0.9, SFM_JAX_TRACKED - 0.05):
        raise Failed(f"sfm tracked share {tracked}")
    if ate > max(1.5 * SFM_JAX_ATE, SFM_JAX_ATE + 0.01):
        raise Failed(f"sfm ATE {ate} m against JAX's {SFM_JAX_ATE} m")
    if abs(n_kf - SFM_JAX_KEYFRAMES) > 0.2 * SFM_JAX_KEYFRAMES:
        raise Failed(f"sfm made {n_kf} keyframes, JAX {SFM_JAX_KEYFRAMES}")
    hold_launches("phase 9b", launches, SFM_LAUNCHES)

    # Relocalization on the card (no frame of the sequence loses
    # tracking): a keyframe's own keypoints against the keyframes the
    # global index votes for, probed in one batch.
    probe = len(pipe.keyframes) - 2
    hit = pipe._attempt_relocalization(pipe.keyframes[probe].kp)
    if hit is None:
        raise Failed(f"keyframe {probe} did not relocalize")
    n_inl = int(hit[3].sum())
    dpose = float(np.abs(hit[1] - pipe.keyframes[probe].pose).max())
    print(f"phase 9b relocalization of keyframe {probe}'s keypoints: against "
          f"keyframe {hit[0]}, {n_inl} inliers, pose within {dpose:.2e} of "
          "the keyframe's", flush=True)
    if hit[0] != probe or n_inl < cfg.keyframe_min_inliers or dpose > 1e-2:
        raise Failed("relocalization on the card")

    # The first chunk's kernel calls against their plain versions.
    plain = extraction_plain()
    errs = {}
    for name, calls in first_chunk.items():
        errs[name] = 0.0
        for args in calls:
            got, want = originals[name](*args), plain[name](*args)
            torch.cuda.synchronize()
            errs[name] = max(errs[name], hold_extraction_kernel(
                torch, descriptor.TOLERANCE, name, got, want)[0])
        print(f"phase 9b {name}: {len(calls)} calls of the first chunk held "
              f"against plain, max_abs_err {errs[name]:.3g}", flush=True)
    del first_chunk

    # Warm second pass: frames/s, per-frame and per-chunk times.
    pipe = SfmPipeline(SFM_INTRINSICS, cfg, seed=0)
    times, chunk_ev = {}, []
    timed_tracking(torch, pipe, times)
    orig_extract = pipe._extract_batch

    def extract(imgs):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        kp = orig_extract(imgs)
        ev[1].record()
        chunk_ev.append(ev)
        return kp

    pipe._extract_batch = extract
    t0 = time.perf_counter()
    res2 = pipe.process_sequence(frames, batch=SFM_BATCH)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    ext_ms = [a.elapsed_time(b) for a, b in chunk_ev]
    ate2 = ate_rmse(pipe.positions(), gt, align=True, with_scale=True)
    med = {k: 1e3 * float(np.median(v)) for k, v in times.items()}
    print(f"phase 9b warm pass: {SFM_FRAMES / warm_s:.3f} frames/s "
          f"({warm_s:.3f} s for {SFM_FRAMES} frames), keyframes "
          f"{len(pipe.keyframes)}, ATE {ate2:.6f} m; median ms of a tracked "
          f"frame that is not promoted {med.get('tracked', float('nan')):.3f} "
          f"(n={len(times.get('tracked', []))}, min "
          f"{1e3 * min(times.get('tracked', [np.nan])):.3f}, max "
          f"{1e3 * max(times.get('tracked', [np.nan])):.3f}); median ms of a "
          f"promotion with its window BA {med.get('promoted', float('nan')):.3f}"
          f" (n={len(times.get('promoted', []))}); extraction "
          f"{np.median(ext_ms):.3f} ms a chunk (CUDA events, median of "
          f"{len(ext_ms)}; min {min(ext_ms):.3f}, max {max(ext_ms):.3f}); "
          f"card {card}", flush=True)
    if [r["is_keyframe"] for r in res2] != [r["is_keyframe"] for r in res]:
        print("phase 9b: the warm pass promoted other frames than the "
              "first", flush=True)

    # Third pass to the profiled chunk: host syncs of each tracked frame,
    # then one warm chunk under the profiler.
    pipe = SfmPipeline(SFM_INTRINSICS, cfg, seed=0)
    syncs, last = [], {}
    timed_tracking(torch, pipe, {}, syncs)
    stage = pipe._track_local

    def keep_args(*a):
        last["args"] = a
        return stage(*a)

    pipe._track_local = keep_args
    pipe.process_sequence(frames[:SFM_PROFILED_CHUNK * SFM_BATCH],
                          batch=SFM_BATCH)
    counts = [len(s) for kind, s in syncs if kind == "tracked"]
    sites = next((s for kind, s in syncs if kind == "tracked"), [])
    promo = [s for kind, s in syncs if kind == "promoted"]
    print(f"phase 9b host syncs of a tracked frame that is not promoted: "
          f"{int(np.median(counts)) if counts else 'none tracked'} (per frame "
          f"{counts}; sites of the first {sorted(sites)}); of a promotion: "
          f"{[len(s) for s in promo]} (sites of the first "
          f"{sorted(promo[0]) if promo else []})", flush=True)
    del pipe._tracking_step, pipe._track_local   # the class's methods
    print(f"phase 9b operator calls of one tracking stage (`_track_local`): "
          f"{track_local_ops(torch, pipe, last['args'])}", flush=True)
    lo = SFM_PROFILED_CHUNK * SFM_BATCH
    busy_ms, wall_ms = profile_busy(
        torch, lambda: (pipe.process_sequence(frames[lo:lo + SFM_BATCH],
                                              batch=SFM_BATCH),
                        torch.cuda.synchronize()),
        "chip_smoke_sfm_profile.txt", card)
    print(f"phase 9b profiled warm chunk (frames {lo}-{lo + SFM_BATCH - 1}): "
          f"device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms wall, busy share "
          f"{busy_ms / wall_ms:.4f}; card {card}", flush=True)
    return launches, errs


class _Events:
    """A `MetricsLogger` stand-in that keeps the pipeline's events."""

    def __init__(self):
        self.events = []

    def log(self, event, **fields):
        self.events.append((event, fields))

    def count(self, event) -> int:
        return sum(e == event for e, _ in self.events)


def capacity_graph(torch, D: int, seed: int):
    """A pose graph at the pipeline's capacities (PGO_NODES nodes,
    PGO_EDGES edges of which PGO_PAD are weight-0 padding): an odometry
    chain plus random chords between distinct nodes, measurements the
    true relative poses plus noise, node 0 and four others fixed, the
    start the truth plus noise. D = 6 (SE(3)) or 7 (Sim(3)); CPU tensors."""
    from sift_tpu_torch.geometry import lie, sim3
    rng = np.random.default_rng(seed)
    n, m = PGO_NODES, PGO_EDGES - PGO_PAD
    gt = np.zeros((n, D), np.float32)
    gt[:, :3] = rng.uniform(-0.6, 0.6, (n, 3))
    gt[:, 3:6] = rng.uniform(-3.0, 3.0, (n, 3))
    if D == 7:
        gt[:, 6] = rng.uniform(-0.2, 0.2, n)
    ei = np.concatenate([np.arange(n - 1), rng.integers(0, n, m - n + 1)])
    ej = np.concatenate([np.arange(1, n), (ei[n - 1:] + rng.integers(
        1, n, m - n + 1)) % n])
    g = torch.from_numpy(gt)
    if D == 7:
        S = sim3.sim3_exp(g)
        ez = sim3.sim3_log(*sim3.sim3_compose(
            *sim3.sim3_inverse(*(x[ei] for x in S)), *(x[ej] for x in S)))
    else:
        R, t = lie.se3_exp(g)
        ez = lie.se3_log(*lie.se3_compose(*lie.se3_inverse(R[ei], t[ei]),
                                          R[ej], t[ej]))
    ez = ez.numpy() + rng.normal(0, 0.01, (m, D)).astype(np.float32)
    ew = rng.uniform(0.5, 20.0, m)
    ei = np.concatenate([ei, rng.integers(0, n, PGO_PAD)])
    ej = np.concatenate([ej, rng.integers(0, n, PGO_PAD)])
    ez = np.concatenate([ez, np.full((PGO_PAD, D), 9.5, np.float32)])
    ew = np.concatenate([ew, np.zeros(PGO_PAD)])
    fixed = np.zeros(n, bool)
    fixed[[0, *rng.choice(np.arange(1, n), 4, replace=False)]] = True
    init = gt + rng.normal(0, 0.05, gt.shape).astype(np.float32)
    init[fixed] = gt[fixed]
    return [torch.from_numpy(np.asarray(a, dt)) for a, dt in (
        (init, np.float32), (ei, np.int64), (ej, np.int64),
        (ez, np.float32), (ew, np.float32), (fixed, bool))]


def pgo_capacity(torch, card: str) -> dict:
    """Phase 10c: both pose graphs at capacity on the card, under
    `set_sync_debug_mode("error")`; two card runs bit-identical, the CPU
    within PGO_CPU_TOL; ms per run (CUDA events, median of PGO_REPS)."""
    from sift_tpu_torch.slam import pose_graph as pg
    out = {}
    for D, name, cls, opt in (
            (6, "SE(3)", pg.PoseGraph, pg.optimize_pose_graph),
            (7, "Sim(3)", pg.Sim3Graph, pg.optimize_pose_graph_sim3)):
        arrays = capacity_graph(torch, D, seed=D)
        cpu_graph = cls(*arrays)
        graph = cls(*(a.cuda() for a in arrays))

        def run():
            return opt(graph, iterations=PGO_ITERATIONS).poses

        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            first = run()
            second = run()
        except RuntimeError as e:
            raise Failed(f"{name} pose graph synced the host: {e}")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        first, second = first.cpu(), second.cpu()
        if not torch.equal(first, second):
            raise Failed(f"{name} pose graph: two card runs differ")
        t0 = time.perf_counter()
        cpu = opt(cpu_graph, iterations=PGO_ITERATIONS).poses
        cpu_s = time.perf_counter() - t0
        err = float((first - cpu).abs().max())
        rel = err / max(1.0, float(cpu.abs().max()))
        moved = float((first - arrays[0]).abs().max())
        if not torch.isfinite(first).all() or rel > PGO_CPU_TOL or \
                moved < 1e-2:
            raise Failed(f"{name} pose graph at capacity: card vs CPU "
                         f"{err:.3g} ({rel:.3g} of the largest coordinate, "
                         f"tolerance {PGO_CPU_TOL}), moved {moved:.3g}")
        times = []
        for _ in range(PGO_REPS):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            t0 = time.perf_counter()
            ev[0].record()
            run()
            ev[1].record()
            ev[1].synchronize()
            times.append((ev[0].elapsed_time(ev[1]),
                          1e3 * (time.perf_counter() - t0)))
        ms = float(np.median([a for a, _ in times]))
        wall = float(np.median([b for _, b in times]))
        busy_ms, busy_wall = profile_busy(
            torch, lambda: (run(), torch.cuda.synchronize()),
            f"chip_smoke_pgo_{D}dof_profile.txt", card)
        print(f"phase 10c {name} pose graph at {PGO_NODES} nodes / "
              f"{PGO_EDGES} edges ({PGO_ITERATIONS} LM x 64 CG steps, no "
              f"host sync under sync_debug_mode error): {ms:.3f} ms a run "
              f"(CUDA events, median of {PGO_REPS}; min "
              f"{min(a for a, _ in times):.3f}, max "
              f"{max(a for a, _ in times):.3f}), wall {wall:.3f} ms; two card "
              f"runs bit-identical; card vs CPU max abs {err:.3g}, {rel:.3g} "
              f"of the largest coordinate (CPU "
              f"{cpu_s:.3f} s); profiled run device busy {busy_ms:.3f} ms of "
              f"{busy_wall:.3f} ms wall; card {card}", flush=True)
        out[name] = ms
    return out


def loop_phase(torch, card: str) -> tuple:
    """Phase 10: loop closure and map maintenance on the card. (a) the
    out-and-back sequence through `process_sequence` with loop closure,
    the Sim(3) graph and compaction on, then `run_global_ba`; (b) a forced
    revisit closed through both graphs; (c) both graphs at capacity;
    (d) `save_map` -> `load_map`. Returns (launch counts of (a),
    {kernel: max abs err on (a)'s first chunk}, the arguments of every
    bootstrap attempt's homography RANSAC in (a))."""
    from sift_tpu_torch.config import PipelineConfig
    from sift_tpu_torch.eval.ate import ate_rmse
    from sift_tpu_torch.kernels import cuda as kcuda
    from sift_tpu_torch.kernels.cuda import descriptor
    from sift_tpu_torch.slam.pipeline import Keyframe, SfmPipeline

    frames, gt = make_sfm_sequence(xs=LOOP_XS)
    frames = list(frames)
    cfg = PipelineConfig(enable_loop_closure=True, pose_graph_sim3=True,
                         compact_interval_kf=10, loop_min_inliers=25,
                         loop_max_rmse=2.0)
    log = _Events()
    pipe = SfmPipeline(SFM_INTRINSICS, cfg, seed=0, logger=log)
    from sift_tpu_torch.slam import pipeline as pipeline_mod
    targets = dict(extraction_kernels(),
                   boot_homography=(pipeline_mod, "ransac_homography"))
    with recording(targets) as (recorded, originals):
        kcuda.reset_launch_counts()
        t0 = time.perf_counter()
        res = pipe.process_sequence(frames, batch=SFM_BATCH)
        torch.cuda.synchronize()
        seq_s = time.perf_counter() - t0
        launches = kcuda.launch_counts()
        boot_calls = recorded.pop("boot_homography")
        first_chunk = {name: calls[:4] for name, calls in recorded.items()}
        recorded.clear()
    tracked = float(np.mean([r["tracked"] for r in res]))
    n_kf = len(pipe.keyframes)
    closures, pgo_runs = pipe.num_loop_closures, log.count("pose_graph")
    t0 = time.perf_counter()
    gba = pipe.run_global_ba()
    gba_s = time.perf_counter() - t0
    est = pipe.positions()
    if est.shape != (len(LOOP_XS), 3) or not np.isfinite(est).all():
        raise Failed(f"loop positions {est.shape} not finite")
    ate = ate_rmse(est, gt, align=True, with_scale=True)
    print(f"phase 10a: {len(frames)} frames out and back in {seq_s:.3f} s "
          f"({len(frames) / seq_s:.3f} frames/s, first pass); state "
          f"{pipe.state}, tracked share {tracked:.4f}, keyframes {n_kf} at "
          f"{[kf.frame_idx for kf in pipe.keyframes]} (JAX "
          f"{LOOP_JAX_KEYFRAMES}), loop closures {closures} (JAX "
          f"{LOOP_JAX_CLOSURES}), pose-graph runs {pgo_runs} (JAX "
          f"{LOOP_JAX_PGO_RUNS}), probes {len(pipe.loop_probe_log)}, "
          f"compactions {log.count('compact')}, landmarks "
          f"{pipe.landmarks.shape[0]}; global BA {gba} in {gba_s:.3f} s "
          f"(JAX RMSE {LOOP_JAX_GBA_RMSE:.6f} px); sim3 ATE {ate:.6f} m "
          f"(JAX {LOOP_JAX_ATE:.6f} m); launches {launches}", flush=True)
    if pipe.state != "tracking" or tracked < 0.9:
        raise Failed(f"loop sequence: state {pipe.state}, tracked {tracked}")
    if (closures, pgo_runs) != (LOOP_JAX_CLOSURES, LOOP_JAX_PGO_RUNS):
        raise Failed(f"loop sequence closed {closures} loops in {pgo_runs} "
                     f"graph runs, JAX {LOOP_JAX_CLOSURES} in "
                     f"{LOOP_JAX_PGO_RUNS}")
    if abs(n_kf - LOOP_JAX_KEYFRAMES) > 0.2 * LOOP_JAX_KEYFRAMES:
        raise Failed(f"loop sequence made {n_kf} keyframes, JAX "
                     f"{LOOP_JAX_KEYFRAMES}")
    if ate > max(1.5 * LOOP_JAX_ATE, LOOP_JAX_ATE + 0.01):
        raise Failed(f"loop sequence ATE {ate} m against JAX's "
                     f"{LOOP_JAX_ATE} m")
    if not np.isfinite(gba["rmse"]) or gba["n_cams"] != n_kf:
        raise Failed(f"global BA {gba}")
    hold_launches("phase 10a", launches, LOOP_LAUNCHES)
    plain = extraction_plain()
    errs = {}
    for name, calls in first_chunk.items():
        errs[name] = 0.0
        for args in calls:
            got, want = originals[name](*args), plain[name](*args)
            torch.cuda.synchronize()
            errs[name] = max(errs[name], hold_extraction_kernel(
                torch, descriptor.TOLERANCE, name, got, want)[0])
        print(f"phase 10a {name}: {len(calls)} calls of the first chunk held "
              f"against plain, max_abs_err {errs[name]:.3g}", flush=True)
    del first_chunk

    # (b) forced revisits: keyframe 0's keypoints with fresh slots (no
    # shared landmark ids, so the covisibility gate passes), closed through
    # the Sim(3) graph, then once more through the SE(3) graph. Each
    # closure is timed with the window BA that ends its promotion.
    for sim3 in (True, False):
        pipe.cfg = pipe.cfg.replace(pose_graph_sim3=sim3)
        kf0 = pipe.keyframes[0]
        pipe.keyframes.append(Keyframe(pipe._frame_idx + 1, kf0.pose.copy(),
                                       kf0.kp))
        new_idx = len(pipe.keyframes) - 1
        before = (pipe.num_loop_closures, log.count("pose_graph"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sites = count_syncs(torch, lambda: pipe._try_loop_closure(new_idx))
        t1 = time.perf_counter()
        pipe._run_window_ba(fix_first_n=2)
        t2 = time.perf_counter()
        fused = int((pipe.keyframes[new_idx].kp_lm >= 0).sum())
        probe = pipe.loop_probe_log[-1]
        graph = "Sim(3)" if sim3 else "SE(3)"
        print(f"phase 10b forced revisit ({graph} graph): probe {probe}, fused {fused} slots; closure "
              f"(probe, fusion, graph) {1e3 * (t1 - t0):.3f} ms with "
              f"{len(sites)} host syncs {sorted(sites)}, its promotion's "
              f"window BA {1e3 * (t2 - t1):.3f} ms; card {card}", flush=True)
        if (pipe.num_loop_closures, log.count("pose_graph")) != \
                (before[0] + 1, before[1] + 1) or \
                pipe.pose_edges[-1]["kind"] != "loop" or \
                fused < cfg.loop_min_inliers:
            raise Failed(f"forced revisit not closed through the {graph} "
                         "graph")
        if not all(np.isfinite(kf.pose).all() for kf in pipe.keyframes) or \
                not np.isfinite(pipe.landmarks).all():
            raise Failed("non-finite map after a closure")

    # (c) both graphs at capacity.
    pgo_capacity(torch, card)

    # (d) save -> load on the card.
    here = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(here, OUT_DIR, "chip_smoke_map.npz")
    pipe.save_map(path)
    back = SfmPipeline(SFM_INTRINSICS, cfg, seed=1)
    back.load_map(path)
    same = (np.array_equal(back.landmarks, pipe.landmarks)
            and np.array_equal(back.lm_ref_kf, pipe.lm_ref_kf)
            and torch.equal(back._gen.get_state(), pipe._gen.get_state())
            and back.num_loop_closures == pipe.num_loop_closures
            and len(back.keyframes) == len(pipe.keyframes)
            and all(np.array_equal(a.pose, b.pose)
                    and np.array_equal(a.kp_lm, b.kp_lm)
                    and torch.equal(a.kp["desc"], b.kp["desc"])
                    and torch.equal(a.kp["valid_t"], b.kp["valid_t"])
                    for a, b in zip(pipe.keyframes, back.keyframes))
            and [(e["i"], e["j"], e["kind"]) for e in back.pose_edges]
            == [(e["i"], e["j"], e["kind"]) for e in pipe.pose_edges])
    print(f"phase 10d save_map -> load_map on the card: "
          f"{len(back.keyframes)} keyframes, {back.landmarks.shape[0]} "
          f"landmarks, {len(back.pose_edges)} edges, state equal: {same}",
          flush=True)
    os.remove(path)
    if not same:
        raise Failed("save_map -> load_map changed the state")
    return launches, errs, boot_calls


def hold_first_chunk(torch, label: str, first_chunk: dict,
                     originals: dict) -> dict:
    """The recorded kernel calls of a run's first chunk against their plain
    versions; returns {kernel: max abs err}."""
    from sift_tpu_torch.kernels.cuda import descriptor
    plain = extraction_plain()
    errs = {}
    for name, calls in first_chunk.items():
        errs[name] = 0.0
        for args in calls:
            got, want = originals[name](*args), plain[name](*args)
            torch.cuda.synchronize()
            errs[name] = max(errs[name], hold_extraction_kernel(
                torch, descriptor.TOLERANCE, name, got, want)[0])
        print(f"{label} {name}: {len(calls)} calls of the first chunk held "
              f"against plain, max_abs_err {errs[name]:.3g}", flush=True)
    return errs


def counted_run(torch, fn, n_calls: int = 4):
    """Run `fn` with the launch counters set to 0 just before and read just
    after, recording the extraction kernels' arguments; returns (fn's
    result, seconds, launch counts, the first `n_calls` recorded calls of
    each kernel, the original kernels)."""
    from sift_tpu_torch.kernels import cuda as kcuda
    with recording(extraction_kernels()) as (recorded, originals):
        kcuda.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = kcuda.launch_counts()
        first = {name: calls[:n_calls] for name, calls in recorded.items()}
        recorded.clear()
    return out, secs, launches, first, originals


def chunk_syncs(torch, pipe, log: list, card: str, profile_chunk: int):
    """Wrap `pipe._process_chunk_tracked`: per chunk, the host syncs
    (`count_syncs`) plus the event waits of applied window-BA results
    (`_AsyncRead.wait`, which the sync debug mode does not see), whether it
    promoted, and the sites; chunk number `profile_chunk` is profiled
    instead (device busy share, operator table in OUT_DIR)."""
    import sift_tpu_torch.slam.pipeline as sp
    orig = pipe._process_chunk_tracked
    wait = sp._AsyncRead.wait

    def step(*a, **k):
        held, waits = {}, []

        def counted_wait(self):
            waits.append(1)
            return wait(self)

        before = pipe.chunk_stats["fused_promotions"]
        if len(log) == profile_chunk:
            busy, wall = profile_busy(torch, lambda: (
                held.setdefault("out", orig(*a, **k)),
                torch.cuda.synchronize()), "chip_smoke_chunk_profile.txt",
                card)
            log.append(dict(profiled=(busy, wall), handled=held["out"]))
            return held["out"]
        sp._AsyncRead.wait = counted_wait
        try:
            sites = count_syncs(torch, lambda: held.setdefault(
                "out", orig(*a, **k)))
        finally:
            sp._AsyncRead.wait = wait
        log.append(dict(handled=held["out"], syncs=len(sites),
                        waits=len(waits), sites=sorted(set(sites)),
                        promoted=pipe.chunk_stats["fused_promotions"]
                        - before))
        return held["out"]

    pipe._process_chunk_tracked = step


def chunk_stage_check(torch, pipe, calls: list, card: str) -> dict:
    """Phase 11d: one chunk stage (a chunk whose interval forces a
    promotion) on its recorded inputs with fixed noise: no host sync before
    the packed read under `set_sync_debug_mode("error")`, two card runs
    bit-identical, and the CPU plain path on the same inputs: inlier counts
    and promote_at exactly, poses within CHUNK_CPU_POSE_TOL."""
    from sift_tpu_torch.geometry.ransac import gumbel
    from sift_tpu_torch.slam.pipeline import SfmPipeline
    cfg = pipe.cfg
    args = next(a for a in calls
                if a[3] + a[4] >= cfg.kf_max_interval
                and a[4] == a[8].x.shape[0])
    B = args[8].x.shape[0]
    M = cfg.match.max_matches
    P = max(1, B // 8)
    gen = torch.Generator(device="cuda").manual_seed(11)
    noise = (gumbel(gen, (B, cfg.tracking_ransac_hypotheses, M), "cuda"),
             gumbel(gen, (P, 8, M), "cuda"))
    stage = type(pipe)._track_chunk_promo.__get__(pipe)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        first = stage(noise, *args[1:])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    second = stage(noise, *args[1:])
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    ms = event_ms(lambda: stage(noise, *args[1:]), 2)
    # The promotion slot's `_kf_track`, which runs whether the slot fires
    # or not: its host time inside one more run of the stage (the stage is
    # host-bound; phase 11c's busy share).
    slot_s, kf_track = [], pipe._kf_track

    def timed_slot(*a):
        t0 = time.perf_counter()
        out = kf_track(*a)
        slot_s.append(time.perf_counter() - t0)
        return out

    pipe._kf_track = timed_slot
    try:
        t0 = time.perf_counter()
        stage(noise, *args[1:])[0].cpu()
        stage_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        del pipe._kf_track

    def cpu(a):
        return a.map(lambda t: t.cpu()) if hasattr(a, "map") else \
            a.cpu() if torch.is_tensor(a) else a

    cpu_pipe = SfmPipeline(SFM_INTRINSICS, cfg, seed=0, device="cpu")
    t0 = time.perf_counter()
    want = cpu_pipe._track_chunk_promo(tuple(n.cpu() for n in noise),
                                       *[cpu(a) for a in args[1:]])
    cpu_ms = 1e3 * (time.perf_counter() - t0)
    g, w = first[0].cpu().numpy(), want[0].numpy()
    fg, fw = g[:B * 8].reshape(B, 8), w[:B * 8].reshape(B, 8)
    pose_err = float(np.abs(fg[:, :6] - fw[:, :6]).max())
    pa_g, pa_w = g[B * 8:B * 8 + P], w[B * 8:B * 8 + P]
    print(f"phase 11d chunk stage (B={B}, since0 {args[3]}): no host sync "
          f"before its read under \"error\"; two card runs bit-identical: "
          f"{same}; promote_at card {pa_g.tolist()} CPU {pa_w.tolist()}; "
          f"inlier counts card {fg[:, 6].astype(int).tolist()} CPU "
          f"{fw[:, 6].astype(int).tolist()}; poses within {pose_err:.3g}; "
          f"card {ms:.3f} ms a stage (CUDA events), CPU plain {cpu_ms:.3f} ms;"
          f" the promotion slot's `_kf_track` {1e3 * sum(slot_s):.3f} ms of "
          f"a {stage_ms:.3f} ms stage (host clock, {len(slot_s)} slot); card "
          f"{card}", flush=True)
    if not same:
        raise Failed("two card runs of the chunk stage differ")
    if not np.array_equal(pa_g, pa_w) or (pa_g < 0).all() or \
            not np.array_equal(fg[:, 6], fw[:, 6]):
        raise Failed("chunk stage: card and CPU plain path disagree on "
                     "promote_at or inlier counts")
    if pose_err > CHUNK_CPU_POSE_TOL:
        raise Failed(f"chunk stage poses {pose_err} apart, card vs CPU")
    return dict(ms=ms, cpu_ms=cpu_ms, slot_ms=1e3 * sum(slot_s))


def chunked_phase(torch, card: str) -> tuple:
    """Phase 11: chunked tracking with asynchronous window BA. (a) phase
    9b's frames through `process_sequence(batch=8)` held to the JAX run;
    (b) 48 frames at batch 16 with kf_max_interval 6 (chunks promote
    twice); (c) (a)'s first 48 frames with extract_ahead off,
    bit-identical, its chunks' host syncs counted and one chunk profiled;
    (d) one chunk stage alone. Returns (launch
    counts of (a), {kernel: max abs err on (a)'s first chunk})."""
    from sift_tpu_torch.config import PipelineConfig
    from sift_tpu_torch.eval.ate import ate_rmse
    from sift_tpu_torch.slam.pipeline import SfmPipeline

    frames, gt = make_sfm_sequence()
    frames = list(frames)
    cfg = PipelineConfig(chunked_tracking=True, ba_async=True)
    pipe = SfmPipeline(SFM_INTRINSICS, cfg, seed=0)
    calls, chunk_s = [], []
    stage, track = pipe._track_chunk_promo, pipe._process_chunk_tracked

    def keep(*a):
        calls.append(a)
        return stage(*a)

    def timed(*a, **k):
        t0 = time.perf_counter()
        handled = track(*a, **k)
        chunk_s.append((handled, time.perf_counter() - t0))
        return handled

    pipe._track_chunk_promo, pipe._process_chunk_tracked = keep, timed
    res, secs, launches, first, originals = counted_run(
        torch, lambda: pipe.process_sequence(frames, batch=SFM_BATCH))
    del pipe._track_chunk_promo, pipe._process_chunk_tracked
    est = pipe.positions()
    if est.shape != (SFM_FRAMES, 3) or not np.isfinite(est).all():
        raise Failed(f"chunked positions {est.shape} not finite")
    ate = ate_rmse(est, gt, align=True, with_scale=True)
    tracked = float(np.mean([r["tracked"] for r in res]))
    boot = next(i for i, r in enumerate(res) if r["state"] == "tracking")
    n_kf = len(pipe.keyframes)
    handled_ms = [1e3 * t for h, t in chunk_s if h]
    print(f"phase 11a: {SFM_FRAMES} frames, chunked + async BA, batch "
          f"{SFM_BATCH}: {SFM_FRAMES / secs:.3f} frames/s ({secs:.3f} s); "
          f"state {pipe.state}, bootstrap at frame {boot} (JAX "
          f"{CHUNK_JAX_BOOT}), tracked share {tracked:.4f}, keyframes {n_kf} "
          f"at {[r['frame_idx'] for r in res if r['is_keyframe']]} (JAX "
          f"{CHUNK_JAX_KEYFRAMES}), chunk_stats {pipe.chunk_stats} (JAX "
          f"{CHUNK_JAX_STATS}), landmarks {pipe.landmarks.shape[0]}, sim3 ATE "
          f"{ate:.6f} m (JAX {CHUNK_JAX_ATE:.6f} m); ms per chunk through the "
          f"chunk stage (host clock, read and promotions included): median "
          f"{np.median(handled_ms):.3f}, min {min(handled_ms):.3f}, max "
          f"{max(handled_ms):.3f} (n={len(handled_ms)}); launches "
          f"{launches}; card {card}", flush=True)
    if pipe.state != "tracking" or tracked < 0.9 or boot != CHUNK_JAX_BOOT:
        raise Failed(f"chunked run: state {pipe.state}, tracked {tracked}, "
                     f"bootstrap at {boot}")
    if abs(n_kf - CHUNK_JAX_KEYFRAMES) > 0.2 * CHUNK_JAX_KEYFRAMES:
        raise Failed(f"chunked run made {n_kf} keyframes, JAX "
                     f"{CHUNK_JAX_KEYFRAMES}")
    if pipe.chunk_stats["chunks"] != CHUNK_JAX_STATS["chunks"] or abs(
            pipe.chunk_stats["fused_promotions"]
            - CHUNK_JAX_STATS["fused_promotions"]) > \
            0.2 * CHUNK_JAX_STATS["fused_promotions"]:
        raise Failed(f"chunk_stats {pipe.chunk_stats}, JAX {CHUNK_JAX_STATS}")
    if ate > max(1.5 * CHUNK_JAX_ATE, CHUNK_JAX_ATE + 0.01):
        raise Failed(f"chunked ATE {ate} m against JAX's {CHUNK_JAX_ATE} m")
    hold_launches("phase 11a", launches, CHUNK_LAUNCHES)
    errs = hold_first_chunk(torch, "phase 11a", first, originals)
    del first

    # (b) batch 16, kf_max_interval 6.
    pipe16 = SfmPipeline(SFM_INTRINSICS, cfg.replace(kf_max_interval=6),
                         seed=0)
    res16, secs16, launches16, _, _ = counted_run(
        torch, lambda: pipe16.process_sequence(frames[:CHUNK16_FRAMES],
                                               batch=16), 0)
    ate16 = ate_rmse(pipe16.positions(), gt[:CHUNK16_FRAMES], align=True,
                     with_scale=True)
    st16 = pipe16.chunk_stats
    print(f"phase 11b: {CHUNK16_FRAMES} frames, batch 16, kf_max_interval 6: "
          f"{CHUNK16_FRAMES / secs16:.3f} frames/s; keyframes "
          f"{len(pipe16.keyframes)} (JAX {CHUNK16_JAX_KEYFRAMES}), "
          f"chunk_stats {st16} (JAX {CHUNK16_JAX_STATS}), sim3 ATE "
          f"{ate16:.6f} m (JAX {CHUNK16_JAX_ATE:.6f} m); launches "
          f"{launches16}", flush=True)
    if st16["fused_promotions"] <= st16["chunks"]:
        raise Failed(f"batch 16: no chunk promoted twice ({st16})")
    if ate16 > max(1.5 * CHUNK16_JAX_ATE, CHUNK16_JAX_ATE + 0.01) or \
            pipe16.state != "tracking":
        raise Failed(f"batch 16 ATE {ate16} m against JAX's "
                     f"{CHUNK16_JAX_ATE} m")
    hold_launches("phase 11b", launches16, CHUNK16_LAUNCHES)

    # (c) extract_ahead off on the first CHUNK_AHEAD_FRAMES frames: their
    # positions bit-identical to (a)'s (a frame's record is final once
    # made); each chunk's syncs.
    off = SfmPipeline(SFM_INTRINSICS, cfg.replace(extract_ahead=False), seed=0)
    log = []
    chunk_syncs(torch, off, log, card, profile_chunk=4)
    off.process_sequence(frames[:CHUNK_AHEAD_FRAMES], batch=SFM_BATCH)
    torch.cuda.synchronize()
    head = est[:CHUNK_AHEAD_FRAMES]
    same = np.array_equal(off.positions(), head)
    counted = [e for e in log if "syncs" in e and e["handled"]]
    plain = [e["syncs"] + e["waits"] for e in counted if not e["promoted"]]
    promo = [e["syncs"] + e["waits"] for e in counted if e["promoted"]]
    prof = next(e["profiled"] for e in log if "profiled" in e)

    def site(promoted: bool) -> list:
        return next((e["sites"] for e in counted
                     if bool(e["promoted"]) == promoted), [])

    print(f"phase 11c extract_ahead off, frames 0-{CHUNK_AHEAD_FRAMES - 1}: "
          f"positions bit-identical to 11a's: {same} (max diff "
          f"{np.abs(off.positions() - head).max():.3g}); host "
          f"syncs per chunk, event waits counted: without a promotion "
          f"{plain} (sites {site(False)}), with one {promo} (waits "
          f"{[e['waits'] for e in counted if e['promoted']]}; sites "
          f"{site(True)}); profiled warm chunk (frames 40-47): device busy "
          f"{prof[0]:.3f} ms of {prof[1]:.3f} ms wall, busy share "
          f"{prof[0] / prof[1]:.4f}; card {card}", flush=True)
    if not same:
        raise Failed("extract_ahead on and off gave other positions")

    # (d) one chunk stage alone.
    chunk_stage_check(torch, pipe, calls, card)
    del calls
    return launches, errs


def stereo_phase(torch, card: str) -> tuple:
    """Phase 12: stereo. (a) `cli sfm --stereo` on the KITTI fixture; (b)
    the rendered stereo sequence batched against per frame; (c)
    `stereo_depths` card against the CPU plain path on one chunk. Returns
    (launch counts of (b), {kernel: max abs err on (b)'s first chunk})."""
    import io
    from sift_tpu_torch import cli
    from sift_tpu_torch.config import PipelineConfig
    from sift_tpu_torch.eval.ate import ate_rmse
    from sift_tpu_torch.matching.stereo import stereo_depths_batch
    from sift_tpu_torch.slam.pipeline import SfmPipeline

    here = os.path.dirname(os.path.abspath(__file__))
    out = io.StringIO()
    kitti = os.path.join(here, "tests", "fixtures", "kitti_mini")
    with contextlib.redirect_stdout(out):
        rc, secs, launches_cli, _, _ = counted_run(torch, lambda: cli.main(
            ["sfm", kitti, "--format", "kitti", "--sequence", "05",
             "--stereo", "--batch", "4"]), 0)
    text = out.getvalue()
    for line in text.splitlines():
        print(f"phase 12a cli sfm --stereo: {line}", flush=True)
    ok = rc == 0 and "ATE RMSE (se3-aligned)" in text
    ate_cli = float(text.split("ATE RMSE")[1].split(":")[1].split("m")[0]) \
        if ok else float("nan")
    print(f"phase 12a: rc {rc} in {secs:.3f} s, ATE {ate_cli} m (bound "
          f"{STEREO_CLI_ATE}), launches {launches_cli}", flush=True)
    if not ok or not ate_cli < STEREO_CLI_ATE:
        raise Failed(f"cli sfm --stereo: rc {rc}, ATE {ate_cli}")
    hold_launches("phase 12a", launches_cli, STEREO_CLI_LAUNCHES)

    xs = [SFM_STEP * i for i in range(STEREO_FRAMES)]
    frames, gt = make_sfm_sequence(xs=xs + [x + STEREO_BASELINE for x in xs])
    left, right = list(frames[:STEREO_FRAMES]), list(frames[STEREO_FRAMES:])
    gt = gt[:STEREO_FRAMES]
    cfg = PipelineConfig()
    per = SfmPipeline(SFM_INTRINSICS, cfg, seed=0,
                      stereo_baseline=STEREO_BASELINE)
    t0 = time.perf_counter()
    for a, b in zip(left, right):
        per.process_frame(a, right=b)
    per.finalize()
    per_s = time.perf_counter() - t0
    bat = SfmPipeline(SFM_INTRINSICS, cfg, seed=0,
                      stereo_baseline=STEREO_BASELINE)
    pairs = []
    stereo = bat._stereo_batch

    def keep(kp_l, kp_r):
        pairs.append((kp_l, kp_r))
        return stereo(kp_l, kp_r)

    bat._stereo_batch = keep
    _, bat_s, launches, first, originals = counted_run(
        torch, lambda: bat.process_sequence(left, rights=right, batch=8))
    diff = float(np.abs(bat.positions() - per.positions()).max())
    ate = ate_rmse(bat.positions(), gt, align=True, with_scale=False)
    n_kf = len(bat.keyframes)
    print(f"phase 12b: {STEREO_FRAMES} stereo pairs at {SFM_H}x{SFM_W}, "
          f"baseline {STEREO_BASELINE:.2f} m: batched "
          f"{STEREO_FRAMES / bat_s:.3f} frames/s, per frame "
          f"{STEREO_FRAMES / per_s:.3f}; batched against per frame within "
          f"{diff:.3g} m (bound {STEREO_BATCHED_TOL}); state "
          f"{bat.state}, keyframes {n_kf} (JAX {STEREO_JAX_KEYFRAMES}), se3 "
          f"ATE (no scale fit) {ate:.6f} m (JAX {STEREO_JAX_ATE:.6f} m); "
          f"launches {launches}; card {card}", flush=True)
    if bat.state != "tracking" or diff > STEREO_BATCHED_TOL:
        raise Failed(f"stereo batched vs per frame {diff} m")
    if abs(n_kf - STEREO_JAX_KEYFRAMES) > 0.2 * STEREO_JAX_KEYFRAMES:
        raise Failed(f"stereo run made {n_kf} keyframes, JAX "
                     f"{STEREO_JAX_KEYFRAMES}")
    if ate > max(1.5 * STEREO_JAX_ATE, STEREO_JAX_ATE + 0.01):
        raise Failed(f"stereo ATE {ate} m against JAX's {STEREO_JAX_ATE} m")
    hold_launches("phase 12b", launches, STEREO_LAUNCHES)
    errs = hold_first_chunk(torch, "phase 12b", first, originals)
    del first

    # (c) stereo_depths on the first chunk, card vs CPU.
    kp_l, kp_r = pairs[0]
    fx = float(SFM_INTRINSICS[0])
    card_z = stereo_depths_batch(kp_l, kp_r, fx, STEREO_BASELINE)
    ms = event_ms(lambda: stereo_depths_batch(kp_l, kp_r, fx,
                                                     STEREO_BASELINE), 10)
    cpu_z = stereo_depths_batch(kp_l.map(lambda t: t.cpu()),
                                kp_r.map(lambda t: t.cpu()), fx,
                                STEREO_BASELINE).numpy()
    card_z = card_z.cpu().numpy()
    valid = kp_l.valid.cpu().numpy()
    same = ((card_z > 0) == (cpu_z > 0)) & (
        np.abs(card_z - cpu_z) <= 1e-5 * np.maximum(cpu_z, 1e-6))
    agree = float(same[valid].mean())
    print(f"phase 12c stereo_depths on the first chunk ({int(valid.sum())} "
          f"left keypoints, {int((cpu_z > 0).sum())} with depth on the CPU): "
          f"card and CPU agree on {agree:.5f} (bound {STEREO_CPU_AGREE}); "
          f"{ms:.3f} ms a chunk (CUDA events); card {card}", flush=True)
    if agree < STEREO_CPU_AGREE:
        raise Failed(f"stereo_depths card vs CPU agree on {agree}")
    return launches, errs


def golden_cases(SiftConfig) -> list:
    """(name, image, golden rows, golden descriptors, config) of every
    reference golden, as the repo's parity tests configure them."""
    here = os.path.dirname(os.path.abspath(__file__))
    out = []
    z = np.load(os.path.join(here, "tests", "parity", "golden_refsim.npz"))
    for key, sub in GOLDEN_REFSIM:
        out.append((key, z[f"{key}_img"], z[f"{key}_kp"], z[f"{key}_desc"],
                    SiftConfig(mode="parity", subpixel=sub,
                               max_keypoints_per_octave=256,
                               max_keypoints=1024)))
    z = np.load(os.path.join(here, "tests", "parity", "golden_grid.npz"))
    for key in GOLDEN_GRID:
        sigma, k, octaves, dogs, subpixel = z[f"{key}_params"]
        cap = GOLDEN_GRID_CAPS.get(key, 1024)
        out.append((key, z[f"{key}_img"], z[f"{key}_kp"], z[f"{key}_desc"],
                    SiftConfig(mode="parity", sigma=float(sigma), k=float(k),
                               octaves=int(octaves), dogs_per_epoch=int(dogs),
                               subpixel=bool(subpixel),
                               max_keypoints_per_octave=cap,
                               max_keypoints=4 * cap)))
    return out


def parity_keys(kp) -> dict:
    """{(octave, level, x, y): (scale, descriptor)} of the valid slots of
    one image's numpy `Keypoints`."""
    return {(int(kp.octave[i]), int(kp.level[i]), int(kp.x[i]),
             int(kp.y[i])): (float(kp.scale[i]), kp.desc[i])
            for i in np.flatnonzero(kp.valid)}


def hold_sets(label: str, got: dict, want: dict, rtol: float = 0.0):
    """Identical keypoint sets, scales within 1e-4, descriptors within
    2e-3 (+ rtol of the value); returns (keypoints, max scale diff, max
    descriptor diff)."""
    if set(got) != set(want) or not want:
        raise Failed(f"{label}: {len(got)} vs {len(want)} keypoints, only "
                     f"here {sorted(set(got) - set(want))[:4]}, only there "
                     f"{sorted(set(want) - set(got))[:4]}")
    ds = max(abs(got[k][0] - want[k][0]) for k in want)
    dd = max(float(np.abs(got[k][1] - want[k][1]).max()) for k in want)
    bad = [k for k in want if not np.all(np.abs(got[k][1] - want[k][1])
                                         <= 2e-3 + rtol * np.abs(want[k][1]))]
    if ds > 1e-4 or bad:
        raise Failed(f"{label}: scale diff {ds}, descriptors differ at "
                     f"{bad[:4]} (max {dd})")
    return len(want), ds, dd


def scan_launches(torch, scan, args) -> int:
    """CUDA kernels launched by one call of the parity descriptor scan on
    a copy of its recorded arguments (the scan mutates its maps)."""
    from torch.profiler import ProfilerActivity
    kp, maps, *rest = args
    maps = maps.clone()
    torch.cuda.synchronize()
    _, events = profiled(lambda: (scan(kp, maps, *rest),
                                  torch.cuda.synchronize()),
                         [ProfilerActivity.CUDA])
    return sum(ev.count for ev in events
               if ev.device_type == torch.autograd.DeviceType.CUDA)


@contextlib.contextmanager
def scan_recording():
    """Wrap `kernels/cuda/parity_scan.py::parity_scan` so that each call records
    its arguments, the maps copied as they were before it (the scan
    mutates them); yields the list of calls."""
    from sift_tpu_torch.kernels.cuda import parity_scan as ps
    calls, original = [], ps.parity_scan

    def recorder(maps, *rest):
        calls.append((maps.clone(), *rest))
        return original(maps, *rest)
    ps.parity_scan = recorder
    try:
        yield calls
    finally:
        ps.parity_scan = original


def parity_phase(torch, card: str) -> tuple:
    """Phase 13: parity mode and subpixel input. (a) every golden on the
    card, held to the golden and to the CPU plain path, launches counted
    (the parity scan once); (b) `cli extract -r 1` at full width in parity
    mode, against the CPU run, with the extraction's and the scan's ms and
    the path's host syncs; (c) lowe `extract_batch` with `subpixel` on
    phase 5's frames: launches, each kernel against its plain version,
    image 0 against the CPU, no host sync, kf/s. Returns ((c)'s launch
    counts, {kernel: max abs err}, {kernel: timing at the subpixel
    shapes}, and for phase 17 {"calls": the recorded parity scan calls of
    (a) and (b), "launches_goldens", "launches_cli", "frame_ms"})."""
    import io
    import tempfile
    from sift_tpu_torch import SiftConfig, cli, extract, extract_batch
    from sift_tpu_torch.frontend import parity
    from sift_tpu_torch.io.image import load_image_gray, save_image_gray
    from sift_tpu_torch.kernels import cuda as kcuda

    # (a) the goldens
    t0 = time.perf_counter()
    cases = golden_cases(SiftConfig)
    n_kp, worst = 0, [0.0, 0.0, 0.0]
    scan_calls = {"goldens": [], "frame": []}
    launches_goldens = 0
    for key, img, rows, descs, cfg in cases:
        with scan_recording() as calls:
            kcuda.reset_launch_counts()
            card_kp = extract(img, cfg).to_numpy()
            launches = kcuda.launch_counts()
        hold_launches(f"phase 13a {key}", launches, PARITY_LAUNCHES)
        launches_goldens += launches["parity_scan"]
        scan_calls["goldens"] += calls
        cpu_kp = extract(img, cfg, device="cpu").to_numpy()
        if int(card_kp.n_dropped) or int(cpu_kp.n_dropped):
            raise Failed(f"phase 13a {key}: keypoints dropped")
        golden = {(int(r[0]), int(r[1]), int(r[2]), int(r[3])): (float(r[4]), d)
                  for r, d in zip(rows, descs)}
        n, ds, dd = hold_sets(f"phase 13a {key} card vs golden",
                              parity_keys(card_kp), golden, rtol=1e-3)
        _, _, dc = hold_sets(f"phase 13a {key} card vs CPU",
                             parity_keys(card_kp), parity_keys(cpu_kp))
        n_kp += n
        worst = [max(worst[0], ds), max(worst[1], dd), max(worst[2], dc)]
    print(f"phase 13a: {len(cases)} goldens held on the card: {n_kp} "
          f"keypoints, sets identical to the goldens and to the CPU runs, "
          f"scale diff <= {worst[0]:.3g}, descriptor diff <= {worst[1]:.3g} "
          f"(golden), <= {worst[2]:.3g} (CPU); "
          f"{time.perf_counter() - t0:.3f} s", flush=True)

    # (b) parity at full width through the command
    frame = parity_frame(torch)
    cfg = SiftConfig(mode="parity", max_keypoints_per_octave=PARITY_CAPS[0],
                     max_keypoints=PARITY_CAPS[1])
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "textured.png")
        save_image_gray(png, frame)
        gray = load_image_gray(png)
        out, err = io.StringIO(), io.StringIO()
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err):
                kcuda.reset_launch_counts()
                t0 = time.perf_counter()
                rc = cli.main(["extract", png, "-r", "1", "--time",
                               "--max-keypoints-per-octave",
                               str(PARITY_CAPS[0]), "--max-keypoints",
                               str(PARITY_CAPS[1])])
                cli_s = time.perf_counter() - t0
                launches_cli = kcuda.launch_counts()
        finally:
            os.chdir(cwd)
        text = out.getvalue()
        for line in text.replace(tmp, "<tmp>").splitlines():
            print(f"phase 13b cli extract: {line}", flush=True)
        with open(os.path.join(tmp, "interstpoints.txt")) as fh:
            n_rows = len(fh.read().splitlines()) - 1
        overlay = os.path.exists(png + "_orientation.png")
    n_cli = int(text.split()[0]) if rc == 0 else -1
    if rc != 0 or err.getvalue().strip() or n_rows != n_cli or not overlay:
        raise Failed(f"phase 13b cli extract: rc {rc}, {n_rows} rows for "
                     f"{n_cli} keypoints, overlay {overlay}, stderr "
                     f"{err.getvalue().strip()!r}")
    hold_launches("phase 13b cli extract", launches_cli, PARITY_LAUNCHES)
    with scan_recording() as calls:
        card_kp = extract(gray, cfg).to_numpy()
    scan_calls["frame"] = calls
    cpu_kp = extract(gray, cfg, device="cpu").to_numpy()
    if int(card_kp.n_dropped) or int(cpu_kp.n_dropped) or \
            int(card_kp.valid.sum()) != n_cli:
        raise Failed(f"phase 13b: n_dropped {card_kp.n_dropped} (card), "
                     f"{cpu_kp.n_dropped} (CPU), {card_kp.valid.sum()} "
                     f"valid against the command's {n_cli}")
    n, ds, dd = hold_sets("phase 13b card vs CPU", parity_keys(card_kp),
                          parity_keys(cpu_kp))

    reps = 5
    scans, scan_s, n_ok = [], [], []
    scan = parity.descriptor_scan_parity

    def timed_scan(*args):
        if not scans:
            scans.append((args[0], args[1].clone()) + args[2:])
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = scan(*args)
        torch.cuda.synchronize()
        scan_s.append(time.perf_counter() - t)
        n_ok.append(int(res[1].sum()))
        return res

    extract(gray, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        extract(gray, cfg)
    torch.cuda.synchronize()
    whole_ms = (time.perf_counter() - t0) / reps * 1e3
    parity.descriptor_scan_parity = timed_scan
    try:
        for _ in range(reps):
            extract(gray, cfg)
    finally:
        parity.descriptor_scan_parity = scan
    launches_scan = scan_launches(torch, scan, scans[0])
    sites = count_syncs(torch, lambda: extract(gray, cfg))
    print(f"phase 13b: {HEIGHT}x{WIDTH}, caps {PARITY_CAPS}: {n} keypoints, "
          f"none dropped, set identical to the CPU run (scale diff {ds:.3g}, "
          f"descriptor diff {dd:.3g}); command {cli_s:.3f} s (first run); "
          f"extraction {whole_ms:.3f} ms warm, descriptor scan "
          f"{float(np.median(scan_s)) * 1e3:.3f} ms median of {reps} "
          f"({n_ok[0]} keypoints, {launches_scan} kernel launches); launches "
          f"of the command {launches_cli}; host syncs {len(sites)} "
          f"{sorted(set(sites))}; card {card}", flush=True)

    # (c) lowe with subpixel on phase 5's frames
    cfg = SiftConfig(subpixel=True)
    frames_np = make_frames(BATCH)
    frames = torch.from_numpy(frames_np).cuda()
    kp, secs, launches, first, originals = counted_run(
        torch, lambda: extract_batch(frames, cfg))
    print(f"phase 13c launches: {launches} ({secs:.3f} s, first run)",
          flush=True)
    hold_launches("phase 13c", launches, EXPECTED_LAUNCHES)
    errs = hold_first_chunk(torch, "phase 13c", first, originals)
    timing = {}
    plain = extraction_plain()
    for name, calls in first.items():
        ms_stream = plain_ms = nbytes = nops = 0.0
        for args in calls:
            ms_stream += event_ms(lambda: originals[name](*args), 20)
            plain_ms += event_ms(lambda: plain[name](*args), 3)
            b, o = kernel_work(name, args)
            nbytes, nops = nbytes + b, nops + o
        # one CUPTI session for all of the kernel's calls
        ms, _, wait = kernel_trace(
            lambda: [originals[name](*a) for a in calls],
            KERNEL_SYMBOLS[name], 20, launches=len(calls))
        seen = ms is not None
        bound_ms, bound_by = bound(nbytes, nops)
        timing[name] = {"ms": ms if seen else ms_stream,
                        "timing": "cupti" if seen else "events",
                        "ms_stream": ms_stream, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by}
        how = (f"cupti, the trace whole after a {wait:g} s wait" if seen
               else "events: no CUPTI trace held every launch")
        print(f"phase 13c {name}: {timing[name]['ms']:.4f} ms/batch ({how}), "
              f"stream {ms_stream:.4f} ms, plain "
              f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by})",
              flush=True)
    kpn = kp.to_numpy()
    n = kpn.valid.sum(axis=1)
    if (n == 0).any() or not all(
            np.isfinite(getattr(kpn, f)[kpn.valid]).all()
            for f in ("x", "y", "scale", "orientation", "desc")):
        raise Failed(f"phase 13c: valid per image {n.tolist()}, or "
                     "non-finite fields")
    cpu = extract_batch(frames_np[:1], cfg, device="cpu").to_numpy()
    fwd, worst_fwd = match_keypoints(cpu, kpn, 0)
    back, worst_back = match_keypoints(kpn, cpu, 0)
    worst_desc = max(worst_fwd, worst_back)
    print(f"phase 13c image 0 vs CPU plain path: {int(cpu.valid[0].sum())} "
          f"vs {int(n[0])} valid, matched {fwd:.4f} / {back:.4f}, max desc "
          f"diff {worst_desc:.3g}; valid per image {n.tolist()}", flush=True)
    if min(fwd, back) < 0.99 or worst_desc > 2e-3:
        raise Failed("phase 13c: card and CPU plain path disagree")
    hold_syncs(torch, lambda: extract_batch(frames, cfg),
               f"subpixel {2 * HEIGHT}x{2 * WIDTH}")
    reps = 10
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        extract_batch(frames, cfg)
    torch.cuda.synchronize()
    batch_s = (time.perf_counter() - t0) / reps
    print(f"phase 13c extract_batch subpixel B={BATCH} {HEIGHT}x{WIDTH} "
          f"(internal {2 * HEIGHT}x{2 * WIDTH}): {batch_s * 1e3:.3f} ms/batch, "
          f"{BATCH / batch_s:.2f} kf/s; card {card}", flush=True)
    return launches, errs, timing, {
        "calls": scan_calls, "launches_goldens": launches_goldens,
        "launches_cli": launches_cli["parity_scan"], "frame_ms": whole_ms}


def nan_equal(a, b) -> bool:
    """Two f32 tensors equal in every bit, every NaN taken as the same NaN
    (NaN-equal; a -0 is not a 0)."""
    import torch
    if a.shape != b.shape:
        return False
    nan = torch.tensor(float("nan"), device=a.device)
    return torch.equal(torch.where(a.isnan(), nan, a).view(torch.int32),
                       torch.where(b.isnan(), nan, b).view(torch.int32))


def synthetic_scans(torch) -> dict:
    """Phase 17's synthetic scan calls on the card, by label. Maps with
    both signs, weight_tl, finite orientations (a twentieth NaN) and
    canonical-order tables: "overlap", SCAN_SYNTH's slots crowding the
    first 3 planes of each image, two thirds in plane 0, their corners in
    a 48 x 48 corner (heavy overlap), some at the far edges, a fifth
    without ok; "one window", every slot of SCAN_SYNTH's images ok on the
    window at (41, 57) of plane 0 (across a tile corner); "far corners",
    SCAN_FAR's slots on windows across the tile corners nearest the far
    edges and on the far edges, a fifth without ok."""
    def call(shape, plane, y0, x0, ok, rng):
        B, O, Lg, H, W, N = shape
        table = np.stack([plane // Lg, plane % Lg, y0, x0, ok],
                         -1).astype(np.int32)
        ori = rng.uniform(0, 360, (B, N)).astype(np.float32)
        ori[rng.uniform(size=(B, N)) < 0.05] = np.nan
        arrays = ((rng.standard_normal((B, O, Lg, 2, H, W)) * 50),
                  rng.uniform(0, 1, (B, O, Lg, 16, 16)), ori, table)
        return tuple(torch.from_numpy(np.ascontiguousarray(
            a.astype(np.float32) if a.dtype == np.float64 else a)).cuda()
            for a in arrays)

    rng = np.random.default_rng(17)
    B, O, Lg, H, W, N = SCAN_SYNTH
    plane = np.where(rng.uniform(size=(B, N)) < 2 / 3, 0,
                     rng.integers(1, 3, (B, N)))
    y0 = rng.integers(0, 48, (B, N))
    x0 = rng.integers(0, 48, (B, N))
    y0[:, ::29], x0[:, ::31] = H - 16, W - 16
    calls = {"overlap": call(SCAN_SYNTH, plane, y0, x0,
                             rng.uniform(size=(B, N)) < 0.8, rng)}
    full = np.full((B, N), 1)
    calls["one window"] = call(SCAN_SYNTH, 0 * full, 41 * full, 57 * full,
                               full, rng)
    B, O, Lg, H, W, N = SCAN_FAR
    # corners 1-15 before the last two tile edges inside the maps, or on
    # the far edge
    ys = np.r_[np.arange(H // 16 * 16 - 15, H // 16 * 16),
               np.arange(H // 16 * 16 - 31, H // 16 * 16 - 16), H - 16]
    xs = np.r_[np.arange(W // 16 * 16 - 15, W // 16 * 16),
               np.arange(W // 16 * 16 - 31, W // 16 * 16 - 16), W - 16]
    ys, xs = ys[ys <= H - 16], xs[xs <= W - 16]
    calls["far corners"] = call(
        SCAN_FAR, rng.integers(0, O * Lg, (B, N)), rng.choice(ys, (B, N)),
        rng.choice(xs, (B, N)), rng.uniform(size=(B, N)) < 0.8, rng)
    return calls


def tile_lists(ps, maps, table) -> tuple:
    """(lists, longest list) of the kernel's tile lists for one call."""
    _, keys, starts, count = ps.tile_order(
        table, (*maps.shape[1:3], *maps.shape[-2:]))
    n = int(count)
    return n, int((starts[1:n + 1] - starts[:n]).max()) if n else 0


def parity_scan_phase(torch, card: str, parity13: dict) -> dict:
    """Phase 17 (run after phase 13): parity `extract_batch` as one batched
    pass and the parity scan kernel (`csrc/parity_scan.cu`; it replaces no
    TPU kernel). (a) a B=8 parity batch (13b's frame rolled by i x
    PARITY_ROLL) with the counts set to 0 just before and read just after:
    the scan exactly once, the blur at least once, no TPU kernel's port;
    every image bit-identical (NaN-equal) to its B=1 extraction; ms a
    batch and a frame; the path's host syncs (`count_syncs`), none at
    `frontend/parity.py` or `kernels/cuda/parity_scan.py`. (b) the kernel
    against `parity_scan_plain` bit for bit (NaN-equal), `seen` and the
    mutated maps, on every recorded call of 13a, 13b and (a), and on the
    `synthetic_scans` calls; the longest tile list of each. (c) of 13b's
    call and the batch's: the kernel's CUPTI ms (one kernel launch a
    call), the whole call's stream ms (tile lists built), the tile lists
    and the longest, bound and plain ms. Returns the `kernels` line's
    parity_scan row."""
    from sift_tpu_torch import SiftConfig, extract_batch
    from sift_tpu_torch.kernels import cuda as kcuda
    from sift_tpu_torch.kernels.cuda import parity_scan as ps
    t_phase = time.perf_counter()
    cfg = SiftConfig(mode="parity", max_keypoints_per_octave=PARITY_CAPS[0],
                     max_keypoints=PARITY_CAPS[1])
    frame = parity_frame(torch)
    frames_np = np.stack([np.roll(frame, (PARITY_ROLL[0] * i,
                                          PARITY_ROLL[1] * i), axis=(0, 1))
                          for i in range(BATCH)])
    frames = torch.from_numpy(frames_np).cuda()

    # (a) the batch, counted and recorded
    extract_batch(frames, cfg)
    torch.cuda.synchronize()
    with scan_recording() as calls:
        kcuda.reset_launch_counts()
        kp = extract_batch(frames, cfg)
        torch.cuda.synchronize()
        launches = kcuda.launch_counts()
    print(f"phase 17a parity B={BATCH} {HEIGHT}x{WIDTH} launches: {launches}",
          flush=True)
    hold_launches("phase 17a parity batch", launches, PARITY_LAUNCHES)
    kpn = kp.to_numpy()
    n = kpn.valid.sum(axis=1)
    if (n == 0).any() or kpn.desc.shape != (BATCH, PARITY_CAPS[1], 128) \
            or not np.isfinite(kpn.desc[kpn.valid]).all() \
            or int(kpn.n_dropped.sum()):
        raise Failed(f"phase 17a: valid per image {n.tolist()}, dropped "
                     f"{kpn.n_dropped.tolist()}, desc {kpn.desc.shape}")
    for i in range(BATCH):
        bad = fields_equal(extract_batch(frames_np[i:i + 1], cfg).to_numpy(),
                           kpn, 0, i)
        if bad:
            raise Failed(f"phase 17a: image {i} of the batch differs from "
                         f"its B=1 extraction in {bad}")
    reps = 10
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        extract_batch(frames, cfg)
    torch.cuda.synchronize()
    batch_ms = (time.perf_counter() - t0) / reps * 1e3
    sites = count_syncs(torch, lambda: extract_batch(frames, cfg))
    ours = [x for x in sites if x.startswith(
        ("sift_tpu_torch/frontend/parity.py", "sift_tpu_torch/kernels/"
         "cuda/parity_scan.py"))]
    print(f"phase 17a: valid per image {n.tolist()}, none dropped, every "
          f"image bit-identical to its B=1 extraction; {batch_ms:.3f} ms a "
          f"batch warm ({batch_ms / BATCH:.3f} ms a frame; 13b's B=1 frame "
          f"{parity13['frame_ms']:.3f} ms); host syncs {len(sites)} "
          f"{sorted(set(sites))}; card {card}", flush=True)
    if ours:
        raise Failed(f"phase 17a: the parity pass syncs the host at {ours}")

    # (b) the kernel against its plain version on every recorded call
    recorded = {"goldens": parity13["calls"]["goldens"],
                "frame": parity13["calls"]["frame"], "batch": calls,
                **{k: [c] for k, c in synthetic_scans(torch).items()}}
    kern = ps.parity_scan
    longest = {}
    for label, cs in recorded.items():
        longest[label] = 0
        for maps, *rest in cs:
            table = rest[-1]
            longest[label] = max(longest[label],
                                 tile_lists(ps, maps, table)[1])
            got_maps, want_maps = maps.clone(), maps.clone()
            got = kern(got_maps, *rest)
            want = ps.parity_scan_plain(want_maps, *rest)
            if not (nan_equal(got, want) and nan_equal(got_maps, want_maps)):
                raise Failed(f"phase 17b: the parity scan kernel differs "
                             f"from its plain version on a {label} call "
                             f"(maps {tuple(maps.shape)}, table "
                             f"{tuple(table.shape)})")
        print(f"phase 17b {label}: {len(cs)} scan calls bit-identical "
              f"(NaN-equal) to the plain walk, seen and maps; longest tile "
              f"list {longest[label]} entries", flush=True)

    # (c) time, bound and plain time of 13b's call and the batch's
    t = {}
    for label in ("frame", "batch"):
        maps, *rest = recorded[label][0]
        work = maps.clone()
        ms, seen, wait = kernel_trace(lambda: kern(work, *rest),
                                      KERNEL_SYMBOLS["parity_scan"], 20)
        if ms is None:
            raise Failed(f"phase 17c: no CUPTI trace of the {label}'s scan "
                         f"held one kernel launch a call (last: {seen:g} "
                         f"after a {wait:g} s wait)")
        nbytes, nops = kernel_work("parity_scan", (maps, *rest))
        bound_ms, bound_by = bound(nbytes, nops)
        lists, longest_list = tile_lists(ps, maps, rest[-1])
        t[label] = {"ms": ms, "ms_stream": event_ms(lambda: kern(work, *rest),
                                                    20),
                    "plain_ms": event_ms(lambda: ps.parity_scan_plain(
                        work, *rest), 3),
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "slots": int(rest[-1][..., 4].count_nonzero()),
                    "lists": lists, "longest": longest_list}
        c = t[label]
        print(f"phase 17c parity_scan per {label}: {c['slots']} ok slots, "
              f"{lists} tile lists, the longest {longest_list} entries; "
              f"kernel {c['ms']:.4f} ms (CUPTI, one kernel launch a call, "
              f"trace whole after a {wait:g} s wait), the whole call "
              f"{c['ms_stream']:.4f} ms (stream, lists built), bound "
              f"{c['bound_ms']:.5f} ms ({c['bound_by']}, "
              f"{100 * c['bound_ms'] / c['ms']:.1f}% of it), plain "
              f"{c['plain_ms']:.3f} ms; library: {PARITY_SCAN_LIBRARY}; "
              f"card {card}", flush=True)
    print(f"phase 17 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    b, f = t["batch"], t["frame"]
    return {
        "name": "parity_scan", "route": "cuda",
        "source": "sift_tpu_torch/csrc/parity_scan.cu",
        "replaces": PARITY_SCAN_REPLACES, "launches": launches["parity_scan"],
        "max_abs_err": 0.0, "ms": b["ms"], "ms_stream": b["ms_stream"],
        "timing": "cupti", "plain_ms": b["plain_ms"],
        "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
        "library_ms": None, "library": PARITY_SCAN_LIBRARY,
        "slots": b["slots"], "tile_lists": b["lists"],
        "longest_tile_list": b["longest"], "ms_frame": f["ms"],
        "ms_stream_frame": f["ms_stream"], "bound_ms_frame": f["bound_ms"],
        "plain_ms_frame": f["plain_ms"], "slots_frame": f["slots"],
        "tile_lists_frame": f["lists"], "longest_tile_list_frame": f["longest"],
        "launches_goldens": parity13["launches_goldens"],
        "launches_cli": parity13["launches_cli"],
        "parity_batch_ms": batch_ms, "parity_frame_ms": parity13["frame_ms"],
    }


def serve_request(port: int, path: str, payload=None):
    """(HTTP status, JSON body, seconds) of one request to the local front."""
    import urllib.error
    import urllib.request
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            code, body = r.status, r.read()
    except urllib.error.HTTPError as e:
        code, body = e.code, e.read()
    return code, json.loads(body), time.perf_counter() - t0


def ok_request(port: int, path: str, payload=None):
    """(JSON body, seconds) of a request that must answer 200."""
    code, out, secs = serve_request(port, path, payload)
    if code != 200:
        raise Failed(f"{path}: HTTP {code}: {str(out)[:300]}")
    return out, secs


@contextlib.contextmanager
def http_front(service):
    """The service's HTTP front on an ephemeral localhost port, in a
    thread; yields the port and shuts the server down after."""
    import threading
    from http.server import ThreadingHTTPServer
    from sift_tpu_torch.serve import make_handler
    srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield srv.server_address[1]
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=60)


def served_share(a: dict, b: dict):
    """Share of the keypoints of service answer `a` (valid keypoints only,
    as /extract gives them) with a counterpart in `b` (same octave,
    position within 0.01 px, orientation within 0.1 deg), and the largest
    descriptor difference over those pairs."""
    a = {k: np.asarray(v) for k, v in a.items()}
    b = {k: np.asarray(v) for k, v in b.items()}
    matched, worst = 0, 0.0
    for s in range(len(a["x"])):
        cand = np.flatnonzero((b["octave"] == a["octave"][s])
                              & (np.abs(b["x"] - a["x"][s]) < 1e-2)
                              & (np.abs(b["y"] - a["y"][s]) < 1e-2))
        dori = np.abs((b["orientation"][cand] - a["orientation"][s]
                       + 180.0) % 360.0 - 180.0)
        cand = cand[dori < 0.1]
        if cand.size:
            matched += 1
            worst = max(worst, float(np.abs(
                b["desc"][cand] - a["desc"][s]).max(axis=1).min()))
    return matched / max(len(a["x"]), 1), worst


def valid_only(kp: dict) -> dict:
    """A service's `extract` answer as /extract sends it: valid slots."""
    v = kp["valid"]
    return {k: val[v] for k, val in kp.items() if k != "valid"}


def pct_ms(secs) -> str:
    a = np.percentile(np.asarray(secs) * 1e3, [50, 99])
    return f"p50 {a[0]:.3f} ms, p99 {a[1]:.3f} ms"


def hold_served_kernels(torch, label: str, calls: dict, originals: dict):
    """Every recorded kernel call of the service against its plain version
    (phase 4's and phase 6's criteria; descriptors also over two
    launches). Returns {kernel: max abs err}."""
    from sift_tpu_torch.kernels.cuda import descriptor
    from sift_tpu_torch.kernels.cuda import match as mk
    plain = dict(extraction_plain(),
                 streaming_top2=mk.streaming_top2_plain)
    errs = {}
    for name, args_list in calls.items():
        errs[name] = 0.0
        for args in args_list:
            got, want = originals[name](*args), plain[name](*args)
            torch.cuda.synchronize()
            if name == "streaming_top2":
                e = top2_check(torch, mk, got, want, args)[0]
            else:
                e = hold_extraction_kernel(torch, descriptor.TOLERANCE, name,
                                           got, want)[0]
            if name == "descriptor_accumulate" and \
                    not torch.equal(got, originals[name](*args)):
                raise Failed(f"{label}: descriptor kernel differs between "
                             "two launches")
            errs[name] = max(errs[name], e)
        print(f"{label} {name}: {len(args_list)} calls held against plain, "
              f"max_abs_err {errs[name]:.3g}", flush=True)
    return errs


def hold_homography_fit(torch, label: str, noise, pa, pb, valid, cfg):
    """`ransac_homography` and a `fit_homography` of its inliers on the
    card against the CPU, same points and noise: returns (largest H
    difference relative to the largest entry, over the RANSAC model and
    the refit, and whether the inlier sets are equal)."""
    from sift_tpu_torch.geometry.homography import (fit_homography,
                                                    ransac_homography)

    def unit(H):
        H = H.double().cpu().numpy()
        return H / H[2, 2]

    est_g = ransac_homography(noise.cuda(), pa.cuda(), pb.cuda(),
                              valid.cuda(), cfg)
    est_c = ransac_homography(noise.cpu(), pa.cpu(), pb.cpu(), valid.cpu(),
                              cfg)
    same = torch.equal(est_g.inliers.cpu(), est_c.inliers)
    w = est_c.inliers.to(pa.dtype)
    fit_g = fit_homography(pa.cuda(), pb.cuda(), w.cuda())
    fit_c = fit_homography(pa.cpu(), pb.cpu(), w)
    rel = 0.0
    for g, c in ((est_g.model, est_c.model), (fit_g, fit_c)):
        Hg, Hc = unit(g), unit(c)
        rel = max(rel, float(np.abs(Hg - Hc).max() / np.abs(Hc).max()))
    print(f"{label}: {int(valid.sum())} points, inliers "
          f"{int(est_g.num_inliers)} (card) vs {int(est_c.num_inliers)} (CPU), "
          f"sets equal {same}; H card vs CPU {rel:.3g} relative", flush=True)
    return rel, same


def serve_phase(torch, card: str, window_state, boot_calls) -> tuple:
    """Phase 14: the feature service on the card. Returns ({kernel:
    launches of 14a's three requests and 14c's match}, {kernel: max abs
    err on the service's recorded calls})."""
    import base64
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    from sift_tpu_torch import SiftConfig, cli, extract, extract_batch, serve
    from sift_tpu_torch.config import MatchConfig, RansacConfig
    from sift_tpu_torch.geometry.ransac import gumbel
    from sift_tpu_torch.io.checkpoint import (restore_checkpoint,
                                              save_checkpoint)
    from sift_tpu_torch.io.image import load_image_gray, save_image_gray
    from sift_tpu_torch.kernels import cuda as kcuda
    from sift_tpu_torch.kernels.cuda import match as mk
    from sift_tpu_torch.matching.ann import build_ivf, match_descriptors_ann
    from sift_tpu_torch.matching.matcher import (match_descriptors,
                                                 matched_coords)

    here = os.path.dirname(os.path.abspath(__file__))
    rgb = os.path.join(here, TUM_DIR, "rgb")
    names = sorted(os.listdir(rgb))
    b64s = []
    for n in names:
        with open(os.path.join(rgb, n), "rb") as fh:
            b64s.append(base64.b64encode(fh.read()).decode())
    grays = [serve._decode_image(b) for b in b64s]
    pair = [b64s[names.index(f"{s}.png")] for s in TUM_PAIR]
    phase_t0 = time.perf_counter()
    launches_serve = dict.fromkeys(kcuda.launch_counts(), 0)
    errs = {}

    # (a) the service at `python -m sift_tpu_torch.serve`'s defaults
    args = serve.build_parser().parse_args([])
    svc = serve.service_from_args(args)
    t0 = time.perf_counter()
    svc.warmup()
    print(f"phase 14a: service {args.height}x{args.width}, {args.mode}, "
          f"{args.max_keypoints} keypoints, window {args.batch_window_ms} ms, "
          f"batches of {args.max_batch}; warmup {time.perf_counter() - t0:.3f}"
          f" s", flush=True)
    cpu_svc = serve.FeatureService(args.height, args.width, sift=svc.sift,
                                   device="cpu")
    intr = list(TUM_FR1_INTRINSICS)
    requests = [
        ("/extract", {"image": b64s[0]}, EXPECTED_LAUNCHES),
        ("/match", {"image_a": pair[0], "image_b": pair[1]},
         TWOVIEW_LAUNCHES),
        ("/twoview", {"image_a": pair[0], "image_b": pair[1],
                      "intrinsics": intr}, TWOVIEW_LAUNCHES),
    ]
    answers = {}
    try:
        with http_front(svc) as port:
            health, _ = ok_request(port, "/healthz")
            if health != {"status": "ok", "shape": [args.height, args.width]}:
                raise Failed(f"phase 14a /healthz: {health}")
            with recording(extraction_kernels()) as (calls, originals):
                for path, payload, expected in requests:
                    kcuda.reset_launch_counts()
                    answers[path], secs = ok_request(port, path, payload)
                    torch.cuda.synchronize()
                    launches = kcuda.launch_counts()
                    for k in launches:
                        launches_serve[k] += launches[k]
                    print(f"phase 14a {path}: {secs * 1e3:.3f} ms (first "
                          f"request), launches {launches}", flush=True)
                    hold_launches(f"phase 14a {path}", launches, expected)
                served_calls = {k: list(v) for k, v in calls.items()}
            syncs = {}
            for path, payload, _ in requests:
                syncs[path] = count_syncs_any_thread(
                    torch, lambda: ok_request(port, path, payload))
                counts = {k: syncs[path].count(k) for k in set(syncs[path])}
                print(f"phase 14a {path} host syncs: {len(syncs[path])} "
                      f"{dict(sorted(counts.items()))}", flush=True)
            stats, _ = ok_request(port, "/stats")
            alone = [ok_request(port, "/extract", {"image": b64s[0]})[1]
                     for _ in range(20)]
        if len(syncs["/extract"]) != 2 or len(syncs["/match"]) != 1:
            raise Failed("phase 14a: the read contract is two bulk reads a "
                         "dispatch and one a /match")
        print(f"phase 14a /stats: {stats}", flush=True)
        if set(stats) != {"dispatch_stats", "phases", "mean_batch"}:
            raise Failed(f"phase 14a /stats keys {sorted(stats)}")

        ext = answers["/extract"]
        want = valid_only(cpu_svc.extract(grays[0]))
        fwd, worst_f = served_share(want, ext)
        back, worst_b = served_share(ext, want)
        worst = max(worst_f, worst_b)
        print(f"phase 14a /extract vs the CPU service: {len(want['x'])} vs "
              f"{ext['n']} keypoints, matched {fwd:.4f} / {back:.4f}, max "
              f"desc diff {worst:.3g}", flush=True)
        if min(fwd, back) < 0.99 or worst > 2e-3 + 1.0 / 255.0:
            raise Failed("phase 14a: /extract disagrees with the CPU service")
        if answers["/match"]["n"] < 100:
            raise Failed(f"phase 14a /match: {answers['/match']['n']} matches")
        tv = answers["/twoview"]
        R_gt, t_gt = tum_relative_pose(here)
        r_err = rot_deg(np.asarray(tv["R"]) @ R_gt.T)
        t_err = dir_deg(tv["t"], t_gt)
        print(f"phase 14a /twoview: matches {tv['n_matches']}, inliers "
              f"{tv['num_inliers']}, success {tv['success']}; rotation "
              f"{r_err:.4f} deg, t {t_err:.4f} deg from the ground truth",
              flush=True)
        if not tv["success"] or r_err > 0.1 or t_err > 2.0:
            raise Failed("phase 14a: /twoview pose off")
        print(f"phase 14a: single /extract requests {pct_ms(alone)} (20 in a "
              f"row, one client); card {card}", flush=True)

        # (b) co-batching
        load = serve.FeatureService(args.height, args.width, sift=svc.sift,
                                    batch_window_ms=50, max_batch=8)
        solo = serve.FeatureService(args.height, args.width, sift=svc.sift)
        try:
            load.warmup()
            with http_front(load) as port:
                body = [{"image": b64s[i % 4]} for i in range(32)]
                with ThreadPoolExecutor(max_workers=8) as ex:
                    list(ex.map(lambda p: ok_request(port, "/extract", p),
                                body[:8]))
                load.dispatch_stats.update(extract_requests=0,
                                           extract_dispatches=0)
                for q in load.phase_stats.values():
                    q.clear()
                t0 = time.perf_counter()
                with ThreadPoolExecutor(max_workers=8) as ex:
                    outs = list(ex.map(
                        lambda p: ok_request(port, "/extract", p), body))
                wall = time.perf_counter() - t0
                st = dict(load.dispatch_stats)
                stats, _ = ok_request(port, "/stats")
            for i in range(4, 32):
                a, b = outs[i][0], outs[i % 4][0]
                if a["n"] != b["n"] or not np.allclose(a["x"], b["x"],
                                                       atol=1e-4, rtol=0):
                    raise Failed(f"phase 14b: request {i} and {i % 4} (one "
                                 "image) differ")
            batches = list(load.phase_stats["batch_size"])
            print(f"phase 14b: 32 /extract from 8 clients at a 50 ms window: "
                  f"{st}, mean batch {np.mean(batches):.3f}, "
                  f"{pct_ms([o[1] for o in outs])}, {32 / wall:.3f} "
                  f"requests/s; /stats phases {stats['phases']}; identical "
                  f"images identical in every slot; card {card}", flush=True)
            if st["extract_requests"] != 32 or st["extract_dispatches"] > 16:
                raise Failed(f"phase 14b: {st}")

            imgs = grays[:6]
            ref = [solo.extract(g) for g in imgs]
            load.dispatch_stats.update(extract_requests=0,
                                       extract_dispatches=0)
            with ThreadPoolExecutor(max_workers=6) as ex:
                got = list(ex.map(load.extract, imgs))
            bitwise = all(np.array_equal(r[k], o[k]) for r, o in zip(ref, got)
                          for k in r)
            bad = []
            for i, (r, o) in enumerate(zip(ref, got)):
                v = r["valid"]
                if not (np.array_equal(r["valid"], o["valid"])
                        and np.allclose(r["x"][v], o["x"][v], atol=1e-4,
                                        rtol=0)
                        and np.allclose(r["desc"][v], o["desc"][v],
                                        atol=1.01 / 255.0, rtol=0)):
                    bad.append((i, int((r["valid"] != o["valid"]).sum())))
            print(f"phase 14b co-batched ({load.dispatch_stats}) vs a "
                  f"window-0 service (one request a dispatch, padded to "
                  f"B={solo.max_batch}): 6 images, bit-identical {bitwise}, "
                  f"failing the JAX test's criteria {bad}", flush=True)
            if bad:
                raise Failed(f"phase 14b: co-batched and single extraction "
                             f"differ on (image, slots) {bad}")
            # `extract_batch` of one image at B=1 against the same image
            # in a batch of 8 (phase 16b holds them equal; printed here
            # on the service's frames).
            frames8 = torch.from_numpy(np.stack(grays[:8])).cuda()
            k8 = extract_batch(frames8, svc.sift).to_numpy()
            same, flips = 0, []
            for i in range(8):
                k1 = extract_batch(frames8[i:i + 1], svc.sift).to_numpy()
                same += all(np.array_equal(getattr(k1, f)[0],
                                           getattr(k8, f)[i])
                            for f in ("x", "y", "scale", "orientation",
                                      "score", "valid", "desc"))
                flips.append(int((k1.valid[0] != k8.valid[i]).sum()))
            print(f"phase 14b extract_batch of one frame at B=1 vs in a "
                  f"batch of 8 (TUM frames 0-7): {same} of 8 bit-identical, "
                  f"valid slots differing {flips}", flush=True)

            def burst():
                with ThreadPoolExecutor(max_workers=8) as ex:
                    list(ex.map(load.extract, grays[:8]))
                torch.cuda.synchronize()

            busy_ms, wall_ms = profile_busy(torch, burst,
                                            "chip_smoke_serve_profile.txt",
                                            card)
            print(f"phase 14b profiled co-batched dispatch of 8 requests: "
                  f"device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms wall "
                  f"({100 * busy_ms / wall_ms:.2f}%); card {card}", flush=True)
        finally:
            load.close()
            solo.close()
    finally:
        svc.close()

    # (c) kernel 4 through the service, at phase 6's COLMAP shape
    pair_np, H_true = match_pair()
    big = serve.FeatureService(
        MATCH_HEIGHT, MATCH_WIDTH,
        sift=SiftConfig(max_keypoints=MATCH_FEATURES,
                        max_keypoints_per_octave=MATCH_FEATURES),
        match=MatchConfig(ratio=0.8, mutual=True, max_matches=MATCH_FEATURES),
        max_batch=1)
    big.warmup()
    targets = dict(extraction_kernels(), streaming_top2=(mk, "streaming_top2"))
    with recording(targets) as (calls, originals):
        kcuda.reset_launch_counts()
        t0 = time.perf_counter()
        mm = big.match_images(pair_np[0], pair_np[1])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = kcuda.launch_counts()
        big_calls = {k: list(v) for k, v in calls.items()}
    for k in launches:
        launches_serve[k] += launches[k]
    v = mm["valid"]
    err = np.linalg.norm(map_points(H_true, np.c_[mm["xa"][v], mm["ya"][v]])
                         - np.c_[mm["xb"][v], mm["yb"][v]], axis=1)
    print(f"phase 14c match_images {MATCH_HEIGHT}x{MATCH_WIDTH}, "
          f"{MATCH_FEATURES} features: {int(v.sum())} matches, transfer "
          f"error median {np.median(err):.4f} px, under 1 px "
          f"{float((err < 1).mean()):.4f}; {secs * 1e3:.3f} ms; launches "
          f"{launches}", flush=True)
    hold_launches("phase 14c", launches, SERVE_LARGE_LAUNCHES)
    if v.sum() < MATCH_FEATURES // 8 or not np.median(err) < 1.0:
        raise Failed("phase 14c: matched coordinates off the homography")
    for label, recorded in (("phase 14a", served_calls),
                            ("phase 14c", big_calls)):
        for k, e in hold_served_kernels(torch, label, recorded,
                                        originals).items():
            errs[k] = max(errs.get(k, 0.0), e)
    del served_calls, big_calls

    # (d) parity mode through the service
    pargs = serve.build_parser().parse_args(["--mode", "parity"])
    psvc = serve.service_from_args(pargs)
    try:
        psvc.warmup()
        with http_front(psvc) as port:
            kcuda.reset_launch_counts()
            got, secs = ok_request(port, "/extract", {"image": b64s[0]})
            launches = kcuda.launch_counts()
    finally:
        psvc.close()
    hold_launches("phase 14d parity /extract", launches, PARITY_LAUNCHES)
    launches_serve["parity_scan"] += launches["parity_scan"]
    want = valid_only(serve.FeatureService(
        pargs.height, pargs.width, sift=psvc.sift,
        device="cpu").extract(grays[0]))
    same = (got["n"] == len(want["x"])
            and all(np.array_equal(np.asarray(got[k]), want[k])
                    for k in ("x", "y", "octave")))
    d_scale = float(np.abs(np.asarray(got["scale"]) - want["scale"]).max()) \
        if same else float("nan")
    d_desc = float(np.abs(np.asarray(got["desc"]) - want["desc"]).max()) \
        if same else float("nan")
    print(f"phase 14d parity /extract: {got['n']} keypoints (CPU "
          f"{len(want['x'])}), the same set {same}, scale diff {d_scale:.3g}, "
          f"descriptor diff {d_desc:.3g}; {secs * 1e3:.3f} ms (batch of "
          f"{pargs.max_batch}); launches {launches}", flush=True)
    if not same or d_scale > 1e-4 or d_desc > 2e-3 + 1.0 / 255.0:
        raise Failed("phase 14d: parity /extract differs from the CPU")

    # (e) IVF through `cli match --match-impl ivf`
    scfg = SiftConfig(max_keypoints=MATCH_FEATURES,
                      max_keypoints_per_octave=MATCH_FEATURES,
                      window_dtype="float32")
    mcfg = MatchConfig(ratio=0.8)
    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, f"{n}.png") for n in ("a", "b")]
        for p, img in zip(paths, pair_np):
            save_image_gray(p, img)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["match", *paths, "--match-impl", "ivf", "--time",
                           "--max-keypoints", str(MATCH_FEATURES),
                           "--max-keypoints-per-octave", str(MATCH_FEATURES)])
        for line in out.getvalue().splitlines():
            print(f"phase 14e cli match --match-impl ivf: {line}", flush=True)
        if rc != 0 or "success=True" not in out.getvalue():
            raise Failed(f"phase 14e: cli match --match-impl ivf rc {rc}")
        grays_ab = [load_image_gray(p) for p in paths]
    kps = [extract(g, scfg) for g in grays_ab]
    ann = cli.ivf_config(scfg)
    u = torch.rand(kps[1].desc.shape[0],
                   generator=torch.Generator().manual_seed(0))
    m_card, idx_card = cli.match_ivf(kps, scfg, mcfg, noise=u.cuda())
    kps_cpu = [k.map(lambda t: t.cpu()) for k in kps]
    m_cpu, idx_cpu = cli.match_ivf(kps_cpu, scfg, mcfg, noise=u)
    a, b = row_map(m_card), row_map(m_cpu)
    agree = sum(a[i][0] == b.get(i, (None,))[0] for i in a) / max(
        len(a), len(b), 1)
    print(f"phase 14e IVF ({ann.n_clusters} clusters of capacity "
          f"{ann.bucket_capacity}, nprobe {ann.nprobe}): n_overflow "
          f"{int(idx_card.n_overflow)} (card), {int(idx_cpu.n_overflow)} "
          f"(CPU); {len(a)} matches on the card, {len(b)} on the CPU, "
          f"{agree:.4f} agree (same init noise)", flush=True)
    if agree < 0.99:
        raise Failed("phase 14e: IVF matches on the card and the CPU differ")
    ann_all = ann.replace(nprobe=ann.n_clusters)
    index = build_ivf(kps[1].desc, kps[1].valid, ann_all, u.cuda())
    if int(index.n_overflow):
        raise Failed(f"phase 14e: {int(index.n_overflow)} points overflow")
    m_all = match_descriptors_ann(kps[0].desc, kps[0].valid, index, mcfg,
                                  ann_all)
    m_exact = match_descriptors(kps[0].desc, kps[0].valid, kps[1].desc,
                                kps[1].valid, mcfg)
    hold_matches_near_ties(torch, "phase 14e IVF nprobe = n_clusters vs the "
                           "exact matcher (streaming kernel)", kps[0], kps[1],
                           mcfg, m_all, m_exact)
    build_ms = event_ms(lambda: build_ivf(kps[1].desc, kps[1].valid,
                                                 ann, u.cuda()), 3)
    search_ms = event_ms(lambda: match_descriptors_ann(
        kps[0].desc, kps[0].valid, idx_card, mcfg, ann), 3)
    args_m = (kps[0].desc, kps[0].valid, kps[1].desc, kps[1].valid)
    dense_ms = event_ms(lambda: match_descriptors(
        *args_m, mcfg.replace(impl="xla")), 3)
    stream_ms = event_ms(lambda: match_descriptors(*args_m, mcfg), 3)
    print(f"phase 14e {MATCH_FEATURES}x{MATCH_FEATURES}: IVF build "
          f"{build_ms:.3f} ms, IVF search + ratio + mutual {search_ms:.3f} ms; "
          f"exact matcher dense {dense_ms:.3f} ms, streaming kernel "
          f"{stream_ms:.3f} ms (CUDA events); card {card}", flush=True)

    # (f) the homography fit, card against the CPU
    worst, all_same = 0.0, True
    for i, (nh, na, nb, valid, cfg_h) in enumerate(boot_calls):
        rel, same = hold_homography_fit(
            torch, f"phase 14f phase 10a bootstrap attempt {i}", nh, na, nb,
            valid, cfg_h)
        worst, all_same = max(worst, rel), all_same and same
    m = match_descriptors(kps[0].desc, kps[0].valid, kps[1].desc,
                          kps[1].valid, MatchConfig(ratio=0.8))
    pa, pb, valid = matched_coords(kps[0], kps[1], m)
    noise = gumbel(torch.Generator().manual_seed(0), (512, pa.shape[0]), "cpu")
    rel, same = hold_homography_fit(torch, "phase 14f cli match's pair", noise,
                                    pa, pb, valid,
                                    RansacConfig(inlier_threshold=3.0))
    worst, all_same = max(worst, rel), all_same and same
    print(f"phase 14f fit_homography card vs CPU: {len(boot_calls)} bootstrap "
          f"attempts and cli match's pair, largest H difference {worst:.3g} "
          f"relative, inlier sets equal {all_same}", flush=True)
    if not boot_calls or worst > HOMOGRAPHY_RTOL or not all_same:
        raise Failed("phase 14f: the homography fit parts card from CPU")

    # (g) a window-BA state through a checkpoint, restored onto the card
    fields = [f.name for f in dataclasses.fields(window_state)]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "window_ba.pt")
        save_checkpoint(path, window_state)
        target = window_state.replace(**{
            f: torch.empty_like(getattr(window_state, f)) for f in fields})
        back = restore_checkpoint(path, target=target)
    same = all(getattr(back, f).is_cuda and torch.equal(
        getattr(back, f), getattr(window_state, f)) for f in fields)
    print(f"phase 14g window-BA state -> save_checkpoint -> "
          f"restore_checkpoint(target=) on the card: bit-identical {same}",
          flush=True)
    if not same:
        raise Failed("phase 14g: the restored state differs")
    print(f"phase 14: {time.perf_counter() - phase_t0:.1f} s", flush=True)
    return launches_serve, errs


def free_port() -> int:
    """A free TCP port on localhost, for the process group's rendezvous."""
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


COLLECTIVES = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor")


@contextlib.contextmanager
def counting_collectives():
    """Count the `torch.distributed` collectives issued inside, by name
    (the port calls them through the module, so wrapping its attributes
    sees every call)."""
    import torch.distributed as dist
    counts = dict.fromkeys(COLLECTIVES, 0)
    originals = {n: getattr(dist, n) for n in COLLECTIVES}

    def counted(name):
        def call(*a, **k):
            counts[name] += 1
            return originals[name](*a, **k)
        return call

    for n in COLLECTIVES:
        setattr(dist, n, counted(n))
    try:
        yield counts
    finally:
        for n in COLLECTIVES:
            setattr(dist, n, originals[n])


def in_turns(torch, a, b, reps: int = DIST_REPS) -> tuple:
    """Host ms per call of `a` and of `b`, each turn `reps` calls ending in
    a synchronize, in turns a, b, b, a; returns (median a, median b)."""
    times = ([], [])
    for which in (0, 1, 1, 0):
        fn = (a, b)[which]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        times[which].append(1e3 * (time.perf_counter() - t0) / reps)
    return float(np.median(times[0])), float(np.median(times[1]))


def differing(torch, a, b, fields) -> list:
    """The fields of `a` and `b` that are not bit-identical."""
    return [f for f in fields
            if not torch.equal(getattr(a, f), getattr(b, f))]


def dist_phase(torch, card: str, frames_np, pair_kp, ba_scenes) -> tuple:
    """Phase 15: the dist paths in a one-rank NCCL world, each held bit
    for bit against its single-device call. Returns ({kernel: launches on
    (a), (b) and (e)}, {kernel: max abs err of those calls against the
    plain versions})."""
    import torch.distributed as dist
    from sift_tpu_torch import SiftConfig, extract_batch
    from sift_tpu_torch.ba.solver import run_ba
    from sift_tpu_torch.config import MatchConfig, PipelineConfig
    from sift_tpu_torch.dist import (extract_batch_sharded, make_mesh,
                                     match_large_sharded,
                                     optimize_pose_graph_sharded,
                                     optimize_pose_graph_sim3_sharded,
                                     run_ba_sharded)
    from sift_tpu_torch.dist.mesh import (init_distributed,
                                          shutdown_distributed)
    from sift_tpu_torch.kernels import cuda as kcuda
    from sift_tpu_torch.kernels.cuda import match as mk
    from sift_tpu_torch.matching.matcher import match_descriptors
    from sift_tpu_torch.slam import pose_graph as pg
    from sift_tpu_torch.slam.pipeline import SfmPipeline

    t_phase = time.perf_counter()
    init_distributed("cuda", f"tcp://localhost:{free_port()}", 0, 1)
    try:
        mesh = make_mesh()
        print(f"phase 15: one-rank {dist.get_backend()} world, mesh "
              f"{tuple(mesh.mesh.shape)} {mesh.mesh_dim_names}, joined in "
              f"{time.perf_counter() - t_phase:.1f} s", flush=True)
        targets = dict(extraction_kernels(),
                       streaming_top2=(mk, "streaming_top2"))
        launches, held = {}, {name: [] for name in targets}
        originals = {}

        def counted(label, fn):
            with recording(targets) as (calls, orig):
                kcuda.reset_launch_counts()
                out = fn()
                torch.cuda.synchronize()
                launches[label] = kcuda.launch_counts()
            originals.update(orig)
            for name, c in calls.items():
                held[name].extend(c)
            print(f"phase 15 {label} launches: {launches[label]}", flush=True)
            hold_launches(f"phase 15 {label}", launches[label],
                          DIST_LAUNCHES[label])
            return out

        # (a) sharded extraction against extract_batch
        cfg = SiftConfig()
        frames = torch.from_numpy(frames_np).cuda()
        kp = counted("extract", lambda: extract_batch_sharded(
            mesh, frames, cfg, replicate=True))
        ref = extract_batch(frames, cfg)
        bad = differing(torch, kp, ref,
                        [f.name for f in dataclasses.fields(ref)])
        ms_single, ms_dist = in_turns(
            torch, lambda: extract_batch(frames, cfg),
            lambda: extract_batch_sharded(mesh, frames, cfg, replicate=True),
            reps=5)
        print(f"phase 15a extract_batch_sharded B={BATCH} {HEIGHT}x{WIDTH}: "
              f"bit-identical to extract_batch {not bad} {bad}; "
              f"{ms_dist:.3f} ms a batch against {ms_single:.3f} ms single "
              f"(host clock, 5 calls a turn, in turns); card {card}",
              flush=True)
        if bad:
            raise Failed(f"sharded extraction differs in {bad}")

        # (b) the large sharded match against match_descriptors
        ka, kb = pair_kp
        mcfg = MatchConfig(ratio=0.8, mutual=True, max_matches=MATCH_FEATURES)
        args = (ka.desc, ka.valid, kb.desc, kb.valid)
        m = counted("match", lambda: match_large_sharded(mesh, *args, mcfg))
        ref = match_descriptors(*args, mcfg)
        bad = differing(torch, m, ref, ("idx_a", "idx_b", "distance",
                                        "valid"))
        ms_single, ms_dist = in_turns(
            torch, lambda: match_descriptors(*args, mcfg),
            lambda: match_large_sharded(mesh, *args, mcfg), reps=5)
        print(f"phase 15b match_large_sharded {MATCH_FEATURES}^2: "
              f"{int(m.count())} matches, bit-identical to match_descriptors "
              f"{not bad} {bad}; {ms_dist:.3f} ms a match against "
              f"{ms_single:.3f} ms single (host clock, 5 calls a turn, in "
              f"turns); card {card}", flush=True)
        if bad:
            raise Failed(f"sharded match differs in {bad}")

        # (c) sharded BA at window capacity and at map scale, both v_modes
        fields = ("poses", "landmarks", "cost", "rmse", "damping",
                  "iterations", "cg_iters")
        for label, (scene, bcfg) in ba_scenes.items():
            ba_args = ba_inputs(torch, scene, "cuda")
            fixed = np.zeros(scene["poses_init"].shape[0], bool)
            fixed[:2] = True
            fixed_d = torch.from_numpy(fixed).cuda()
            ref = run_ba(*ba_args, bcfg, fixed_d)
            with counting_collectives() as base:
                run_ba_sharded(mesh, *ba_args, cfg=bcfg.replace(
                    max_iterations=0), fixed_cam_mask=fixed_d)
            for v_mode in ("psum", "reduce_scatter"):
                with counting_collectives() as coll:
                    st = run_ba_sharded(mesh, *ba_args, cfg=bcfg,
                                        fixed_cam_mask=fixed_d,
                                        v_mode=v_mode)
                    torch.cuda.synchronize()
                bad = differing(torch, st, ref, fields)
                per_iter = {k: (coll[k] - base[k]) / bcfg.max_iterations
                            for k in COLLECTIVES}
                print(f"phase 15c {label} BA v_mode={v_mode}: bit-identical "
                      f"to run_ba {not bad} {bad}; rmse {float(st.rmse):.5f}, "
                      f"{int(st.iterations)} LM / {int(st.cg_iters)} CG "
                      f"iterations; collectives {dict(coll)} in all, per LM "
                      f"iteration {per_iter} (before the loop {dict(base)})",
                      flush=True)
                if bad:
                    raise Failed(f"sharded {label} BA ({v_mode}) differs in "
                                 f"{bad}")
            ms_single, ms_dist = in_turns(
                torch, lambda: run_ba(*ba_args, bcfg, fixed_d).rmse,
                lambda: run_ba_sharded(mesh, *ba_args, cfg=bcfg,
                                       fixed_cam_mask=fixed_d).rmse, reps=1)
            n = bcfg.max_iterations
            print(f"phase 15c {label} BA: {ms_dist / n:.3f} ms per LM "
                  f"iteration sharded against {ms_single / n:.3f} single "
                  f"(host clock over a {n}-iteration run, in turns); card "
                  f"{card}", flush=True)
        # What a one-rank collective costs the host, and whether a sharded
        # solve makes the host wait (the single one makes no sync, phase 8).
        group = mesh.get_group("data")
        t = torch.zeros(6, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            dist.all_reduce(t, group=group)
        issue_us = 1e6 * (time.perf_counter() - t0) / 200
        torch.cuda.synchronize()
        done_us = 1e6 * (time.perf_counter() - t0) / 200
        sites = count_syncs(torch, lambda: run_ba_sharded(
            mesh, *ba_args, cfg=bcfg, fixed_cam_mask=fixed_d))
        print(f"phase 15c one-rank NCCL all_reduce of 6 floats: "
              f"{issue_us:.1f} us of host time a call to issue, "
              f"{done_us:.1f} us a call to complete (200 calls); host syncs "
              f"of one sharded {label} BA run: {len(sites)} "
              f"{sorted(set(sites))}", flush=True)

        # (d) both sharded pose graphs at capacity
        for D, name, cls, opt, opt_dist in (
                (6, "SE(3)", pg.PoseGraph, pg.optimize_pose_graph,
                 optimize_pose_graph_sharded),
                (7, "Sim(3)", pg.Sim3Graph, pg.optimize_pose_graph_sim3,
                 optimize_pose_graph_sim3_sharded)):
            graph = cls(*(a.cuda() for a in capacity_graph(torch, D, seed=D)))
            ref = opt(graph, iterations=PGO_ITERATIONS).poses
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with counting_collectives() as coll:
                got = opt_dist(mesh, graph, iterations=PGO_ITERATIONS).poses
                torch.cuda.synchronize()
            t1 = time.perf_counter()
            opt(graph, iterations=PGO_ITERATIONS).poses.sum().item()
            t2 = time.perf_counter()
            same = torch.equal(got, ref)
            print(f"phase 15d {name} sharded pose graph at {PGO_NODES}/"
                  f"{PGO_EDGES}: bit-identical to the single-device solve "
                  f"{same}; {1e3 * (t1 - t0):.3f} ms sharded against "
                  f"{1e3 * (t2 - t1):.3f} ms single (host clock, one run "
                  f"each after a single-device run); collectives "
                  f"{dict(coll)}; card {card}", flush=True)
            if not same:
                raise Failed(f"sharded {name} pose graph differs")

        # (e) the mesh pipeline against the pipeline without one
        frames48 = list(make_sfm_sequence()[0][:DIST_FRAMES])
        pcfg = PipelineConfig(chunked_tracking=True, ba_async=True)
        plain = SfmPipeline(SFM_INTRINSICS, pcfg, seed=0)
        t0 = time.perf_counter()
        plain.process_sequence(frames48, batch=SFM_BATCH)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        meshed = SfmPipeline(SFM_INTRINSICS, pcfg, seed=0, mesh=mesh)
        t0 = time.perf_counter()
        counted("sfm", lambda: meshed.process_sequence(frames48,
                                                       batch=SFM_BATCH))
        mesh_s = time.perf_counter() - t0
        bad = [k for k, equal in (
            ("positions", np.array_equal(meshed.positions(),
                                         plain.positions())),
            ("landmarks", np.array_equal(meshed.landmarks, plain.landmarks)),
            ("tracked", [r["tracked"] for r in meshed.trajectory]
             == [r["tracked"] for r in plain.trajectory]),
            ("chunk_stats", meshed.chunk_stats == plain.chunk_stats))
            if not equal]
        print(f"phase 15e SfmPipeline(mesh=) on {DIST_FRAMES} frames, "
              f"chunked + async BA: {len(meshed.keyframes)} keyframes, "
              f"{meshed.landmarks.shape[0]} landmarks, chunk_stats "
              f"{meshed.chunk_stats}; trajectory and map bit-identical to the "
              f"pipeline without a mesh {not bad} {bad}; "
              f"{DIST_FRAMES / mesh_s:.3f} "
              f"frames/s against {DIST_FRAMES / plain_s:.3f} (host clock, "
              f"one run each, the plain one first); card {card}", flush=True)
        if bad:
            raise Failed(f"the mesh pipeline differs from the plain one in "
                         f"{bad}")
        with counting_collectives() as coll:
            g_mesh = meshed.run_global_ba(mesh=mesh)
        g_plain = plain.run_global_ba()
        same = g_mesh == g_plain and np.array_equal(
            meshed.landmarks, plain.landmarks) and all(
            np.array_equal(a.pose, b.pose)
            for a, b in zip(meshed.keyframes, plain.keyframes))
        print(f"phase 15e run_global_ba(mesh=): {g_mesh}; bit-identical to "
              f"run_global_ba() {same}; collectives {dict(coll)}", flush=True)
        if not same:
            raise Failed(f"global BA on the mesh {g_mesh} differs from "
                         f"{g_plain}")

        errs = hold_served_kernels(torch, "phase 15", held, originals)
        total = {name: sum(launches[label][name] for label in launches)
                 for name in kcuda.launch_counts()}
    finally:
        shutdown_distributed()
    print(f"phase 15: dist launches {total}, {time.perf_counter() - t_phase:.1f}"
          f" s in all", flush=True)
    return total, errs


def bits(a: np.ndarray) -> np.ndarray:
    """A field as integers: floats by their bit pattern, every NaN made the
    same NaN (NaN-equal); other types as they are."""
    if a.dtype.kind != "f":
        return a
    return np.where(np.isnan(a), np.float32(np.nan), a).view(np.uint32)


def same_bits(a, b) -> bool:
    """Two f32 tensors equal in every bit (a -0 is not a 0)."""
    import torch
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def fields_equal(a, b, i: int, j: int) -> list:
    """The `Keypoints` fields (numpy) in which image i of `a` and image j
    of `b` differ in any bit (NaN-equal)."""
    return [f for f in KP_FIELDS if getattr(a, f) is not None and not
            np.array_equal(bits(getattr(a, f)[i]), bits(getattr(b, f)[j]))]


def blur_library(torch, img, taps):
    """One PyTorch call (after a pad) of the same blur: a 2-D convolution
    by the outer product of the taps over a reflect pad ("reflect" is the
    mirror border without the edge repeated). cuDNN, TF32 off."""
    import torch.nn.functional as F
    r = (len(taps) - 1) // 2
    H, W = img.shape[-2:]
    if r >= min(H, W):
        raise Failed(f"reflect pad of {r} does not fit a {H}x{W} plane")
    t = torch.from_numpy(np.asarray(taps, np.float32)).to(img.device)
    w2 = torch.outer(t, t)[None, None]
    x = img.reshape(-1, 1, H, W)
    return lambda: F.conv2d(F.pad(x, (r, r, r, r), mode="reflect"), w2)


def blur_phase(torch, card: str, frames_np, main_blurs: int, kf_s: float,
               pairs_s: float) -> dict:
    """Phase 16: the blur kernel and extraction independent of the batch.
    (a) every blur call of phase 5's batch, 13c's subpixel batch, phase
    6's pair and 13b's parity frame, tiny planes whose radius reaches
    past their size and the edge planes of the tile plan, against the
    plain stencil bit for bit; (b)
    `extract_batch` of phase 5's frames at B=8 against B=1, 2 and 4, every
    field bit for bit (NaN-equal), in lowe, lowe with `subpixel` and
    parity; (c) phase 5's batch on the card against the CPU: images equal
    in every bit printed, phase 5's criteria held on every image; (d) the
    blur's time per batch and per pair. Returns the `kernels` line's blur
    row."""
    from sift_tpu_torch import SiftConfig, extract_batch
    from sift_tpu_torch.kernels import cuda as kcuda
    from sift_tpu_torch.kernels.cuda import blur as bk
    from sift_tpu_torch.kernels.gaussian import gaussian_kernel_1d
    t_phase = time.perf_counter()
    frames = torch.from_numpy(frames_np).cuda()
    pair = torch.from_numpy(match_pair()[0].copy()).cuda()
    parity_cfg = SiftConfig(mode="parity",
                            max_keypoints_per_octave=PARITY_CAPS[0],
                            max_keypoints=PARITY_CAPS[1])
    cells = {
        "batch": (frames, SiftConfig()),
        "subpixel": (frames, SiftConfig(subpixel=True)),
        "pair": (pair, SiftConfig(max_keypoints=MATCH_FEATURES,
                                  max_keypoints_per_octave=MATCH_FEATURES)),
        "parity": (torch.from_numpy(parity_frame(torch))[None].cuda(),
                   parity_cfg),
    }

    # (a) every blur call of each cell against the plain stencil
    calls, launches = {}, {}
    for label, (imgs, cfg) in cells.items():
        with recording({"blur": (bk, "blur")}) as (rec, orig):
            kcuda.reset_launch_counts()
            extract_batch(imgs, cfg)
            torch.cuda.synchronize()
            launches[label] = kcuda.launch_counts()["blur"]
        calls[label] = rec["blur"]
        kern = orig["blur"]
        for img, taps in calls[label]:
            if not same_bits(kern(img, taps), bk.blur_plain(img, taps)):
                raise Failed(f"phase 16a blur differs from the stencil at "
                             f"{tuple(img.shape)}, {len(taps)} taps")
        shapes = sorted({(tuple(a.shape), len(t)) for a, t in calls[label]})
        print(f"phase 16a {label}: {len(calls[label])} blur calls "
              f"({launches[label]} launches) bit-identical to the stencil; "
              f"(shape, taps) {shapes}", flush=True)
    if launches["batch"] != main_blurs:
        raise Failed(f"phase 16a: {launches['batch']} blurs a batch, the "
                     f"main path launched {main_blurs}")
    gen = torch.Generator(device="cuda").manual_seed(16)
    plans = []
    for shape, sigma, radius in ([(s, g, None) for s, g in BLUR_TINY]
                                 + BLUR_EDGE):
        # values of both signs, so that a sign or a -0 would show
        img = torch.rand(shape, generator=gen, device="cuda") * 255.0 - 60.0
        taps = gaussian_kernel_1d(sigma, radius=radius)
        plans.append(bk.tile_plan(*shape[-2:], (len(taps) - 1) // 2,
                                  shape[0]))
        if not same_bits(kern(img, taps), bk.blur_plain(img, taps)):
            raise Failed(f"phase 16a blur differs from the stencil at "
                         f"{shape}, {len(taps)} taps, plan {plans[-1]}")
    print(f"phase 16a tiny planes ({len(BLUR_TINY)}, radius >= their size) "
          f"and edge planes ({len(BLUR_EDGE)}) bit-identical to the "
          f"stencil; plans (TH, TW, S, smem) {plans}", flush=True)

    # (b) extract_batch at B=8 against B=1, 2 and 4, every field
    for mode, cfg in (("lowe", SiftConfig()),
                      ("subpixel", SiftConfig(subpixel=True)),
                      ("parity", SiftConfig(mode="parity"))):
        full = extract_batch(frames, cfg).to_numpy()
        for split in (1, 2, 4):
            for s in range(0, BATCH, split):
                part = extract_batch(frames[s:s + split], cfg).to_numpy()
                for i in range(split):
                    bad = fields_equal(part, full, i, s + i)
                    if bad:
                        raise Failed(f"phase 16b {mode}: image {s + i} at "
                                     f"B={split} differs from B={BATCH} "
                                     f"in {bad}")
        print(f"phase 16b {mode}: all {BATCH} images at B=1, 2 and 4 "
              f"bit-identical to B={BATCH} in every field "
              f"({int(full.valid.sum())} valid keypoints)", flush=True)

    # (c) phase 5's batch, card against the CPU
    card_kp = extract_batch(frames, SiftConfig()).to_numpy()
    cpu_kp = extract_batch(frames_np, SiftConfig(), device="cpu").to_numpy()
    same = [i for i in range(BATCH) if not fields_equal(card_kp, cpu_kp, i, i)]
    worst = (1.0, 1.0, 0.0)
    for i in range(BATCH):
        if not (cpu_kp.valid[i].any() or card_kp.valid[i].any()):
            continue                    # nothing found on either: agree
        fwd, wf = match_keypoints(cpu_kp, card_kp, i)
        back, wb = match_keypoints(card_kp, cpu_kp, i)
        worst = (min(worst[0], fwd), min(worst[1], back),
                 max(worst[2], wf, wb))
    print(f"phase 16c card vs CPU, phase 5's batch: {len(same)} of {BATCH} "
          f"images equal in every bit {same}; matched >= {worst[0]:.4f} / "
          f"{worst[1]:.4f}, max desc diff {worst[2]:.3g}", flush=True)
    if min(worst[:2]) < 0.99 or worst[2] > 2e-3:
        raise Failed("phase 16c: card and CPU disagree on phase 5's batch")

    # (d) the blur's time per batch and per pair
    t = {}
    for label in ("batch", "pair"):
        c = t[label] = {"ms": 0.0, "ms_stream": 0.0, "plain_ms": 0.0,
                        "library_ms": 0.0, "library_err": 0.0,
                        "bytes": 0.0, "ops": 0.0, "kernel_launches": 0.0}
        # one CUPTI session for all of the cell's calls; a trace is whole
        # only with one kernel launch a call
        dev, c["kernel_launches"], c["cupti_wait_s"] = kernel_trace(
            lambda: [kern(img, taps) for img, taps in calls[label]],
            KERNEL_SYMBOLS["blur"], 20, launches=len(calls[label]))
        if dev is None:
            raise Failed(f"phase 16d: no CUPTI trace of the {label}'s "
                         f"{len(calls[label])} blur calls held one kernel "
                         f"launch a call; the last, after a "
                         f"{c['cupti_wait_s']:g} s wait, held "
                         f"{c['kernel_launches']:g}")
        c["ms"] = dev
        for img, taps in calls[label]:
            c["ms_stream"] += event_ms(lambda: kern(img, taps), 20)
            c["plain_ms"] += event_ms(lambda: bk.blur_plain(img, taps), 3)
            lib = blur_library(torch, img, taps)
            c["library_ms"] += event_ms(lib, 3)
            c["library_err"] = max(c["library_err"], float(
                (lib().reshape(img.shape) - kern(img, taps)).abs().max()))
            b, o = kernel_work("blur", (img, taps))
            c["bytes"] += b
            c["ops"] += o
        c["timing"] = "cupti"
        c["bound_ms"], c["bound_by"] = bound(c["bytes"], c["ops"])
        if c["kernel_launches"] != launches[label]:
            raise Failed(f"phase 16d: {launches[label]} blur calls per "
                         f"{label}, {c['kernel_launches']:g} kernel launches "
                         "in their CUPTI trace")
        print(f"phase 16d blur per {label}: {launches[label]} calls, "
              f"{c['kernel_launches']:g} kernel launches (CUPTI, trace "
              f"whole after a {c['cupti_wait_s']:g} s wait), "
              f"{c['ms']:.4f} ms ({c['timing']}), stream "
              f"{c['ms_stream']:.4f} ms, bound {c['bound_ms']:.4f} ms "
              f"({c['bound_by']}), plain {c['plain_ms']:.3f} ms, library "
              f"(reflect pad + conv2d) {c['library_ms']:.3f} ms, within "
              f"{c['library_err']:.3g} of the kernel; card {card}",
              flush=True)
    print(f"phase 16d: phase 5 {kf_s:.2f} kf/s, phase 6 {pairs_s:.3f} "
          f"pairs/s; card {card}; phase 16 took "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    b, p = t["batch"], t["pair"]
    return {
        "name": "blur", "route": "cuda",
        "source": "sift_tpu_torch/csrc/blur.cu",
        "replaces": BLUR_REPLACES, "launches": main_blurs, "max_abs_err": 0.0,
        "ms": b["ms"], "ms_stream": b["ms_stream"], "timing": b["timing"],
        "plain_ms": b["plain_ms"], "bound_ms": b["bound_ms"],
        "bound_by": b["bound_by"], "library_ms": b["library_ms"],
        "library": "F.conv2d(F.pad(x, mode='reflect'), outer(taps, taps)), "
                   "TF32 off",
        f"launches_{MATCH_HEIGHT}x{MATCH_WIDTH}": launches["pair"],
        f"ms_{MATCH_HEIGHT}x{MATCH_WIDTH}": p["ms"],
        f"bound_ms_{MATCH_HEIGHT}x{MATCH_WIDTH}": p["bound_ms"],
        f"plain_ms_{MATCH_HEIGHT}x{MATCH_WIDTH}": p["plain_ms"],
        f"library_ms_{MATCH_HEIGHT}x{MATCH_WIDTH}": p["library_ms"],
        "launches_parity_frame": launches["parity"],
        "launches_subpixel_batch": launches["subpixel"],
    }


def public_edges(n: int) -> list:
    """8 window centres on and past both edges of an axis of n pixels: with
    those of the other axis, all four edges and corners. As in
    `lax.dynamic_slice`, a start past the near edge by less than n counts
    from the far end, and one past it by more is clamped to 0."""
    return [-n - 2, -5, 0, 7, n - 8, n - 1, n, n + 5]


@contextlib.contextmanager
def plain_extraction_kernels():
    """The window gather and the descriptor pass replaced by their plain
    versions (on the card's tensors) inside the block."""
    from sift_tpu_torch.kernels.cuda import descriptor, windows
    swaps = [(windows, "gather_windows", windows.gather_windows_plain),
             (descriptor, "descriptor_accumulate",
              descriptor.descriptor_accumulate_plain)]
    originals = [getattr(mod, attr) for mod, attr, _ in swaps]
    for mod, attr, fn in swaps:
        setattr(mod, attr, fn)
    try:
        yield
    finally:
        for (mod, attr, _), fn in zip(swaps, originals):
            setattr(mod, attr, fn)


def public_call(torch, label: str, fn):
    """fn() with the counts set to 0 just before and read just after, the
    hand kernel it must launch (PUBLIC_LAUNCHES) recorded. Returns (its
    result, the counts, the kernel's recorded arguments)."""
    from sift_tpu_torch.kernels import cuda as kcuda
    name = PUBLIC_LAUNCHES[label]
    targets = {name: extraction_kernels()[name]} if name else {}
    with recording(targets) as (recorded, _):
        kcuda.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        launches = kcuda.launch_counts()
    want = {k: int(k == name) for k in launches}
    if launches != want:
        raise Failed(f"phase 18 {label} launch counts {launches} != {want}")
    return out, launches, recorded.get(name, [])


def public_timing(label: str, fn, args) -> dict:
    """The CUPTI ms of fn's one kernel launch, its stream ms, the plain
    version's ms (`plain_extraction_kernels`) and the kernel's bound on its
    recorded arguments."""
    name = PUBLIC_LAUNCHES[label]
    ms, seen, wait = kernel_trace(fn, KERNEL_SYMBOLS[name], 20)
    if ms is None:
        raise Failed(f"phase 18 {label}: no whole CUPTI trace ({seen:g} "
                     "launches a call in the last)")
    with plain_extraction_kernels():
        plain_ms = event_ms(fn, 3)
    bound_ms, bound_by = bound(*kernel_work(name, args))
    return {"ms": ms, "ms_stream": event_ms(fn, 20), "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "cupti_wait_s": wait}


def public_api_phase(torch, card: str, frames, kp, cfg) -> tuple:
    """Phase 18: the public frontend API on phase 5's batch `frames` and
    its keypoints `kp`, each call with the counts set to 0 just before and
    read just after (`public_call`). (a) `gather_window` on image 0's
    octave-0 gradient map (dx of level 1, in the main path's window dtype)
    at every valid keypoint of image 0 and the PUBLIC_EDGE starts: one
    window-kernel launch, bit-identical to the plain version. (b)
    `descriptors_from_windows` on the main path's 48x48 windows of those
    keypoints (`gather_gradient_windows` on each octave's maps, all
    octaves in one call) at each keypoint's orientation: one
    descriptor-kernel launch; raw histograms within
    `descriptor.TOLERANCE` of the plain version's and descriptors within
    1e-3 of the largest, bit-identical to `descriptors_from_windows_multi`
    's peak 0 fed the orientation in both slots, and within phase 5's 2e-3
    of the main path's own descriptors. (c) `detect_extrema` on the
    batch's card pyramid against the same pyramid copied to the CPU: every
    field bit for bit; no kernel launched. Prints each kernel's CUPTI ms a
    launch beside the card. Returns ({kernel: launches over (a)-(c)},
    {kernel: timing})."""
    from sift_tpu_torch.frontend import extrema, orientation, windows
    from sift_tpu_torch.frontend.pyramid import Pyramid, build_pyramid
    from sift_tpu_torch.frontend.sift import _gradient_xy
    from sift_tpu_torch.kernels.cuda import descriptor
    from sift_tpu_torch.utils.device import constant
    t_phase = time.perf_counter()
    dev = frames.device
    pyr = build_pyramid(frames, cfg)
    kpn = kp.to_numpy()
    valid = kpn.valid[0]
    totals, timing = {}, {}

    def add(counts):
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v

    # (a) gather_window
    g0 = pyr.gauss[0][0]
    H, W = g0.shape[-2:]
    gmap = _gradient_xy(g0)[0][1].to(getattr(torch, cfg.window_dtype))
    scale = 2.0 ** kpn.octave[0][valid]
    ky = np.floor(kpn.y[0][valid] * scale).astype(np.int32)
    kx = np.floor(kpn.x[0][valid] * scale).astype(np.int32)
    ey, ex = np.meshgrid(public_edges(H), public_edges(W), indexing="ij")
    y = torch.from_numpy(np.concatenate([ky, ey.reshape(-1)]).astype(
        np.int32)).to(dev)
    x = torch.from_numpy(np.concatenate([kx, ex.reshape(-1)]).astype(
        np.int32)).to(dev)

    def gather():
        return orientation.gather_window(gmap, y, x)
    got, counts, args = public_call(torch, "gather_window", gather)
    add(counts)
    with plain_extraction_kernels():
        want = gather()
    if got.shape != (y.numel(), 16, 16) or not torch.equal(got, want):
        raise Failed("phase 18a gather_window differs from its plain version")
    timing["gather_windows"] = public_timing("gather_window", gather, args[0])
    t = timing["gather_windows"]
    print(f"phase 18a gather_window: {ky.size} keypoints + {ey.size} edge "
          f"starts of a {H}x{W} {cfg.window_dtype} map, bit-identical to "
          f"plain; 1 kernel launch {t['ms']:.4f} ms (CUPTI, trace whole "
          f"after a {t['cupti_wait_s']:g} s wait), stream "
          f"{t['ms_stream']:.4f} ms, bound {t['bound_ms']:.5f} ms "
          f"({t['bound_by']}), plain {t['plain_ms']:.3f} ms; card {card}",
          flush=True)

    # (b) descriptors_from_windows on the main path's windows
    octave_factor = cfg.k ** (cfg.dogs_per_epoch - 1)
    parts = []
    for o in range(pyr.num_octaves):
        sel = torch.from_numpy(np.flatnonzero(
            valid & (kpn.octave[0] == o))).to(dev)
        if not sel.numel():
            continue
        g = pyr.gauss[o][0]
        Ho, Wo = g.shape[-2:]
        r_eff = min(windows.R_DESC, Ho // 2, Wo // 2)
        if r_eff != windows.R_DESC:
            raise Failed(f"phase 18b: octave {o} ({Ho}x{Wo}) has no 48x48 "
                         "windows")
        sw = kp.scale[0][sel] / constant(octave_factor ** o, dev)
        gl = torch.argmin((constant(pyr.gauss_sigmas[o], dev)
                           - sw[:, None]).abs(), dim=-1)
        dxm, dym = _gradient_xy(g)
        wins, oy0, ox0 = windows.gather_gradient_windows(
            dxm, dym, gl, kp.y[0][sel], kp.x[0][sel], radius=r_eff,
            dtype=cfg.window_dtype)
        parts.append((wins, oy0, ox0, kp.orientation[0][sel], sw))
    wins, oy0, ox0, ori, sw = (torch.cat(c) for c in zip(*parts))
    dargs = (wins[:, 0], wins[:, 1], oy0, ox0, ori, sw, cfg)

    def describe():
        return windows.descriptors_from_windows(*dargs)
    got, counts, args = public_call(torch, "descriptors_from_windows",
                                    describe)
    add(counts)
    raw_err, raw_rel = hold_extraction_kernel(
        torch, descriptor.TOLERANCE, "descriptor_accumulate",
        descriptor.descriptor_accumulate(*args[0]),
        descriptor.descriptor_accumulate_plain(*args[0]))
    with plain_extraction_kernels():
        want = describe()
    err = float((got - want).abs().max())
    if got.shape != (ori.numel(), 128) or \
            err > 1e-3 * float(want.abs().max()):
        raise Failed(f"phase 18b descriptors_from_windows: {err} from plain")
    multi = windows.descriptors_from_windows_multi(
        wins, oy0, ox0, torch.stack([ori, ori], dim=1), sw, cfg)[:, 0]
    if not torch.equal(got, multi):
        raise Failed("phase 18b descriptors_from_windows differs from the "
                     "two-peak call's peak 0")
    main_err = float(np.abs(got.cpu().numpy() - kpn.desc[0][valid]).max())
    if main_err > 2e-3:
        raise Failed(f"phase 18b: {main_err} from the main path's "
                     "descriptors")
    t = public_timing("descriptors_from_windows", describe, args[0])
    n, d = wins.shape[0], wins.shape[-1]
    t["bound_ms_one_peak"], t["bound_by_one_peak"] = bound(
        n * (2 * d * d * 4 + descriptor.N_SCAL * 4 + 128 * 4),
        n * d * d * float(DESC_OPS_ONE_PEAK))
    timing["descriptor_accumulate"] = t
    print(f"phase 18b descriptors_from_windows: {n} keypoints of image 0, "
          f"raw within {raw_rel:.3g} of the largest bin ({raw_err:.3g}), "
          f"descriptors {err:.3g} from plain, bit-identical to the two-peak "
          f"call's peak 0, {main_err:.3g} from the main path's; 1 kernel "
          f"launch {t['ms']:.4f} ms (CUPTI, two peaks' work, trace whole "
          f"after a {t['cupti_wait_s']:g} s wait), stream "
          f"{t['ms_stream']:.4f} ms, bound {t['bound_ms']:.5f} ms "
          f"({t['bound_by']}; one peak's {t['bound_ms_one_peak']:.5f}), "
          f"plain {t['plain_ms']:.3f} ms; card {card}", flush=True)

    # (c) detect_extrema, card against the same pyramid on the CPU
    found, counts, _ = public_call(torch, "detect_extrema",
                                   lambda: extrema.detect_extrema(pyr, cfg))
    add(counts)
    cpu = extrema.detect_extrema(Pyramid(
        gauss=[g.cpu() for g in pyr.gauss], dogs=[g.cpu() for g in pyr.dogs],
        gauss_sigmas=pyr.gauss_sigmas, dog_sigmas=pyr.dog_sigmas,
        abs_sigmas=pyr.abs_sigmas), cfg)
    n_slots = sum(cfg.octave_cap(o) for o in range(pyr.num_octaves))
    for f, v in cpu.items():
        if not torch.equal(found[f].cpu(), v):
            raise Failed(f"phase 18c detect_extrema: {f} differs between "
                         "the card and the CPU")
    if found["x"].shape != (frames.shape[0], n_slots):
        raise Failed(f"phase 18c detect_extrema: x {tuple(found['x'].shape)}")
    print(f"phase 18c detect_extrema: {int(cpu['valid'].sum())} candidates "
          f"in {frames.shape[0]} x {n_slots} slots, n_dropped "
          f"{cpu['n_dropped'].tolist()}, every field bit-identical to the "
          f"CPU's; phase 18 launches {totals}; took "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return totals, timing


def finish(torch, card: str) -> int:
    """Print the card line and, as the last line, the result."""
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs the card",
              file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if _PORT_MISSING is not None:
        print("chip_smoke: sift_tpu_torch not found beside the script: "
              f"{_PORT_MISSING}", file=sys.stderr)
        return 2
    from sift_tpu_torch import SiftConfig, extract_batch
    from sift_tpu_torch.kernels import build
    from sift_tpu_torch.kernels import cuda as kcuda
    from sift_tpu_torch.kernels.cuda import descriptor

    t_main = time.perf_counter()
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
    try:
        atomics = sass_atomics(paths["descriptor"])
    except Failed as e:
        return fail(str(e))
    print(f"descriptor SASS atomics: {len(atomics)} {sorted(set(atomics))}",
          flush=True)
    if atomics:
        return fail("the descriptor kernel has atomic instructions")

    # 3. the main path, counted, with the kernels' arguments recorded
    cfg = SiftConfig()
    frames_np = make_frames(BATCH)
    frames = torch.from_numpy(frames_np).cuda()
    with recording(extraction_kernels()) as (recorded, originals):
        kcuda.reset_launch_counts()
        kp = extract_batch(frames, cfg)
        torch.cuda.synchronize()
        launches = kcuda.launch_counts()
    print(f"main path launches: {launches}", flush=True)
    try:
        hold_launches("main path", launches, EXPECTED_LAUNCHES)
    except Failed as e:
        return fail(str(e))

    # 4. each kernel against its plain version, on the recorded arguments
    plain = extraction_plain()
    rows = []
    for name, calls in recorded.items():
        kern = originals[name]
        err = rel = 0.0
        ms = ms_events = plain_ms = bytes_total = ops_total = 0.0
        cells = reads = 0
        device_seen = True
        for args in calls:
            got, want = kern(*args), plain[name](*args)
            torch.cuda.synchronize()
            try:
                e, r = hold_extraction_kernel(torch, descriptor.TOLERANCE,
                                              name, got, want)
            except Failed as exc:
                return fail(str(exc))
            if name == "descriptor_accumulate" and \
                    not torch.equal(got, kern(*args)):
                return fail("descriptor kernel differs between two launches "
                            f"at {tuple(args[0].shape)}")
            err, rel = max(err, e), max(rel, r)
            reps = 20
            ms_events += event_ms(lambda: kern(*args), reps)
            dev = kernel_trace(lambda: kern(*args), KERNEL_SYMBOLS[name],
                               reps)[0]
            if dev is None:
                device_seen = False
            else:
                ms += dev
            plain_ms += event_ms(lambda: plain[name](*args), 3)
            b, o = kernel_work(name, args)
            bytes_total += b
            ops_total += o
            if name == "refine_walk":
                cells += covered_cells(*args[:3])
                reads += walk_cells(*args)
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
        if name == "refine_walk":
            rows[-1].update(walk_cells=reads, covered_cells=cells)
        print(f"{name}: {len(calls)} calls ok, max_abs_err {err:.3g} "
              f"(relative to the largest output {rel:.3g}), "
              f"{rows[-1]['ms']:.4f} ms/batch ({rows[-1]['timing']}), stream "
              f"{ms_events:.4f} ms, plain {plain_ms:.3f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by})"
              + (f"; {reads} DoG cells read by the walks, {cells} covered "
                 "by the patches" if cells else ""), flush=True)
    try:
        n_win = hold_dog_gathers(torch, originals["gather_windows"],
                                 recorded["refine_walk"])
    except Failed as exc:
        return fail(str(exc))
    print(f"gather_windows f32 d=16 on the recorded DoG stacks: {n_win} "
          "windows bit-identical to plain", flush=True)
    from sift_tpu_torch.kernels.cuda import refine
    try:
        n_edge = refine_edge_cases(torch, refine, originals["refine_walk"])
    except Failed as exc:
        return fail(str(exc))
    print(f"refine_walk edge cases: {n_edge} ok (L = 3, 4, 7, 15; octaves "
          "under 16 px; all borders), bit-identical to plain", flush=True)
    try:
        n_edge = descriptor_edge_cases(torch, descriptor,
                                       originals["descriptor_accumulate"])
    except Failed as exc:
        return fail(str(exc))
    print(f"descriptor_accumulate edge cases: {n_edge} ok (d = 16, 30, 48; K "
          "= 1 and odd counts; zero windows; orientation-bin and cell edges; "
          "two identical peaks), each bit-identical over two launches",
          flush=True)

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

    try:
        hold_syncs(torch, lambda: extract_batch(frames, cfg),
                   f"{HEIGHT}x{WIDTH}")
    except Failed as e:
        return fail(str(e))
    reps = 20
    extract_batch(frames, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        extract_batch(frames, cfg)
    torch.cuda.synchronize()
    batch_s = (time.perf_counter() - t0) / reps
    busy_ms, wall_ms = profile_busy(
        torch, lambda: (extract_batch(frames, cfg), torch.cuda.synchronize()),
        "chip_smoke_profile.txt", card)
    print(f"extract_batch B={BATCH} {HEIGHT}x{WIDTH}: {batch_s * 1e3:.3f} "
          f"ms/batch, {BATCH / batch_s:.2f} kf/s; profiled batch device busy "
          f"{busy_ms:.3f} ms of {wall_ms:.3f} ms wall; card {card}",
          flush=True)

    # 6. the matching path at full width; 16. the blur kernel, run here,
    # beside the extraction cells it reads (after large profiles CUPTI's
    # records come late: `utils/timing.py::kernel_trace` waits for them)
    laps = {"1-5": round(time.perf_counter() - t_main, 1)}

    def lap(label, fn, *args):
        """fn(*args), its seconds kept in `laps` under `label` and printed
        (a run cut short still shows where its time went)."""
        t = time.perf_counter()
        out = fn(*args)
        laps[label] = round(time.perf_counter() - t, 1)
        print(f"phase {label}: {laps[label]} s, "
              f"{time.perf_counter() - t_main:.1f} s in all", flush=True)
        return out
    try:
        extraction_err, at_size, pair_kp, row = lap("6", match_phase, torch,
                                                    card)
        blur_row = lap("16", blur_phase, torch, card, frames_np,
                       launches["blur"], BATCH / batch_s, row["pairs_per_s"])
        public_launches, public_times = lap("18", public_api_phase, torch,
                                              card, frames, kp, cfg)
    except Failed as e:
        return fail(str(e))
    # 7. the two-view path; 8. bundle adjustment
    try:
        twoview_launches = lap("7", twoview_phase, torch, card)
        ba = lap("8", ba_phase, torch, card)
        sfm_launches, sfm_err = lap("9", sfm_phase, torch, card)
        loop_launches, loop_err, boot_calls = lap("10", loop_phase, torch,
                                                  card)
        chunked_launches, chunked_err = lap("11", chunked_phase, torch, card)
        stereo_launches, stereo_err = lap("12", stereo_phase, torch, card)
        sub_launches, sub_err, sub_timing, parity13 = lap(
            "13", parity_phase, torch, card)
        scan_row = lap("17", parity_scan_phase, torch, card, parity13)
        serve_launches, serve_err = lap(
            "14", serve_phase, torch, card, ba["window"]["state"], boot_calls)
        dist_launches, dist_err = lap("15", dist_phase, torch, card,
                                      frames_np, pair_kp, ba["scenes"])
    except Failed as e:
        return fail(str(e))
    print(f"phase seconds: {laps}; in all "
          f"{time.perf_counter() - t_main:.1f} s", flush=True)
    size = f"{MATCH_HEIGHT}x{MATCH_WIDTH}"
    for r in rows:
        r["launches_twoview"] = twoview_launches[r["name"]]
        r["launches_sfm"] = sfm_launches[r["name"]]
        r["max_abs_err_sfm"] = sfm_err[r["name"]]
        r["launches_loop"] = loop_launches[r["name"]]
        r["max_abs_err_loop"] = loop_err[r["name"]]
        r["launches_chunked"] = chunked_launches[r["name"]]
        r["max_abs_err_chunked"] = chunked_err[r["name"]]
        r["launches_stereo"] = stereo_launches[r["name"]]
        r["max_abs_err_stereo"] = stereo_err[r["name"]]
        r["launches_subpixel"] = sub_launches[r["name"]]
        r["max_abs_err_subpixel"] = sub_err[r["name"]]
        r["launches_serve"] = serve_launches[r["name"]]
        r["max_abs_err_serve"] = serve_err[r["name"]]
        r["launches_dist"] = dist_launches[r["name"]]
        r["max_abs_err_dist"] = dist_err[r["name"]]
        r.update({f"{k}_subpixel": v
                  for k, v in sub_timing[r["name"]].items()})
        r[f"max_abs_err_{size}"] = extraction_err[r["name"]]
        r["launches_public"] = public_launches[r["name"]]
        r.update({f"{k}_public": v
                  for k, v in public_times.get(r["name"], {}).items()})
        if r["name"] in at_size:
            t = at_size[r["name"]]
            r.update({f"ms_{size}": t["ms"],
                      f"ms_stream_{size}": t["ms_stream"],
                      f"bound_ms_{size}": t["bound_ms"]})
            r.update({f"{k}_{size}": t[k]
                      for k in ("walk_cells", "covered_cells") if k in t})
        if r["name"] == "descriptor_accumulate":
            r.update({"deterministic": True, "sass_atomics": len(atomics)})
    row["launches_twoview"] = twoview_launches["streaming_top2"]
    row["launches_sfm"] = sfm_launches["streaming_top2"]
    row["launches_loop"] = loop_launches["streaming_top2"]
    row["launches_chunked"] = chunked_launches["streaming_top2"]
    row["launches_stereo"] = stereo_launches["streaming_top2"]
    row["launches_subpixel"] = sub_launches["streaming_top2"]
    row["launches_serve"] = serve_launches["streaming_top2"]
    row["max_abs_err_serve"] = serve_err["streaming_top2"]
    row["launches_dist"] = dist_launches["streaming_top2"]
    row["max_abs_err_dist"] = dist_err["streaming_top2"]
    row["launches_public"] = public_launches["streaming_top2"]
    rows.append(row)
    for key, counts in (("twoview", twoview_launches), ("sfm", sfm_launches),
                        ("loop", loop_launches),
                        ("chunked", chunked_launches),
                        ("stereo", stereo_launches),
                        ("subpixel", sub_launches), ("serve", serve_launches),
                        ("dist", dist_launches)):
        blur_row[f"launches_{key}"] = counts["blur"]
    blur_row["launches_public"] = public_launches["blur"]
    rows.append(blur_row)
    scan_row["launches_serve_parity"] = serve_launches["parity_scan"]
    scan_row["launches_public"] = public_launches["parity_scan"]
    rows.append(scan_row)
    print(json.dumps({"kernels": rows}), flush=True)
    return finish(torch, card)


if __name__ == "__main__":
    sys.exit(main())
