"""Command line of the PyTorch port (counterpart of `sift_tpu/cli.py`,
`extract`, `match`, `twoview` and `sfm` subcommands).

    python -m sift_tpu_torch.cli img.png [-r 1] [--device cuda|cpu]
    python -m sift_tpu_torch.cli extract img.png [--mode parity|lowe] [-r 1]
    python -m sift_tpu_torch.cli match a.png b.png [--device cuda|cpu]
    python -m sift_tpu_torch.cli twoview a.png b.png [--fx F --fy F
        --cx C --cy C] [--device cuda|cpu]
    python -m sift_tpu_torch.cli sfm <sequence> [--format tum|kitti]
        [--traj out.txt] [--device cuda|cpu]

`extract` mirrors the reference executable (its flags and defaults,
parity mode by default; a bare image path means `extract`): it prints the
keypoint count, writes `<img>_orientation.png` (each keypoint a square of
side scale*10 at original-image coordinates, rotated by its orientation)
and with `-r 1` the tab table `interstpoints.txt` in the working
directory. `match` extracts both images (lowe mode), matches their
descriptors (ratio test, mutual), and verifies the matches with homography
RANSAC. `twoview` extracts and matches the same way, normalizes the
matched pixels by the intrinsics (default: focal = the larger image side,
principal point at the centre) and estimates the camera-B-from-camera-A
pose (5-point essential RANSAC, cheirality, Gauss-Newton polish). `sfm` runs the
incremental SfM/SLAM loop (`slam/pipeline.py::SfmPipeline`) over a TUM-RGBD
sequence (RGB-D unless `--no-depth`) or a KITTI odometry sequence
(monocular, or stereo with `--stereo`) and reports ATE and RPE against
the ground truth, with chunked tracking (`--chunked`), asynchronous window
BA (`--ba-async`), loop closure (`--loop-closure`, `--sim3`), landmark
compaction (`--compact-every`) and a final full-map BA (`--global-ba`) on
request, and a trajectory plot with `--plot`. Each takes the JAX
command's flags and prints its output lines; `match --match-impl ivf`
matches through the IVF-Flat index (`matching/ann.py`).
`--device` (default `cuda`) picks where everything runs; RANSAC draws
from a `torch.Generator` seeded with 0 on that device.
"""

from __future__ import annotations

import argparse
import math
import sys
import time

import numpy as np

SUBCOMMANDS = ("extract", "match", "twoview", "sfm")


def _add_reference_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("image", nargs="?", help="input image (`extract`)")
    p.add_argument("--img", "-i", dest="img",
                   help="the image on which sift will be executed")
    p.add_argument("--sigma", "-s", type=float, default=1.6,
                   help="sigma of the Gaussian calculations (default 1.6)")
    p.add_argument("--k", "-k", type=float, default=math.sqrt(2.0),
                   help="scale-step constant (default sqrt(2))")
    p.add_argument("--octaves", "-o", type=int, default=4,
                   help="number of octaves (default 4)")
    p.add_argument("--dogsPerEpoch", "-d", dest="dogs_per_epoch", type=int,
                   default=3, help="DoGs per octave (default 3)")
    p.add_argument("--subpixel", "-p", type=int, default=0,
                   help="start from a 2x-upsampled image (default 0)")
    p.add_argument("--result", "-r", type=int, default=0,
                   help="dump interest points to interstpoints.txt "
                        "(`extract`; default 0)")
    p.add_argument("--mode", choices=("lowe", "parity"), default="parity",
                   help="'parity' replicates the reference's behaviour; "
                        "'lowe' is the Lowe-2004 pipeline")
    p.add_argument("--max-keypoints", type=int, default=1024)
    p.add_argument("--max-keypoints-per-octave", type=int, default=None,
                   help="per-octave candidate buffer capacity (default: "
                        "SiftConfig's)")
    p.add_argument("--rootsift", action="store_true",
                   help="RootSIFT descriptors: L1-normalize + sqrt")
    p.add_argument("--no-viz", action="store_true",
                   help="skip writing <img>_orientation.png (`extract`)")
    p.add_argument("--time", action="store_true",
                   help="print wall-clock timings")
    p.add_argument("--pallas", choices=("auto", "on", "off"), default="auto",
                   help="carried for parity with the JAX CLI; 'off' is "
                        "refused on the card")
    p.add_argument("--window-dtype", choices=("float32", "bfloat16"),
                   default="float32",
                   help="gradient-map precision for the window gather")
    p.add_argument("--extrema-topk", choices=("exact", "approx"),
                   default="exact",
                   help="candidate selection; 'approx' (a TPU partial sort "
                        "in the JAX package, exact elsewhere) selects "
                        "exactly")


def _sift_config(args):
    from sift_tpu_torch.config import SiftConfig

    kw = {}
    if args.max_keypoints_per_octave is not None:
        kw["max_keypoints_per_octave"] = args.max_keypoints_per_octave
    return SiftConfig(
        sigma=args.sigma, k=args.k, octaves=args.octaves,
        dogs_per_epoch=args.dogs_per_epoch, subpixel=bool(args.subpixel),
        mode=args.mode, max_keypoints=args.max_keypoints,
        rootsift=args.rootsift, pallas=args.pallas,
        window_dtype=args.window_dtype, extrema_topk=args.extrema_topk, **kw)


def _sync(device: str) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def viz_geometry(x, y, octave, scale, orientation_deg, subpixel: bool):
    """Keypoint -> drawn-square geometry, the reference's transform
    (main.cpp:59-74): centre `loc * 2^octave / (2 if subpixel else 1)`,
    side `scale * 10`, angle the orientation in degrees. Returns (cx, cy,
    side, angle_deg) float64 arrays."""
    div = 2.0 if subpixel else 1.0
    factor = np.exp2(np.asarray(octave, np.float64)) / div
    cx = np.asarray(x, np.float64) * factor
    cy = np.asarray(y, np.float64) * factor
    side = np.asarray(scale, np.float64) * 10.0
    return cx, cy, side, np.asarray(orientation_deg, np.float64)


def square_corners(x: float, y: float, side: float, angle_deg: float):
    """The 4 corners of a side x side square centred at (x, y), rotated by
    `angle_deg` (cv::RotatedRect::points(): degrees, clockwise in image
    coordinates). Order: top-left, top-right, bottom-right, bottom-left of
    the unrotated square."""
    half = 0.5 * float(side)
    rad = math.radians(float(angle_deg))
    c, sn = math.cos(rad), math.sin(rad)
    return [(x + dx * c - dy * sn, y + dx * sn + dy * c)
            for dx, dy in ((-half, -half), (half, -half),
                           (half, half), (-half, half))]


def draw_keypoints(rgb: np.ndarray, xs, ys, sides, angles_deg,
                   color=(0, 0, 255)) -> np.ndarray:
    """Draw each keypoint as a rotated square outline, 1 px wide, on a
    copy of the (H, W, 3) image."""
    from PIL import Image, ImageDraw

    im = Image.fromarray(rgb.astype(np.uint8), mode="RGB")
    drw = ImageDraw.Draw(im)
    for x, y, s, a in zip(xs, ys, sides, angles_deg):
        pts = square_corners(float(x), float(y), float(s), float(a))
        drw.line([pts[0], pts[1], pts[2], pts[3], pts[0]], fill=color, width=1)
    return np.asarray(im)


def _dump_result_file(path: str, kps, descs) -> None:
    """The reference's result table (main.cpp:78-89), %g floats."""
    def g(v):
        return f"{float(v):g}"

    with open(path, "w") as out:
        out.write("Location\tscale\torientation\tdescriptors\n")
        for kp, d in zip(kps, descs):
            desc_str = "".join(g(v) + ", " for v in d)
            out.write(f"[{g(kp['x'])}, {g(kp['y'])}]\t{g(kp['scale'])}\t"
                      f"{g(kp['orientation'])}\t[{desc_str}]\n")


def cmd_extract(args) -> int:
    import torch

    from sift_tpu_torch.frontend.sift import extract
    from sift_tpu_torch.io.image import load_image_gray

    img_file = args.img or args.image
    if not img_file:
        print("error: no input image (use positional arg or --img/-i)",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _sift_config(args)
    gray = load_image_gray(img_file)

    t0 = time.perf_counter()
    kp = extract(gray, cfg, True, device=args.device).to_numpy()
    t1 = time.perf_counter()

    valid = kp.valid
    n = int(valid.sum())
    print(f"{n} interest points ({img_file}, mode={args.mode})")
    if kp.n_dropped is not None and int(kp.n_dropped) > 0:
        print(f"warning: {int(kp.n_dropped)} keypoints "
              f"exceeded the static buffer capacities and were dropped "
              f"(weakest-response first). Raise --max-keypoints-per-octave/"
              f"--max-keypoints; parity-mode output is NOT "
              f"reference-faithful while this warning prints.",
              file=sys.stderr)
    if kp.n_cand_pruned is not None and int(kp.n_cand_pruned) > 0:
        print(f"note: {int(kp.n_cand_pruned)} raw extrema candidates "
              f"beyond the per-octave cap were pruned weakest-first before "
              f"refinement (strongest-N selection, not silent loss).",
              file=sys.stderr)
    if args.time:
        print(f"extract wall time: {t1 - t0:.3f}s (includes the kernel "
              f"build on the first call)")

    xs, ys, sides, angles = viz_geometry(
        kp.x[valid], kp.y[valid], kp.octave[valid], kp.scale[valid],
        kp.orientation[valid], cfg.subpixel)
    if not args.no_viz:
        from PIL import Image

        from sift_tpu_torch.io.image import save_image_rgb

        with Image.open(img_file) as im:
            rgb = np.asarray(im.convert("RGB"))
        out_png = img_file + "_orientation.png"
        save_image_rgb(out_png, draw_keypoints(rgb, xs, ys, sides, angles))
        print(f"wrote {out_png}")

    if args.result:
        rows = [dict(x=kp.x[valid][i], y=kp.y[valid][i],
                     scale=kp.scale[valid][i],
                     orientation=kp.orientation[valid][i]) for i in range(n)]
        descs = kp.desc[valid] if kp.desc is not None else np.zeros((n, 128))
        _dump_result_file("interstpoints.txt", rows, descs)
        print("wrote interstpoints.txt")
    return 0


def cmd_match(args) -> int:
    import torch

    from sift_tpu_torch.config import MatchConfig, RansacConfig
    from sift_tpu_torch.frontend.sift import extract
    from sift_tpu_torch.geometry.homography import ransac_homography
    from sift_tpu_torch.io.image import load_image_gray
    from sift_tpu_torch.matching.matcher import match_descriptors, matched_coords

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _sift_config(args)
    mcfg = MatchConfig(ratio=args.ratio, impl=args.match_impl)

    t0 = time.perf_counter()
    kps = [extract(load_image_gray(f), cfg, True, device=args.device)
           for f in (args.image_a, args.image_b)]
    _sync(args.device)
    t1 = time.perf_counter()
    if args.match_impl == "ivf":
        m, index = match_ivf(kps, cfg, mcfg)
        n_overflow = int(index.n_overflow)
        if n_overflow:
            print(f"warning: IVF bucket overflow dropped {n_overflow} "
                  "descriptors")
    else:
        m = match_descriptors(kps[0].desc, kps[0].valid, kps[1].desc,
                              kps[1].valid, mcfg)
    n = int(m.count())
    t2 = time.perf_counter()
    print(f"{n} matches (ratio={mcfg.ratio}, mutual={mcfg.mutual})")

    pa, pb, valid = matched_coords(kps[0], kps[1], m)
    gen = torch.Generator(device=args.device).manual_seed(0)
    est = ransac_homography(gen, pa, pb, valid,
                            RansacConfig(inlier_threshold=3.0))
    num_inliers, success = int(est.num_inliers), bool(est.success)
    t3 = time.perf_counter()
    print(f"homography-verified inliers: {num_inliers} (success={success})")
    if success:
        H = est.model.double().cpu().numpy()
        print("H =\n", np.round(H / H[2, 2], 4))
    if args.time:
        print(f"extract {1e3 * (t1 - t0):.3f} ms (both images), match "
              f"{1e3 * (t2 - t1):.3f} ms, RANSAC {1e3 * (t3 - t2):.3f} ms "
              f"on {args.device}")

    if args.viz:
        from sift_tpu_torch.io.image import save_image_rgb
        from sift_tpu_torch.io.viz import side_by_side_matches

        img = side_by_side_matches(
            load_image_gray(args.image_a), load_image_gray(args.image_b),
            pa.cpu().numpy(), pb.cpu().numpy(), valid.cpu().numpy(),
            est.inliers.cpu().numpy())
        save_image_rgb(args.viz, img)
        print(f"wrote {args.viz}")
    return 0


def ivf_config(cfg):
    """The `match --match-impl ivf` index sizing: clusters of ~32
    keypoints (4 to 64 of them) and buckets of a quarter of the capacity
    (at least 128)."""
    from sift_tpu_torch.config import AnnConfig

    return AnnConfig(n_clusters=min(64, max(4, cfg.max_keypoints // 32)),
                     bucket_capacity=max(128, cfg.max_keypoints // 4))


def match_ivf(kps, cfg, mcfg, noise=None):
    """`match --match-impl ivf`: index image B's descriptors, probe with
    A's. `noise` seeds the k-means init (default: a generator seeded with
    0). Returns (Matches, IvfIndex)."""
    from sift_tpu_torch.matching.ann import build_ivf, match_descriptors_ann

    ann = ivf_config(cfg)
    index = build_ivf(kps[1].desc, kps[1].valid, ann, noise)
    m = match_descriptors_ann(kps[0].desc, kps[0].valid, index,
                              mcfg.replace(impl="auto"), ann)
    return m, index


def twoview_extract(grays, cfg, device):
    """`twoview` step 1: keypoints and descriptors of each (H, W) image."""
    from sift_tpu_torch.frontend.sift import extract

    return [extract(g, cfg, True, device=device) for g in grays]


def twoview_match(kps, ratio: float):
    """`twoview` step 2: (matches, pa, pb, valid) in original pixels."""
    from sift_tpu_torch.config import MatchConfig
    from sift_tpu_torch.matching.matcher import match_keypoints, matched_coords

    m = match_keypoints(kps[0], kps[1], MatchConfig(ratio=ratio))
    return (m, *matched_coords(kps[0], kps[1], m))


def default_intrinsics(height: int, width: int):
    """The JAX command's crude default: focal = max image dim, principal
    point = centre."""
    f = float(max(height, width))
    return f, f, width / 2.0, height / 2.0


def twoview_pose(pa, pb, valid, intrinsics, threshold: float, noise=None):
    """`twoview` step 3: normalize by (fx, fy, cx, cy) and estimate the
    relative pose. RANSAC draws from `noise`, a Gumbel tensor or a
    `torch.Generator`; by default a generator seeded with 0 on the points'
    device. Returns (R, t, TwoViewEstimate)."""
    import torch

    from sift_tpu_torch.config import RansacConfig
    from sift_tpu_torch.geometry.epipolar import estimate_relative_pose

    fx, fy, cx, cy = intrinsics
    na = torch.stack([(pa[:, 0] - cx) / fx, (pa[:, 1] - cy) / fy], -1)
    nb = torch.stack([(pb[:, 0] - cx) / fx, (pb[:, 1] - cy) / fy], -1)
    if noise is None:
        noise = torch.Generator(device=pa.device).manual_seed(0)
    return estimate_relative_pose(noise, na, nb, valid,
                                  RansacConfig(inlier_threshold=threshold),
                                  focal=fx)


def cmd_twoview(args) -> int:
    """Relative pose between two frames (essential RANSAC + GN polish)."""
    import torch

    from sift_tpu_torch.io.image import load_image_gray

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    grays = [load_image_gray(f) for f in (args.image_a, args.image_b)]
    intrinsics = (args.fx, args.fy, args.cx, args.cy)
    if args.fx is None:
        intrinsics = default_intrinsics(*grays[0].shape)

    t0 = time.perf_counter()
    kps = twoview_extract(grays, _sift_config(args), args.device)
    _sync(args.device)
    t1 = time.perf_counter()
    m, pa, pb, valid = twoview_match(kps, args.ratio)
    _sync(args.device)
    t2 = time.perf_counter()
    R, t, est = twoview_pose(pa, pb, valid, intrinsics, args.threshold)
    success = bool(est.success)
    t3 = time.perf_counter()
    print(f"matches: {int(m.count())}  inliers: {int(est.num_inliers)}  "
          f"success: {success}")
    print("R =\n", np.round(R.cpu().numpy(), 5))
    print("t =", np.round(t.cpu().numpy(), 5), "(unit scale)")
    if args.time:
        print(f"extract {1e3 * (t1 - t0):.3f} ms (both images), match "
              f"{1e3 * (t2 - t1):.3f} ms, relative pose "
              f"{1e3 * (t3 - t2):.3f} ms on {args.device}")
    return 0 if success else 1




def cmd_sfm(args) -> int:
    """Incremental SfM over an image sequence (TUM-RGBD or KITTI)."""
    import torch

    from sift_tpu_torch.config import PipelineConfig
    from sift_tpu_torch.eval.ate import (ate_rmse, poses_from_Rt, rpe_rmse,
                                         rpe_rmse_poses, umeyama_alignment)
    from sift_tpu_torch.io.datasets import load_kitti_odometry, load_tum_rgbd
    from sift_tpu_torch.slam.pipeline import SfmPipeline
    from sift_tpu_torch.utils.metrics import MetricsLogger

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.format == "tum":
        seq = load_tum_rgbd(args.path, max_frames=args.max_frames,
                            stride=args.stride)
    else:
        seq = load_kitti_odometry(args.path, sequence=args.sequence,
                                  max_frames=args.max_frames,
                                  stride=args.stride, stereo=args.stereo)
    use_stereo = args.format == "kitti" and args.stereo and \
        seq.baseline is not None and any(f.gray_right is not None
                                         for f in seq)

    logger = MetricsLogger(args.metrics) if args.metrics else None
    kw = {}
    if args.chunked:
        kw["chunked_tracking"] = True
    if args.ba_async:
        kw["ba_async"] = True
    if args.loop_closure or args.sim3:
        kw["enable_loop_closure"] = True
    if args.sim3:
        kw["pose_graph_sim3"] = True
    if args.window:
        kw["window_size"] = args.window
    if args.compact_every:
        kw["compact_interval_kf"] = args.compact_every
    pipe = SfmPipeline(seq.intrinsics, PipelineConfig(**kw), logger=logger,
                       device=args.device,
                       stereo_baseline=seq.baseline if use_stereo else None)
    use_depth = args.format == "tum" and not args.no_depth
    t0 = time.perf_counter()
    # Stereo batching needs every right frame (fixed chunk shapes); a
    # sequence with missing right images takes the per-frame path, which
    # tracks those frames monocular.
    all_rights = use_stereo and all(f.gray_right is not None for f in seq)
    if args.batch > 1 and (not use_stereo or all_rights):
        results = pipe.process_sequence(
            [f.gray for f in seq],
            depths=[f.depth for f in seq] if use_depth else None,
            rights=[f.gray_right for f in seq] if use_stereo else None,
            batch=args.batch)
    else:
        results = [pipe.process_frame(
            f.gray, depth=f.depth if use_depth else None,
            right=f.gray_right if use_stereo else None) for f in seq]
        pipe.finalize()
    if args.verbose:
        for r in results:
            print(f"frame {r['frame_idx']}: tracked={r['tracked']} "
                  f"kf={r['is_keyframe']} inliers={r['n_inliers']}")
    dt = time.perf_counter() - t0
    print(f"{len(seq)} frames in {dt:.1f}s ({len(seq)/dt:.1f} fps), "
          f"{len(pipe.keyframes)} keyframes, "
          f"{pipe.landmarks.shape[0]} landmarks")
    if args.global_ba:
        stats = pipe.run_global_ba()
        print(f"global BA: {stats['n_cams']} cams / {stats['n_lms']} lms / "
              f"{stats['n_obs']} obs, reproj RMSE {stats['rmse']:.3f} px")

    gt = seq.gt_positions()
    if gt is not None and len(pipe.trajectory) == gt.shape[0]:
        # RGB-D and stereo trajectories are metric (rigid alignment);
        # monocular ones are scale-free (similarity alignment). One
        # alignment serves ATE and RPE.
        metric = use_depth or use_stereo
        est = np.asarray(pipe.positions(), np.float64)
        gt64 = np.asarray(gt, np.float64)
        s, R, t = umeyama_alignment(est, gt64, with_scale=not metric)
        est_aligned = (s * (R @ est.T)).T + t
        ate = ate_rmse(est_aligned, gt64, align=False)
        kind = "se3" if metric else "sim3"
        print(f"ATE RMSE ({kind}-aligned): {ate:.4f} m")
        gtT = seq.gt_poses()
        if gtT is not None:
            Rs, ts = pipe.poses_Rt()
            rpe = rpe_rmse_poses(poses_from_Rt(Rs, ts), gtT, delta=1, scale=s)
            print(f"RPE RMSE (TUM, delta=1): {rpe:.4f} m")
        else:
            rpe = rpe_rmse(est_aligned, gt64, delta=1)
            print(f"RPE RMSE (position-delta, delta=1, {kind}-aligned): "
                  f"{rpe:.4f} m")
    if args.traj:
        if args.traj_format == "tum":
            from sift_tpu_torch.io.trajectory import save_tum
            Rs, ts = pipe.poses_Rt()
            stamps = [f.timestamp for f in seq][:ts.shape[0]]
            save_tum(args.traj, Rs, ts, timestamps=stamps)
        else:
            np.savetxt(args.traj, pipe.positions())
        print(f"wrote {args.traj}")
    if args.plot:
        from sift_tpu_torch.io.viz import plot_trajectory
        plot_trajectory(pipe.positions(), gt, path=args.plot,
                        title=f"{seq.name} trajectory")
        print(f"wrote {args.plot}")
    if args.ply:
        from sift_tpu_torch.io.trajectory import save_ply
        lms = pipe.landmarks
        finite = np.isfinite(lms).all(axis=1)
        save_ply(args.ply, lms[finite])
        print(f"wrote {args.ply} ({int(finite.sum())} points)")
    return 0


def build_parser() -> argparse.ArgumentParser:
    top = argparse.ArgumentParser(
        prog="sift-tpu-torch",
        description="PyTorch/CUDA port of sift-tpu (reference-compatible "
                    "extract, match, twoview and sfm subcommands)")
    sub = top.add_subparsers(dest="command")
    pe = sub.add_parser("extract",
                        help="extract SIFT keypoints (reference-compatible)")
    pe.add_argument("--device", default="cuda",
                    help="where to run: cuda (default) or cpu")
    _add_reference_flags(pe)
    pe.set_defaults(func=cmd_extract)

    pm = sub.add_parser("match", help="extract + match two images")
    pm.add_argument("image_a")
    pm.add_argument("image_b")
    pm.add_argument("--ratio", type=float, default=0.8)
    pm.add_argument("--match-impl", choices=("auto", "xla", "pallas", "ivf"),
                    default="auto",
                    help="top-2 backend: auto takes the streaming CUDA kernel "
                         "above 4096^2 pairs on the card; xla = dense; pallas "
                         "= streaming; ivf = the approximate IVF-Flat index "
                         "over image B")
    pm.add_argument("--viz", help="write side-by-side match visualization")
    pm.add_argument("--device", default="cuda",
                    help="where to run: cuda (default) or cpu")
    _add_reference_flags(pm)
    # Parity descriptors cannot discriminate (every histogram's mass is in
    # bin 0), so the matching commands default to lowe; `extract` keeps
    # the reference executable's parity default.
    pm.set_defaults(func=cmd_match, mode="lowe")

    pt = sub.add_parser("twoview", help="relative pose between two frames")
    pt.add_argument("image_a")
    pt.add_argument("image_b")
    pt.add_argument("--ratio", type=float, default=0.8)
    pt.add_argument("--threshold", type=float, default=2.0,
                    help="RANSAC inlier threshold in pixels")
    pt.add_argument("--fx", type=float)
    pt.add_argument("--fy", type=float)
    pt.add_argument("--cx", type=float)
    pt.add_argument("--cy", type=float)
    pt.add_argument("--device", default="cuda",
                    help="where to run: cuda (default) or cpu")
    _add_reference_flags(pt)
    pt.set_defaults(func=cmd_twoview, mode="lowe")

    ps = sub.add_parser("sfm", help="incremental SfM over a sequence")
    ps.add_argument("path", help="sequence directory (TUM) or dataset root "
                                 "(KITTI)")
    ps.add_argument("--format", choices=("tum", "kitti"), default="tum")
    ps.add_argument("--sequence", default="00", help="KITTI sequence id")
    ps.add_argument("--max-frames", type=int)
    ps.add_argument("--stride", type=int, default=1)
    ps.add_argument("--metrics", help="JSONL metrics output path")
    ps.add_argument("--no-depth", action="store_true",
                    help="ignore TUM depth maps (pure monocular)")
    ps.add_argument("--batch", type=int, default=8,
                    help="frontend extraction batch size (1 = per-frame)")
    ps.add_argument("--traj", help="write trajectory positions to this file")
    ps.add_argument("--traj-format", choices=["xyz", "tum"], default="xyz",
                    help="trajectory file dialect: bare xyz rows, or the "
                         "TUM grammar (ts tx ty tz qx qy qz qw)")
    ps.add_argument("--ply", help="write the sparse landmark map as an "
                                  "ASCII PLY point cloud")
    ps.add_argument("--verbose", action="store_true")
    ps.add_argument("--window", type=int, default=None,
                    help="sliding BA window size (keyframes)")
    ps.add_argument("--device", default="cuda",
                    help="where to run: cuda (default) or cpu")
    ps.add_argument("--stereo", action="store_true",
                    help="KITTI: use image_1 for stereo depth (metric scale)")
    ps.add_argument("--chunked", action="store_true",
                    help="device-resident chunked tracking (one stage and "
                         "one read per extraction batch)")
    ps.add_argument("--ba-async", action="store_true",
                    help="deferred (asynchronous) window BA")
    ps.add_argument("--plot", help="write a top-down trajectory plot (PNG)")
    # Loop closure and map maintenance.
    ps.add_argument("--loop-closure", action="store_true",
                    help="enable loop closure + pose-graph optimization")
    ps.add_argument("--sim3", action="store_true",
                    help="Sim(3) pose graph (monocular scale drift); implies "
                         "--loop-closure")
    ps.add_argument("--compact-every", type=int, default=0, metavar="N",
                    help="compact landmark ids every N keyframes (0 = off)")
    ps.add_argument("--global-ba", action="store_true",
                    help="run a full-map bundle adjustment after the "
                         "sequence")
    ps.set_defaults(func=cmd_sfm)
    return top


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    # Reference compatibility: arguments without a subcommand (a bare
    # image path, or --img) mean `extract`, as the reference binary.
    if not argv or (argv[0] not in SUBCOMMANDS
                    and argv[0] not in ("-h", "--help")):
        argv = ["extract"] + argv
    args = build_parser().parse_args(argv)
    if not hasattr(args, "func"):
        build_parser().print_help()
        return 1
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
