"""Command line of the PyTorch port (counterpart of `sift_tpu/cli.py`,
`match` subcommand only).

    python -m sift_tpu_torch.cli match a.png b.png [--device cuda|cpu]

Extracts both images (lowe mode), matches their descriptors (ratio test,
mutual), and verifies the matches with homography RANSAC, with the JAX
command's flags and output lines. `--device` (default `cuda`) picks where
everything runs; RANSAC draws from a `torch.Generator` seeded with 0 on
that device.
"""

from __future__ import annotations

import argparse
import math
import sys
import time

import numpy as np


def _add_reference_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("image", nargs="?", help="unused by `match`")
    p.add_argument("--img", "-i", dest="img", help="unused by `match`")
    p.add_argument("--sigma", "-s", type=float, default=1.6,
                   help="sigma of the Gaussian calculations (default 1.6)")
    p.add_argument("--k", "-k", type=float, default=math.sqrt(2.0),
                   help="scale-step constant (default sqrt(2))")
    p.add_argument("--octaves", "-o", type=int, default=4,
                   help="number of octaves (default 4)")
    p.add_argument("--dogsPerEpoch", "-d", dest="dogs_per_epoch", type=int,
                   default=3, help="DoGs per octave (default 3)")
    p.add_argument("--subpixel", "-p", type=int, default=0,
                   help="start from a 2x-upsampled image (not ported)")
    p.add_argument("--result", "-r", type=int, default=0,
                   help="unused by `match`")
    p.add_argument("--mode", choices=("lowe", "parity"), default="lowe",
                   help="'lowe' only; 'parity' is not ported")
    p.add_argument("--max-keypoints", type=int, default=1024)
    p.add_argument("--max-keypoints-per-octave", type=int, default=None,
                   help="per-octave candidate buffer capacity (default: "
                        "SiftConfig's)")
    p.add_argument("--rootsift", action="store_true",
                   help="RootSIFT descriptors: L1-normalize + sqrt")
    p.add_argument("--no-viz", action="store_true", help="unused by `match`")
    p.add_argument("--time", action="store_true",
                   help="print wall-clock timings of the three steps")
    p.add_argument("--pallas", choices=("auto", "on", "off"), default="auto",
                   help="carried for parity with the JAX CLI; 'off' is "
                        "refused on the card")
    p.add_argument("--window-dtype", choices=("float32", "bfloat16"),
                   default="float32",
                   help="gradient-map precision for the window gather")
    p.add_argument("--extrema-topk", choices=("exact", "approx"),
                   default="exact", help="'exact' only; 'approx' is not ported")


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


def cmd_match(args) -> int:
    import torch

    from sift_tpu_torch.config import MatchConfig, RansacConfig
    from sift_tpu_torch.frontend.sift import extract
    from sift_tpu_torch.geometry.homography import ransac_homography
    from sift_tpu_torch.io.image import load_image_gray
    from sift_tpu_torch.matching.matcher import match_descriptors, matched_coords

    if args.match_impl == "ivf":
        raise NotImplementedError("--match-impl ivf needs matching/ann.py, "
                                  "which is not ported")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _sift_config(args)
    mcfg = MatchConfig(ratio=args.ratio, impl=args.match_impl)

    t0 = time.perf_counter()
    kps = [extract(load_image_gray(f), cfg, True, device=args.device)
           for f in (args.image_a, args.image_b)]
    _sync(args.device)
    t1 = time.perf_counter()
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


def build_parser() -> argparse.ArgumentParser:
    top = argparse.ArgumentParser(
        prog="sift-tpu-torch",
        description="PyTorch/CUDA port of sift-tpu (match subcommand)")
    sub = top.add_subparsers(dest="command")
    pm = sub.add_parser("match", help="extract + match two images")
    pm.add_argument("image_a")
    pm.add_argument("image_b")
    pm.add_argument("--ratio", type=float, default=0.8)
    pm.add_argument("--match-impl", choices=("auto", "xla", "pallas", "ivf"),
                    default="auto",
                    help="top-2 backend: auto takes the streaming CUDA kernel "
                         "above 4096^2 pairs on the card; xla = dense; pallas "
                         "= streaming; ivf is not ported")
    pm.add_argument("--viz", help="write side-by-side match visualization")
    pm.add_argument("--device", default="cuda",
                    help="where to run: cuda (default) or cpu")
    _add_reference_flags(pm)
    pm.set_defaults(func=cmd_match)
    return top


def main(argv=None) -> int:
    args = build_parser().parse_args(sys.argv[1:] if argv is None else argv)
    if not hasattr(args, "func"):
        build_parser().print_help()
        return 1
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
