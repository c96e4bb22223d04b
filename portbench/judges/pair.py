"""Judge of step kind `pair`: a checked pair's keypoints, descriptors,
matches and homography.

Numbers:
- `kp_miss`, `desc_gap`: as for `extract` (`judges/extract.py`), over
  both images;
- `match_miss`: share of matches found on one side only, the program's
  matches mapped through the keypoint counterparts to the reference's
  slots, against the reference's own matches of its own descriptors;
- `match_dist_gap`: the largest gap between a program match's reported
  distance and the float32 squared distance of the two program
  descriptors it joins;
- `h_gap_px`: the largest distance, over the image's four corners, between
  the program's homography and the reference's RANSAC run on the
  program's own matched coordinates with the same noise (the fit alone,
  judged on the program's match set);
- `h_ref_gap_px`: the same distance to the reference's homography from
  its own pipeline: its keypoints, matches and RANSAC with the same noise.
`info` gives `h_true_px`, the corner distance to the generator's
homography.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.lib.compare import counterparts, desc_gap, match_miss
from portbench.reference import homography, matching, sift_lowe

NUMBERS = ("kp_miss", "desc_gap", "match_miss", "match_dist_gap", "h_gap_px",
           "h_ref_gap_px")


def image_xy(kp: dict, b: int, idx: torch.Tensor, subpixel: bool):
    """Original-image (x, y) of keypoints `idx` of image b: level
    coordinates times 2^octave, halved where the input was doubled."""
    f = torch.exp2(kp["octave"][b].to(torch.float32))
    if subpixel:
        f = f / 2.0
    return torch.stack([kp["x"][b][idx] * f[idx], kp["y"][b][idx] * f[idx]], -1)


def reference(config: dict, inputs: dict, prec=sift_lowe.EXACT) -> dict:
    """The reference pipeline's outputs for one pair, on the host, in the
    program's layout."""
    sub = bool(config["sift"].get("subpixel"))
    kp = sift_lowe.extract(inputs["images"], config["sift"], prec)
    m = matching.match(kp["desc"][0], kp["valid"][0], kp["desc"][1],
                       kp["valid"][1], config["match"], prec)
    pa = image_xy(kp, 0, m["idx_a"], sub)
    pb = image_xy(kp, 1, m["idx_b"], sub)
    H, n = homography.ransac(inputs["noise"], pa, pb, m["valid"],
                             config["ransac"], prec)
    out = {k: v.cpu() for k, v in kp.items()}
    out.update(idx_a=m["idx_a"].cpu(), idx_b=m["idx_b"].cpu(),
               distance=m["distance"].cpu(), match_valid=m["valid"].cpu(),
               H=H.cpu(), num_inliers=n.cpu(),
               success=(n >= config["ransac"]["min_inliers"]).cpu())
    return out


def _corners(config):
    h, w = config["image"]["height"], config["image"]["width"]
    return np.array([[0, 0], [w - 1, 0], [0, h - 1], [w - 1, h - 1]], float)


def corner_gap(H1, H2, corners) -> float:
    def mapped(H):
        q = np.c_[corners, np.ones(len(corners))] @ np.asarray(H, np.float64).T
        return q[:, :2] / q[:, 2:]
    d = np.linalg.norm(mapped(H1) - mapped(H2), axis=1).max()
    return float(d) if np.isfinite(d) else float("inf")


def numbers(config: dict, inputs: dict, prog: dict, ref: dict) -> dict:
    dev = inputs["images"].device
    sub = bool(config["sift"].get("subpixel"))
    miss = gap = 0.0
    ref_of = []
    for b in range(2):
        one = {k: prog[k][b] for k in sift_lowe.FIELDS}
        m, r = counterparts(one, {k: ref[k][b] for k in one}, dev)
        miss = max(miss, m)
        gap = max(gap, desc_gap(prog["desc"][b], ref["desc"][b], r))
        ref_of.append(r)
    pv = prog["match_valid"].to(dev)
    ia = prog["idx_a"].to(dev).long()[pv]
    ib = prog["idx_b"].to(dev).long()[pv]
    rv = ref["match_valid"].to(dev)
    mapped = torch.stack([ref_of[0][ia], ref_of[1][ib]], dim=1)
    own = torch.stack([ref["idx_a"].to(dev).long()[rv],
                       ref["idx_b"].to(dev).long()[rv]], dim=1)
    da = prog["desc"][0].to(dev)[ia]
    db = prog["desc"][1].to(dev)[ib]
    d32 = torch.clamp_min((da * da).sum(-1) + (db * db).sum(-1)
                          - 2.0 * (da * db).sum(-1), 0.0)
    dist_gap = float((prog["distance"].to(dev)[pv] - d32).abs().max()) \
        if ia.numel() else 0.0
    kp = {k: prog[k].to(dev) for k in ("x", "y", "octave")}
    pa = image_xy(kp, 0, prog["idx_a"].to(dev).long(), sub)
    pb = image_xy(kp, 1, prog["idx_b"].to(dev).long(), sub)
    H_fit, _ = homography.ransac(inputs["noise"], pa, pb, pv,
                                 config["ransac"], sift_lowe.EXACT)
    corners = _corners(config)
    return {"kp_miss": miss, "desc_gap": gap,
            "match_miss": match_miss(mapped, own),
            "match_dist_gap": dist_gap,
            "h_gap_px": corner_gap(prog["H"].numpy(), H_fit.cpu().numpy(),
                                   corners),
            "h_ref_gap_px": corner_gap(prog["H"].numpy(), ref["H"].numpy(),
                                       corners)}


def info(config: dict, inputs: dict, prog: dict) -> dict:
    out = {"matches": float(prog["match_valid"].sum()),
           "inliers": float(prog["num_inliers"])}
    if inputs.get("truth") is not None:
        out["h_true_px"] = corner_gap(prog["H"].numpy(), inputs["truth"],
                                      _corners(config))
    return out
