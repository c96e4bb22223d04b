"""Comparison of keypoint sets and match sets, the program's against the
reference's.

Two keypoints are counterparts where octave and level are equal, x and y
(level coordinates) differ by at most `POS_TOL` and the orientations by
at most `ORI_TOL_DEG` around the circle.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

POS_TOL = 0.01
ORI_TOL_DEG = 0.1
_BLOCK = 1024


def _valid(kp: Dict[str, torch.Tensor], device):
    idx = torch.nonzero(kp["valid"].to(device), as_tuple=True)[0]
    cols = {f: kp[f].to(device)[idx] for f in ("x", "y", "octave", "level",
                                                 "orientation")}
    return idx, cols


def counterparts(prog: dict, ref: dict, device) -> Tuple[float, torch.Tensor]:
    """One image's keypoints: (share of keypoints on either side with no
    counterpart on the other, and for each program slot the lowest
    reference slot among its counterparts, -1 where none)."""
    pi, pc = _valid(prog, device)
    ri, rc = _valid(ref, device)
    slots = prog["valid"].shape[0]
    ref_of = torch.full((slots,), -1, dtype=torch.long, device=device)
    if pi.numel() + ri.numel() == 0:
        return 0.0, ref_of
    p_has = torch.zeros(pi.numel(), dtype=torch.bool, device=device)
    r_has = torch.zeros(ri.numel(), dtype=torch.bool, device=device)
    none = ri.numel()
    cols = torch.arange(none, device=device)
    for s in range(0, pi.numel(), _BLOCK):
        e = min(s + _BLOCK, pi.numel())
        dori = (pc["orientation"][s:e, None] - rc["orientation"][None, :]
                + 180.0).remainder(360.0) - 180.0
        same = ((pc["octave"][s:e, None] == rc["octave"][None, :])
                & (pc["level"][s:e, None] == rc["level"][None, :])
                & ((pc["x"][s:e, None] - rc["x"][None, :]).abs() <= POS_TOL)
                & ((pc["y"][s:e, None] - rc["y"][None, :]).abs() <= POS_TOL)
                & (dori.abs() <= ORI_TOL_DEG))
        p_has[s:e] = same.any(dim=1)
        r_has |= same.any(dim=0)
        if none:
            first = torch.where(same, cols, none).amin(dim=1)
            ref_of[pi[s:e]] = torch.where(first < none,
                                          ri[first.clamp_max(none - 1)], -1)
    missing = int((~p_has).sum()) + int((~r_has).sum())
    return missing / (pi.numel() + ri.numel()), ref_of


def desc_gap(prog_desc: torch.Tensor, ref_desc: torch.Tensor,
             ref_of: torch.Tensor) -> float:
    """The largest gap of a descriptor element between a program keypoint
    and its reference counterpart (`ref_of`, from `counterparts`), each
    side's descriptor its own; 0 where no keypoint has a counterpart."""
    slots = torch.nonzero(ref_of >= 0, as_tuple=True)[0]
    if slots.numel() == 0:
        return 0.0
    dev = ref_of.device
    got = prog_desc.to(dev)[slots]
    want = ref_desc.to(dev)[ref_of[slots]]
    return float((got - want).abs().max())


def match_miss(prog_pairs: torch.Tensor, ref_pairs: torch.Tensor) -> float:
    """Share of matches, (k, 2) index pairs into the reference's keypoint
    slots on both sides (-1 where a program keypoint has no counterpart),
    found on one side only."""
    n = prog_pairs.shape[0] + ref_pairs.shape[0]
    if n == 0:
        return 0.0
    base = int(max(prog_pairs.max().item() if prog_pairs.numel() else 0,
                   ref_pairs.max().item() if ref_pairs.numel() else 0)) + 2
    def keys(p):
        ok = (p >= 0).all(dim=1)
        return torch.where(ok, p[:, 0] * base + p[:, 1], -1 - torch.arange(
            p.shape[0], device=p.device))
    kp, kr = keys(prog_pairs), keys(ref_pairs)
    in_r = torch.isin(kp, kr)
    in_p = torch.isin(kr, kp)
    return (int((~in_r).sum()) + int((~in_p).sum())) / n
