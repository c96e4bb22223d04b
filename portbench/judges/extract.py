"""Judge of step kind `extract`: every frame of a checked batch, the
program's keypoints and descriptors against the reference's.

Numbers: `kp_miss`, the largest share, over the batch's frames, of
keypoints with no counterpart on the other side (`lib/compare.py`);
`desc_gap`, the largest difference of a descriptor element between a
program keypoint's descriptor and its reference counterpart's, each
computed by its own side.
"""

from __future__ import annotations

import torch

from portbench.lib.compare import counterparts, desc_gap
from portbench.reference import sift_lowe

NUMBERS = ("kp_miss", "desc_gap")
_FRAMES_A_PASS = 16      # reference frames a pass (bounds its memory)


def reference(config: dict, inputs: dict, prec=sift_lowe.EXACT) -> dict:
    """The reference's outputs for one step, on the host, in the
    program's layout."""
    imgs = inputs["images"]
    def part(s):
        return sift_lowe.extract(imgs[s:s + _FRAMES_A_PASS], config["sift"],
                                 prec)
    parts = [part(s) for s in range(0, imgs.shape[0], _FRAMES_A_PASS)]
    return {k: torch.cat([p[k] for p in parts]).cpu() for k in parts[0]}


def image(out: dict, b: int) -> dict:
    return {k: out[k][b] for k in sift_lowe.FIELDS + ("desc",) if k in out}


def numbers(config: dict, inputs: dict, prog: dict, ref: dict) -> dict:
    dev = inputs["images"].device
    miss = gap = 0.0
    for b in range(prog["valid"].shape[0]):
        m, ref_of = counterparts(image(prog, b), image(ref, b), dev)
        miss = max(miss, m)
        gap = max(gap, desc_gap(prog["desc"][b], ref["desc"][b], ref_of))
    return {"kp_miss": miss, "desc_gap": gap}


def info(config: dict, inputs: dict, prog: dict) -> dict:
    return {"valid_per_frame_min": float(prog["valid"].sum(dim=1).min())}
