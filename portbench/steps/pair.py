"""Step kind `pair`: one image pair extracted, matched and verified.

A step calls `extract_batch` on the pair's two images (B = 2),
`match_descriptors` between them, and `ransac_homography` on the matched
original-image coordinates (halved where `subpixel` doubled the input), and ends when the homography, the matches and
both images' keypoints are on the host. Steps cycle through the scene's
pairs in order. Each pair's RANSAC noise is drawn from the seed in set-up.

Spans: extract, match, ransac, read.
"""

from __future__ import annotations

import torch

from portbench.lib.hostcopy import HostCopy
from portbench.lib.seeds import generator

KP_FIELDS = ("x", "y", "octave", "level", "scale", "score", "orientation",
             "valid")


def gumbel(shape, gen: torch.Generator, device) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=device)
    u = torch.clamp_min(u, torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


class Step:
    def __init__(self, config: dict, traffic: dict, scene, seed: int, device):
        import sift_tpu_torch as port
        from sift_tpu_torch.geometry.homography import ransac_homography
        from sift_tpu_torch.matching.matcher import (match_descriptors,
                                                     matched_coords)
        self.device = torch.device(device)
        self.scene = scene
        self.batch = 2                   # images a step extracts
        self.sift = port.SiftConfig(**config["sift"])
        self.match_cfg = port.MatchConfig(**config["match"])
        self.ransac_cfg = port.RansacConfig(**config["ransac"])
        self._extract = port.extract_batch
        self._match = match_descriptors
        self._coords = matched_coords
        self._ransac = ransac_homography
        gen = generator(seed, "pair/ransac", self.device)
        shape = (self.ransac_cfg.num_hypotheses, self.match_cfg.max_matches)
        self.noise = [gumbel(shape, gen, self.device) for _ in scene.pairs]
        self.copy = HostCopy(self.device)
        self._kp = None

    def item(self, i: int) -> int:
        """The scene pair that step i takes."""
        return i % len(self.scene.pairs)

    def run(self, i: int, span) -> dict:
        p = self.item(i)
        a, b = self.scene.pairs[p]
        frames = self.scene.frames
        imgs = frames[a:b + 1] if b == a + 1 else frames[[a, b]]
        with span("extract"):
            kp = self._extract(imgs, self.sift, device=self.device)
        with span("match"):
            m = self._match(kp.desc[0], kp.valid[0], kp.desc[1], kp.valid[1],
                            self.match_cfg)
        with span("ransac"):
            ka, kb = kp.map(lambda t: t[0]), kp.map(lambda t: t[1])
            pa, pb, ok = self._coords(ka, kb, m, self.sift.subpixel)
            est = self._ransac(self.noise[p], pa, pb, ok, self.ransac_cfg)
        with span("read"):
            out = {f: getattr(kp, f) for f in KP_FIELDS}
            out.update(idx_a=m.idx_a, idx_b=m.idx_b, distance=m.distance,
                       match_valid=m.valid, H=est.model,
                       num_inliers=est.num_inliers, success=est.success)
            out = self.copy(out)
        self._kp = kp
        return out

    def inputs(self, i: int) -> dict:
        """What the reference is handed for step i: the same tensors."""
        p = self.item(i)
        a, b = self.scene.pairs[p]
        return {"images": self.scene.frames[[a, b]], "noise": self.noise[p],
                "truth": self.scene.truth[p]}

    def keep(self, out: dict) -> dict:
        """A copy of the last step's outputs that outlives the next step,
        with both images' descriptors."""
        kept = dict(self.copy.hand_over(out))
        kept["desc"] = self._kp.desc.detach().cpu()
        return kept

    def failed(self, out: dict) -> bool:
        return not bool(out["success"])

    @staticmethod
    def stats(out: dict) -> dict:
        v = out["valid"]
        mv = out["match_valid"]
        return {"valid_a": float(v[0].sum()), "valid_b": float(v[1].sum()),
                "matches": float(mv.sum())}

    def release(self):
        self._kp = None
        self.noise = None
