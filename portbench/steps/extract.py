"""Step kind `extract`: one batch of frames through `extract_batch`.

Traffic keys: `batch`. Step i takes frames [i * batch, (i + 1) * batch)
of the scene, wrapping around its end, and ends when the batch's
keypoints and descriptors are on the host.

Spans: extract, read.
"""

from __future__ import annotations

import torch

from portbench.lib.hostcopy import HostCopy

KP_FIELDS = ("x", "y", "octave", "level", "scale", "score", "orientation",
             "valid", "desc")


class Step:
    def __init__(self, config: dict, traffic: dict, scene, seed: int, device):
        import sift_tpu_torch as port
        self.device = torch.device(device)
        self.scene = scene
        self.batch = traffic["batch"]
        n = scene.frames.shape[0]
        if n % self.batch:
            raise ValueError(f"{n} scene frames are no whole number of "
                             f"batches of {self.batch}")
        self.sift = port.SiftConfig(**config["sift"])
        self._extract = port.extract_batch
        self.copy = HostCopy(self.device)

    def item(self, i: int) -> int:
        """The first scene frame of step i's batch."""
        return (i * self.batch) % self.scene.frames.shape[0]

    def frames(self, i: int) -> torch.Tensor:
        s = self.item(i)
        return self.scene.frames[s:s + self.batch]

    def run(self, i: int, span) -> dict:
        imgs = self.frames(i)
        with span("extract"):
            kp = self._extract(imgs, self.sift, device=self.device)
        with span("read"):
            out = self.copy({f: getattr(kp, f) for f in KP_FIELDS})
        return out

    def inputs(self, i: int) -> dict:
        """What the reference is handed for step i: the same tensors."""
        return {"images": self.frames(i)}

    def keep(self, out: dict) -> dict:
        """The last step's outputs, made to outlive the next step."""
        return self.copy.hand_over(out)

    def failed(self, out: dict) -> bool:
        return bool((out["valid"].sum(dim=1) == 0).any())

    @staticmethod
    def stats(out: dict) -> dict:
        """Valid orientations and distinct keypoints (the two orientations
        of one keypoint sit side by side after the stable top-K)."""
        v = out["valid"]
        same = v[:, 1:] & v[:, :-1]
        for f in ("x", "y", "octave", "level"):
            same &= out[f][:, 1:] == out[f][:, :-1]
        n = float(v.sum())
        return {"orientations": n, "windows": n - float(same.sum())}

    def release(self):
        pass
