"""Global descriptor index: brute-force place recognition (counterpart of
`sift_tpu/matching/global_index.py`).

The index keeps every keyframe's L2-normalized descriptors in one stacked
(C, Nk, D) bf16 tensor on the device (256 x 1024 x 128 at the pipeline's
defaults: 64 MiB). A query scores its normalized bf16 descriptors against
each keyframe with f32 accumulation and reduces to per-keyframe VOTE
counts: queries whose best cosine similarity in that keyframe clears a
threshold. The SLAM layer probes the top voted keyframes as
relocalization candidates.

The bf16 operands are widened to f32 before the product: a product of two
bf16 values is exact in f32, so this is the JAX package's bf16 product
with f32 accumulation (`preferred_element_type=f32`), which a bf16
`torch.matmul` would round to bf16 at the output. Keyframes are scored in
chunks (as `lax.map` scores them one at a time), so the (N, C * Nk)
similarity matrix is never built, and only the slots up to the last used
one are scored (unused slots vote 0 either way).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

_CHUNK = 16   # keyframes scored per product


def _normalize(desc: torch.Tensor) -> torch.Tensor:
    n = torch.clamp_min(torch.linalg.vector_norm(desc, dim=-1, keepdim=True),
                        1e-12)
    return desc / n


class GlobalDescriptorIndex:
    """Fixed-capacity per-keyframe descriptor bank on the device."""

    def __init__(self, capacity_kf: int, n_per_kf: int, dim: int = 128,
                 device="cuda"):
        self.capacity_kf = capacity_kf
        self.n_per_kf = n_per_kf
        self.device = torch.device(device)
        self._bank = torch.zeros((capacity_kf, n_per_kf, dim),
                                 dtype=torch.bfloat16, device=self.device)
        self._bank_valid = torch.zeros((capacity_kf, n_per_kf),
                                       dtype=torch.bool, device=self.device)
        self._used = np.zeros((capacity_kf,), bool)

    def add(self, kf_index: int, desc: torch.Tensor,
            valid: torch.Tensor) -> None:
        """Install keyframe `kf_index`'s descriptors (tensors on the index's
        device), L2-normalized, in place in the bank."""
        if kf_index >= self.capacity_kf:
            return                       # over capacity: index degrades
        self._bank[kf_index].copy_(_normalize(desc.to(torch.float32)))
        self._bank_valid[kf_index].copy_(valid)
        self._used[kf_index] = True

    def query(self, desc_q: torch.Tensor, valid_q: torch.Tensor,
              sim_threshold: float = 0.85) -> np.ndarray:
        """(C,) per-keyframe vote counts for the query descriptor set (one
        small host read). Unused slots vote 0."""
        qn = _normalize(desc_q.to(torch.float32)).to(torch.bfloat16)
        qn = qn.to(torch.float32)
        used = np.nonzero(self._used)[0]
        hi = int(used[-1]) + 1 if used.size else 0
        out = torch.zeros((self.capacity_kf,), dtype=torch.int32,
                          device=self.device)
        for c0 in range(0, hi, _CHUNK):
            c1 = min(c0 + _CHUNK, hi)
            bank = self._bank[c0:c1].to(torch.float32)          # (c, Nk, D)
            sims = torch.matmul(qn, bank.transpose(1, 2))       # (c, N, Nk)
            sims = torch.where(self._bank_valid[c0:c1, None, :], sims, -1.0)
            best = sims.amax(dim=-1)                            # (c, N)
            out[c0:c1] = ((best > sim_threshold) & valid_q).sum(dim=-1).to(
                torch.int32)
        votes = out.cpu().numpy().copy()
        votes[~self._used] = 0
        return votes

    def top_candidates(self, desc_q, valid_q, k: int,
                       exclude_from: Optional[int] = None,
                       min_votes: int = 1) -> np.ndarray:
        """Indices of the top-k voted keyframes (descending), optionally
        excluding indices >= `exclude_from` (the covisible tail)."""
        votes = self.query(desc_q, valid_q)
        if exclude_from is not None:
            votes[exclude_from:] = 0
        order = np.argsort(-votes)
        order = order[votes[order] >= min_votes]
        return order[:k]
