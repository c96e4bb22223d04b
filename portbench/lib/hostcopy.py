"""Device tensors to the host, through pinned buffers reused from step to
step (what a deployment reading every result would do)."""

from __future__ import annotations

from typing import Dict

import torch


class HostCopy:
    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self._buf: Dict[str, torch.Tensor] = {}

    def __call__(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Host copies of `tensors`, landed when this returns. The buffers
        are overwritten by the next call unless handed over."""
        if not self.cuda:
            return {k: v.detach().clone() for k, v in tensors.items()}
        out = {}
        for k, v in tensors.items():
            b = self._buf.get(k)
            if b is None or b.shape != v.shape or b.dtype != v.dtype:
                b = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                self._buf[k] = b
            b.copy_(v, non_blocking=True)
            out[k] = b
        torch.cuda.current_stream().synchronize()
        return out

    def hand_over(self, out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """`out`, the last call's result, kept by the caller: the next call
        copies into other buffers (the pinned cache reuses freed ones)."""
        self._buf = {}
        return out
