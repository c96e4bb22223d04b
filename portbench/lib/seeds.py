"""Random streams derived from a run's `--seed`: the same seed and stream
name give the same numbers on every run."""

from __future__ import annotations

import hashlib

import torch


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for stream `stream` of run seed `seed` (any integer)."""
    digest = hashlib.sha256(f"{int(seed)}/{stream}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, stream: str, device="cpu") -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, stream))
    return gen
