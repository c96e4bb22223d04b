"""Hand-written CUDA kernels of the port, one module each, with their
plain PyTorch versions and launch counters."""

from sift_tpu_torch.kernels.cuda import (blur, descriptor, match,
                                        parity_scan, refine, windows)

_MODULES = {"gather_windows": windows, "refine_walk": refine,
            "descriptor_accumulate": descriptor, "streaming_top2": match,
            "blur": blur, "parity_scan": parity_scan}


def launch_counts() -> dict:
    """Kernel launches since the last `reset_launch_counts`, by kernel."""
    return {name: mod.LAUNCHES for name, mod in _MODULES.items()}


def reset_launch_counts() -> None:
    for mod in _MODULES.values():
        mod.LAUNCHES = 0
