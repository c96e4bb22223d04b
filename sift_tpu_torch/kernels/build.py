"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into its own
shared library with a plain C interface, loaded with ctypes. Libraries go
to `build/sift_tpu_torch/` at the repository root, named by a hash of the
source and flags, so an edited source is rebuilt and an unchanged one is
reused. Only the sources in this package are ever built. A failed build
raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "sift_tpu_torch"

_COMMON_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3", "-shared", "-Xcompiler", "-fPIC"]
# Per-source flags. The refine walk must round every product and sum on its
# own (no fused multiply-add), as the JAX walk does: a rounding tie moves a
# keypoint. So must the blur, to equal its plain stencil bit for bit. The
# descriptor takes CUDA's approximate division, sqrt and exp (inside
# atan2f, sqrtf, expf): its votes are continuous in them and stay within
# its tolerance, and the exact forms' special-case branches cost a fifth
# of its time. The parity scan promises plain adds, in the plain loop's
# order.
KERNELS = {
    "windows": [],
    "refine": ["-fmad=false"],
    "descriptor": ["-use_fast_math"],
    "match": [],
    "blur": ["-fmad=false"],
    "parity_scan": ["-fmad=false"],
}

_libs: dict = {}
_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _target(name: str) -> tuple[Path, list[str]]:
    src = CSRC / f"{name}.cu"
    flags = _COMMON_FLAGS + KERNELS[name]
    h = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so", flags


def build(names=None) -> dict:
    """Compile the named kernels (default: all) that are not built yet, one
    `nvcc` per source, all started together. Returns {name: library path}."""
    names = list(KERNELS) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, paths = {}, {}
    for name in names:
        out, flags = _target(name)
        paths[name] = out
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *flags, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    errors = []
    for name, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu (rc={p.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _libs[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {rc}")
