"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled with
``nvcc`` for ``sm_90a`` into a shared library under ``build/`` at the root
of the checkout, keyed by a hash of the source and the flags, then loaded
with ``ctypes``. The first use in a fresh checkout builds it (a few
seconds); later uses load the cached library. Nothing here runs at import
time: the CPU test suite imports this module on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}  # guarded-by: _lock


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    candidate = Path("/usr/local/cuda/bin/nvcc")  # the toolkit's default home
    if candidate.exists():
        return str(candidate)
    raise KernelBuildError(
        "nvcc not found on PATH or in /usr/local/cuda/bin: the CUDA kernels "
        "are compiled at first use and need the CUDA toolkit"
    )


def library_path(name: str) -> Path:
    """Where the build of ``csrc/<name>.cu`` lives: keyed by its content."""
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its keyed build exists; raise
    ``KernelBuildError`` carrying nvcc's stderr when the compile fails."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise KernelBuildError(
                f"nvcc failed ({proc.returncode}) on {name}.cu:\n{proc.stderr}"
            )
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            # Built under the lock: concurrent first callers wait for one
            # nvcc run instead of starting their own.
            lib = ctypes.CDLL(str(build(name)))
            _loaded[name] = lib
        return lib
