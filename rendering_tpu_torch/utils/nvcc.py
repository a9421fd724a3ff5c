"""Builds a CUDA source of the port (rendering_tpu_torch/csrc) into a
shared library with a plain C interface, for binding through ctypes.

Nothing is built at import time: a kernel module calls `build_library`
at its first launch, so the package imports on a host without nvcc.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "rendering_tpu_torch")
# sm_90a (Hopper), no FMA contraction, IEEE division; -Xptxas -v prints
# each kernel's registers, shared memory and spills into the log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str | None:
    """Path of nvcc: on PATH, else the toolkit's default location."""
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    return path if os.path.exists(path) else None


def build_library(source: str, flags=NVCC_FLAGS) -> tuple[str, str]:
    """Compile `source` with nvcc and `flags` into BUILD_DIR, named by the
    hash of the source and the flags (an edit rebuilds; a finished build
    is reused). The library is written under a temporary name and renamed,
    so concurrent builds of one source never load a half-written file.
    Returns (library path, compiler output). Raises when nvcc is missing
    or the build fails."""
    with open(source, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(flags).encode())
    stem = os.path.splitext(os.path.basename(source))[0]
    path = os.path.join(BUILD_DIR, f"lib{stem}-{digest.hexdigest()[:12]}.so")
    if os.path.exists(path):
        return path, ""
    nvcc = _nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is required to "
                           "build rendering_tpu_torch's kernels")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run([nvcc, *flags, "-o", tmp, source],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed building {source}:\n{proc.stderr}")
    os.replace(tmp, path)
    return path, proc.stdout + proc.stderr
