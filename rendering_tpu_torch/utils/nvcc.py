"""Builds a source of the port (rendering_tpu_torch/csrc) into a shared
library with a plain C interface, for binding through ctypes: a CUDA
source (`.cu`) with nvcc, the host runtime (`.cpp`) with g++.

Nothing is built at import time: a kernel module calls `build_library`
at its first launch, and the host runtime at its first use, so the
package imports on a host without nvcc.
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
# The host runtime: native/Makefile's flags. No FMA contraction (g++
# contracts by default where the target has FMA, as aarch64 does), no
# -ffast-math and no -march: the results stay bit-equal to the Python
# paths on any host CPU.
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-ffp-contract=off",
             "-shared")


def _nvcc() -> str | None:
    """Path of nvcc: on PATH, else the toolkit's default location."""
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    return path if os.path.exists(path) else None


def _gxx() -> str | None:
    """Path of g++ on PATH."""
    return shutil.which("g++")


def build_library(source: str) -> tuple[str, str]:
    """Compile `source` into BUILD_DIR: a `.cpp` with g++ and CXX_FLAGS,
    anything else with nvcc and NVCC_FLAGS. The library is named by the
    hash of the source and the flags (an edit rebuilds; a finished build
    is reused). It is written under a name of its own process and thread
    and renamed into place, so concurrent builds of one source never load
    a half-written file. Returns (library path, compiler output). Raises
    when the compiler is missing or the build fails, with the compiler's
    error output."""
    host = source.endswith(".cpp")
    name, flags = ("g++", CXX_FLAGS) if host else ("nvcc", NVCC_FLAGS)
    with open(source, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(flags).encode())
    stem = os.path.splitext(os.path.basename(source))[0]
    path = os.path.join(BUILD_DIR, f"lib{stem}-{digest.hexdigest()[:12]}.so")
    if os.path.exists(path):
        return path, ""
    compiler = _gxx() if host else _nvcc()
    if compiler is None:
        need = "a C++ compiler" if host else "the CUDA toolkit"
        raise RuntimeError(f"{name} not found: {need} is required to build "
                           f"rendering_tpu_torch's {source}")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run([compiler, *flags, "-o", tmp, source],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{name} failed building {source}:\n{proc.stderr}")
    os.replace(tmp, path)
    return path, proc.stdout + proc.stderr
