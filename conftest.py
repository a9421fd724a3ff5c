"""Repository-wide pytest set-up, run before any test module is collected.

The JAX package's native library (rendering_tpu/native/librt_native.so,
from native/rt_native.cpp) is built here once, on the controlling
process, before any pytest-xdist worker starts. tests/test_native.py
decides while it is collected whether the library loads; workers that
each start `make -C native` at once can find a half-written library,
fail to load it and skip that module. Built beforehand, every worker
finds it whole. A failed build changes nothing: the package builds or
falls back on its own, as without this file.
"""

import os
import subprocess

REPO = os.path.dirname(os.path.abspath(__file__))


def pytest_configure(config):
    if hasattr(config, "workerinput"):  # an xdist worker: already built
        return
    try:
        subprocess.run(["make", "-C", os.path.join(REPO, "native")],
                       capture_output=True, timeout=120, check=False)
    except (OSError, subprocess.TimeoutExpired):
        pass
