"""Loads every traffic kind that BENCHMARK.json names before the
benchmark's tests are collected, so that a kind which declares its own
faults (`traffic/train_sharded.py`) has them in `harness/faults.py`'s
tables when `tests/test_bench_reference.py` lists each cell's faults."""

import os
import sys

BENCH = os.path.dirname(os.path.abspath(__file__))
for _p in (os.path.dirname(BENCH), BENCH):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from harness import registry  # noqa: E402

for _kind in sorted({w["traffic"] for w in registry.manifest()["workloads"]}):
    registry.traffic(_kind)
