"""The benchmark's CPU tests: `python -m pytest benchmark/tests` from the
repo root (the repo's own `pytest tests/` does not collect them)."""

import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)
