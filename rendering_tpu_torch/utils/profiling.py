"""Profiling — the port of `rendering_tpu.utils.profiling` on
`torch.profiler`.

The reference's only profiling is its RAII phase timers
(include/timer.h:8-40), which `utils.timer` copies. This module records
what ran underneath: the PyTorch operators on the host and, on a card,
every kernel with its device time (the hand-written intersection
kernels, launched through ctypes, among them: CUPTI sees each launch),
inside the port's own stages (`utils.tracing` spans, `rt.*`), and the
port's counters of the capture (`utils.tracing.counters`) as JSON beside
the trace.

Usage:
    with trace("/tmp/rt_trace"):
        render(scene)
    rows = op_profile("/tmp/rt_trace")      # -> [(op_name, time_ps), ...]

or from the CLI: `python -m rendering_tpu_torch scene.scene --trace-dir DIR`.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import time

import torch

from rendering_tpu_torch.device import resolve_device
from rendering_tpu_torch.utils import tracing

TRACE_SUFFIX = ".pt.trace.json"
COUNTERS_SUFFIX = ".counters.json"


@contextlib.contextmanager
def trace(logdir: str, device=None):
    """Capture a `torch.profiler` trace of the block into `logdir`: the
    host's operators, and the device's kernels, copies and sets when
    `device` is a card (the CUDA device unless `device` says otherwise).
    The card is synchronized before the capture stops, so no queued work
    escapes it; the trace is written as Chrome trace JSON,
    `<logdir>/trace_<ns>_<pid>.pt.trace.json`, and the capture's counters
    (`tracing.counters()`, from zero at its start) beside it as
    `trace_<ns>_<pid>.counters.json`. Yields the profiler."""
    device = resolve_device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    tracing.reset()
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    stem = os.path.join(logdir, f"trace_{time.time_ns()}_{os.getpid()}")
    prof.export_chrome_trace(stem + TRACE_SUFFIX)
    with open(stem + COUNTERS_SUFFIX, "w") as fh:
        json.dump(tracing.counters(), fh, indent=1, sort_keys=True)


def find_traces(logdir: str) -> list[str]:
    """The trace files under `logdir`, newest last."""
    return sorted(glob.glob(os.path.join(logdir, "**", "*" + TRACE_SUFFIX),
                            recursive=True), key=os.path.getmtime)


def op_profile(logdir: str, *, top: int = 20):
    """Time by name in the newest trace under `logdir`: [(name, time_ps),
    ...], the `top` largest, descending, in picoseconds as the JAX
    package's op_profile. A trace of a card sums its device kernels'
    durations; one without device kernels (the CPU) sums its operators'
    (`cpu_op` events, each operator's own span, nested calls within it
    counted again under their names)."""
    traces = find_traces(logdir)
    if not traces:
        raise FileNotFoundError(f"no {TRACE_SUFFIX} traces under {logdir}")
    with open(traces[-1]) as fh:
        events = [e for e in json.load(fh).get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e]
    cat = ("kernel" if any(e.get("cat") == "kernel" for e in events)
           else "cpu_op")
    totals: dict = {}
    for e in events:
        if e.get("cat") == cat:
            totals[e["name"]] = totals.get(e["name"], 0.0) + float(e["dur"])
    rows = sorted(((name, us * 1e6) for name, us in totals.items()),
                  key=lambda r: -r[1])
    return rows[:top]
