"""One run of one cell: set-up, the measured window, the trace's per-layer
numbers, the comparison with the reference, and the result line.

A traffic kind (`traffic/<kind>.py`) provides:
  setup(ctx) -> state        build, warm up every shape, run what the
                             comparison follows (set-up ends here)
  request(state) -> dict     one request of the window; "ok": False marks
                             a failed one
  finish(state, records)     wait for the device; mark requests whose
                             result turned out bad
  end_to_end(state, records, window_s) -> {metric: value}
  release(state)             drop the program's state, keep its outputs
  check(state, records, dtype) -> {number: value}, the reference's gaps
  control(state, records, dtype) -> the same numbers with the reference
                             in `dtype` put in the program's place
"""

from __future__ import annotations

import contextlib
import gc
import io
import json
import math
import os
import shutil
import sys
import tempfile
import time
import traceback
import types

import torch

from . import registry
from .trace import WINDOW, Trace, load

FORBIDDEN = ("jax", "jaxlib", "flax", "rendering_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _request(kind, state) -> dict:
    buf = io.StringIO()
    t = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rec = kind.request(state) or {}
    except Exception:  # a failed request is counted, the window goes on
        traceback.print_exc(file=sys.stderr)
        rec = {"ok": False}
    rec.setdefault("ok", True)
    rec["start"], rec["end"] = t, time.perf_counter()
    rec["stdout"] = buf.getvalue()
    if "paths were dropped" in rec["stdout"]:
        rec["ok"] = False
    return rec


def _window(kind, state, seconds: float, n_trace: int, device, workdir):
    """The closed loop: requests back to back until `seconds` have passed,
    the first n_trace under the profiler. Returns (records, window_s,
    trace events or None)."""
    records, events = [], None
    prof = mark = None
    if n_trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
        mark = torch.profiler.record_function(WINDOW)
        mark.__enter__()
    t0 = time.perf_counter()
    try:
        while True:
            records.append(_request(kind, state))
            if mark is not None and len(records) >= n_trace:
                _sync(device)
                mark.__exit__(None, None, None)
                mark = None
                prof.__exit__(None, None, None)
            if time.perf_counter() - t0 >= seconds:
                break
        kind.finish(state, records)
        _sync(device)
        window_s = time.perf_counter() - t0
    finally:
        if mark is not None:
            _sync(device)
            mark.__exit__(None, None, None)
            prof.__exit__(None, None, None)
    if prof is not None:
        path = os.path.join(workdir, "trace.json")
        prof.export_chrome_trace(path)
        events = load(path)
        os.remove(path)
    return records, window_s, events


def _describe_device(device) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device=None, t_start: float | None = None,
             overrides: dict | None = None) -> dict:
    """Run cell `name` once and return its result (the last key,
    "checks", holds each compared number beside its limit). `overrides`
    replaces scene settings (tests run tiny sizes on the CPU)."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = registry.manifest()
    cell = registry.workload(name)
    cfg = registry.config(cell["config"])
    kind = registry.traffic(cell["traffic"])
    device = torch.device(device or "cuda")
    workdir = tempfile.mkdtemp(prefix="rtbench-")
    try:
        ctx = types.SimpleNamespace(name=name, cell=cell, cfg=cfg, seed=seed,
                                    device=device, workdir=workdir,
                                    overrides=overrides or {})
        state = kind.setup(ctx)
        _sync(device)
        setup_s = time.perf_counter() - t_start
        n_trace = int(cell.get("trace_requests", 1)) if trace else 0
        records, window_s, events = _window(kind, state, seconds, n_trace,
                                            device, workdir)
        failed = sum(1 for r in records if not r["ok"])
        dev_info = _describe_device(device)
        result = {"correct": False, "attempted": len(records),
                  "failed": failed, "metrics": {}, "device": dev_info}
        if trace:
            tr = Trace(events)
            mctx = types.SimpleNamespace(trace=tr, n=n_trace,
                                         records=records[:n_trace], cell=name)
            for m in registry.cell_metrics(name, True, bench):
                value = registry.metric(m["name"]).read(mctx)
                if value is not None:
                    result["metrics"][m["name"]] = {"value": float(value),
                                                    "unit": m["unit"]}
            dev_info["busy_s"] = tr.busy_s
            dev_info["window_s"] = tr.window_s
            result["breakdown"] = {"device_ops": tr.top_ops(),
                                   "idle_gaps": tr.idle_gaps()}
        else:
            values = kind.end_to_end(state, records, window_s)
            values["setup_s"] = setup_s
            for m in registry.cell_metrics(name, False, bench):
                if m["name"] in values:
                    result["metrics"][m["name"]] = {
                        "value": float(values[m["name"]]), "unit": m["unit"]}
        kind.release(state)
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        found = forbidden_modules()
        if found:
            raise RuntimeError(f"modules of JAX or the JAX package loaded: "
                               f"{', '.join(found)}")
        t_ref = time.perf_counter()
        gaps = kind.check(state, records, torch.float32)
        lat = sorted(r["end"] - r["start"] for r in records)
        print(f"{name}: {len(records)} requests in {window_s:.3f} s "
              f"(latency min {lat[0]:.4f} median {lat[len(lat) // 2]:.4f} "
              f"max {lat[-1]:.4f} s); set-up {setup_s:.3f} s; reference "
              f"{time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
        limits = cell["limits"]
        checks = {k: {"value": float(v), "limit": float(limits[k])}
                  for k, v in gaps.items()}
        result["correct"] = bool(records) and all(
            math.isfinite(c["value"]) and c["value"] <= c["limit"]
            for c in checks.values())
        result["checks"] = checks
        return result
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def print_result(result: dict) -> None:
    """Each compared number beside its limit as the last lines of stderr,
    then the result as the last line of stdout."""
    for k, c in result["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
