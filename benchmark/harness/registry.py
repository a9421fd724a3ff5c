"""Where the harness finds a cell's pieces, by the names in
BENCHMARK.json: the cell `workloads/<cell>.json`, its configuration
`configs/<config>.json`, its traffic kind `traffic/<kind>.py`, and each
per-layer metric `metrics/<metric>.py`. Adding a cell, a configuration
or a metric adds files; no file here names one."""

from __future__ import annotations

import importlib.util
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def manifest() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _json(kind: str, name: str) -> dict:
    path = os.path.join(BENCH_DIR, kind, f"{name}.json")
    if not os.path.exists(path):
        raise SystemExit(f"no {kind[:-1]} named {name!r} ({path})")
    with open(path) as fh:
        return json.load(fh)


def workload(name: str) -> dict:
    return _json("workloads", name)


def config(name: str) -> dict:
    cfg = _json("configs", name)
    cfg["_dir"] = os.path.join(BENCH_DIR, "configs")
    return cfg


def _module(kind: str, name: str):
    path = os.path.join(BENCH_DIR, kind, f"{name}.py")
    if not os.path.exists(path):
        raise SystemExit(f"no {kind} module named {name!r} ({path})")
    mod_name = f"_bench_{kind}_{name.replace('.', '_').replace('-', '_')}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def traffic(kind: str):
    return _module("traffic", kind)


def metric(name: str):
    return _module("metrics", name)


def reports(metric: dict, cell: str, bench: dict) -> bool:
    """Whether `cell` reports `metric`: listed under its "workloads", or,
    without that key, every cell that reports the metric it moves (an
    end-to-end metric without the key: every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    moves = metric.get("moves")
    if moves is None:
        return True
    target = next(m for m in bench["end_to_end"] if m["name"] == moves)
    return reports(target, cell, bench)


def cell_metrics(cell: str, trace: bool, bench: dict | None = None) -> list:
    """The metric entries a run of `cell` reports."""
    bench = bench or manifest()
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if reports(m, cell, bench)]
