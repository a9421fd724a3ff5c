"""Per-layer numbers from a `torch.profiler` Chrome trace.

Device time is the union of the intervals of kernels, copies and sets.
A kernel is PyTorch's when the host call that launched it (matched by
its correlation id) lies inside an `aten::` operator, and the port's
hand-written kernel otherwise, whatever its name; a kernel whose launch
is not in the trace falls back to its name (PyTorch's and its libraries'
namespaces). A kernel belongs to the backward pass when its launch lies
inside an `autograd::engine::evaluate_function` span. The window is the
`bench_window` annotation the runner puts around the traced requests,
which ends after a synchronize.
"""

from __future__ import annotations

import bisect
import json

WINDOW = "bench_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
LIBRARY_NAMES = ("at::", "at_cuda_detail", "c10::", "cub::", "cublas",
                 "cutlass", "gemm", "gemv", "splitK", "nvjet", "sm90_",
                 "sm80_", "ampere_", "cudnn")


def load(path: str) -> list:
    """The complete ("X") events of a Chrome trace file."""
    with open(path) as fh:
        events = json.load(fh).get("traceEvents", [])
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def _spans(events, pred) -> dict:
    """{tid: (starts, ends)} of the merged spans of events matching pred."""
    by_tid: dict = {}
    for e in events:
        if e.get("cat") in ("cpu_op", "user_annotation") and pred(e["name"]):
            by_tid.setdefault(e.get("tid"), []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    out = {}
    for tid, iv in by_tid.items():
        merged = _merge(iv)
        out[tid] = ([a for a, _ in merged], [b for _, b in merged])
    return out


def _merge(intervals) -> list:
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _inside(spans: dict, tid, ts: float) -> bool:
    if tid not in spans:
        return False
    starts, ends = spans[tid]
    i = bisect.bisect_right(starts, ts) - 1
    return i >= 0 and ts <= ends[i]


class Trace:
    """A traced window: its device events classified."""

    def __init__(self, events: list):
        win = [e for e in events if e["name"] == WINDOW
               and e.get("cat") == "user_annotation"]
        if not win:
            raise ValueError(f"no {WINDOW!r} span in the trace")
        w = win[0]
        self.t0, self.t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        self.main_tid = w.get("tid")
        self.events = events
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS
                       and self.t0 <= float(e["ts"]) <= self.t1]
        launches = {}
        for e in events:
            if e.get("cat") in LAUNCH_CATS:
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    launches[corr] = e
        aten = _spans(events, lambda n: n.startswith("aten::"))
        backward = _spans(events, lambda n: n.startswith(
            "autograd::engine::evaluate_function"))
        self.kernels = []  # (event, is_torch, is_backward)
        for e in self.device:
            if e.get("cat") != "kernel":
                continue
            launch = launches.get((e.get("args") or {}).get("correlation"))
            if launch is None:
                is_torch = any(s in e["name"] for s in LIBRARY_NAMES)
                is_bwd = False
            else:
                ts, tid = float(launch["ts"]), launch.get("tid")
                is_torch = _inside(aten, tid, ts)
                is_bwd = _inside(backward, tid, ts)
            self.kernels.append((e, is_torch, is_bwd))

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def busy_intervals(self) -> list:
        iv = [(max(float(e["ts"]), self.t0),
               min(float(e["ts"]) + float(e["dur"]), self.t1))
              for e in self.device]
        return _merge([(a, b) for a, b in iv if b > a])

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def kernel_s(self, *, torch_side=None, backward=None) -> float:
        return sum(float(e["dur"]) for e, is_t, is_b in self.kernels
                   if (torch_side is None or is_t == torch_side)
                   and (backward is None or is_b == backward)) * 1e-6

    def top_ops(self, n: int = 10) -> list:
        tot: dict = {}
        for e in self.device:
            tot[e["name"]] = tot.get(e["name"], 0.0) + float(e["dur"]) * 1e-6
        return sorted(([k[:200], v] for k, v in tot.items()),
                      key=lambda r: -r[1])[:n]

    def idle_gaps(self, n: int = 10) -> list:
        """The n longest idle gaps of the device in the window, each
        named by the innermost host operator of the window's thread that
        spans its middle."""
        busy = self.busy_intervals()
        edges = [self.t0] + [x for ab in busy for x in ab] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
        ops = [e for e in self.events
               if e.get("cat") == "cpu_op" and e.get("tid") == self.main_tid]
        out = []
        for a, b in gaps:
            mid = 0.5 * (a + b)
            spanning = [e for e in ops if float(e["ts"]) <= mid
                        <= float(e["ts"]) + float(e["dur"])]
            name = (min(spanning, key=lambda e: float(e["dur"]))["name"]
                    if spanning else "host, outside any operator")
            out.append([name[:200], (b - a) * 1e-6])
        return out
