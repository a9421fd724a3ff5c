"""The program's own spans in a traced window: the `rt.*` annotations that
rendering_tpu_torch.utils.tracing records (`record_function`), read from
the `Trace` of harness/trace.py, which this module leaves as it is.

- Each kernel of the window is charged to the `rt.` spans that held its
  launch (matched by correlation id) on the launching thread.
- A kernel launched inside autograd's `evaluate_function` (the backward,
  on autograd's own thread, where the program opens no span) is charged
  to the spans that held the forward operator with the same `Sequence
  number`, so the backward's device time lands at the forward stage that
  caused it.
- The device's idle time in the window is integrated over the innermost
  `rt.` span of the window's thread.
- Each synchronize call of the host (the CUDA runtime's) is held by the
  spans around it: those inside a request's root span are the program's.

A kernel counts "inclusive" under every span that held it, "exclusive"
under the innermost one only. A trace of a program without the spans
charges nothing: every reader then finds nothing.
"""

from __future__ import annotations

import weakref

from .trace import LAUNCH_CATS

PREFIX = "rt."
SYNC = "rt.sync."
BACKWARD = "autograd::engine::evaluate_function"
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")

_CACHE: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def of(trace) -> "Spans":
    """The Spans of `trace`, built once however many readers ask."""
    if trace not in _CACHE:
        _CACHE[trace] = Spans(trace)
    return _CACHE[trace]


def _seq(e):
    return (e.get("args") or {}).get("Sequence number")


def _by_tid(events) -> dict:
    """{tid: [(start, end, event)]} sorted by start, outer spans first."""
    out: dict = {}
    for e in events:
        ts = float(e["ts"])
        out.setdefault(e.get("tid"), []).append((ts, ts + float(e["dur"]), e))
    for iv in out.values():
        iv.sort(key=lambda x: (x[0], -x[1]))
    return out


def _enclosing(intervals, points) -> list:
    """For each time in `points` (sorted), the events of `intervals`
    (sorted by start, outer first; nested) that hold it, outermost
    first."""
    out, stack, i = [], [], 0
    for t in points:
        while i < len(intervals) and intervals[i][0] <= t:
            a = intervals[i]
            while stack and stack[-1][1] < a[0]:
                stack.pop()
            stack.append(a)
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(tuple(s[2] for s in stack if s[1] >= t))
    return out


def _lookup(by_tid, queries) -> list:
    """queries [(tid, ts)] -> the enclosing events of each, outermost
    first."""
    out = [()] * len(queries)
    groups: dict = {}
    for k, (tid, ts) in enumerate(queries):
        groups.setdefault(tid, []).append((ts, k))
    for tid, pts in groups.items():
        if tid not in by_tid:
            continue
        pts.sort()
        for (_, k), held in zip(pts, _enclosing(by_tid[tid],
                                                [p[0] for p in pts])):
            out[k] = held
    return out


class Spans:
    """The `rt.` spans of a traced window and what they hold."""

    def __init__(self, trace):
        self.trace = trace
        events = trace.events
        rt = [e for e in events if e.get("cat") == "user_annotation"
              and e["name"].startswith(PREFIX)]
        self.spans = _by_tid(rt)
        self.names = [e["name"] for e in rt
                      if trace.t0 <= float(e["ts"]) <= trace.t1]
        launches, backward, forward = {}, [], {}
        for e in events:
            cat = e.get("cat")
            if cat in LAUNCH_CATS:
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    launches[corr] = e
            elif cat == "cpu_op" and _seq(e) is not None:
                if e["name"].startswith(BACKWARD):
                    backward.append(e)
                elif not e["name"].startswith("autograd::"):
                    forward.setdefault(_seq(e), []).append(e)
        self.launches = launches
        bwd = _by_tid(backward)
        # A forward op: one with its sequence number run outside any
        # backward (on the CPU the backward runs on the caller's thread).
        fwd_ops = [e for es in forward.values() for e in es]
        in_bwd = _lookup(bwd, [(e.get("tid"), float(e["ts"]))
                               for e in fwd_ops])
        self.forward = {}
        for e, held in sorted(zip(fwd_ops, in_bwd),
                              key=lambda x: float(x[0]["ts"])):
            if not held:
                self.forward.setdefault(_seq(e), e)
        # Where each kernel's work was asked for: its launch, or for a
        # backward kernel the forward op of its evaluate_function.
        kernels, sites = [], []
        for e, _is_torch, _is_bwd in trace.kernels:
            launch = launches.get((e.get("args") or {}).get("correlation"))
            if launch is None:
                continue
            kernels.append(e)
            sites.append((launch.get("tid"), float(launch["ts"])))
        ops = [None] * len(sites)
        for k, held in enumerate(_lookup(bwd, sites)):
            fwd = self.forward.get(_seq(held[-1])) if held else None
            if fwd is not None:
                sites[k] = (fwd.get("tid"), float(fwd["ts"]))
                ops[k] = fwd["name"]
        # (names of the spans that held it, outermost first, seconds,
        # kernel name, the forward op of a backward kernel or None) for
        # each kernel with a launch in the trace.
        self.charges = [
            (tuple(s["name"] for s in held), float(e["dur"]) * 1e-6,
             e["name"], op)
            for e, held, op in zip(kernels, _lookup(self.spans, sites), ops)]

    def count(self, prefix: str) -> int:
        """Spans of the window whose name starts with `prefix`."""
        return sum(1 for n in self.names if n.startswith(prefix))

    def kernel_s(self, name: str, *, inclusive: bool = False) -> float:
        """Device seconds of the kernels charged to span `name`: held by
        it anywhere (inclusive), or innermost."""
        if inclusive:
            return sum(c[1] for c in self.charges if name in c[0])
        return sum(c[1] for c in self.charges if c[0] and c[0][-1] == name)

    def kernel_by_span(self) -> dict:
        """{innermost span or None: device seconds} of every kernel."""
        out: dict = {}
        for held, s, *_ in self.charges:
            key = held[-1] if held else None
            out[key] = out.get(key, 0.0) + s
        return out

    def idle_by_span(self) -> dict:
        """{innermost span of the window's thread, or None: seconds the
        device idled under it} over the window."""
        t0, t1 = self.trace.t0, self.trace.t1
        busy = self.trace.busy_intervals()
        edges = [t0] + [x for ab in busy for x in ab] + [t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        spans = self.spans.get(self.trace.main_tid, [])
        cuts = sorted({t0, t1} | {min(max(x, t0), t1)
                                  for a, b, _ in spans for x in (a, b)})
        segs = list(zip(cuts, cuts[1:]))
        held = _enclosing(spans, [0.5 * (a + b) for a, b in segs])
        out: dict = {}
        j = 0
        for (a, b), h in zip(segs, held):
            key = h[-1]["name"] if h else None
            while j < len(gaps) and gaps[j][1] <= a:
                j += 1
            k = j
            while k < len(gaps) and gaps[k][0] < b:
                lap = min(b, gaps[k][1]) - max(a, gaps[k][0])
                if lap > 0:
                    out[key] = out.get(key, 0.0) + lap * 1e-6
                k += 1
        return out

    def syncs(self) -> list:
        """The host's synchronize calls in the window: [(name, start us,
        names of the `rt.` spans that held it, outermost first)]."""
        calls = [e for e in self.trace.events
                 if e.get("cat") in LAUNCH_CATS and e["name"] in SYNC_CALLS
                 and self.trace.t0 <= float(e["ts"]) <= self.trace.t1]
        held = _lookup(self.spans, [(e.get("tid"), float(e["ts"]))
                                    for e in calls])
        return [(e["name"], float(e["ts"]), tuple(s["name"] for s in h))
                for e, h in zip(calls, held)]

    def unspanned_syncs(self) -> list:
        """The synchronize calls of the window that no `rt.sync.` span
        holds: [(name, start us, innermost rt. span or None)]."""
        return [(name, ts, held[-1] if held else None)
                for name, ts, held in self.syncs()
                if not any(s.startswith(SYNC) for s in held)]
