"""harness/spans.py on a small canned Chrome trace: a kernel charged by
correlation id to its innermost program span, a backward kernel charged
through its `Sequence number` to the span of its forward operator, the
device's idle time integrated across spans, the host's synchronize
calls inside and outside the program's spans, the breakdown's report,
and each metric that reads the spans or the program's
counters returning nothing where there is nothing to read."""

import sys
import types

import pytest

from harness import registry, spans
from harness.trace import Trace

MAIN, BWD, DEV = 1, 2, 7


def X(name, cat, ts, dur, tid=MAIN, **args):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "pid": 0, "tid": tid}
    if args:
        e["args"] = {k.replace("_", " "): v for k, v in args.items()}
    return e


def U(name, ts, dur, tid=MAIN):
    return X(name, "user_annotation", ts, dur, tid)


def launch(ts, corr, tid=MAIN):
    return X("cudaLaunchKernel", "cuda_runtime", ts, 2, tid,
             correlation=corr)


def kernel(name, ts, dur, corr):
    return X(name, "kernel", ts, dur, DEV, correlation=corr)


EVENTS = [
    U("bench_window", 0, 1000),
    U("rt.render", 10, 890),
    U("rt.pipeline.ssaa", 100, 500),
    U("rt.integrator.scatter", 150, 50),
    launch(160, 1),
    kernel("indexing_backward_kernel_stride_1", 300, 100, 1),
    U("rt.sync.ssaa_queue", 250, 40),
    X("cudaStreamSynchronize", "cuda_runtime", 255, 15),
    X("cudaStreamSynchronize", "cuda_runtime", 272, 15),
    U("rt.integrator.shade", 650, 50),
    X("aten::index", "cpu_op", 655, 10, Sequence_number=42),
    U("rt.intersect.prepass", 710, 50),
    launch(720, 2),
    kernel("elementwise_kernel", 730, 50, 2),
    # the backward, on autograd's thread: no program span there
    X("autograd::engine::evaluate_function: IndexBackward0", "cpu_op", 800,
      80, BWD, Sequence_number=42),
    launch(810, 3, tid=BWD),
    kernel("indexing_backward_kernel_stride_1", 820, 50, 3),
    # the harness's own window-end sync
    X("cudaDeviceSynchronize", "cuda_runtime", 950, 40),
]


@pytest.fixture
def trace():
    return Trace(EVENTS)


def test_kernel_charged_to_innermost_span(trace):
    sp = spans.of(trace)
    assert spans.of(trace) is sp
    assert sp.kernel_s("rt.integrator.scatter") == pytest.approx(100e-6)
    assert sp.kernel_s("rt.pipeline.ssaa") == 0.0
    assert sp.kernel_s("rt.pipeline.ssaa", inclusive=True) == \
        pytest.approx(100e-6)
    assert sp.kernel_s("rt.render", inclusive=True) == pytest.approx(200e-6)
    assert sp.kernel_s("rt.intersect.prepass") == pytest.approx(50e-6)


def test_backward_kernel_charged_through_sequence_number(trace):
    sp = spans.of(trace)
    assert sp.kernel_s("rt.integrator.shade") == pytest.approx(50e-6)
    held, s, name, op = next(c for c in sp.charges if c[3] is not None)
    assert held == ("rt.render", "rt.integrator.shade")
    assert (name, op) == ("indexing_backward_kernel_stride_1", "aten::index")
    assert sp.kernel_by_span() == {
        "rt.integrator.scatter": pytest.approx(100e-6),
        "rt.intersect.prepass": pytest.approx(50e-6),
        "rt.integrator.shade": pytest.approx(50e-6)}


def test_idle_integrated_across_spans(trace):
    # busy [300,400] [730,780] [820,870]; the gap [0,300] crosses five
    # spans, [400,730] four.
    idle = spans.of(trace).idle_by_span()
    want = {None: 110, "rt.render": 220, "rt.pipeline.ssaa": 310,
            "rt.integrator.scatter": 50, "rt.sync.ssaa_queue": 40,
            "rt.integrator.shade": 50, "rt.intersect.prepass": 20}
    assert idle == {k: pytest.approx(v * 1e-6) for k, v in want.items()}
    assert sum(idle.values()) == pytest.approx(
        trace.window_s - trace.busy_s)


def test_syncs_and_counts(trace):
    sp = spans.of(trace)
    assert sp.count("rt.sync.") == 1
    assert sp.count("rt.integrator.") == 2
    assert sp.unspanned_syncs() == [("cudaDeviceSynchronize", 950.0, None)]
    held = ("rt.render", "rt.pipeline.ssaa", "rt.sync.ssaa_queue")
    assert sp.syncs() == [("cudaStreamSynchronize", 255.0, held),
                          ("cudaStreamSynchronize", 272.0, held),
                          ("cudaDeviceSynchronize", 950.0, ())]


def test_span_metrics_read_the_spans(trace):
    ctx = types.SimpleNamespace(trace=trace, n=2, records=[])
    got = {m: registry.metric(m).read(ctx) for m in (
        "prepass_ms.train", "prepass_ms.scenefile", "scatter_ms.frame",
        "shade_ms.train", "ssaa_ms.frame", "syncs.frame")}
    assert got == {"prepass_ms.train": pytest.approx(0.025),
                   "prepass_ms.scenefile": pytest.approx(0.025),
                   "scatter_ms.frame": pytest.approx(0.05),
                   "shade_ms.train": pytest.approx(0.025),
                   "ssaa_ms.frame": pytest.approx(0.05),
                   "syncs.frame": 1.0}


def _counters(monkeypatch, values):
    mod = types.ModuleType("rendering_tpu_torch.utils.tracing")
    mod.counters = lambda: dict(values)
    monkeypatch.setitem(sys.modules, mod.__name__, mod)


def test_counter_metrics(monkeypatch):
    _counters(monkeypatch, {"lanes": 200, "live_lanes": 50,
                            "ssaa_lanes": 400, "ssaa_masked": 40})
    ctx = types.SimpleNamespace(n=4)
    assert registry.metric("live_lane_pct.frame").read(ctx) == 25.0
    assert registry.metric("ssaa_fill_pct.frame").read(ctx) == 90.0


SPAN_METRICS = ("prepass_ms.train", "prepass_ms.scenefile",
                "scatter_ms.frame", "shade_ms.train", "ssaa_ms.frame",
                "syncs.frame")
COUNTER_METRICS = ("live_lane_pct.frame", "ssaa_fill_pct.frame")


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_span_metric_without_its_span(name):
    events = [U("bench_window", 0, 100), launch(10, 1),
              kernel("k", 20, 30, 1)]
    ctx = types.SimpleNamespace(trace=Trace(events), n=1, records=[])
    assert registry.metric(name).read(ctx) is None


@pytest.mark.parametrize("name", COUNTER_METRICS)
def test_counter_metric_without_counters(monkeypatch, name):
    ctx = types.SimpleNamespace(n=1)
    _counters(monkeypatch, {})
    assert registry.metric(name).read(ctx) is None
    # A program without the tracing module (an import that fails).
    monkeypatch.setitem(sys.modules, "rendering_tpu_torch.utils.tracing",
                        None)
    assert registry.metric(name).read(ctx) is None


def test_breakdown_reports_the_spans(trace):
    import breakdown

    got = breakdown.report(trace, 2)
    assert got["idle_ms"] == pytest.approx(
        1e3 * (trace.window_s - trace.busy_s) / 2)
    assert got["idle_under_span_share"] == pytest.approx(690 / 800)
    assert got["kernel_ms_by_span"]["rt.integrator.scatter"] == \
        pytest.approx(0.05)
    assert got["heaviest_kernels"]["indexing_backward_kernel_stride_1"] == {
        "rt.render > rt.pipeline.ssaa > rt.integrator.scatter":
            pytest.approx(0.05),
        "rt.render > rt.integrator.shade (backward of aten::index)":
            pytest.approx(0.025)}
    assert (got["sync_calls"], got["program_sync_calls"]) == (1.5, 1.0)
    assert got["unspanned_syncs"] == 1
    assert got["span_counts"]["rt.render"] == 0.5
