"""The per-layer arithmetic on a small canned Chrome trace: the device's
busy union and idle share, the split of kernels into PyTorch's and the
port's by where they were launched, the backward's kernels by
correlation id, and the idle gaps named by the host operator."""

import json
import types

import pytest

from harness import registry
from harness.trace import Trace, load

MAIN, BWD = 1, 2


def X(name, cat, ts, dur, tid=MAIN, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "pid": 0, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


EVENTS = [
    X("bench_window", "user_annotation", 0, 1000),
    X("bench_window", "gpu_user_annotation", 0, 1000, tid=7),
    # forward: an aten op launching a PyTorch kernel
    X("aten::mul", "cpu_op", 10, 20),
    X("cudaLaunchKernel", "cuda_runtime", 15, 2, corr=1),
    X("void at::native::vectorized_elementwise_kernel<4>", "kernel", 30, 100,
      tid=7, corr=1),
    # the port's kernel, launched outside any aten op (ctypes)
    X("cudaLaunchKernelEx", "cuda_runtime", 200, 3, corr=2),
    X("closest_walk_kernel", "kernel", 210, 50, tid=7, corr=2),
    # a copy overlapping the port's kernel
    X("Memcpy DtoH", "gpu_memcpy", 240, 40, tid=7),
    # backward on the autograd thread
    X("autograd::engine::evaluate_function: MulBackward0", "cpu_op", 400,
      100, tid=BWD),
    X("aten::mul", "cpu_op", 410, 30, tid=BWD),
    X("cudaLaunchKernel", "cuda_runtime", 420, 2, tid=BWD, corr=3),
    X("void at::native::vectorized_elementwise_kernel<4>", "kernel", 500, 200,
      tid=7, corr=3),
    # a host op on the main thread while the device idles
    X("aten::nonzero", "cpu_op", 700, 250),
    # outside the window
    X("late_kernel", "kernel", 2000, 10, tid=7, corr=9),
]


@pytest.fixture
def trace(tmp_path):
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": EVENTS + [
        {"ph": "s", "name": "ac2g", "id": 1, "ts": 15}]}))
    return Trace(load(str(p)))


def test_busy_union_and_idle(trace):
    # busy: [30,130] + [210,280] + [500,700] = 100 + 70 + 200
    assert trace.window_s == pytest.approx(1e-3)
    assert trace.busy_s == pytest.approx(370e-6)
    ctx = types.SimpleNamespace(trace=trace, n=1, records=[])
    idle = registry.metric("device_idle_pct.train").read(ctx)
    assert idle == pytest.approx(63.0)


def test_kernels_split_by_launch_site(trace):
    assert trace.kernel_s(torch_side=True) == pytest.approx(300e-6)
    assert trace.kernel_s(torch_side=False) == pytest.approx(50e-6)
    ctx = types.SimpleNamespace(trace=trace, n=2, records=[])
    assert registry.metric("port_kernel_ms.train").read(ctx) == \
        pytest.approx(0.025)
    assert registry.metric("torch_kernel_ms.train").read(ctx) == \
        pytest.approx(0.15)


def test_backward_by_correlation(trace):
    assert trace.kernel_s(backward=True) == pytest.approx(200e-6)
    ctx = types.SimpleNamespace(trace=trace, n=1, records=[])
    assert registry.metric("backward_ms.train").read(ctx) == \
        pytest.approx(0.2)


def test_idle_gaps_and_top_ops(trace):
    gaps = trace.idle_gaps()
    assert gaps[0] == ["aten::nonzero", pytest.approx(300e-6)]
    assert [g[1] for g in gaps] == sorted((g[1] for g in gaps), reverse=True)
    top = trace.top_ops()
    assert top[0][0].startswith("void at::native::vectorized")
    assert top[0][1] == pytest.approx(300e-6)


def test_nothing_to_read_gives_nothing():
    events = [X("bench_window", "user_annotation", 0, 100)]
    tr = Trace(events)
    ctx = types.SimpleNamespace(trace=tr, n=1, records=[])
    for name in ("port_kernel_ms.train", "torch_kernel_ms.frame",
                 "backward_ms.train", "scene_load_ms.scenefile"):
        assert registry.metric(name).read(ctx) is None
