"""The readers of the metrics that `glass250k.train` and
`shotgun250k.train.sharded4` add, on canned traces and counters (each
returns nothing where the program has nothing to read, as a parent
without the growing queue or the ranks' spans), and the sharded kind's
refusal without a card for each rank."""

import sys
import types

import pytest
import torch

from harness import registry
from harness.trace import Trace
from test_bench_spans import U, kernel, launch


def _counters(monkeypatch, values):
    mod = types.ModuleType("rendering_tpu_torch.utils.tracing")
    mod.counters = lambda: dict(values)
    monkeypatch.setitem(sys.modules, mod.__name__, mod)


def test_queue_fill_reads_the_queue_counters(monkeypatch):
    _counters(monkeypatch, {"lanes": 800, "live_lanes": 700,
                            "queue_lanes": 400, "queue_live_lanes": 100})
    ctx = types.SimpleNamespace(n=2)
    assert registry.metric("queue_fill_pct.train").read(ctx) == 25.0


def _regrow_trace(with_regrow: bool):
    events = [U("bench_window", 0, 1000), U("rt.train.step", 10, 900),
              U("rt.train.forward", 20, 500)]
    if with_regrow:
        events += [U("rt.train.regrow", 100, 30), U("rt.train.regrow", 200, 10)]
    return Trace(events)


def test_regrow_ms_reads_the_spans(monkeypatch):
    _counters(monkeypatch, {"queue_lanes": 10})
    read = registry.metric("regrow_ms.train").read
    ctx = types.SimpleNamespace(trace=_regrow_trace(True), n=2)
    assert read(ctx) == pytest.approx(0.02)
    # Capacities held: the span never opens, the metric reads 0.
    ctx = types.SimpleNamespace(trace=_regrow_trace(False), n=2)
    assert read(ctx) == 0.0


@pytest.mark.parametrize("name", ["queue_fill_pct.train", "regrow_ms.train"])
def test_queue_metrics_without_the_counters(monkeypatch, name):
    ctx = types.SimpleNamespace(trace=_regrow_trace(True), n=1)
    _counters(monkeypatch, {"lanes": 10, "live_lanes": 5})
    assert registry.metric(name).read(ctx) is None
    monkeypatch.setitem(sys.modules, "rendering_tpu_torch.utils.tracing",
                        None)
    assert registry.metric(name).read(ctx) is None


def test_collective_ms_reads_the_ranks_spans():
    events = [U("bench_window", 0, 1000), U("rt.train.step", 10, 900),
              U("rt.ranks.all_gather", 100, 20), launch(105, 1),
              kernel("ncclDevKernel_AllGather", 130, 40, 1),
              # an all-reduce launched in a gradient hook, on autograd's
              # thread, outside any forward operator
              U("rt.ranks.all_reduce", 300, 20, tid=2), launch(305, 2, tid=2),
              kernel("ncclDevKernel_AllReduce", 330, 60, 2),
              U("rt.integrator.shade", 500, 50), launch(510, 3),
              kernel("elementwise_kernel", 520, 30, 3)]
    ctx = types.SimpleNamespace(trace=Trace(events), n=2)
    assert registry.metric("collective_ms.train").read(ctx) == \
        pytest.approx(0.05)
    none = [e for e in events if not e["name"].startswith("rt.ranks.")]
    ctx = types.SimpleNamespace(trace=Trace(none), n=2)
    assert registry.metric("collective_ms.train").read(ctx) is None


def test_sharded_kind_refuses_without_a_card_a_rank(monkeypatch, tmp_path):
    kind = registry.traffic("train_sharded")
    cell = registry.workload("shotgun250k.train.sharded4")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    started = []
    monkeypatch.setattr(kind.subprocess, "Popen",
                        lambda *a, **k: started.append(a))
    ctx = types.SimpleNamespace(name="shotgun250k.train.sharded4", cell=cell,
                                cfg=registry.config(cell["config"]), seed=1,
                                device=torch.device("cuda"),
                                workdir=str(tmp_path), overrides={})
    with pytest.raises(RuntimeError, match="4 cards"):
        kind.setup(ctx)
    assert not started


def test_sharded_run_counts_a_device_a_rank():
    from harness import runner

    describe = runner._describe_device
    r = runner.run_cell("shotgun250k.train.sharded4", 3_000_000_019, 0.2,
                        False, device="cpu",
                        overrides={"width": 64, "height": 48, "n_tris": 2000})
    assert r["correct"], r["checks"]
    assert r["device"]["count"] == 4
    assert runner._describe_device is describe
    assert runner._describe_device(torch.device("cpu"))["count"] == 1
