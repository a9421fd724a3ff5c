"""A new configuration, cell or per-layer metric is found by its name:
adding its files is enough, no file of the harness changes."""

import json
import shutil
import types

import pytest

from harness import registry


@pytest.fixture
def copy_of_benchmark(tmp_path, monkeypatch):
    root = tmp_path / "checkout"
    shutil.copytree(registry.BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(registry.ROOT + "/BENCHMARK.json", root / "BENCHMARK.json")
    monkeypatch.setattr(registry, "ROOT", str(root))
    monkeypatch.setattr(registry, "BENCH_DIR", str(root / "benchmark"))
    return root


def test_new_files_add_a_cell(copy_of_benchmark):
    root = copy_of_benchmark
    b = root / "benchmark"
    cfg = json.loads((b / "configs" / "simpleshapes.json").read_text())
    cfg["settings"]["width"] = 320
    (b / "configs" / "smallshapes.json").write_text(json.dumps(cfg))
    cell = json.loads((b / "workloads" / "simpleshapes.turntable.json")
                      .read_text())
    cell["config"] = "smallshapes"
    (b / "workloads" / "smallshapes.turntable.json").write_text(
        json.dumps(cell))
    (b / "metrics" / "frames_per_call.frame.py").write_text(
        "def read(ctx):\n    return float(ctx.n)\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "smallshapes.turntable",
                               "config": "smallshapes",
                               "traffic": "turntable", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "frames_per_call.frame", "unit": "1",
                               "better": "lower", "source": "program_counter",
                               "layer": "render pipeline",
                               "moves": "frame_rays_per_s",
                               "workloads": ["smallshapes.turntable"]})
    for m in bench["end_to_end"]:
        if m["name"] in ("frame_rays_per_s", "frame_p95_ms"):
            m["workloads"].append("smallshapes.turntable")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    assert registry.config("smallshapes")["settings"]["width"] == 320
    assert registry.workload("smallshapes.turntable")["config"] == "smallshapes"
    assert hasattr(registry.traffic("turntable"), "request")
    names = [m["name"] for m in
             registry.cell_metrics("smallshapes.turntable", True)]
    assert "frames_per_call.frame" in names
    assert "device_idle_pct.frame" not in names
    ctx = types.SimpleNamespace(n=4)
    assert registry.metric("frames_per_call.frame").read(ctx) == 4.0
    e2e = [m["name"] for m in
           registry.cell_metrics("smallshapes.turntable", False)]
    assert set(e2e) == {"frame_rays_per_s", "frame_p95_ms", "setup_s"}


def test_unknown_names_stop_the_run(copy_of_benchmark):
    with pytest.raises(SystemExit):
        registry.workload("no.such.cell")
    with pytest.raises(SystemExit):
        registry.metric("no_such_metric")
