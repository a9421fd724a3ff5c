"""BENCHMARK.json against the contract's shape and against the files the
harness finds by name."""

import json
import os
import re

import pytest

from harness import registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return registry.manifest()


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) < 64 * 1024


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_names_and_units(bench, group):
    names = [e["name"] for e in bench[group]]
    assert len(set(names)) == len(names)
    for e in bench[group]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]
        if group == "configs":
            assert 1 <= len(e["source"]) <= 200


def test_configs_have_their_files(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        cfg = registry.config(c["name"])
        assert cfg["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in bench["workloads"])


def test_workload_files_agree(bench):
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200
        cell = registry.workload(w["name"])
        for key in ("config", "traffic", "chips", "why"):
            assert cell[key] == w[key], (w["name"], key)
        assert os.path.exists(os.path.join(registry.BENCH_DIR, "traffic",
                                           w["traffic"] + ".py"))
        assert cell["limits"], w["name"]


def test_metric_entries(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert os.path.exists(os.path.join(registry.BENCH_DIR, "metrics",
                                           m["name"] + ".py"))


def test_each_cell_reports_what_it_must(bench):
    for w in bench["workloads"]:
        e2e = [m["name"] for m in registry.cell_metrics(w["name"], False, bench)]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert registry.cell_metrics(w["name"], True, bench), w["name"]


def test_per_layer_moves_a_metric_of_its_cells(bench):
    for m in bench["per_layer"]:
        target = next(e for e in bench["end_to_end"] if e["name"] == m["moves"])
        for cell in m["workloads"]:
            assert registry.reports(target, cell, bench), (m["name"], cell)


def test_layers_are_named_alike(bench):
    layers = {m["layer"] for m in bench["per_layer"]}
    assert layers <= {"command line", "train step", "scene build (host)",
                      "render pipeline", "integrator", "kernels", "ranks",
                      "device"}
