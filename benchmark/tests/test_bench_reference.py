"""The comparison that decides `correct`, at a size a test run holds, on
the CPU (the port's plain versions stand in for its kernels): each cell's
honest run comes out correct, the reference computed in bfloat16 in the
program's place fails a limit, and every fault a cell can have, planted
in the program under a whole run of the harness, makes `correct` false."""

import types

import pytest
import torch

from harness import faults, registry, runner

TINY = {"width": 64, "height": 48, "n_tris": 2000}
SEED = 3_000_000_019
CELLS = [w["name"] for w in registry.manifest()["workloads"]]


def _run(cell, seed=SEED):
    return runner.run_cell(cell, seed, 0.2, False, device="cpu",
                           overrides=TINY)


@pytest.mark.parametrize("cell", CELLS)
def test_honest_run_is_correct(cell):
    r = _run(cell)
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_a_limit(cell, tmp_path):
    spec = registry.workload(cell)
    kind = registry.traffic(spec["traffic"])
    ctx = types.SimpleNamespace(name=cell, cell=spec,
                                cfg=registry.config(spec["config"]),
                                seed=SEED, device=torch.device("cpu"),
                                workdir=str(tmp_path), overrides=TINY)
    state = kind.setup(ctx)
    records = [runner._request(kind, state)]
    kind.finish(state, records)
    kind.release(state)
    gaps = kind.control(state, records, torch.bfloat16)
    assert any(v > spec["limits"][k] for k, v in gaps.items()), gaps


@pytest.mark.parametrize("cell,fault", [
    (w["name"], f) for w in registry.manifest()["workloads"]
    for f in faults.KIND_FAULTS[w["traffic"]]])
def test_fault_makes_the_run_incorrect(cell, fault):
    with faults.FAULTS[fault]():
        r = _run(cell)
    assert not r["correct"], r["checks"]
