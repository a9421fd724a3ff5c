"""The train step on a transparent scene whose continuation queue
overflows headroom 1: the benchmark's glass250k configuration (the
default scene with its glass object a mesh, backface culling off) cut to
64x48 and 2,000 triangles, the mesh enlarged to size 3.6 so that its
live children outnumber the rays (tests/torch_dist_util.glass_scene).

Held against the benchmark's plain PyTorch reference
(benchmark/reference/, which follows every path with no capacity), on
the CPU at seeded values:
- the frame inside `growing_queue` to 1e-6 (measured at most 4.8e-7 on
  three seeds: f32 summation order), where headroom 1's frame is off by
  more than 0.1;
- a train step's loss to rtol 1e-6 (measured equal) and the norm of
  each leaf's gradient to rtol 1e-5 (measured at most 8.7e-7). The
  vertex gradient is compared by its norm and its sum over the mesh: a
  ray through a shared edge may pick either triangle, which moves its
  gradient between their vertices and leaves both unchanged.
The step drops no path, repeats bit-equal, raises at the queue's limit
before touching its parameters, keeps its capacities from step to step
(the span `rt.train.regrow` in the first step only) and counts the
continuation queue's lanes. On 2 gloo ranks the sharded train step and
make_sharded_grad_fn match the unsharded step.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import torch_dist_util as du
from rendering_tpu_torch.diff.inverse import (
    apply_params,
    extract_params,
    make_train_step,
)
from rendering_tpu_torch.render import integrator
from rendering_tpu_torch.render.integrator import (
    QueueGrowth,
    QueueOverflow,
    growing_queue,
)
from rendering_tpu_torch.render.pipeline import render_scene
from rendering_tpu_torch.utils import tracing

sys.path.insert(0, os.path.join(du.REPO, "benchmark"))
from reference import render as ref_render  # noqa: E402

PATHS = du.GLASS_PATHS


@pytest.fixture(scope="module")
def glass():
    scene, desc = du.glass_scene()
    return scene, desc, du.glass_target(scene)


def _step(step_fn, init, scene, target):
    params = extract_params(scene, PATHS)
    params, _, loss = step_fn(params, init(params), scene, target)
    return loss, {k: v.grad.clone() for k, v in params.items()}


def test_headroom1_drops_and_the_growing_queue_matches_reference(glass):
    scene, desc, _ = glass
    with torch.no_grad():
        f1, aux1 = render_scene(scene)
        growth = QueueGrowth()
        with growing_queue(growth):
            f2, aux2 = render_scene(scene)
        ref = ref_render.render(ref_render.build(desc, device="cpu"))
    assert float(aux1["stats"]["paths_dropped"]) > 0
    assert growth.dropped == 0 and aux2["stats"]["paths_dropped"] == 0
    # The queue after each bounce (keyed by rays in and bounce) grew past
    # the rays' own blocks, which headroom 1 caps it at.
    assert len(growth.held) == 11
    assert all(v % (64 * 48) == 0 for v in growth.held.values())
    assert max(growth.held.values()) > 64 * 48
    assert float((f1.permute(1, 2, 0) - ref).abs().max()) > 0.1
    np.testing.assert_allclose(f2.permute(1, 2, 0).numpy(), ref.numpy(),
                               rtol=0, atol=1e-6)


def test_train_step_matches_reference(glass):
    scene, desc, target = glass
    init, step_fn = make_train_step(PATHS)
    loss, grads = _step(step_fn, init, scene, target)
    rs = ref_render.build(desc, device="cpu")
    leaves = {k: rs.get(k).detach().clone().requires_grad_(True)
              for k in grads}
    _, ref_loss = ref_render.render(rs.with_params(leaves),
                                    target=target.permute(1, 2, 0))
    assert float(loss) == pytest.approx(ref_loss, rel=1e-6)
    for k, leaf in leaves.items():
        want = leaf.grad
        assert float(want.norm()) > 0, k
        assert float(grads[k].norm()) == pytest.approx(float(want.norm()),
                                                       rel=1e-5), k
    np.testing.assert_allclose(grads["meshes/0/v"].sum((0, 1)).numpy(),
                               leaves["meshes/0/v"].grad.sum((0, 1)).numpy(),
                               rtol=1e-4, atol=1e-7)


def test_repeat_steps_bit_equal_and_capacities_held(glass):
    scene, _, target = glass
    init, step_fn = make_train_step(PATHS)
    loss_a, grads_a = _step(step_fn, init, scene, target)
    loss_b, grads_b = _step(step_fn, init, scene, target)
    init2, fresh = make_train_step(PATHS)
    loss_c, grads_c = _step(fresh, init2, scene, target)
    for loss, grads in ((loss_b, grads_b), (loss_c, grads_c)):
        assert torch.equal(loss.view(torch.int32), loss_a.view(torch.int32))
        for k in grads_a:
            assert torch.equal(grads[k].view(torch.int32),
                               grads_a[k].view(torch.int32)), k


def test_step_raises_at_the_limit_before_stepping(glass, monkeypatch):
    scene, _, target = glass
    monkeypatch.setattr(integrator, "MAX_QUEUE_HEADROOM", 1)
    init, step_fn = make_train_step(PATHS)
    params = extract_params(scene, PATHS)
    before = {k: v.detach().clone() for k, v in params.items()}
    opt = init(params)
    with pytest.raises(QueueOverflow):
        step_fn(params, opt, scene, target)
    for k, v in params.items():
        assert v.grad is None and torch.equal(v.detach(), before[k]), k


def test_regrow_span_and_queue_counters(glass, tmp_path):
    scene, _, target = glass
    init, step_fn = make_train_step(PATHS)
    regrows, counts = [], []
    for i in range(2):
        tracing.reset()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _step(step_fn, init, scene, target)
            counts.append(tracing.counters())
        path = str(tmp_path / f"step{i}.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
        spans = [(e["name"], float(e["ts"]), float(e["ts"]) + e["dur"])
                 for e in events if e.get("cat") == "user_annotation"]
        forward = [s for s in spans if s[0] == "rt.train.forward"]
        regrow = [s for s in spans if s[0] == "rt.train.regrow"]
        assert all(forward[0][1] <= s[1] and s[2] <= forward[0][2]
                   for s in regrow)
        regrows.append(len(regrow))
    # The first step grows the held capacity after every bounce; the
    # second finds it held.
    assert regrows == [11, 0]
    for c in counts:
        # Bounces 1-10 of the 11: the continuation queue, each in blocks
        # of the 3,072 rays.
        assert c["queue_lanes"] % (64 * 48) == 0
        assert c["queue_lanes"] > 10 * 64 * 48
        assert 0 < c["queue_live_lanes"] <= c["queue_lanes"]
    assert counts[0] == counts[1]


@pytest.fixture(scope="module")
def glass_ranks(tmp_path_factory):
    return du.run_ranks(du.glass_worker, 2, tmp_path_factory.mktemp("glass"))


def test_sharded_step_and_grad_fn_match_unsharded(glass, glass_ranks):
    """C2: each rank's queue holds its share of the rays; neither the
    sharded train step nor make_sharded_grad_fn drops a path, so both
    give the unsharded step's loss and gradients (rtol 1e-4, the
    sharded tests' tolerance: f32 summation order over the ranks)."""
    scene, _, target = glass
    init, step_fn = make_train_step(PATHS)
    loss, grads = _step(step_fn, init, scene, target)
    params = extract_params(scene, PATHS)
    with growing_queue(QueueGrowth()):
        frame = render_scene(apply_params(scene, params, PATHS))[0]
    fn_loss = torch.mean((frame[:, :-1, :-1] - target[:, :-1, :-1]) ** 2)
    fn_loss.backward()
    for r in glass_ranks:
        for (got_loss, got), (want_loss, want) in (
                (r["train"], (float(loss), grads)),
                (r["grad_fn"], (float(fn_loss.detach()), {k: p.grad for k, p
                                                 in params.items()}))):
            assert got_loss == pytest.approx(want_loss, rel=1e-6)
            for k, g in want.items():
                g = g.numpy()
                np.testing.assert_allclose(got[k], g, rtol=1e-4,
                                           atol=1e-4 * np.abs(g).max(),
                                           err_msg=k)
