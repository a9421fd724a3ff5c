"""The port's spans and counters (`utils/tracing.py`) on the CPU, torch
only: a profiled render of a tiny bouncing scene with SSAA and a
profiled train step hold every span their path reaches, nested under
the request's root; with no profiler session nothing is built and
nothing counted; the lane counters equal counts taken independently
from the bounce blocks' weights and the Sobel mask; frames, losses and
gradients are bit-equal with tracing on and off; `--trace-dir` writes
the counters beside the trace.
"""

from __future__ import annotations

import glob
import json
import os

import pytest
import torch

from rendering_tpu_torch import cli
from rendering_tpu_torch.diff.inverse import extract_params, make_train_step
from rendering_tpu_torch.flagship import build_tiny_scene
from rendering_tpu_torch.ops.sobel import sobel_mask
from rendering_tpu_torch.render import integrator
from rendering_tpu_torch.render.pipeline import (
    default_ssaa_capacity,
    render,
    render_scene,
)
from rendering_tpu_torch.utils import profiling, timer, tracing

W, H = 32, 16
PATHS = (("lights", 0, "intensity"), ("obj_color",))


def _scene(**settings):
    return build_tiny_scene(width=W, height=H, n_tris=64, device="cpu",
                            settings_overrides=settings)


def _profiled(fn, tmp_path, name="t.json"):
    """fn()'s result and the rt. spans of its trace:
    [(name, start, end)] sorted by start. The counts start from zero, as
    in a process that records one session."""
    tracing.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    path = str(tmp_path / name)
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    spans = sorted((e["name"], float(e["ts"]), float(e["ts"]) + e["dur"])
                   for e in events if e.get("ph") == "X"
                   and e.get("cat") == "user_annotation"
                   and e["name"].startswith("rt."))
    return out, sorted(spans, key=lambda s: s[1])


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _held_by(spans, name, *outer_names) -> bool:
    """Every `name` span lies inside some span named in `outer_names`."""
    outers = [s for s in spans if s[0] in outer_names]
    return all(any(_inside(s, o) for o in outers)
               for s in spans if s[0] == name)


RENDER_SPANS = (
    "rt.render", "rt.pipeline.primary", "rt.pipeline.ssaa",
    "rt.pipeline.pull", "rt.integrator.bounce", "rt.integrator.trace",
    "rt.integrator.shade", "rt.integrator.shadow", "rt.integrator.scatter",
    "rt.integrator.compact", "rt.intersect.prepass", "rt.intersect.kernel",
    "rt.sync.ssaa_queue", "rt.sync.ssaa_masked", "rt.sync.redo_check",
    "rt.sync.dropped", "rt.sync.pull", "rt.sync.occluder_mask",
    "rt.sync.prepass_bounds",
)


@pytest.fixture(scope="module")
def render_trace(tmp_path_factory):
    scene = _scene(enable_ssaa=True, ssaa_capacity_fraction=1.0)
    (frame, aux), spans = _profiled(lambda: render(scene),
                                    tmp_path_factory.mktemp("trace"))
    return scene, frame, aux, spans, tracing.counters()


@pytest.mark.parametrize("name", RENDER_SPANS)
def test_render_reaches_span_under_its_root(render_trace, name):
    *_, spans, _ = render_trace
    roots = [s for s in spans if s[0] == "rt.render"]
    assert len(roots) == 1
    mine = [s for s in spans if s[0] == name]
    assert mine, name
    assert all(_inside(s, roots[0]) for s in mine)


@pytest.mark.parametrize("name,outers", [
    ("rt.integrator.trace", ("rt.integrator.bounce",)),
    ("rt.integrator.shade", ("rt.integrator.bounce",)),
    ("rt.integrator.shadow", ("rt.integrator.shade",)),
    ("rt.integrator.compact", ("rt.integrator.bounce",)),
    ("rt.intersect.prepass", ("rt.integrator.trace", "rt.integrator.shadow")),
    ("rt.intersect.kernel", ("rt.integrator.trace", "rt.integrator.shadow")),
    ("rt.integrator.bounce", ("rt.pipeline.primary", "rt.pipeline.ssaa")),
])
def test_render_spans_nest(render_trace, name, outers):
    *_, spans, _ = render_trace
    assert _held_by(spans, name, *outers)
    if name == "rt.integrator.trace":
        shades = [s for s in spans if s[0] == "rt.integrator.shade"]
        assert not any(_inside(s, o) for s in spans if s[0] == name
                       for o in shades)


def test_train_step_spans(tmp_path):
    scene = _scene()
    with torch.no_grad():
        target = render_scene(_scene(enable_ssaa=False))[0] * 0.9
    init_fn, step_fn = make_train_step(PATHS)
    params = extract_params(scene, PATHS)
    opt = init_fn(params)
    _, spans = _profiled(lambda: step_fn(params, opt, scene, target),
                         tmp_path)
    roots = [s for s in spans if s[0] == "rt.train.step"]
    assert len(roots) == 1
    assert all(_inside(s, roots[0]) for s in spans)
    for stage in ("rt.train.forward", "rt.train.backward",
                  "rt.train.optimizer"):
        assert [s for s in spans if s[0] == stage], stage
    for name in ("rt.pipeline.primary", "rt.integrator.bounce",
                 "rt.integrator.shade", "rt.intersect.prepass"):
        assert [s for s in spans if s[0] == name], name
        assert _held_by(spans, name, "rt.train.forward")


def test_off_builds_nothing_and_counts_nothing(monkeypatch, tmp_path):
    built = []
    real = torch.profiler.record_function

    def counting(name, *a, **k):
        built.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    scene = _scene(enable_ssaa=True)
    tracing.reset()

    class NoKernel:
        def detach(self):
            raise AssertionError("count reduced a value with no session")

    tracing.count("x", NoKernel())
    render(scene)
    assert built == []
    assert tracing.counters() == {}
    assert tracing.span("rt.a") is tracing.span("rt.b")
    # The same render under a session does build them.
    _profiled(lambda: render(scene), tmp_path)
    assert "rt.render" in built and tracing.counters()["lanes"] > 0


def test_counters_equal_independent_counts(monkeypatch, render_trace,
                                           tmp_path):
    scene, *_ = render_trace
    st = scene.static.settings
    seen = {"lanes": 0, "live_lanes": 0}
    real = integrator.bounce_block

    def recording(scene_, ro3, rd3, weight, active):
        seen["lanes"] += weight.numel()
        seen["live_lanes"] += int((weight > st.min_weight).sum())
        return real(scene_, ro3, rd3, weight, active)

    monkeypatch.setattr(integrator, "bounce_block", recording)
    _, spans = _profiled(lambda: render(scene), tmp_path)
    c = tracing.counters()
    assert c["lanes"] == seen["lanes"] > c["live_lanes"] == seen["live_lanes"]
    # One SSAA pass (the queue holds every pixel): 4 lanes a slot.
    assert len([s for s in spans if s[0] == "rt.pipeline.ssaa"]) == 1
    with torch.no_grad():
        base = render_scene(_scene(enable_ssaa=False))[0]
    n_masked = int(sobel_mask(base).sum())
    cap = default_ssaa_capacity(st)
    assert 0 < n_masked <= cap
    assert c["ssaa_lanes"] == 4 * cap
    assert c["ssaa_masked"] == 4 * n_masked


def test_a_new_session_counts_from_zero(render_trace, tmp_path):
    scene, *_, first = render_trace
    kept = tracing.counters()
    render(scene)  # no session: nothing is counted
    assert tracing.counters() == kept
    for _ in range(2):  # back to back through profiling.trace
        with profiling.trace(str(tmp_path / "p"), device="cpu"):
            render(scene)
        assert tracing.counters() == first


def test_frames_bit_equal_with_tracing(render_trace):
    scene, frame, aux, *_ = render_trace
    frame_off, aux_off = render(scene)
    assert (frame_off == frame).all()
    assert aux_off["ssaa_masked"] == aux["ssaa_masked"]


def test_train_step_bit_equal_with_tracing(tmp_path):
    scene = _scene()
    with torch.no_grad():
        target = render_scene(_scene())[0] * 0.9
    results = []
    for traced in (False, True):
        init_fn, step_fn = make_train_step(PATHS)
        params = extract_params(scene, PATHS)
        opt = init_fn(params)

        def step():
            return step_fn(params, opt, scene, target)

        _, _, loss = _profiled(step, tmp_path)[0] if traced else step()
        results.append((loss, {k: (v.detach().clone(), v.grad.clone())
                               for k, v in params.items()}))
    (loss0, p0), (loss1, p1) = results
    assert torch.equal(loss0, loss1)
    for k in p0:
        assert torch.equal(p0[k][0], p1[k][0]), k
        assert torch.equal(p0[k][1], p1[k][1]), k


_SCENE = """[options]
width={w}
height={h}
enableOutput=1
outputProgress={progress}

[light]
type=point
position=0,1,0
color=1,1,1
intensity=2.0

[object]
type=sphere
pos=0,0,-3
radius=1
color=1,0.5,0.5
material=reflective

[object]
type=plane
pos=0,-1,0
normal=0,1,0
color=0.8,0.8,0.8
"""


@pytest.mark.parametrize("progress", [0, 1])
def test_trace_dir_writes_the_counters(tmp_path, monkeypatch, capsys,
                                       progress):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "s.scene").write_text(_SCENE.format(w=W, h=H,
                                                    progress=progress))
    rc = cli.main(["s.scene", "--output", "o.bmp", "--trace-dir", "tr"],
                  device="cpu")
    assert rc == 0 and os.path.exists("o.bmp")
    assert "Render scene" in capsys.readouterr().out
    traces = profiling.find_traces("tr")
    assert len(traces) == 1
    stem = traces[0][:-len(profiling.TRACE_SUFFIX)]
    with open(stem + profiling.COUNTERS_SUFFIX) as fh:
        counts = json.load(fh)
    assert counts["lanes"] >= counts["live_lanes"] > 0
    assert counts["ssaa_lanes"] > 0
    assert glob.glob("tr/*" + profiling.COUNTERS_SUFFIX) == [
        stem + profiling.COUNTERS_SUFFIX]
    with open(traces[0]) as fh:
        names = {e["name"] for e in json.load(fh)["traceEvents"]
                 if e.get("cat") == "user_annotation"}
    assert "rt.render" in names
    # The strips' "Sobel filter" and "MSAA" timers mark their phases.
    assert ({"rt.pipeline.sobel", "rt.pipeline.ssaa"} <= names) == bool(
        progress)


def test_timer_span_names(tmp_path):
    """A timer given a stage span marks its phase with it, the timer of a
    phase_timer too; a timer given none opens no span."""
    def phases():
        with timer.phase_timer("Render scene", enable_output=False,
                               span="rt.render"):
            t = timer.Timer("OBJ loading", enable_output=False,
                            span="rt.scene.obj")
            t.stop()
            timer.Timer("Total time", enable_output=False).stop()

    _, spans = _profiled(phases, tmp_path)
    names = [s[0] for s in spans]
    assert names == ["rt.render", "rt.scene.obj"]
    assert _inside(spans[1], spans[0])
