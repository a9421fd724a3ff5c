"""Port parity of multi-frame rendering (render/animation.py) on the CPU,
and of the phase timer and the profiler (utils/timer.py, utils/profiling.py):

- `look_at_rotation` and `orbit_cameras` bit-equal to the JAX package's
  (the same float64 numpy code); `set_camera` holds `euler_matrix`;
- `render_frames` equal to the port's `render` of each camera bit for bit,
  and within tests/test_golden.py's DEFAULT_TOL of the JAX package's
  `render_frames` (u8, each package from its own rays);
- `render_frames_pipelined` equal to `render_frames` at depth 1, 2 and 3,
  in f32 and u8, and the redo of a frame whose SSAA mask overflowed;
- `mesh=` raising NotImplementedError;
- `phase_timer` recording into its dict; `trace` writing a trace of the
  CPU's operators, and `op_profile` reading rows from it.

The scene is tests/test_animation.py's: a red sphere over a plane, 48x32.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import pytest
import torch

from rendering_tpu.render import animation as j_anim
from rendering_tpu.utils.bmp import quantize_reference
from rendering_tpu_torch.models.objloader import euler_matrix
from rendering_tpu_torch.parallel.shard import make_ray_mesh
from rendering_tpu_torch.render import animation as t_anim
from rendering_tpu_torch.render.pipeline import render
from rendering_tpu_torch.utils.profiling import find_traces, op_profile, trace
from rendering_tpu_torch.utils.timer import phase_timer
from test_animation import _tiny_scene
from test_golden import DEFAULT_TOL
from torch_port_util import golden_fractions, port_scene

CAMS = t_anim.orbit_cameras((0, 0, -4), 3.5, 3, elevation_deg=10.0)


@pytest.fixture(scope="module")
def scenes():
    js = _tiny_scene()
    return js, port_scene(js)


def _with_settings(ts, **kw):
    return dataclasses.replace(ts, static=dataclasses.replace(
        ts.static, settings=ts.static.settings.replace(**kw)))


def test_camera_paths_bit_equal_to_jax():
    rng = np.random.default_rng(7)
    pos = np.array([0.3, -0.2, 1.5])
    targets = list(rng.normal(size=(20, 3)) * 3.0) + [
        pos + np.array([0, 0, -2.0]), pos + np.array([0, 0, 2.0]),
        pos + np.array([0, 2.0, 0.01]), pos + np.array([2.0, 0, 0]),
    ]
    for t in targets:
        a = t_anim.look_at_rotation(pos, t)
        b = j_anim.look_at_rotation(pos, t)
        assert a.dtype == b.dtype == np.float64
        np.testing.assert_array_equal(a, b)
    for kw in (dict(), dict(elevation_deg=25.0, start_deg=10.0)):
        for (pa, ra), (pb, rb) in zip(
                t_anim.orbit_cameras((0.5, -1, -4), 3.0, 7, **kw),
                j_anim.orbit_cameras((0.5, -1, -4), 3.0, 7, **kw)):
            np.testing.assert_array_equal(pa, pb)
            np.testing.assert_array_equal(ra, rb)
    with pytest.raises(ValueError):
        t_anim.look_at_rotation(pos, pos)


def test_set_camera(scenes):
    _, ts = scenes
    pos, rot = CAMS[1]
    s = t_anim.set_camera(ts, pos, rot_deg=rot)
    assert torch.equal(s.cam_rmat, torch.from_numpy(euler_matrix(rot)))
    assert torch.equal(s.cam_pos, torch.tensor(pos, dtype=torch.float32))
    s2 = t_anim.set_camera(ts, pos, look_at=(0, 0, -4))
    assert torch.equal(s2.cam_rmat, s.cam_rmat)
    with pytest.raises(ValueError):
        t_anim.set_camera(ts, pos)


def test_render_frames_equal_single_renders_and_match_jax(scenes):
    js, ts = scenes
    frames = [f for f, _ in t_anim.render_frames(ts, CAMS)]
    assert len(frames) == 3
    for (pos, rot), frame in zip(CAMS, frames):
        ref, _ = render(t_anim.set_camera(ts, pos, rot_deg=rot))
        assert np.array_equal(frame.view(np.int32), ref.view(np.int32))
    assert not np.array_equal(frames[0], frames[1])
    j_frames = [f for f, _ in j_anim.render_frames(js, CAMS)]
    for f, jf in zip(frames, j_frames):
        gt1, gt8 = golden_fractions(quantize_reference(f),
                                    quantize_reference(np.asarray(jf)))
        assert gt1 <= DEFAULT_TOL[0] and gt8 <= DEFAULT_TOL[1], (gt1, gt8)
    u8 = [f for f, _ in t_anim.render_frames(ts, CAMS, out_u8=True)]
    for f, f8 in zip(frames, u8):
        assert f8.dtype == np.uint8
        np.testing.assert_array_equal(f8, quantize_reference(f))


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("out_u8", [False, True])
def test_pipelined_equals_sequential(scenes, depth, out_u8):
    _, ts = scenes
    cams = t_anim.orbit_cameras((0, 0, -4), 3.5, 4)
    seq = [f for f, _ in t_anim.render_frames(ts, cams, out_u8=out_u8)]
    pip = list(t_anim.render_frames_pipelined(ts, cams, out_u8=out_u8,
                                              depth=depth))
    assert len(pip) == 4
    for a, (b, aux) in zip(seq, pip):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(np.ascontiguousarray(a).view(np.uint8),
                              np.ascontiguousarray(b).view(np.uint8))
        assert "stats" in aux


def test_pipelined_redoes_ssaa_overflow(scenes, monkeypatch):
    """With SSAA on and a capacity of 1% of the pixels, the Sobel mask
    overflows: each pipelined frame is redone through `render`'s
    escalating wrapper and equals its single render."""
    _, ts = scenes
    ts = _with_settings(ts, enable_ssaa=True, ssaa_capacity_fraction=0.01)
    cams = t_anim.orbit_cameras((0, 0, -4), 3.5, 2)
    redone = []
    real = t_anim.render

    def counting_render(s, **kw):
        redone.append(s)
        return real(s, **kw)

    monkeypatch.setattr(t_anim, "render", counting_render)
    pip = [f for f, _ in t_anim.render_frames_pipelined(ts, cams)]
    assert len(redone) == 2
    monkeypatch.undo()
    for (pos, rot), frame in zip(cams, pip):
        ref, aux = render(t_anim.set_camera(ts, pos, rot_deg=rot))
        assert aux["ssaa_masked"] > 0.01 * 48 * 32
        assert np.array_equal(frame, ref)


def test_mesh_raises(scenes):
    """render_frames*(mesh=) on a one-rank ray mesh (this process alone)
    gives render_frames' frames without one; an object that is no mesh
    raises. tests/test_torch_parallel.py runs the mesh paths on several
    ranks."""
    _, ts = scenes
    want = [f for f, _ in t_anim.render_frames(ts, CAMS)]
    mesh = make_ray_mesh(device="cpu")
    for fn in (t_anim.render_frames, t_anim.render_frames_pipelined):
        got = [f for f, _ in fn(ts, CAMS, mesh=mesh)]
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, atol=2e-6, rtol=0)
        with pytest.raises(AttributeError):
            list(fn(ts, CAMS, mesh=object()))


def test_phase_timer_records(capsys):
    result = {}
    with phase_timer("sleep", result=result, device="cpu") as t:
        time.sleep(0.02)
    assert result["sleep"] == t.elapsed_ms >= 20.0
    assert "sleep" in capsys.readouterr().out
    with pytest.raises(RuntimeError):
        with phase_timer("raise", enable_output=False, result=result):
            raise RuntimeError
    assert result["raise"] >= 0.0


def test_trace_and_op_profile_on_the_cpu(scenes, tmp_path):
    _, ts = scenes
    d = str(tmp_path / "tr")
    with pytest.raises(FileNotFoundError):
        op_profile(d)
    with trace(d, device="cpu"):
        render(ts)
    assert len(find_traces(d)) == 1
    rows = op_profile(d, top=5)
    assert len(rows) == 5
    assert all(isinstance(n, str) and t > 0 for n, t in rows)
    assert [t for _, t in rows] == sorted((t for _, t in rows), reverse=True)
    assert any(n.startswith("aten::") for n, _ in rows)
