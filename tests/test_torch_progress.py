"""The port's strip renders and checkpoints against the JAX package on the
CPU: `render_with_progress` (outputProgress) and `render_resumable` on
t01_simple_shapes (a glass, a mirror and two spheres over a plane) at
64x48 in 16-row strips, their progress prints, out_u8, the resume after
a preemption and the stale-checkpoint rejection (as tests/test_progress.py
and tests/test_determinism.py hold the JAX package), `_scene_fingerprint`,
the showAC and showNormals delegation through both wrappers, and
`diff.checkpoint` with a torch optimizer.

Tolerances: a strip frame against the port's own one-shot frame at JAX's
strip tolerance (atol 2e-6, rtol 3e-4: a strip's kernel tiles and
transparent queue differ from the one-shot frame's, and so may its f32
summation order); against JAX's strip frame at the port's bouncing-frame
tolerance (`assert_bounce_frames_agree`: XLA contracts multiply-adds in
its jitted strips). A resumed render and a resumed Adam run are
bit-equal to uninterrupted ones.
"""

from __future__ import annotations

import dataclasses
import itertools
import os

import numpy as np
import pytest
import torch

from rendering_tpu.models.scene import load_scene as j_load_scene
from rendering_tpu.models.settings import RenderSettings as JSettings
from rendering_tpu.render.pipeline import (
    render_with_progress as j_render_with_progress,
)
import rendering_tpu_torch.render.pipeline as t_pipeline
from rendering_tpu_torch import cli
from rendering_tpu_torch.diff.checkpoint import (
    load_checkpoint,
    load_checkpoint_meta,
    save_checkpoint,
)
from rendering_tpu_torch.diff.inverse import extract_params, make_train_step
from rendering_tpu_torch.flagship import build_flagship_scene, build_tiny_scene
from rendering_tpu_torch.models.scene import load_scene
from rendering_tpu_torch.models.settings import RenderSettings
from rendering_tpu_torch.render.pipeline import (
    _scene_fingerprint,
    render,
    render_resumable,
    render_with_progress,
)
from rendering_tpu_torch.utils.bmp import (
    bmp_to_image,
    load_bmp,
    quantize_reference,
)
from test_golden import REPO, SCENE_MAD, SCENE_TOL, neighborhood_violations
from test_torch_debug import obj_workspace, write_debug_scene  # noqa: F401
from torch_port_util import assert_bounce_frames_agree, shared_strip_rays

STRIP_TOL = dict(atol=2e-6, rtol=3e-4)  # tests/test_progress.py:43


def _shrink(scene, w, h, **kw):
    st = scene.static
    return dataclasses.replace(scene, static=dataclasses.replace(
        st, settings=st.settings.replace(width=w, height=h, **kw)))


def _t01(w=64, h=48):
    return _shrink(load_scene("t01_simple_shapes.scene",
                              RenderSettings(ssaa_capacity_fraction=1.0),
                              device="cpu"), w, h)


def _fake_clock():
    """+2 s a read: every strip prints."""
    clock = itertools.count(step=2.0)
    return lambda: next(clock)


def test_progress_matches_jax_and_render(in_workspace):
    """16-row strips of a 64x48 frame: JAX's strip frame, from shared
    strip rays, within the bouncing-frame tolerance, the port's own render
    within JAX's strip tolerance, and both print 33%, 67%, 100% on a fake
    clock; the strips' rays cover the frame."""
    js = j_load_scene("t01_simple_shapes.scene",
                      JSettings(ssaa_capacity_fraction=1.0))
    js = dataclasses.replace(js, static=dataclasses.replace(
        js.static, settings=js.static.settings.replace(width=64, height=48)))
    j_lines, t_lines = [], []
    scene = _t01()
    with shared_strip_rays(js):
        j_frame, _ = j_render_with_progress(
            js, strip_rows=16, _now=_fake_clock(), _print=j_lines.append)
        t_frame, aux = render_with_progress(
            scene, strip_rows=16, _now=_fake_clock(), _print=t_lines.append)
    assert t_lines == j_lines == ["33%", "67%", "100%"]
    assert_bounce_frames_agree(t_frame.transpose(2, 0, 1),
                               np.asarray(j_frame).transpose(2, 0, 1))
    ref, _ = render(scene)
    np.testing.assert_allclose(t_frame, ref, **STRIP_TOL)
    assert aux["stats"]["rays_casted"] >= 64 * 48
    assert aux["ssaa_masked"] > 0


def test_out_u8_matches_quantized(in_workspace, tmp_path):
    """out_u8 quantizes the finished frame on the device: the bytes of
    quantize_reference of the f32 frame, for both wrappers."""
    scene = _t01()
    f32, _ = render_with_progress(scene, strip_rows=16, _print=lambda s: None)
    want = quantize_reference(f32)
    u8, _ = render_with_progress(scene, strip_rows=16, out_u8=True,
                                 _print=lambda s: None)
    np.testing.assert_array_equal(u8, want)
    u8_res, _ = render_resumable(scene, str(tmp_path / "ck.npz"),
                                 strip_rows=16, out_u8=True)
    np.testing.assert_array_equal(u8_res, want)


def test_resumable_resumes_bit_equal(tmp_path, monkeypatch):
    """The tiny four-material scene (tests/test_determinism.py:31): a
    fresh resumable run equals render() within the strip tolerance; a
    run resumed from its checkpoint with the last strip cleared renders
    only that strip and ends bit-equal to the uninterrupted run."""
    scene = build_tiny_scene(48, 40, n_tris=64, device="cpu")
    ref, _ = render(scene)
    ck = str(tmp_path / "strips.npz")
    out, _ = render_resumable(scene, ck, strip_rows=16, resume=False)
    np.testing.assert_allclose(out, ref, **STRIP_TOL)

    _s, _p, _o, frame_ck, mask = load_checkpoint(ck, {}, {})
    assert mask.tolist() == [True, True, True]
    mask[-1] = False
    acc = frame_ck.reshape(3, 40, 48).copy()
    acc[:, 32:, :] = 0.0
    save_checkpoint(ck, 2, {}, {}, frame=acc.reshape(3, -1), tile_mask=mask,
                    meta=load_checkpoint_meta(ck))
    strips = []
    real = t_pipeline._render_strip

    def counting(*a, **kw):
        strips.append(kw["y0"])
        return real(*a, **kw)

    monkeypatch.setattr(t_pipeline, "_render_strip", counting)
    out2, _ = render_resumable(scene, ck, strip_rows=16)
    assert strips == [32]
    np.testing.assert_array_equal(out2, out)


def test_resumable_rejects_stale_scene_checkpoint(in_workspace, tmp_path,
                                                  capsys):
    """A finished checkpoint of another scene at the same resolution (the
    point light at half its intensity) is ignored with JAX's warning and
    the frame renders from scratch; the original scene resumes from its
    own checkpoint to the same frame with its counters restored."""
    scene_a = _t01()
    ck = str(tmp_path / "stale.npz")
    f_a, aux_a = render_resumable(scene_a, ck, strip_rows=16)
    l0 = scene_a.lights[0]
    scene_b = dataclasses.replace(scene_a, lights=(dataclasses.replace(
        l0, intensity=l0.intensity * 0.5),) + tuple(scene_a.lights[1:]))
    f_b_fresh, _ = render_resumable(scene_b, str(tmp_path / "fresh.npz"),
                                    strip_rows=16)
    capsys.readouterr()
    f_b_resumed, _ = render_resumable(scene_b, ck, strip_rows=16)
    assert "ignoring checkpoint" in capsys.readouterr().out
    np.testing.assert_array_equal(f_b_fresh, f_b_resumed)
    assert not np.array_equal(f_a, f_b_resumed)
    f_a2, aux_a2 = render_resumable(scene_a, ck, strip_rows=16)
    np.testing.assert_array_equal(f_a, f_a2)
    assert aux_a2["stats"]["rays_casted"] >= aux_a["stats"]["rays_casted"]


def test_fingerprint_detects_edits():
    """A uniform vertex shift, one interior vertex edit and a texel
    repaint each change the fingerprint; recomputing it does not."""
    scene = build_flagship_scene(32, 24, n_tris=4096, device="cpu")
    m = scene.meshes[0]
    fp0 = _scene_fingerprint(scene)
    assert fp0 == _scene_fingerprint(scene)

    def with_mesh(**kw):
        return dataclasses.replace(
            scene, meshes=(dataclasses.replace(m, **kw),))

    assert _scene_fingerprint(with_mesh(v=m.v + 0.01)) != fp0
    v2 = m.v.clone()
    v2[m.v.shape[0] // 2, 1, 1] += 0.25
    assert _scene_fingerprint(with_mesh(v=v2)) != fp0
    assert m.diffuse_map is not None
    repainted = with_mesh(diffuse_map=torch.clamp(m.diffuse_map * 0.5, 0, 1))
    assert _scene_fingerprint(repainted) != fp0


@pytest.mark.parametrize("mode", ["show_ac", "show_normals"])
def test_debug_passes_through_strip_wrappers(obj_workspace, tmp_path, mode):
    """On a written-OBJ scene file: showAC delegates (bit-equal to
    render(), "100%" printed); showNormals with SSAA strips and refines
    like render(), within JAX's strip tolerance."""
    path = write_debug_scene(obj_workspace, "d.scene",
                             ac=int(mode == "show_ac"),
                             normals=int(mode == "show_normals"))
    scene = load_scene(path, device="cpu")
    assert scene.static.settings.enable_ssaa
    ref, aux = render(scene)
    lines = []
    f_prog, _ = render_with_progress(scene, strip_rows=8,
                                     _print=lines.append)
    f_res, _ = render_resumable(scene, str(tmp_path / "ck.npz"),
                                strip_rows=8)
    if mode == "show_ac":
        assert lines == ["100%"]
        np.testing.assert_array_equal(f_prog, ref)
        np.testing.assert_array_equal(f_res, ref)
    else:
        assert aux["ssaa_masked"] > 0
        np.testing.assert_allclose(f_prog, ref, **STRIP_TOL)
        np.testing.assert_allclose(f_res, ref, **STRIP_TOL)


@pytest.mark.parametrize("name", ["t08_shownormals", "t09_showac"])
def test_bunny_debug_goldens(in_workspace, name):
    """The debug goldens through the port's CLI (outputProgress as the
    scene files set it), within tests/test_golden.py's limits; they need
    the reference's bunny.obj."""
    if not os.path.exists(os.path.join("input", "objects", "bunny.obj")):
        pytest.skip("reference assets not mounted")
    assert cli.main([f"{name}.scene", "--output", f"{name}.bmp"],
                    device="cpu") == 0
    ours = bmp_to_image(load_bmp(f"{name}.bmp"))
    gold = bmp_to_image(load_bmp(os.path.join(REPO, "tests", "goldens",
                                              f"{name}.bmp")))
    inner = np.abs(ours.astype(np.int16) - gold.astype(np.int16))[1:-1, 1:-1]
    measured = ((inner > 1).mean(), (inner > 8).mean(),
                neighborhood_violations(ours, gold)[1:-1, 1:-1].mean(),
                inner.mean())
    limits = (*SCENE_TOL[name], SCENE_MAD[name])
    assert all(m <= t for m, t in zip(measured, limits)), (measured, limits)


# ---- diff/checkpoint.py ----------------------------------------------------


def _params():
    return {"lights/0/intensity": torch.tensor(0.7, requires_grad=True),
            "obj_color": torch.tensor([[0.1, 0.2, 0.3], [0.4, 0.5, 0.6]],
                                      requires_grad=True)}


def test_checkpoint_round_trip(tmp_path):
    """Parameters, the optimizer state, frame, tile mask and meta come back
    as saved, into the templates; the file is an npz with JAX's layout."""
    p = _params()
    opt = torch.optim.Adam(list(p.values()), lr=1e-2)
    (p["lights/0/intensity"] * p["obj_color"].sum()).backward()
    opt.step()
    frame = np.arange(12, dtype=np.float32).reshape(3, 4)
    mask = np.array([True, False, True])
    ck = str(tmp_path / "ck.npz")
    save_checkpoint(ck, 7, p, opt, frame=frame, tile_mask=mask,
                    meta={"scene_fp": np.int64(-5), "rays_casted": 12.0})
    assert not os.path.exists(ck + ".tmp.npz")
    with np.load(ck) as data:
        assert {"step", "params__treedef", "params__0", "opt__treedef",
                "frame", "tile_mask", "meta__scene_fp"} <= set(data.files)
    q = {k: torch.zeros_like(v).requires_grad_(True) for k, v in p.items()}
    opt_q = torch.optim.Adam(list(q.values()), lr=1e-2)
    step, q2, opt_q2, frame_l, mask_l = load_checkpoint(ck, q, opt_q)
    assert step == 7 and q2 is q and opt_q2 is opt_q
    for k in p:
        assert torch.equal(q[k], p[k]) and q[k].requires_grad
    st_p, st_q = opt.state_dict()["state"], opt_q.state_dict()["state"]
    for i in st_p:
        for key in st_p[i]:
            assert torch.equal(st_p[i][key], st_q[i][key])
    np.testing.assert_array_equal(frame_l, frame)
    np.testing.assert_array_equal(mask_l, mask)
    meta = load_checkpoint_meta(ck)
    assert int(meta["scene_fp"]) == -5 and float(meta["rays_casted"]) == 12.0


def test_checkpoint_structure_mismatch_raises(tmp_path):
    """A renamed or reordered parameter, or an optimizer over other
    parameter groups, raises instead of loading into the wrong slot."""
    p = _params()
    ck = str(tmp_path / "ck.npz")
    save_checkpoint(ck, 1, p, torch.optim.Adam(list(p.values())))
    keys = list(p)
    reordered = {k: p[k].detach().clone() for k in reversed(keys)}
    renamed = {"x" + k: v.detach().clone() for k, v in p.items()}
    for bad in (reordered, renamed):
        with pytest.raises(ValueError, match="params structure"):
            load_checkpoint(ck, bad, {})
    q = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
    split = torch.optim.Adam([{"params": [q[keys[0]]]},
                              {"params": [q[keys[1]]]}])
    with pytest.raises(ValueError, match="optimizer structure"):
        load_checkpoint(ck, q, split)


def test_adam_resumed_bit_equal(tmp_path):
    """Three Adam steps of the train step on a small flagship scene
    against two steps, a checkpoint, fresh parameters and optimizer
    restored from it, and the third step: loss, parameters and the
    optimizer state bit-equal."""
    paths = (("lights", 0, "intensity"), ("obj_color",), ("meshes", 0, "v"))
    scene = build_flagship_scene(16, 12, n_tris=200, with_maps=False,
                                 device="cpu")
    target = torch.from_numpy(
        np.random.default_rng(0).uniform(size=(3, 12, 16)).astype(np.float32))
    init, step = make_train_step(paths)

    params = extract_params(scene, paths)
    opt = init(params)
    losses = [step(params, opt, scene, target)[2] for _ in range(3)]

    params_b = extract_params(scene, paths)
    opt_b = init(params_b)
    for _ in range(2):
        step(params_b, opt_b, scene, target)
    ck = str(tmp_path / "train.npz")
    save_checkpoint(ck, 2, params_b, opt_b)
    params_c = extract_params(scene, paths)
    opt_c = init(params_c)
    n, params_c, opt_c, _, _ = load_checkpoint(ck, params_c, opt_c)
    assert n == 2
    _, _, loss_c = step(params_c, opt_c, scene, target)
    assert torch.equal(loss_c, losses[2])
    for k in params:
        assert torch.equal(params_c[k], params[k]), k
    sa, sc = opt.state_dict()["state"], opt_c.state_dict()["state"]
    for i in sa:
        for key in sa[i]:
            assert torch.equal(sa[i][key], sc[i][key])
