"""Port parity of the whole forward render: rendering_tpu_torch's
render_scene on the CPU against the JAX package's render_scene with the
Pallas kernel in interpret mode, on the flagship scene and on a
hand-built non-bouncing scene; plus the port's import boundary.

Tolerance: frames agree to atol=2e-5 (XLA's exp/log/sqrt may differ from
torch's by an ulp and it may fuse sums in another order), and the u8
frames within tests/test_golden.py's DEFAULT_TOL measures.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rendering_tpu.flagship import build_flagship_scene as j_flagship
from rendering_tpu.flagship import procedural_mesh as j_procedural_mesh
from rendering_tpu.models import parser as j_parser
from rendering_tpu.models.scene import build_scene as j_build_scene
from rendering_tpu.models.settings import RenderSettings as JSettings
from rendering_tpu.render.pipeline import quantize_u8 as j_quantize_u8
from rendering_tpu.render.pipeline import render_scene as j_render_scene
from rendering_tpu_torch.flagship import build_flagship_scene as t_flagship
from rendering_tpu_torch.flagship import procedural_mesh as t_procedural_mesh
from rendering_tpu_torch.models import parser as t_parser
from rendering_tpu_torch.models.scene import build_scene as t_build_scene
from rendering_tpu_torch.models.settings import RenderSettings as TSettings
from rendering_tpu_torch.render.pipeline import render, render_scene
from torch_port_util import (
    golden_fractions,
    jax_leaves,
    port_scene,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "rendering_tpu_torch")
GOLDEN_TOL = (0.006, 0.005)  # tests/test_golden.py DEFAULT_TOL, first two
INTERPRET = dict(pallas_interpret=True)


def _assert_frames_agree(j_frame, t_frame):
    jf = np.asarray(j_frame)
    tf = t_frame.detach().cpu().numpy()
    assert jf.shape == tf.shape
    assert np.isfinite(tf).all()
    np.testing.assert_allclose(tf, jf, rtol=0, atol=2e-5)
    ju8 = np.asarray(j_quantize_u8(j_frame))
    tu8 = render_scene_u8(t_frame)
    f1, f8 = golden_fractions(ju8, tu8)
    assert f1 <= GOLDEN_TOL[0] and f8 <= GOLDEN_TOL[1]


def render_scene_u8(frame3):
    from rendering_tpu_torch.render.pipeline import quantize_u8

    return quantize_u8(frame3).cpu().numpy()


# ---- scene carried across -----------------------------------------------------


@pytest.mark.parametrize("with_maps", [True, False])
def test_scene_from_numpy_round_trip(with_maps):
    """The JAX flagship's leaves carried across equal the port's own
    build of the same scene, tensor for tensor."""
    js = j_flagship(64, 32, n_tris=2000, with_maps=with_maps)
    leaves = jax_leaves(js)
    cs = port_scene(js)
    ts = t_flagship(64, 32, n_tris=2000, with_maps=with_maps, device="cpu")
    for k in ("cam_pos", "cam_rmat", "scale", "bg_color", "bias", "obj_color",
              "obj_ambient", "obj_diffuse", "obj_specular", "obj_nspec",
              "mat_type"):
        np.testing.assert_array_equal(getattr(cs, k).numpy(), leaves[k])
        assert torch.equal(getattr(cs, k), getattr(ts, k))
    for k in ("v", "n", "uv", "tangent", "bitangent", "vgeoT"):
        np.testing.assert_array_equal(getattr(cs.meshes[0], k).numpy(),
                                      leaves[f"meshes.0.{k}"])
        assert torch.equal(getattr(cs.meshes[0], k), getattr(ts.meshes[0], k))
    for k in ("tri", "cbox", "sbox"):
        assert torch.equal(getattr(cs.meshes[0].itables, k),
                           getattr(ts.meshes[0].itables, k))
    for k in ("color", "intensity", "dir", "pos"):
        for i in range(2):
            assert torch.equal(getattr(cs.lights[i], k),
                               getattr(ts.lights[i], k))
    if with_maps:
        assert torch.equal(cs.meshes[0].mapsT, ts.meshes[0].mapsT)
        assert cs.static.meshes[0].pmap_wh == js.static.meshes[0].pmap_wh
    assert cs.static == ts.static


# ---- whole render ------------------------------------------------------------


@pytest.mark.parametrize("with_maps,texture_filter", [
    (True, "nearest"), (False, "nearest"), (True, "bilinear")])
def test_flagship_render_matches_jax(with_maps, texture_filter):
    js = j_flagship(64, 32, n_tris=2000, with_maps=with_maps,
                    settings_overrides=dict(INTERPRET,
                                            texture_filter=texture_filter))
    j_frame, _ = j_render_scene(js)
    ts = t_flagship(64, 32, n_tris=2000, with_maps=with_maps, device="cpu",
                    settings_overrides=dict(texture_filter=texture_filter))
    t_frame, aux = render_scene(ts)
    assert t_frame.shape == (3, 32, 64)
    assert (t_frame[:, -1, :] == 0).all() and (t_frame[:, :, -1] == 0).all()
    assert aux["stats"]["rays_casted"] > 64 * 32
    _assert_frames_agree(j_frame, t_frame)


def _hand_built_defs(mod, settings, area_samples=2):
    """A non-bouncing scene of every primitive kind and light kind:
    plane, diffuse sphere, phong mesh, point, distant and area lights."""
    sd = mod.SceneDef(settings=settings)
    sd.lights = [
        mod.LightDef("point", color=(1, 0.9, 0.8), intensity=0.7,
                     pos=(0, 2, -1)),
        mod.LightDef("distant", color=(1, 1, 1), intensity=0.3,
                     dir=(0.2, -1, -0.4)),
        mod.LightDef("area", color=(1, 1, 1), intensity=40.0,
                     pos=(0, 3, -3), i=(1.5, 0, 0), j=(0, 0, 1.5),
                     samples=area_samples),
    ]
    mesh = mod.ObjectDef("mesh", pos=(0.8, 0.1, -3), size=(1.4, 1.4, 1.4),
                         color=(1, 1, 1), material="phong", ambient=0.4,
                         diffuse=0.1, specular=0.7, n_specular=10.0)
    sd.objects = [
        mod.ObjectDef("plane", pos=(0, -1.5, 0), normal=(0, 1, 0),
                      color=(0.85, 0.85, 0.85)),
        mesh,
        mod.ObjectDef("sphere", pos=(-0.9, -0.2, -2.6), radius=0.6,
                      color=(0.9, 0.3, 0.2)),
        mod.ObjectDef("sphere", pos=(0.2, 0.8, -4), radius=0.8,
                      color=(0.3, 0.6, 0.9), material="phong", ambient=0.2,
                      diffuse=0.5, specular=0.4, n_specular=20.0),
    ]
    return sd, mesh


@pytest.mark.parametrize("area_samples", [2, 1])
def test_hand_built_scene_matches_jax(area_samples):
    kw = dict(width=64, height=32, enable_ssaa=False,
              background_color=(0.2, 0.25, 0.3))
    jsd, jmesh = _hand_built_defs(j_parser, JSettings(
        output_progress=False, enable_output=False, **kw, **INTERPRET),
        area_samples)
    jmesh.mesh = j_procedural_mesh(600, pos=(0.8, 0.1, -3),
                                   size=(1.4, 1.4, 1.4))
    js = j_build_scene(jsd)
    j_frame, _ = j_render_scene(js)

    tsd, tmesh = _hand_built_defs(t_parser, TSettings(**kw), area_samples)
    tmesh.mesh = t_procedural_mesh(600, pos=(0.8, 0.1, -3),
                                   size=(1.4, 1.4, 1.4))
    ts = t_build_scene(tsd, device="cpu")
    t_frame, _ = render_scene(ts)
    _assert_frames_agree(j_frame, t_frame)
    # Every object and the background are on screen.
    colors = {tuple(c) for c in np.round(
        t_frame.numpy()[:, :-1, :-1].reshape(3, -1).T, 3)}
    assert len(colors) > 100


def test_render_host_wrapper():
    ts = t_flagship(32, 16, n_tris=500, with_maps=False, device="cpu")
    frame, _ = render(ts)
    u8, _ = render(ts, out_u8=True)
    assert frame.shape == (16, 32, 3) and u8.shape == (16, 32, 3)
    assert u8.dtype == np.uint8
    from rendering_tpu_torch.utils.bmp import quantize_reference

    np.testing.assert_array_equal(u8, quantize_reference(frame))


def test_render_is_differentiable():
    """The render stays autograd-clean: gradients of the mean pixel reach
    the distant light's intensity (the point and area falloffs saturate
    at 1 here), object colors and the mesh's gather table (the fwd+bwd
    slice holds them against jax.grad)."""
    sd, mesh = _hand_built_defs(t_parser, TSettings(width=32, height=16,
                                                    enable_ssaa=False))
    mesh.mesh = t_procedural_mesh(300, pos=(0.8, 0.1, -3),
                                  size=(1.4, 1.4, 1.4))
    ts = t_build_scene(sd, device="cpu")
    ts.obj_color.requires_grad_(True)
    ts.lights[1].intensity.requires_grad_(True)
    vgeoT = ts.meshes[0].vgeoT.requires_grad_(True)
    frame, _ = render_scene(ts)
    frame.mean().backward()
    for g in (ts.obj_color.grad, ts.lights[1].intensity.grad, vgeoT.grad):
        assert g is not None and torch.isfinite(g).all() and g.abs().sum() > 0


# ---- what the slice does not render yet ------------------------------------------


@pytest.mark.parametrize("change", [
    "enable_ssaa", "show_normals", "show_ac", "collect_statistics",
    "reflective", "transparent",
])
def test_unported_features_raise(change):
    overrides = {}
    if change in ("enable_ssaa", "show_normals", "show_ac",
                  "collect_statistics"):
        overrides[change] = True
    ts = t_flagship(16, 8, n_tris=200, with_maps=False, device="cpu",
                    settings_overrides=overrides)
    if change in ("reflective", "transparent"):
        from rendering_tpu_torch.models.scene import _MAT_IDS

        ts = dataclasses.replace(ts, static=dataclasses.replace(
            ts.static, mat_types=(_MAT_IDS[change],)))
    with pytest.raises(NotImplementedError):
        render_scene(ts)


def test_multi_mesh_and_clipped_mesh_raise():
    sd, mesh = _hand_built_defs(t_parser, TSettings(width=8, height=8))
    mesh.mesh = t_procedural_mesh(100, pos=(0.8, 0.1, -3), size=(1, 1, 1))
    sd.objects.append(mesh)
    with pytest.raises(NotImplementedError, match="two or more meshes"):
        t_build_scene(sd, device="cpu")
    sd.objects.pop()
    m = mesh.mesh
    m.root_bounds = m.root_bounds * 0.5  # the mesh now pokes outside
    with pytest.raises(NotImplementedError, match="root"):
        t_build_scene(sd, device="cpu")


def test_default_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_flagship(16, 8, n_tris=200)


# ---- the import boundary ---------------------------------------------------------


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_reference_package():
    files = [os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs
             if f.endswith(".py")]
    files.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(files) > 15
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "rendering_tpu"), (path, mod)


def test_import_leaves_jax_unloaded():
    code = ("import sys, rendering_tpu_torch.render.pipeline, "
            "rendering_tpu_torch.flagship, rendering_tpu_torch.convert; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not any(m.split('.')[0] == 'rendering_tpu' "
            "for m in sys.modules)")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
