"""Port parity of the gradients of the inverse-rendering extras: autograd
through the port on the CPU against jax.grad of the JAX package (its
Pallas kernel in interpret mode) for every parameter family the other
gradient tests leave out.

- `ops.geometry.euler_matrix_j` and its gradient against JAX's.
- The camera: `cam_pos` and the Euler angles (through euler_matrix_j) on
  tests/test_grad_camera_reference.py's scene, an infinite plane that
  fills the frame (camera pitched 50 degrees, point light at x = 0.8).
  It has no silhouette, so each package makes its own rays: an ulp
  between them moves no hit.
- The mesh's normals, uvs, tangents, bitangents and its three maps on
  the flagship at 64x33 with 2000 triangles, at texture_filter nearest
  and bilinear, from shared primary rays.
- Skybox texels, on a seeded synthetic (6, 16, 16, 3) skybox behind two
  spheres, given to both packages' SceneDef.
- The bouncing families (bias, the materials, ior, the plane, the
  lights' colours, directions and positions, and the camera) on
  tests/test_grad.py's scene at max_ray_depth 2, against eager jax.grad
  (tests/test_torch_bounce_grad.py says why), from straight-through
  primary rays (torch_port_util.straight_through_primary_rays): the
  values shared, the gradient through each package's own rays, so that
  it reaches the camera.
- SSAA on, with both packages' Sobel mask frozen to one precomputed mask
  (each package computes its own, and an ulp can flip a mask pixel).

The loss is tests/test_torch_grad.py's sum(frame * w). Tolerance: its
`_assert_grad_close`, rtol 1e-4 and atol 1e-4 * max|g|: each gradient is
a sum of per-pixel terms in f32, which torch and XLA add in another
order. Every gradient is also nonzero somewhere, but for the uvs under
nearest filtering: the texel index is a floor of them, so both packages'
uv gradients are exactly 0 there (asserted).
"""

from __future__ import annotations

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rendering_tpu.render.pipeline as j_pipeline
import rendering_tpu_torch.render.pipeline as t_pipeline
from rendering_tpu.flagship import build_flagship_scene as j_flagship
from rendering_tpu.models import parser as j_parser
from rendering_tpu.models.scene import build_scene as j_build_scene
from rendering_tpu.models.scene import load_scene as j_load_scene
from rendering_tpu.models.settings import RenderSettings as JSettings
from rendering_tpu.ops.geometry import euler_matrix_j as j_euler
from rendering_tpu.ops.sobel import sobel_mask as j_sobel_mask
from rendering_tpu_torch.models.scene import load_scene as t_load_scene
from rendering_tpu_torch.models.settings import RenderSettings as TSettings
from rendering_tpu_torch.ops.geometry import euler_matrix_j as t_euler
from rendering_tpu_torch.render.pipeline import render_scene
from test_grad import _small_scene
from test_grad_camera_reference import BASE, SCENE_TMPL
from test_torch_grad import _assert_grad_close, _grads, _key
from torch_port_util import (
    loss_weights,
    port_scene,
    shared_primary_rays,
    straight_through_primary_rays,
)


def _assert_nonzero(g):
    assert np.abs(g).sum() > 0


# ---- euler_matrix_j ---------------------------------------------------------

ANGLES = ((50.0, 0.0, 0.0), (12.5, -100.0, 33.0), (-170.0, 89.5, 271.0))


@pytest.mark.parametrize("angles", ANGLES, ids=str)
def test_euler_matrix_j_matches_jax(angles):
    """The matrix within atol 2.5e-7 of JAX's; the gradient of a seeded
    weighted sum of its entries against jax.grad."""
    wgt = np.random.default_rng(3).normal(size=(3, 3)).astype(np.float32)
    a = np.asarray(angles, np.float32)
    j_m = np.asarray(j_euler(jnp.asarray(a)))
    jg = np.asarray(jax.grad(lambda r: jnp.sum(j_euler(r) * wgt))(
        jnp.asarray(a)))
    ta = torch.tensor(a, requires_grad=True)
    t_m = t_euler(ta)
    (t_m * torch.from_numpy(wgt)).sum().backward()
    np.testing.assert_allclose(t_m.detach().numpy(), j_m, rtol=0, atol=2.5e-7)
    _assert_grad_close(jg, ta.grad.numpy())
    _assert_nonzero(ta.grad.numpy())


# ---- the camera on the infinite plane ----------------------------------------

CAM_WH = (64, 48)


@pytest.fixture(scope="module")
def camera_grads(tmp_path_factory):
    """jax.grad and the port's gradient of sum(frame * w) with respect to
    cam_pos and the Euler angles, each package from its own rays."""
    d = tmp_path_factory.mktemp("fdcam")
    path = str(d / "fdcam.scene")
    with open(path, "w") as fh:
        fh.write(SCENE_TMPL.format(**BASE).replace(
            "width=200\nheight=150",
            f"width={CAM_WH[0]}\nheight={CAM_WH[1]}"))
    js = j_load_scene(path, JSettings(enable_ssaa=False,
                                      pallas_interpret=True))
    ts = t_load_scene(path, TSettings(enable_ssaa=False), device="cpu")
    assert ts.static.settings.width == CAM_WH[0]
    w = loss_weights((3, CAM_WH[1], CAM_WH[0]))
    angles = np.asarray([BASE["rx"], 0.0, 0.0], np.float32)

    def j_loss(p):
        s = dataclasses.replace(js, cam_pos=p["pos"],
                                cam_rmat=j_euler(p["angles"]))
        return jnp.sum(j_pipeline.render_scene.__wrapped__(s)[0] * w)

    jg = jax.jit(jax.grad(j_loss))({"pos": js.cam_pos,
                                    "angles": jnp.asarray(angles)})
    tp = {"pos": ts.cam_pos.clone().requires_grad_(True),
          "angles": torch.tensor(angles, requires_grad=True)}
    frame, _ = render_scene(dataclasses.replace(
        ts, cam_pos=tp["pos"], cam_rmat=t_euler(tp["angles"])))
    (frame * torch.from_numpy(w)).sum().backward()
    # The background (magenta: no green) never shows: the plane fills the
    # frame but for the dead last row and column.
    assert (frame[1, :-1, :-1] > 0).all()
    return ({k: np.asarray(v) for k, v in jg.items()},
            {k: v.grad.numpy() for k, v in tp.items()})


@pytest.mark.parametrize("key", ["pos", "angles"])
def test_camera_grad_matches_jax(camera_grads, key):
    jg, tg = camera_grads
    _assert_grad_close(jg[key], tg[key])
    _assert_nonzero(tg[key])
    if key == "pos":  # the light at x = 0.8 gives lateral motion signal
        assert tg[key][0] != 0 and tg[key][2] != 0
    else:
        assert tg[key][0] != 0


# ---- the mesh's attributes and maps ---------------------------------------------

MESH_PATHS = tuple(("meshes", 0, k) for k in (
    "n", "uv", "tangent", "bitangent", "diffuse_map", "normal_map",
    "specular_map"))


@pytest.fixture(scope="module", params=["nearest", "bilinear"])
def mesh_grads(request):
    js = j_flagship(64, 33, n_tris=2000, with_maps=True,
                    settings_overrides=dict(pallas_interpret=True,
                                            texture_filter=request.param))
    return request.param, _grads(js, MESH_PATHS)


@pytest.mark.parametrize("path", MESH_PATHS, ids=_key)
def test_mesh_attribute_grad_matches_jax(mesh_grads, path):
    texture_filter, (jg, tg) = mesh_grads
    k = _key(path)
    _assert_grad_close(jg[k], tg[k])
    if texture_filter == "nearest" and path[-1] == "uv":
        assert not jg[k].any() and not tg[k].any()
    else:
        _assert_nonzero(tg[k])


# ---- skybox texels ----------------------------------------------------------------


def _skybox_scene():
    """Two spheres over a seeded synthetic skybox, 48x31: most primary
    rays miss and read a texel."""
    st = JSettings(width=48, height=31, enable_ssaa=False,
                   enable_output=False, output_progress=False,
                   use_skybox=True, pallas_interpret=True)
    sd = j_parser.SceneDef(settings=st)
    sd.lights = [j_parser.LightDef("distant", color=(1, 1, 1),
                                   intensity=0.7, dir=(0.3, -1, -0.4))]
    sd.objects = [
        j_parser.ObjectDef("sphere", pos=(-0.7, 0, -4), radius=0.8,
                           color=(0.9, 0.4, 0.2)),
        j_parser.ObjectDef("sphere", pos=(1.0, 0.3, -5), radius=0.6,
                           color=(0.2, 0.5, 0.9), material="phong",
                           ambient=0.3, diffuse=0.4, specular=0.3,
                           n_specular=8.0),
    ]
    sd.skybox = np.random.default_rng(11).random(
        (6, 16, 16, 3)).astype(np.float32)
    sd.skybox_wh = (16, 16)
    return j_build_scene(sd)


def test_skybox_grad_matches_jax():
    path = ("skybox",)
    jg, tg = _grads(_skybox_scene(), (path,))
    _assert_grad_close(jg["skybox"], tg["skybox"])
    _assert_nonzero(tg["skybox"])
    # The camera looks down -z: the misses read many texels of that face.
    assert (np.abs(tg["skybox"][1]).sum(axis=-1) > 0).sum() >= 50


# ---- the bouncing families ------------------------------------------------------

BOUNCE_PATHS = tuple((k,) for k in (
    "bias", "obj_ior", "obj_diffuse", "obj_specular", "obj_nspec",
    "pln_pos", "pln_n", "cam_rmat", "cam_pos")) + (
    ("lights", 0, "color"), ("lights", 0, "pos"),
    ("lights", 1, "color"), ("lights", 1, "dir"))


@pytest.fixture(scope="module")
def bounce_grads():
    return _grads(_small_scene(pallas_interpret=True, max_ray_depth=2),
                  BOUNCE_PATHS, eager=True, rays=straight_through_primary_rays)


@pytest.mark.parametrize("path", BOUNCE_PATHS, ids=_key)
def test_bouncing_family_grad_matches_jax(bounce_grads, path):
    jg, tg = bounce_grads
    _assert_grad_close(jg[_key(path)], tg[_key(path)])
    _assert_nonzero(tg[_key(path)])


def test_straight_through_rays_reach_the_camera(bounce_grads):
    """Through the straight-through rays the camera gets a gradient from
    every pixel; with shared constant rays it would get none. The port's
    frame is the same, bit for bit, under both."""
    _, tg = bounce_grads
    assert (tg["cam_rmat"] != 0).sum() >= 6
    assert (tg["cam_pos"] != 0).all()
    js = _small_scene(pallas_interpret=True, max_ray_depth=2)
    ts = port_scene(js)
    frames = []
    for rays in (shared_primary_rays, straight_through_primary_rays):
        with rays(js), torch.no_grad():
            frames.append(render_scene(ts)[0].numpy())
    assert np.array_equal(frames[0].view(np.int32), frames[1].view(np.int32))


# ---- SSAA on, the Sobel mask frozen -----------------------------------------------

SSAA_PATHS = (("lights", 1, "intensity"), ("meshes", 0, "v"),
              ("meshes", 0, "diffuse_map"))


@contextlib.contextmanager
def frozen_sobel_mask(mask, calls: list):
    """Both packages' SSAA pass reads `mask` (H, W) bool instead of its
    own Sobel mask; each read appends its package to `calls`. JAX's
    `_ssaa_pass` runs unjitted inside the block, so no trace made before
    it is reused."""
    saved = (j_pipeline.sobel_mask, j_pipeline._ssaa_pass,
             t_pipeline.sobel_mask)

    def j_mask(frame3):
        calls.append("jax")
        return jnp.asarray(mask)

    def t_mask(frame3):
        calls.append("port")
        return torch.tensor(mask, device=frame3.device)

    j_pipeline.sobel_mask, t_pipeline.sobel_mask = j_mask, t_mask
    j_pipeline._ssaa_pass = j_pipeline._ssaa_pass.__wrapped__
    try:
        yield
    finally:
        (j_pipeline.sobel_mask, j_pipeline._ssaa_pass,
         t_pipeline.sobel_mask) = saved


@pytest.fixture(scope="module")
def ssaa_grads():
    # A capacity of half the pixels: the maps' edges mask ~40% of them.
    kw = dict(pallas_interpret=True, ssaa_capacity_fraction=0.5)
    js = j_flagship(64, 33, n_tris=2000, with_maps=True,
                    settings_overrides=kw)
    with shared_primary_rays(js):
        frame3 = j_pipeline.render_scene.__wrapped__(js)[0]
    mask = np.asarray(j_sobel_mask(frame3))
    js = j_flagship(64, 33, n_tris=2000, with_maps=True, enable_ssaa=True,
                    settings_overrides=kw)
    assert js.static.settings.enable_ssaa
    calls = []
    with frozen_sobel_mask(mask, calls):
        return mask, calls, _grads(js, SSAA_PATHS)


def test_ssaa_mask_is_frozen(ssaa_grads):
    mask, calls, _ = ssaa_grads
    assert 0 < mask.sum() <= 0.5 * mask.size  # within the SSAA capacity
    assert sorted(set(calls)) == ["jax", "port"]


@pytest.mark.parametrize("path", SSAA_PATHS, ids=_key)
def test_ssaa_grad_matches_jax(ssaa_grads, path):
    _, _, (jg, tg) = ssaa_grads
    _assert_grad_close(jg[_key(path)], tg[_key(path)])
    _assert_nonzero(tg[_key(path)])
