"""Port parity of gradients through the bounce loop: the reflective
child, the transparent queue's compaction and its permutations, the
pixel scatter, the refraction and fresnel guards and the depth-guard
skybox tail. Autograd through the port's render_scene on the CPU against
jax.grad of the JAX package's (its Pallas kernel in interpret mode),
with tests/test_torch_grad.py's loss and shared primary rays:

- tests/test_grad.py's scene (a phong, a reflective and a transparent
  sphere over a plane) at max_ray_depth 2, for its parameters: the point
  light's intensity, obj_color, sph_pos, sph_r, obj_ambient, bg_color.
  Against eager jax.grad (jax.disable_jit): jitted, XLA contracts
  multiply-adds into FMAs, and on the glass sphere's grazing refractions
  that moves its radius gradient by 1.2% (measured at depth 10: jit
  -0.79765, eager -0.78769, the port -0.78777), where the port, like the
  reference (-ffp-contract=off), keeps every f32 operation apart.
- The tiny scene (all four materials, the area light), jitted: the area
  light's intensity and the mesh vertices.

Tolerance: tests/test_torch_grad.py's, rtol 1e-4 and atol 1e-4 * max|g|.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from rendering_tpu_torch.diff import inverse as t_inverse
from rendering_tpu_torch.render.pipeline import render_scene
from test_grad import _small_scene
from test_torch_grad import _assert_grad_close, _grads, _key
from torch_port_util import jax_tiny_scene, loss_weights, port_scene

BOUNCE_PATHS = (("lights", 0, "intensity"), ("obj_color",), ("sph_pos",),
                ("sph_r",), ("obj_ambient",), ("bg_color",))
TINY_PATHS = (("lights", 2, "intensity"), ("meshes", 0, "v"))


@pytest.fixture(scope="module")
def bounce_grads():
    return _grads(_small_scene(pallas_interpret=True, max_ray_depth=2),
                  BOUNCE_PATHS, eager=True)


@pytest.fixture(scope="module")
def tiny_grads():
    return _grads(jax_tiny_scene(32, 17), TINY_PATHS)


@pytest.mark.parametrize("path", BOUNCE_PATHS, ids=_key)
def test_bouncing_grad_matches_jax(bounce_grads, path):
    jg, tg = bounce_grads
    _assert_grad_close(jg[_key(path)], tg[_key(path)])
    assert np.abs(tg[_key(path)]).sum() > 0


def test_bouncing_grads_reach_the_glass_sphere(bounce_grads):
    """The transparent sphere's position and radius get a gradient (only
    through refracted and reflected children: it casts no shadow)."""
    _, tg = bounce_grads
    assert np.abs(tg["sph_pos"][2]).sum() > 0 and tg["sph_r"][2] != 0


@pytest.mark.parametrize("path", TINY_PATHS, ids=_key)
def test_tiny_scene_grad_matches_jax(tiny_grads, path):
    jg, tg = tiny_grads
    _assert_grad_close(jg[_key(path)], tg[_key(path)])
    assert np.abs(tg[_key(path)]).sum() > 0


def test_bouncing_grads_finite_on_every_parameter():
    """Every float tensor of tests/test_grad.py's scene as a parameter at
    once (camera, bias, materials, ior, spheres, plane, lights): each
    gradient is finite, through the critical-angle and head-on guards
    too; only a point light's direction and a distant light's position,
    which nothing reads, get none."""
    ts = port_scene(_small_scene())
    paths = [(k,) for k in ("cam_pos", "cam_rmat", "scale", "bg_color",
                            "bias", "obj_color", "obj_ior", "obj_ambient",
                            "obj_diffuse", "obj_specular", "obj_nspec",
                            "sph_pos", "sph_r", "pln_pos", "pln_n")]
    paths += [("lights", i, k) for i in range(len(ts.lights))
              for k in ("color", "intensity", "dir", "pos")]
    params = t_inverse.extract_params(ts, paths)
    frame, _ = render_scene(t_inverse.apply_params(ts, params, paths))
    st = ts.static.settings
    (frame * torch.from_numpy(loss_weights((3, st.height, st.width)))
     ).sum().backward()
    unused = {f"lights/{i}/{k}" for i, li in enumerate(ts.lights)
              for k in (("pos",) if li.kind == "distant" else ("dir",))}
    for k, v in params.items():
        assert (v.grad is None) == (k in unused), k
        assert k in unused or torch.isfinite(v.grad).all(), k
    assert params["obj_ior"].grad[3] != 0  # the glass sphere's ior
