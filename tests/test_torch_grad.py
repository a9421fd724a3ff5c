"""Port parity of gradients: autograd through the port's render_scene on
the CPU against jax.grad of the JAX package's render_scene (its Pallas
kernel in interpret mode), for light intensities, obj_color and mesh
vertices. On the flagship at 64x32 with 2000 triangles and its maps
(one mesh: the K1/K2 path) and on the two-mesh scene of
tests/test_fused.py at 64x31 (the fused K5 path, both meshes' vertices;
see torch_port_util.jax_two_mesh_scene for the odd height). The loss is
tests/test_fused.py's sum(frame * w), w = (flat index % 7 + 1) / 7, and
both packages render from the same primary rays
(torch_port_util.shared_primary_rays). Bouncing scenes:
tests/test_torch_bounce_grad.py.

Tolerance: rtol 1e-4 and atol 1e-4 * max|g|. Each gradient is a sum of
per-pixel terms in f32; torch and XLA add them, and the terms' own
products, in another order. Measured: at most 1.2e-5 * max|g|.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rendering_tpu.render.pipeline as j_pipeline
from rendering_tpu.diff import inverse as j_inverse
from rendering_tpu.flagship import build_flagship_scene as j_flagship
from rendering_tpu_torch.diff import inverse as t_inverse
from rendering_tpu_torch.render.pipeline import render_scene
from torch_port_util import (
    jax_two_mesh_scene,
    loss_weights,
    port_scene,
    shared_primary_rays,
)

FLAGSHIP_PATHS = (("lights", 0, "intensity"), ("lights", 1, "intensity"),
                  ("obj_color",), ("meshes", 0, "v"))
TWO_MESH_PATHS = (("lights", 0, "intensity"), ("lights", 1, "intensity"),
                  ("obj_color",), ("meshes", 0, "v"), ("meshes", 1, "v"))


def _key(path):
    return "/".join(map(str, path))


def _grads(js, paths, eager=False, rays=shared_primary_rays):
    """({key: jax.grad}, {key: port grad}) of sum(frame * w), as numpy.
    eager: jax.grad op by op (jax.disable_jit), without the FMA
    contraction of a jitted program. rays: the context that gives both
    packages the same primary rays (torch_port_util's
    straight_through_primary_rays where the camera is a parameter)."""
    ts = port_scene(js)
    st = js.static.settings
    w = loss_weights((3, st.height, st.width))
    with rays(js):
        def loss(p):
            s = j_inverse.apply_params(js, p, paths)
            return jnp.sum(j_pipeline.render_scene.__wrapped__(s)[0] * w)

        params = j_inverse.extract_params(js, paths)
        if eager:
            with jax.disable_jit():
                jg = jax.grad(loss)(params)
        else:
            jg = jax.jit(jax.grad(loss))(params)
        tp = t_inverse.extract_params(ts, paths)
        frame, _ = render_scene(t_inverse.apply_params(ts, tp, paths))
        (frame * torch.from_numpy(w)).sum().backward()
    return ({k: np.asarray(v) for k, v in jg.items()},
            {k: v.grad.numpy() for k, v in tp.items()})


@pytest.fixture(scope="module")
def flagship_grads():
    js = j_flagship(64, 32, n_tris=2000, with_maps=True,
                    settings_overrides=dict(pallas_interpret=True))
    return _grads(js, FLAGSHIP_PATHS)


@pytest.fixture(scope="module")
def two_mesh_grads():
    return _grads(jax_two_mesh_scene(height=31), TWO_MESH_PATHS)


def _assert_grad_close(jg, tg):
    assert tg.shape == jg.shape and np.isfinite(tg).all()
    np.testing.assert_allclose(tg, jg, rtol=1e-4,
                               atol=1e-4 * float(np.abs(jg).max()))


@pytest.mark.parametrize("path", FLAGSHIP_PATHS, ids=_key)
def test_flagship_grad_matches_jax(flagship_grads, path):
    jg, tg = flagship_grads
    _assert_grad_close(jg[_key(path)], tg[_key(path)])


@pytest.mark.parametrize("path", TWO_MESH_PATHS, ids=_key)
def test_two_mesh_grad_matches_jax(two_mesh_grads, path):
    jg, tg = two_mesh_grads
    _assert_grad_close(jg[_key(path)], tg[_key(path)])


def test_flagship_zero_grads_are_structural(flagship_grads):
    """bench.py trains the point light's intensity and obj_color. On the
    flagship both gradients are exactly 0, in both packages: the point
    light sits inside the sphere, so its falloff min(1, I / (4 pi d^2 /
    1000)) saturates at every hit, and the diffuse map replaces
    obj_color. The distant light's and the vertices' are not 0."""
    jg, tg = flagship_grads
    for k in ("lights/0/intensity", "obj_color"):
        assert not jg[k].any() and not tg[k].any(), k
    for k in ("lights/1/intensity", "meshes/0/v"):
        assert np.abs(tg[k]).sum() > 0, k
    # The gradient reaches most of the visible triangles' vertices.
    assert (np.abs(tg["meshes/0/v"]).sum(axis=(1, 2)) > 0).sum() > 100


def test_two_mesh_grads_reach_both_meshes(two_mesh_grads):
    """Through the fused gather every parameter gets a gradient: both
    lights, each object's colour, and the vertices of both meshes."""
    _, tg = two_mesh_grads
    for k in ("lights/0/intensity", "lights/1/intensity"):
        assert tg[k] != 0, k
    assert (np.abs(tg["obj_color"]).sum(axis=1) > 0).all()
    for k in ("meshes/0/v", "meshes/1/v"):
        assert (np.abs(tg[k]).sum(axis=(1, 2)) > 0).sum() > 10, k
