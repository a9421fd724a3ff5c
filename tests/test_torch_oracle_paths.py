"""The intersection paths that skip the tile-walk kernels
(settings.use_pallas_intersect=False) through the port's render_scene,
against the JAX package's render_scene with the same settings, on the
CPU: the BVH walk (bruteforce_threshold 0: every mesh above it), the
dense bilinear form (the default threshold, use_mxu_intersect) and the
direct dense scan (use_mxu_intersect off), on JAX's tiny scene (all four
materials, bouncing, an area light) and on a 3-mesh scene that the port
would otherwise query through its fused tables; one train step's
gradients against jax.grad; and the per-mesh choice of the oracle.

Tolerances: non-bouncing frames atol 2e-5, bouncing frames as
torch_port_util.assert_bounce_frames_agree (PERF.md section 2), both
packages from the same primary rays (shared_primary_rays); the stats
(rays, box and triangle tests, dropped paths) equal, which also shows
that each mesh took the oracle JAX took (the walk counts box tests, the
dense scans none and R*T triangle tests); gradients rtol 1e-4, atol 1e-4
* max|g| (tests/test_torch_grad.py's).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rendering_tpu.render.pipeline as j_pipeline
from rendering_tpu.diff import inverse as j_inverse
from rendering_tpu.flagship import build_multimesh_scene as j_multimesh
from rendering_tpu_torch.diff import inverse as t_inverse
from rendering_tpu_torch.render import integrator
from rendering_tpu_torch.render import pipeline as t_pipeline
from torch_port_util import (
    assert_bounce_frames_agree,
    jax_settings,
    jax_tiny_scene,
    jax_two_mesh_scene,
    loss_weights,
    port_scene,
    shared_primary_rays,
)

ORACLES = {"walk": dict(bruteforce_threshold=0), "mxu": {},
           "direct": dict(use_mxu_intersect=False)}
GRAD_PATHS = (("lights", 0, "intensity"), ("obj_color",), ("meshes", 0, "v"),
              ("meshes", 2, "v"))


def _scene(name, oracle):
    if name == "tiny":
        js = jax_tiny_scene()
    else:
        js = jax_settings(j_multimesh(48, 32, n_meshes=3, tris_per_mesh=200),
                          pallas_interpret=True)
    return jax_settings(js, use_pallas_intersect=False, **ORACLES[oracle])


def _stats(aux):
    return {k: float(v) for k, v in aux["stats"].items()}


@pytest.mark.parametrize("oracle", list(ORACLES))
@pytest.mark.parametrize("name", ["tiny", "three_mesh"])
def test_frame_matches_jax(name, oracle):
    """The frame within the frame tolerances, every counter equal."""
    js = _scene(name, oracle)
    ts = port_scene(js)
    assert not ts.static.settings.use_pallas_intersect
    assert (ts.fused_itables is not None) == (name == "three_mesh")
    with shared_primary_rays(js):
        j_frame, j_aux = jax.jit(
            lambda s: j_pipeline.render_scene.__wrapped__(s))(js)
        with torch.no_grad():
            t_frame, t_aux = t_pipeline.render_scene(ts)
    j_frame, t_frame = np.asarray(j_frame), t_frame.numpy()
    if ts.static.any_bouncing:
        assert_bounce_frames_agree(t_frame, j_frame)
    else:
        np.testing.assert_allclose(t_frame, j_frame, atol=2e-5, rtol=0)
    j_stats, t_stats = _stats(j_aux), _stats(t_aux)
    assert t_stats == j_stats
    walked = oracle == "walk"
    assert (t_stats["accel_struct_tests"] > 0) == walked
    assert t_stats["ray_tri_tests"] > 0


def test_train_step_grads_match_jax():
    """Gradients of sum(frame * w) through the walk on the 3-mesh scene
    (a point light, obj_color, two meshes' vertices) against jax.grad."""
    js = _scene("three_mesh", "walk")
    ts = port_scene(js)
    st = js.static.settings
    w = loss_weights((3, st.height, st.width))
    with shared_primary_rays(js):
        def loss(p):
            s = j_inverse.apply_params(js, p, GRAD_PATHS)
            return jnp.sum(j_pipeline.render_scene.__wrapped__(s)[0] * w)

        jg = jax.jit(jax.grad(loss))(j_inverse.extract_params(js, GRAD_PATHS))
        tp = t_inverse.extract_params(ts, GRAD_PATHS)
        frame, _ = t_pipeline.render_scene(
            t_inverse.apply_params(ts, tp, GRAD_PATHS))
        (frame * torch.from_numpy(w)).sum().backward()
    for path in GRAD_PATHS:
        key = "/".join(map(str, path))
        j, t = np.asarray(jg[key]), tp[key].grad.numpy()
        assert t.shape == j.shape and np.isfinite(t).all()
        np.testing.assert_allclose(t, j, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(j).max()))
    assert np.abs(tp["meshes/2/v"].grad.numpy()).sum() > 0


def test_oracle_choice_per_mesh(monkeypatch):
    """With the kernels off, each mesh of a fused scene is queried on its
    own: the 150-triangle mesh above a threshold of 100 by the walk, the
    90-triangle one by the dense scan (the bilinear form, or the direct
    one with use_mxu_intersect off), closest hits and shadow rays alike;
    with the kernels on, none of them."""
    calls = []

    def record(name, fn):
        def wrapper(mesh, *args, **kw):
            calls.append((name, int(mesh.v.shape[0])))
            return fn(mesh, *args, **kw)
        monkeypatch.setattr(integrator, name, wrapper)

    for name in ("traverse_bvh", "bruteforce_mesh", "bruteforce_mesh_mxu"):
        record(name, getattr(integrator, name))
    base = jax_two_mesh_scene()
    for mxu in (True, False):
        calls.clear()
        ts = port_scene(jax_settings(base, use_pallas_intersect=False,
                                     bruteforce_threshold=100,
                                     use_mxu_intersect=mxu))
        with torch.no_grad():
            t_pipeline.render_scene(ts)
        dense = "bruteforce_mesh_mxu" if mxu else "bruteforce_mesh"
        assert set(calls) == {("traverse_bvh", 150), (dense, 90)}
        # Closest hits and shadow rays, a bounce each: the mesh of 90 is
        # transparent-free and opaque, so it is queried in both.
        assert calls.count(("traverse_bvh", 150)) >= 2
    calls.clear()
    with torch.no_grad():
        t_pipeline.render_scene(port_scene(base))
    assert not calls
