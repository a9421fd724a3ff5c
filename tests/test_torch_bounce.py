"""Port parity of the bounce loop: reflective and transparent materials
(the Morton re-sort of the continuation queue, the transparent queue's
weight-priority compaction, the depth-guard skybox tail, SSAA on a
bouncing scene and the queue-headroom redo), rendering_tpu_torch on the
CPU against the JAX package with its Pallas kernel in interpret mode.
Both packages render from the same primary rays
(torch_port_util.shared_primary_rays).

Tolerances: frames atol 2e-5, as tests/test_torch_render.py (XLA's
exp/log/sqrt may differ from torch's by an ulp and it may add in another
order), on all but 0.2% of the values, which stay within 1e-4: the
jitted JAX program contracts multiply-adds into FMAs, and near a sphere's
silhouette that ulp grows into the reflected direction
(torch_port_util.assert_bounce_frames_agree has the measurement);
rays_casted and paths_dropped equal; `_compact_children` bit-equal
on given candidates. With drops, equal-weight ties are broken by queue
position, which depends on Morton keys of origins an ulp apart, so the
headroom test compares the drop count, the headroom the redo settles on
and the escalated frame, not the dropping frame.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rendering_tpu.render.integrator as j_integrator
import rendering_tpu.render.pipeline as j_pipeline
from rendering_tpu.models.scene import MAT_REFLECTIVE
from rendering_tpu_torch.flagship import build_tiny_scene
from rendering_tpu_torch.render import integrator as t_integrator
from rendering_tpu_torch.render import pipeline as t_pipeline
from test_headroom import _glass_heavy_scene
from torch_port_util import (
    assert_bounce_frames_agree,
    jax_leaves,
    jax_material,
    jax_tiny_scene,
    jax_two_mesh_scene,
    port_scene,
    shared_primary_rays,
)


def _j_render(js, ssaa_capacity=None, queue_headroom=1):
    """JAX render_scene's (frame, stats), traced anew (so it reads the
    primary rays in effect), as numpy and floats."""
    fn = functools.partial(j_pipeline.render_scene.__wrapped__,
                           ssaa_capacity=ssaa_capacity,
                           queue_headroom=queue_headroom)
    frame, aux = jax.jit(fn)(js)
    return np.asarray(frame), {k: float(v) for k, v in aux["stats"].items()}


def _t_render(ts, **kw):
    with torch.no_grad():
        frame, aux = t_pipeline.render_scene(ts, **kw)
    return frame.numpy(), {k: float(v) for k, v in aux["stats"].items()}


def _scene(name):
    if name == "tiny":
        return jax_tiny_scene()
    if name == "reflective_only":  # the glass sphere made a mirror
        return jax_material(jax_tiny_scene(), 2, MAT_REFLECTIVE)
    if name == "transparent_mesh":
        return jax_two_mesh_scene(transparent_second=True)
    assert name == "tiny_ssaa"
    return jax_tiny_scene(enable_ssaa=True)


@pytest.mark.parametrize("name", ["tiny", "reflective_only",
                                  "transparent_mesh", "tiny_ssaa"])
def test_bouncing_frame_matches_jax(name):
    """The tiny scene (all four materials, an area light), its
    reflective-only variant (scatter mode with the Morton re-sort, no
    compaction), the two-mesh scene with a transparent mesh (its fused
    shadow tables leave that mesh out) and the tiny scene with SSAA
    on."""
    js = _scene(name)
    ts = port_scene(js)
    st = ts.static
    assert st.any_bouncing
    assert st.any_transparent == (name != "reflective_only")
    if name == "transparent_mesh":
        assert ts.fused_shadow_itables is not ts.fused_itables
    with shared_primary_rays(js):
        j_frame, j_stats = _j_render(js)
        t_frame, t_stats = _t_render(ts)
    assert_bounce_frames_agree(t_frame, j_frame)
    assert t_stats["rays_casted"] == j_stats["rays_casted"]
    assert t_stats["paths_dropped"] == j_stats["paths_dropped"] == 0
    # Several bounces were traced: more rays than one per pixel and light.
    assert t_stats["rays_casted"] > 4 * st.settings.width * st.settings.height


def test_tiny_scene_round_trip():
    """The port's build_tiny_scene equals the JAX scene carried across,
    field for field (material ids, obj_ior and min_weight included)."""
    js = jax_tiny_scene()
    leaves = jax_leaves(js)
    cs = port_scene(js)
    ts = build_tiny_scene(device="cpu")
    for k in ("cam_pos", "cam_rmat", "scale", "bg_color", "bias", "obj_color",
              "obj_ior", "obj_ambient", "obj_diffuse", "obj_specular",
              "obj_nspec", "mat_type", "sph_pos", "sph_r", "pln_pos", "pln_n"):
        np.testing.assert_array_equal(getattr(cs, k).numpy(), leaves[k])
        assert torch.equal(getattr(cs, k), getattr(ts, k)), k
    for k in ("v", "n", "uv", "tangent", "bitangent"):
        assert torch.equal(getattr(cs.meshes[0], k), getattr(ts.meshes[0], k))
    for k in ("tri", "cbox", "sbox"):
        assert torch.equal(getattr(cs.meshes[0].itables, k),
                           getattr(ts.meshes[0].itables, k))
    for a, b in zip(cs.lights, ts.lights):
        assert (a.kind, a.samples) == (b.kind, b.samples)
        for k in ("color", "intensity", "dir", "pos", "ivec", "jvec"):
            assert torch.equal(getattr(a, k), getattr(b, k))
    assert cs.static == ts.static
    assert ts.static.settings.max_ray_depth == 4
    assert ts.static.mat_types == (0, 3, 2, 1, 0)
    assert ts.static.settings.min_weight == js.static.settings.min_weight


def test_compact_children_bit_equal():
    """The weight-priority compaction on given candidates with weight
    ties, inactive lanes and more active children than the capacity:
    kept lanes, their order and the drop count equal JAX's bit for
    bit."""
    rng = np.random.default_rng(7)
    n, cap = 96, 40
    ro = rng.normal(0, 2, (3, n)).astype(np.float32)
    rd = rng.normal(0, 1, (3, n)).astype(np.float32)
    w = rng.choice(np.asarray([0.0, 0.1, 0.25, 0.5, 0.8], np.float32), n)
    w[::7] = 0.5  # many ties
    pix = rng.integers(0, 50, n).astype(np.int32)
    j_stats = {"paths_dropped": jnp.zeros((), jnp.float32)}
    j_out = j_integrator._compact_children(
        jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(w), jnp.asarray(pix),
        cap, 0.0, j_stats)
    t_stats = {"paths_dropped": 0}
    t_out = t_integrator._compact_children(
        *(torch.from_numpy(x) for x in (ro, rd, w)),
        torch.from_numpy(pix).long(), cap, 0.0, t_stats)
    for j, t in zip(j_out, t_out):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    dropped = int(t_stats["paths_dropped"])
    assert dropped == float(j_stats["paths_dropped"]) == (w > 0).sum() - cap


def _escalations(render_fn, escalate, st):
    """escalate(render_fn', st) with render_fn' recording the queue
    headroom of each attempt; returns (frame, aux, headrooms)."""
    tried = []

    def fn(cap, headroom):
        tried.append(headroom)
        return render_fn(cap, headroom)
    frame, aux = escalate(fn, st)
    return frame, aux, tried


def test_headroom_escalation_matches_jax(capsys):
    """The glass-heavy scene of tests/test_headroom.py: at headroom 1
    both packages drop the same number of paths; the redo settles on the
    same headroom in both, with no drops, and the escalated frames
    agree."""
    js = _glass_heavy_scene()
    ts = port_scene(js)
    with shared_primary_rays(js):
        _, j_stats = _j_render(js, queue_headroom=1)
        _, t_stats = _t_render(ts, queue_headroom=1)
        assert t_stats["paths_dropped"] == j_stats["paths_dropped"] > 0

        def j_fn(cap, headroom):
            return jax.jit(functools.partial(
                j_pipeline.render_scene.__wrapped__, ssaa_capacity=cap,
                queue_headroom=headroom))(js)

        def t_fn(cap, headroom):
            with torch.no_grad():
                return t_pipeline.render_scene(ts, ssaa_capacity=cap,
                                               queue_headroom=headroom)
        j_frame, j_aux, j_tried = _escalations(
            j_fn, j_pipeline.escalating_render, js.static.settings)
        t_frame, t_aux, t_tried = _escalations(
            t_fn, t_pipeline.escalating_render, ts.static.settings)
    assert t_tried == j_tried and len(t_tried) > 1
    assert float(t_aux["stats"]["paths_dropped"]) == 0
    assert float(j_aux["stats"]["paths_dropped"]) == 0
    assert_bounce_frames_agree(t_frame, j_frame)
    assert "warning" not in capsys.readouterr().out


def test_render_warns_when_drops_remain(capsys, monkeypatch):
    """At the headroom cap the drop warning stands: with the cap at 1 the
    glass-heavy scene renders once and warns."""
    ts = port_scene(_glass_heavy_scene())
    monkeypatch.setattr(t_pipeline, "MAX_QUEUE_HEADROOM", 1)
    frame, aux = t_pipeline.render(ts)
    assert np.isfinite(frame).all()
    assert float(aux["stats"]["paths_dropped"]) > 0
    assert "transparent continuation paths were dropped" in \
        capsys.readouterr().out


def test_out_slots_rejects_transparent_scene():
    ts = port_scene(_glass_heavy_scene(8, 6))
    ro = torch.zeros((4, 3))
    rd = torch.ones((4, 3))
    with pytest.raises(ValueError, match="slot"):
        t_integrator.integrate(ts, ro, rd, torch.arange(4), torch.ones(4),
                               48, out_slots=True)


def test_reflective_slot_mode_equals_scatter_mode():
    """A reflective-only scene may also accumulate per slot (the
    continuation stays in its lane, as JAX's out_slots allows): the same
    radiance per pixel as the scatter mode's Morton-sorted queue."""
    ts = port_scene(jax_material(jax_tiny_scene(16, 8), 2, MAT_REFLECTIVE))
    st = ts.static.settings
    from rendering_tpu_torch.render.raygen import primary_rays

    ro, rd, pix = primary_rays(ts, offset=1.0)
    w = torch.ones(pix.shape)
    scene = t_pipeline.derive_mesh_tables(ts)
    n = st.width * st.height
    with torch.no_grad():
        slots, s1 = t_integrator.integrate(scene, ro, rd, pix, w, n,
                                           ray_block=32, out_slots=True)
        accum, s2 = t_integrator.integrate(scene, ro, rd, pix, w, n,
                                           ray_block=32)
    by_pix = torch.zeros_like(accum).index_add(1, pix.long(), slots)
    torch.testing.assert_close(by_pix, accum, rtol=0, atol=1e-6)
    assert s1["rays_casted"] == s2["rays_casted"]

