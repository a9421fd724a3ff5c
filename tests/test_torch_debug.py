"""The debug passes of the port against the JAX package on the CPU:
`ops.intersect.slab_test` and `ops.traversal.count_ac_nodes` (the showAC
walk's plain version) against JAX's, `integrator.shade_normals`, and
whole showNormals and showAC frames, from scene files with OBJ meshes
that the tests write (t08/t09's layout: one rotated mesh, and a second
one, which makes the scene build the fused tables).

Tolerances: the slab test, the AC counts and the showAC frames are
bit-equal (the same f32 sub, mul and compare in the same order; no
multiply-add to contract). showNormals colours agree to atol 2e-5, the
port's frame tolerance (tests/test_torch_render.py: XLA may round the
normal's interpolation and normalization an ulp apart, contracting its
multiply-adds in the jitted block body), frames from shared primary
rays.
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rendering_tpu.models.scene import load_scene as j_load_scene
from rendering_tpu.models.settings import RenderSettings as JSettings
from rendering_tpu.ops.intersect import slab_test as j_slab_test
from rendering_tpu.ops.traversal import count_ac_nodes as j_count_ac_nodes
from rendering_tpu.render.integrator import shade_normals as j_shade_normals
from rendering_tpu.render.raygen import primary_rays as j_primary_rays
from rendering_tpu_torch.flagship import procedural_mesh
from rendering_tpu_torch.models.objloader import write_obj
from rendering_tpu_torch.ops.intersect import slab_test
from rendering_tpu_torch.ops.traversal import (
    count_ac_nodes,
    count_ac_nodes_plain,
)
from rendering_tpu_torch.render.integrator import shade_normals
from rendering_tpu_torch.render.pipeline import (
    derive_mesh_tables,
    render_scene,
)
from torch_port_util import j_render_fresh, port_scene, shared_primary_rays

FRAME_ATOL = 2e-5

_SCENE = """[options]
width={w}
height={h}
ac_penalty=3
background_color=0.52,0.8,0.92
enableOutput=0
outputProgress=0
showNormals={normals}
showAC={ac}
useAC={use_ac}

[light]
type=distant
direction=0,-1,0
color=1,1,1
intensity=1

[object]
type=mesh
pos=0,0,-3
size=2,2,2
color=1,1,1
rot=0,160,0
name=mesh.obj
{second}
[end]
"""
# A second, unrotated mesh: the scene then takes the fused tables.
_SECOND = """
[object]
type=mesh
pos=1.1,0.6,-2.2
size=0.6,0.6,0.6
color=0.3,0.5,0.9
material=diffuse
name=second.obj
"""


@pytest.fixture()
def obj_workspace(in_workspace, monkeypatch):
    """The golden workspace with two procedural OBJ files; the JAX loader
    and BVH run in Python (no native build)."""
    monkeypatch.setenv("RTPU_NATIVE", "0")
    for name, n, seed in (("mesh.obj", 1500, 0), ("second.obj", 400, 3)):
        m = procedural_mesh(n, pos=(0, 0, 0), size=(2, 2, 2), seed=seed)
        write_obj(os.path.join(in_workspace, name), m.v, m.uv, m.n)
    return in_workspace


def write_debug_scene(ws, name, *, w=48, h=32, normals=0, ac=0, use_ac=1,
                      second=False):
    """A debug scene file over the workspace's OBJ files (SSAA on, the
    scene-file default)."""
    text = _SCENE.format(w=w, h=h, normals=normals, ac=ac, use_ac=use_ac,
                         second=_SECOND if second else "")
    with open(os.path.join(ws, name), "w") as fh:
        fh.write(text)
    return name


def both_scenes(path, **settings):
    """(JAX scene with the Pallas kernel in interpret mode and `settings`,
    the port's scene carrying its arrays)."""
    js = j_load_scene(path, JSettings(pallas_interpret=True, **settings))
    return js, port_scene(js)


def seeded_slab_case(n=4096, seed=0):
    """Rays and boxes with the slab test's corner cases: axis-parallel
    directions (+0 and -0 components: 1/rd = +-inf), NaN components,
    origins on a box plane (0 * inf = NaN), boxes behind the origin,
    degenerate and inverted boxes."""
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    lo = rng.uniform(-1.5, 1.0, (n, 3)).astype(np.float32)
    hi = (lo + rng.uniform(0.0, 1.5, (n, 3))).astype(np.float32)
    k = n // 8
    rd[:k, rng.integers(0, 3, k)] = 0.0
    rd[k:2 * k, 0] = -0.0
    rd[2 * k:2 * k + 16, 1] = np.nan
    ro[3 * k:4 * k, 0] = lo[3 * k:4 * k, 0]          # on the lo plane
    ro[3 * k:4 * k, 2] = hi[3 * k:4 * k, 2]
    rd[3 * k:4 * k, 0] = 0.0                          # ... and parallel
    lo[4 * k:5 * k] = hi[4 * k:5 * k]                 # degenerate boxes
    lo[5 * k:5 * k + 64], hi[5 * k:5 * k + 64] = (hi[5 * k:5 * k + 64],
                                                  lo[5 * k:5 * k + 64])
    return ro, rd, lo, hi


def test_slab_test_bit_equal_to_jax():
    """hit, tmin and tmax equal JAX's bit for bit, NaNs where JAX has
    them, on the seeded corner cases."""
    ro, rd, lo, hi = seeded_slab_case()
    j_out = [np.asarray(x) for x in j_slab_test(
        jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(lo), jnp.asarray(hi))]
    t_out = [x.numpy() for x in slab_test(*(torch.from_numpy(a)
                                            for a in (ro, rd, lo, hi)))]
    np.testing.assert_array_equal(t_out[0], j_out[0])
    for t, j in zip(t_out[1:], j_out[1:]):
        assert np.array_equal(t.view(np.int32), j.view(np.int32))
    assert j_out[0].any() and not j_out[0].all()
    assert np.isnan(j_out[1]).any()  # the corner cases reached NaN


@pytest.mark.parametrize("second", [False, True])
@pytest.mark.parametrize("use_ac", [True, False])
def test_count_ac_nodes_equal_to_jax(obj_workspace, second, use_ac):
    """Each mesh's counts, on the frame's +0.5 rays and on seeded rays
    from inside and outside the meshes, equal JAX's integer for integer;
    without useAC every ray counts every real node."""
    path = write_debug_scene(obj_workspace, "ac.scene", ac=1,
                             use_ac=int(use_ac), second=second)
    js, ts = both_scenes(path)
    assert (ts.fused_itables is not None) == second
    ro, rd, _ = (np.array(x) for x in j_primary_rays(js, offset=0.5))
    rng = np.random.default_rng(1)
    ro = np.concatenate([ro, rng.uniform(-1, 1, (512, 3)).astype(np.float32)])
    rd = np.concatenate([rd, rng.normal(size=(512, 3)).astype(np.float32)])
    for jm, tm in zip(js.meshes, ts.meshes):
        want = np.asarray(j_count_ac_nodes(jm, jnp.asarray(ro),
                                           jnp.asarray(rd), use_ac=use_ac))
        got = count_ac_nodes(tm, torch.from_numpy(ro), torch.from_numpy(rd),
                             use_ac=use_ac)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        assert want.max() > 1
        if not use_ac:
            assert (want == int((np.asarray(jm.real_flag) > 0).sum())).all()


def test_plain_walk_counts_its_box_tests(obj_workspace):
    """The plain walk's box-test count (the AC kernel's work, chip_smoke's
    bound) equals a per-ray Python walk's steps."""
    path = write_debug_scene(obj_workspace, "ac.scene", ac=1, w=8, h=4)
    _, ts = both_scenes(path)
    m = ts.meshes[0]
    rng = np.random.default_rng(2)
    ro = torch.from_numpy(rng.uniform(-0.3, 0.3, (24, 3)).astype(np.float32))
    rd = torch.from_numpy(rng.normal(size=(24, 3)).astype(np.float32))
    counts, tests = count_ac_nodes_plain(m.node_min, m.node_max, m.skip,
                                         m.real_flag, ro, rd)
    steps, want = 0, []
    for i in range(ro.shape[0]):
        cur = count = 0
        while cur < m.node_min.shape[0]:
            steps += 1
            hit = bool(slab_test(ro[i], rd[i], m.node_min[cur],
                                 m.node_max[cur])[0])
            count += int(hit and m.real_flag[cur] > 0)
            cur = cur + 1 if hit else int(m.skip[cur])
        want.append(count)
    assert int(tests) == steps
    assert counts.tolist() == want


@pytest.mark.parametrize("second", [False, True])
def test_shade_normals_matches_jax(obj_workspace, second):
    """shade_normals on JAX's primary rays: within the frame tolerance
    of JAX's (the closest hit of the port's plain version against the
    Pallas kernel in interpret mode); misses take the background."""
    path = write_debug_scene(obj_workspace, "n.scene", normals=1,
                             second=second)
    js, ts = both_scenes(path)
    ro, rd, _ = (np.array(x) for x in j_primary_rays(js, offset=1.0))
    want = np.asarray(j_shade_normals(js, jnp.asarray(ro), jnp.asarray(rd),
                                      ray_block=512))
    got = shade_normals(derive_mesh_tables(ts), torch.from_numpy(ro),
                        torch.from_numpy(rd), ray_block=512)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FRAME_ATOL)
    bg = np.asarray(js.bg_color)[:, None]
    hit = ~(want == bg).all(axis=0)
    assert 0.05 < hit.mean() < 0.95


@pytest.mark.parametrize("ssaa", [False, True])
def test_show_normals_frame_matches_jax(obj_workspace, ssaa):
    """render_scene under showNormals, without and with SSAA (the four
    weighted subsamples scattered into their pixel): JAX's frame within
    the frame tolerance, from shared primary rays; rays_casted w * h."""
    path = write_debug_scene(obj_workspace, "n.scene", normals=1,
                             second=True)
    js, ts = both_scenes(path, enable_ssaa=ssaa)
    with shared_primary_rays(js):
        j_frame = np.array(j_render_fresh(js))
        with torch.no_grad():
            t_frame, aux = render_scene(ts)
    np.testing.assert_allclose(t_frame.numpy(), j_frame, rtol=0,
                               atol=FRAME_ATOL)
    assert aux["stats"]["rays_casted"] == 48 * 32
    assert (aux["ssaa_masked"] > 0) == ssaa


@pytest.mark.parametrize("use_ac", [True, False])
def test_show_ac_frame_bit_equal_to_jax(obj_workspace, use_ac):
    """render_scene under showAC on a two-mesh scene: the heatmap equals
    JAX's bit for bit (rays shared at +0.5), no SSAA, zero counters."""
    path = write_debug_scene(obj_workspace, "ac.scene", ac=1, second=True,
                             use_ac=int(use_ac))
    js, ts = both_scenes(path)
    with shared_primary_rays(js, offset=0.5):
        j_frame = np.array(j_render_fresh(js))
        t_frame, aux = render_scene(ts)
    assert np.array_equal(t_frame.numpy().view(np.int32),
                          j_frame.view(np.int32))
    assert aux["ssaa_masked"] == 0
    assert not any(aux["stats"].values())
    assert t_frame.max() == 1.0 and (t_frame.min() < 1.0) == use_ac
