"""Port parity of the fused multi-mesh intersection (K5): the fused chunk
tables against the JAX package's `build_fused_tables`, the plain K5
(`cuda_intersect.intersect_fused` on CPU tensors) against the Pallas
kernel's `intersect_fused(..., interpret=True)`, and whole renders of
multi-mesh scenes against JAX's with the kernel in interpret mode.

Tolerance: tables and idmap bit-equal. Mesh and column ids equal except
on rays whose two t values are equal (a tie across or within meshes is
broken by the tile's visit order, which comes from float sums that
torch may add in another order than XLA), at most 0.1% of rays; t to
rtol 2e-5 and occlusion bits equal, as in tests/test_torch_intersect.py.
Frames from the same primary rays to atol 2e-5 and u8 within
DEFAULT_TOL, as in tests/test_torch_render.py; from each package's own
rays (an ulp apart on some rays, see torch_port_util.shared_primary_rays)
u8 within DEFAULT_TOL.
"""

from __future__ import annotations

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rendering_tpu.flagship import build_multimesh_scene as j_multimesh
from rendering_tpu.flagship import procedural_mesh as j_procedural_mesh
from rendering_tpu.ops import pallas_intersect as jpi
from rendering_tpu.render.pipeline import quantize_u8 as j_quantize_u8
from rendering_tpu.render.pipeline import render_scene as j_render_scene
from rendering_tpu_torch.flagship import build_multimesh_scene as t_multimesh
from rendering_tpu_torch.flagship import procedural_mesh as t_procedural_mesh
from rendering_tpu_torch.models import parser as t_parser
from rendering_tpu_torch.models.scene import build_scene as t_build_scene
from rendering_tpu_torch.models.settings import RenderSettings as TSettings
from rendering_tpu_torch.ops import cuda_intersect as ci
from rendering_tpu_torch.render.pipeline import quantize_u8, render_scene
from torch_port_util import (
    golden_fractions,
    j_render_fresh,
    jax_two_mesh_scene,
    port_scene,
    shared_primary_rays,
    two_mesh_defs,
)

FMAX = np.float32(3.4028234663852886e38)
GOLDEN_TOL = (0.006, 0.005)  # tests/test_golden.py DEFAULT_TOL, first two


@pytest.fixture(scope="module")
def two_mesh():
    js = jax_two_mesh_scene()
    return js, port_scene(js)


def _assert_tables_equal(tf, jf):
    """Port FusedTables == JAX FusedTables: every table row (the reach
    boxes in rows 9-14 included), boxes, idmap."""
    assert (tf.n_meshes, tf.t_total, tf.any_clipped) == (
        jf.n_meshes, jf.t_total, jf.any_clipped)
    assert (tf.geo.tri_chunk, tf.geo.n_sub) == (jf.geo.tri_chunk,
                                                jf.geo.n_sub)
    jtri = np.asarray(jf.geo.tri)
    assert tuple(tf.geo.tri.shape) == jtri.shape
    np.testing.assert_array_equal(tf.geo.tri.numpy(), jtri)
    np.testing.assert_array_equal(tf.geo.cbox.numpy(), np.asarray(jf.geo.cbox))
    np.testing.assert_array_equal(tf.geo.sbox.numpy(), np.asarray(jf.geo.sbox))
    np.testing.assert_array_equal(tf.idmap.numpy(), np.asarray(jf.idmap))
    assert tf.idmap.dtype == torch.int32


@pytest.mark.parametrize("transparent_second", [False, True])
def test_fused_tables_bit_equal(transparent_second):
    """The two-mesh scene carried across, and the port's own build of it:
    fused and shadow tables equal JAX's; the shadow tables are the fused
    tables when both meshes are opaque, and leave out the transparent
    mesh B otherwise."""
    js = jax_two_mesh_scene(transparent_second)
    ts = port_scene(js)
    own = t_build_scene(two_mesh_defs(
        t_parser, t_procedural_mesh,
        TSettings(width=64, height=32, enable_ssaa=False,
                  background_color=(0.2, 0.2, 0.25)),
        transparent_second), device="cpu")
    for scene in (ts, own):
        assert all(m.itables is None for m in scene.meshes)  # fused only
        _assert_tables_equal(scene.fused_itables, js.fused_itables)
        _assert_tables_equal(scene.fused_shadow_itables,
                             js.fused_shadow_itables)
        if transparent_second:
            assert scene.fused_shadow_itables is not scene.fused_itables
            assert int(scene.fused_shadow_itables.idmap[0].max()) == 0
        else:
            assert scene.fused_shadow_itables is scene.fused_itables
    # .to() keeps the alias, and moves idmap with the geometry.
    moved = ts.to("cpu")
    assert (moved.fused_shadow_itables is moved.fused_itables) == (
        not transparent_second)


@pytest.mark.parametrize("sizes,include", [
    ((90, 700), None),                   # a mesh with fewer chunks than n_sub
    ((5, 2000, 0, 333), None),           # a mesh without triangles
    ((3000, 40, 41), (True, False, True)),  # an excluded mesh in the middle
    ((270_000, 500), None),              # the tri_chunk doubles
])
def test_fused_tables_ragged(sizes, include):
    vs, hosts = [], []
    for k, n in enumerate(sizes):
        v = (j_procedural_mesh(n, pos=(k, 0, -3), size=(1, 1, 1), seed=k).v
             if n else np.zeros((0, 3, 3), np.float32))
        vs.append(v)
        hosts.append(types.SimpleNamespace(
            v=v, reach_lo=v.min(axis=1) if n else v[:, 0],
            reach_hi=v.max(axis=1) if n else v[:, 0], morton_perm=None))
    clipped = [False] * len(sizes)
    jf = jpi.build_fused_tables(hosts, clipped, include=include,
                                as_numpy=True)
    tf = ci.build_fused_tables(vs, clipped, include=include)
    _assert_tables_equal(tf, jf)
    # Pad cull chunks sit inside the table: inverted boxes past each
    # mesh's last real chunk, not only at the end.
    cbox = tf.geo.cbox.numpy()
    inverted = cbox[:, 0] > cbox[:, 3]
    assert (inverted[:-1] & ~inverted[1:]).any()
    if sum(sizes) > 512 * 8 * 64:
        assert tf.geo.tri_chunk == 128


def _rays(n, seed, aims):
    """A third aimed at the mesh centres, a third random, a third leaving
    points near the meshes (the shadow-ray workload)."""
    rng = np.random.default_rng(seed)
    ro = rng.normal(0, 0.5, (3, n)).astype(np.float32)
    rd = rng.normal(0, 1, (3, n)).astype(np.float32)
    q = n // 3
    aims = np.asarray(aims, np.float32)
    pick = aims[rng.integers(0, len(aims), n)].T
    rd[:, :q] = pick[:, :q] + rng.normal(0, 0.4, (3, q)) - ro[:, :q]
    ro[:, q:2 * q] = pick[:, q:2 * q] + rng.normal(0, 0.7, (3, q))
    rd /= np.linalg.norm(rd, axis=0, keepdims=True)
    return ro, rd.astype(np.float32)


def _limits(n, seed, pre_done=0.1):
    rng = np.random.default_rng(seed)
    tl = rng.uniform(0.05, 6.0, n).astype(np.float32)
    tl[rng.uniform(size=n) < pre_done] = -1.0
    return tl


TWO_MESH_AIMS = [(-0.8, 0.0, -3.0), (0.9, 0.2, -3.5)]


@pytest.mark.parametrize("bfc", [True, False])
@pytest.mark.parametrize("with_limit", [True, False])
def test_plain_fused_closest_matches_pallas(two_mesh, bfc, with_limit):
    js, ts = two_mesh
    n = 1900  # 4 tiles, the last one partial
    ro, rd = _rays(n, seed=21, aims=TWO_MESH_AIMS)
    tl = _limits(n, seed=22) if with_limit else None
    jt, jmid, jvid, _, _ = jpi.intersect_fused(
        js.fused_itables, jnp.asarray(ro), jnp.asarray(rd),
        None if tl is None else jnp.asarray(tl), mode="closest",
        backface_culling=bfc, use_root_filter=False, interpret=True)
    jt, jmid, jvid = map(np.asarray, (jt, jmid, jvid))
    tt, tmid, tvid = (x.numpy() for x in ci.intersect_fused(
        ts.fused_itables, torch.from_numpy(ro), torch.from_numpy(rd),
        None if tl is None else torch.from_numpy(tl), mode="closest",
        backface_culling=bfc))
    assert tmid.dtype == tvid.dtype == np.int32
    for sub in (0, 1):
        assert (tmid == sub).sum() > 50  # both meshes are hit
    if with_limit:
        assert (tmid[tl < 0] == -1).all()
    np.testing.assert_array_equal(jmid >= 0, tmid >= 0)
    differ = (jmid != tmid) | (jvid != tvid)
    assert (jt[differ] == tt[differ]).all()  # only exact ties differ
    assert differ.mean() <= 1e-3
    assert (tt[tmid < 0] == FMAX).all() and (tvid[tmid < 0] == 0).all()
    hit = tmid >= 0
    np.testing.assert_allclose(jt[hit], tt[hit], rtol=2e-5)


@pytest.mark.parametrize("bfc", [True, False])
def test_plain_fused_any_matches_pallas(two_mesh, bfc):
    js, ts = two_mesh
    n = 2100
    ro, rd = _rays(n, seed=23, aims=TWO_MESH_AIMS)
    tl = _limits(n, seed=24, pre_done=0.2)
    jocc, _, _ = jpi.intersect_fused(
        js.fused_shadow_itables, jnp.asarray(ro), jnp.asarray(rd),
        jnp.asarray(tl), mode="any", backface_culling=bfc,
        use_root_filter=False, interpret=True)
    occ = ci.intersect_fused(ts.fused_shadow_itables, torch.from_numpy(ro),
                             torch.from_numpy(rd), torch.from_numpy(tl),
                             mode="any", backface_culling=bfc).numpy()
    assert 50 < occ.sum() < n - 50
    assert not occ[tl < 0].any()
    np.testing.assert_array_equal(np.asarray(jocc), occ)


def test_fused_query_edges(two_mesh):
    """The fused kernels refuse CPU tensors (and count nothing), the
    mode is checked, and an empty query returns empty results."""
    _, ts = two_mesh
    ft = ts.fused_itables
    ro, rd = (torch.from_numpy(a) for a in _rays(512, 25, TWO_MESH_AIMS))
    prep = ci.prepare(ft.geo, ro, rd)
    before = (ci.fused_closest_hit_kernel.launches,
              ci.fused_any_hit_kernel.launches)
    with pytest.raises(ValueError, match="CUDA"):
        ci.fused_closest_hit_kernel(ft.geo, prep, idmap=ft.idmap,
                                    backface_culling=True)
    with pytest.raises(ValueError, match="CUDA"):
        ci.fused_any_hit_kernel(ft.geo, prep, backface_culling=True)
    assert before == (ci.fused_closest_hit_kernel.launches,
                      ci.fused_any_hit_kernel.launches)
    with pytest.raises(ValueError, match="mode"):
        ci.intersect_fused(ft, ro, rd, mode="nearest")
    t, mid, vid = ci.intersect_fused(ft, torch.zeros((3, 0)),
                                     torch.ones((3, 0)))
    occ = ci.intersect_fused(ft, torch.zeros((3, 0)), torch.ones((3, 0)),
                             mode="any")
    assert t.shape == mid.shape == vid.shape == occ.shape == (0,)


# ---- whole renders ----------------------------------------------------------


def _assert_golden(j_frame, t_frame):
    f1, f8 = golden_fractions(np.asarray(j_quantize_u8(j_frame)),
                              quantize_u8(t_frame).numpy())
    assert f1 <= GOLDEN_TOL[0] and f8 <= GOLDEN_TOL[1]


def _assert_renders_agree(js, ts):
    """From the same primary rays, frames to atol 2e-5 and u8 within
    DEFAULT_TOL; each package from its own rays (the render as it runs),
    u8 within DEFAULT_TOL. Returns the port's frame."""
    with shared_primary_rays(js):
        j_frame = j_render_fresh(js)
        t_frame, _ = render_scene(ts)
    jf = np.asarray(j_frame)
    tf = t_frame.detach().numpy()
    assert jf.shape == tf.shape and np.isfinite(tf).all()
    np.testing.assert_allclose(tf, jf, rtol=0, atol=2e-5)
    _assert_golden(j_frame, t_frame)
    _assert_golden(j_render_scene(js)[0], render_scene(ts)[0])
    return tf


def test_two_mesh_render_matches_jax(two_mesh):
    tf = _assert_renders_agree(*two_mesh)
    # Both meshes, the plane, the sphere and the background are seen.
    assert len({tuple(c) for c in np.round(
        tf[:, :-1, :-1].reshape(3, -1).T, 3)}) > 100


def test_multimesh_render_matches_jax():
    js = j_multimesh(48, 32, n_meshes=4, tris_per_mesh=60,
                     settings_overrides=dict(pallas_interpret=True))
    _assert_renders_agree(js, port_scene(js))


def test_multimesh_scene_matches_port_build():
    """The port's own build_multimesh_scene equals the JAX scene carried
    across: arrays, fused tables and static."""
    js = j_multimesh(48, 32, n_meshes=4, tris_per_mesh=60)
    cs = port_scene(js)
    ts = t_multimesh(48, 32, n_meshes=4, tris_per_mesh=60, device="cpu")
    assert cs.static == ts.static and ts.static.n_meshes == 4
    for k in ("cam_pos", "obj_color", "obj_ambient", "obj_diffuse",
              "obj_specular", "obj_nspec", "mat_type", "pln_pos", "pln_n"):
        assert torch.equal(getattr(cs, k), getattr(ts, k)), k
    for cm, tm in zip(cs.meshes, ts.meshes):
        for k in ("v", "n", "uv", "tangent", "bitangent"):
            assert torch.equal(getattr(cm, k), getattr(tm, k)), k
    for a, b in ((cs.fused_itables, ts.fused_itables),
                 (cs.fused_itables.geo, ts.fused_itables.geo)):
        for k in ("tri", "cbox", "sbox", "idmap"):
            if hasattr(a, k):
                assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert ts.fused_shadow_itables is ts.fused_itables
