"""The dense oracles of the port (`ops.bruteforce.bruteforce_mesh`, direct
Moller-Trumbore, and `ops.bruteforce_mxu.bruteforce_mesh_mxu`, the
bilinear form as one f32 product a chunk) against the JAX package's on
the CPU: a 1500-triangle mesh clipped by its root box (so the root
filter's reach boxes matter; tests/test_torch_rootfilter.py's), with the
filter on and off, backface culling on and off, t limits with resolved
lanes; seeded rays from tests/test_torch_rootfilter.py and rays aimed at
the mesh's edges and vertices (shared edges: ties, and grazing hits).

Tolerances. The direct path: ids equal, t bit-equal (the same f32
operations in the same order; JAX runs eagerly, jax.disable_jit, since a
jitted scan would contract multiply-adds into FMAs). The mxu path: ids
equal on all but grazing rays, at most 1% of the rays, each within 1e-3
of an edge of the triangle either package took (u, v or 1 - u - v by
the direct form), and t within rtol 1e-5 where the ids agree: the 13-term
product is summed by another library in another order (on this CPU torch
and XLA happen to give the same bits; another BLAS need not). The mxu
path against the direct one differs on grazing rays only, as JAX's does.
"""

from __future__ import annotations

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rendering_tpu.ops.bruteforce import bruteforce_mesh as j_direct
from rendering_tpu.ops.bruteforce_mxu import bruteforce_mesh_mxu as j_mxu
from rendering_tpu_torch.ops.bruteforce import bruteforce_mesh
from rendering_tpu_torch.ops.bruteforce_mxu import bruteforce_mesh_mxu
from rendering_tpu_torch.ops.intersect import ray_triangle_r
from test_torch_rootfilter import _j_build, _rays
from torch_port_util import port_scene

GRAZE = 1e-3
MAX_MXU_FLIPS = 0.01


@pytest.fixture(scope="module")
def meshes():
    js = _j_build(1)
    assert js.meshes[0].clipped_by_root
    return js.meshes[0], port_scene(js).meshes[0]


def seeded_rays(kind, v):
    """(ro, rd, t_limit) as (n, 3), (n, 3), (n,) f32 numpy. "around":
    tests/test_torch_rootfilter.py's rays (limits, -1 on a tenth of the
    lanes); "edges": rays at points of the mesh's edges, every fourth at a
    vertex, no limit."""
    if kind == "around":
        ro, rd, tl = _rays(3072, seed=5)
        return ro.T.copy(), rd.T.copy(), tl
    rng = np.random.default_rng(7)
    n = 3072
    ids = rng.integers(0, v.shape[0], n)
    k = rng.integers(0, 3, n)
    a, b = v[ids, k], v[ids, (k + 1) % 3]
    target = a + (b - a) * rng.uniform(0, 1, (n, 1)).astype(np.float32)
    target[::4] = a[::4]
    ro = (target + rng.normal(0, 1.5, (n, 3))).astype(np.float32)
    rd = target - ro
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    return ro, rd, None


def _both(jfn, tfn, jm, tm, kind, **kw):
    ro, rd, tl = seeded_rays(kind, np.asarray(jm.v))
    with jax.disable_jit():
        jt, jtri, jbox, jtris = jfn(
            jm, jnp.asarray(ro), jnp.asarray(rd),
            None if tl is None else jnp.asarray(tl), **kw)
    out = tfn(tm, torch.from_numpy(ro), torch.from_numpy(rd),
              None if tl is None else torch.from_numpy(tl), **kw)
    return (ro, rd), (np.asarray(jt), np.asarray(jtri), float(jbox),
                      float(jtris)), tuple(x.numpy() for x in out)


def _edge_distance(v, ro, rd, tri, bfc):
    """min(u, v, 1 - u - v) of each ray's hit on triangle tri (direct
    form); inf where tri is -1."""
    ok_id = tri >= 0
    g = torch.from_numpy(v[np.maximum(tri, 0)]).permute(1, 2, 0)  # (3, 3, n)
    _, u, w, _ = ray_triangle_r(torch.from_numpy(ro).T, torch.from_numpy(rd).T,
                                g[0], g[1], g[2], bfc)
    u, w = u.numpy(), w.numpy()
    d = np.minimum(np.minimum(u, w), 1 - u - w)
    return np.where(ok_id, np.abs(d), np.inf)


CASES = {"filter": dict(use_root_filter=True),
         "no_filter": dict(use_root_filter=False),
         "no_culling": dict(use_root_filter=True, backface_culling=False)}


@pytest.mark.parametrize("kind", ["around", "edges"])
@pytest.mark.parametrize("case", list(CASES))
def test_direct_matches_jax(meshes, case, kind):
    """Ids equal, t bit-equal, the counters JAX's (0 and R*T)."""
    _, (jt, jtri, jbox, jtris), (t, tri, box, tris) = _both(
        j_direct, bruteforce_mesh, *meshes, kind, tri_chunk=256,
        **CASES[case])
    np.testing.assert_array_equal(tri, jtri)
    np.testing.assert_array_equal(t.view(np.int32), jt.view(np.int32))
    assert (jtri >= 0).sum() > 300
    assert float(box) == jbox == 0.0 and float(tris) == jtris > 0


@pytest.mark.parametrize("kind", ["around", "edges"])
@pytest.mark.parametrize("case", list(CASES))
def test_mxu_matches_jax(meshes, case, kind):
    """Ids equal but on grazing rays (counted, bounded), t within rtol
    1e-5 where they agree, the counters JAX's."""
    jm, _ = meshes
    (ro, rd), (jt, jtri, jbox, jtris), (t, tri, box, tris) = _both(
        j_mxu, bruteforce_mesh_mxu, *meshes, kind, tri_chunk=256,
        **CASES[case])
    bfc = CASES[case].get("backface_culling", True)
    flips = tri != jtri
    assert flips.mean() <= MAX_MXU_FLIPS, flips.sum()
    v = np.asarray(jm.v)
    near = np.minimum(_edge_distance(v, ro, rd, tri, bfc),
                      _edge_distance(v, ro, rd, jtri, bfc))
    assert (near[flips] <= GRAZE).all(), near[flips].max()
    np.testing.assert_allclose(t[~flips], jt[~flips], rtol=1e-5)
    assert float(box) == jbox == 0.0 and float(tris) == jtris > 0


@pytest.mark.parametrize("case", list(CASES))
def test_mxu_differs_from_direct_only_on_grazing_rays(meshes, case):
    """The bilinear form's rounding flips grazing hits only (on the edge
    rays about a quarter of the hits: the mesh's shared edges)."""
    jm, tm = meshes
    ro, rd, _ = seeded_rays("edges", np.asarray(jm.v))
    args = (tm, torch.from_numpy(ro), torch.from_numpy(rd))
    kw = dict(tri_chunk=256, **CASES[case])
    _, tri_d, _, _ = bruteforce_mesh(*args, **kw)
    _, tri_m, _, _ = bruteforce_mesh_mxu(*args, **kw)
    tri_d, tri_m = tri_d.numpy(), tri_m.numpy()
    flips = tri_d != tri_m
    bfc = kw.get("backface_culling", True)
    v = np.asarray(jm.v)
    near = np.minimum(_edge_distance(v, ro, rd, tri_d, bfc),
                      _edge_distance(v, ro, rd, tri_m, bfc))
    assert flips.any() and (near[flips] <= GRAZE).all()


@pytest.mark.parametrize("fn", [bruteforce_mesh, bruteforce_mesh_mxu],
                         ids=["direct", "mxu"])
def test_ids_do_not_depend_on_the_chunk(meshes, fn):
    """The strict < across chunks and the first minimum inside one: the
    lowest id wins a tie whatever tri_chunk is (one chunk, ragged
    chunks)."""
    jm, tm = meshes
    ro, rd, tl = seeded_rays("edges", np.asarray(jm.v))
    args = (tm, torch.from_numpy(ro), torch.from_numpy(rd))
    outs = [fn(*args, tri_chunk=c) for c in (64, 100, 2048)]
    for t, tri, _, _ in outs[1:]:
        assert torch.equal(tri, outs[0][1])
        assert torch.equal(t, outs[0][0])


@pytest.mark.parametrize("fn,jfn", [(bruteforce_mesh, j_direct),
                                    (bruteforce_mesh_mxu, j_mxu)],
                         ids=["direct", "mxu"])
def test_mesh_without_triangles(fn, jfn):
    """T = 0: FLT_MAX and -1 everywhere, no tests, as JAX's."""
    empty = dict(v=np.zeros((0, 3, 3), np.float32),
                 reach_lo=np.zeros((0, 3), np.float32),
                 reach_hi=np.zeros((0, 3), np.float32))
    ro, rd, tl = seeded_rays("around", None)
    jt, jtri, _, _ = jfn(types.SimpleNamespace(
        **{k: jnp.asarray(a) for k, a in empty.items()}),
        jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(tl))
    t, tri, box, tris = fn(types.SimpleNamespace(
        **{k: torch.from_numpy(a) for k, a in empty.items()}),
        torch.from_numpy(ro), torch.from_numpy(rd), torch.from_numpy(tl))
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tri.numpy(), np.asarray(jtri))
    assert float(box) == float(tris) == 0.0
