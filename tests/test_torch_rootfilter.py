"""The plain versions of the root filter (K4) and the test counters (K3)
against the Pallas kernel run in interpret mode, on the CPU, over a
mesh clipped by its root box (the JAX scene carried across, its BVH
reach boxes in the table rows 9-14).

Tolerance: as tests/test_torch_intersect.py, triangle ids equal except
on rays whose two t values are equal (an exact tie is broken by the
tile's visit order), at most 0.1% of rays; t to rtol=2e-5. The counters
[box_tests, tri_tests] are equal exactly: the Pallas kernel sums them in
f32, which is exact while they stay below 2^24, as they do here, and
its fine 512-ray tiling is the one the port counts (the coarse fallback
tiling starts above 200_000 / 12 tile-super pairs).
"""

from __future__ import annotations

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rendering_tpu.flagship import procedural_mesh as j_procedural_mesh
from rendering_tpu.models import parser as j_parser
from rendering_tpu.models.scene import build_scene as j_build_scene
from rendering_tpu.models.settings import RenderSettings
from rendering_tpu.ops import pallas_intersect as jpi
from rendering_tpu_torch.ops import cuda_intersect as ci
from torch_port_util import port_scene

EXACT = 2 ** 24  # the Pallas counters are f32 sums


def _clipped_defs(n_meshes):
    """A SceneDef of n_meshes procedural meshes; the first is clipped by
    a root box of 0.7 of its extent, the others are not."""
    sd = j_parser.SceneDef(settings=RenderSettings(
        width=32, height=16, ac_penalty=3, enable_ssaa=False,
        enable_output=False, output_progress=False, pallas_interpret=True))
    for k in range(n_meshes):
        pos = (-0.1 + 1.5 * k, 0.0, -0.6 - 2.0 * k)
        # At most 4 supers of 8 x 64 triangles, fused ones included: the
        # Pallas wrapper then compiles only its all-pairs grid (no bucket
        # ladder), which keeps interpret mode fast.
        m = j_procedural_mesh(1500 if k == 0 else 500, pos=pos,
                              size=(2, 2, 2), seed=k)
        if k == 0:
            c = m.root_bounds.mean(axis=0)
            m = dataclasses.replace(m, root_bounds=(
                c + (m.root_bounds - c) * np.float32(0.7)).astype(np.float32))
        obj = j_parser.ObjectDef("mesh", pos=pos, size=(2, 2, 2))
        obj.mesh = m
        sd.objects.append(obj)
    return sd


def _j_build(n_meshes):
    """The JAX scene, its BVH built in Python (no native build)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RTPU_NATIVE", "0")
        return j_build_scene(_clipped_defs(n_meshes))


@pytest.fixture(scope="module")
def single():
    js = _j_build(1)
    assert js.meshes[0].clipped_by_root
    return js, port_scene(js)


@pytest.fixture(scope="module")
def fused():
    js = _j_build(2)
    assert js.fused_itables.any_clipped
    ts = port_scene(js)
    assert ts.fused_itables.any_clipped
    return js, ts


def _rays(n, seed, aims=((-0.1, 0.0, -0.6), (1.4, 0.0, -2.6))):
    """Rays aimed at the meshes from around them, rays leaving points
    near their surfaces, and random rays; limits with resolved lanes."""
    rng = np.random.default_rng(seed)
    ro = rng.normal(0, 2, (3, n)).astype(np.float32)
    rd = rng.normal(0, 1, (3, n)).astype(np.float32)
    q = n // 4
    for k, aim in enumerate(aims):
        a = np.asarray(aim, np.float32)[:, None]
        sl = slice(k * q // 2, (k + 1) * q // 2)
        rd[:, sl] = a - ro[:, sl]
        ro[:, q + sl.start:q + sl.stop] = a + rng.normal(
            0, 0.6, (3, sl.stop - sl.start)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=0, keepdims=True)
    tl = rng.uniform(0.05, 8.0, n).astype(np.float32)
    tl[rng.uniform(size=n) < 0.1] = -1.0
    return ro, rd, tl


def _torch(*xs):
    return [torch.from_numpy(x) for x in xs]


def _assert_ids(jt, jtri, tt, ttri):
    differ = jtri != ttri
    assert (jt[differ] == tt[differ]).all()  # only on an exact tie of t
    assert differ.mean() <= 1e-3
    np.testing.assert_array_equal(jtri >= 0, ttri >= 0)
    hit = ttri >= 0
    np.testing.assert_allclose(jt[hit], tt[hit], rtol=2e-5)


@pytest.mark.parametrize("anyhit", [False, True])
def test_rootfilter_plain_matches_pallas(single, anyhit):
    """K4 with the counters (K3): ids and occlusion as the Pallas
    kernel's, counters equal, and fewer hits than without the filter."""
    js, ts = single
    ro, rd, tl = _rays(1300, seed=11)
    mode = "any" if anyhit else "closest"
    jt, jtri, jbox, jtt = (np.asarray(x) for x in jpi.bruteforce_mesh_pallas(
        js.meshes[0], jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(tl),
        backface_culling=True, use_root_filter=True, interpret=True,
        tables=js.meshes[0].itables, mode=mode, collect_stats=True,
        rays_row=True))
    query = ci.any_hit if anyhit else ci.closest_hit
    out = query(ts.meshes[0].itables, *_torch(ro, rd, tl),
                backface_culling=True, root_filter=True, collect_stats=True)
    if anyhit:
        occ = out[0].numpy()
        np.testing.assert_array_equal(jtri >= 0, occ)
        assert 50 < occ.sum() < len(occ) - 50
    else:
        _assert_ids(jt, jtri, out[0].numpy(), out[1].numpy())
    box, tri = (int(x) for x in out[-2:])
    assert 0 < tri < EXACT and 0 < box < EXACT
    assert (box, tri) == (int(jbox), int(jtt))
    # The filter rejects hits that the unfiltered query accepts.
    unfiltered = query(ts.meshes[0].itables, *_torch(ro, rd, tl),
                       backface_culling=True)
    if anyhit:
        assert out[0].sum() < unfiltered.sum()
    else:
        assert (out[1] >= 0).sum() < (unfiltered[1] >= 0).sum()


@pytest.mark.parametrize("anyhit", [False, True])
def test_fused_rootfilter_stats_plain_matches_pallas(fused, anyhit):
    """K5 with the root filter (one clipped, one unclipped mesh) and the
    counters."""
    js, ts = fused
    ro, rd, tl = _rays(1500, seed=12)
    mode = "any" if anyhit else "closest"
    jout = [np.asarray(x) for x in jpi.intersect_fused(
        js.fused_itables, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(tl),
        mode=mode, backface_culling=True, use_root_filter=True,
        collect_stats=True, interpret=True)]
    tout = ci.intersect_fused(ts.fused_itables, *_torch(ro, rd, tl),
                              mode=mode, backface_culling=True,
                              root_filter=True, collect_stats=True)
    tout = [x.numpy() for x in tout]
    if anyhit:
        np.testing.assert_array_equal(jout[0], tout[0])
        assert 50 < tout[0].sum() < len(tout[0]) - 50
    else:
        _assert_ids(jout[0], jout[2], tout[0], tout[2])
        np.testing.assert_array_equal(jout[1] >= 0, tout[1] >= 0)
        assert len(set(tout[1][tout[1] >= 0].tolist())) == 2  # both meshes
    box, tri = int(tout[-2]), int(tout[-1])
    assert 0 < tri < EXACT and 0 < box < EXACT
    assert (box, tri) == (int(jout[-2]), int(jout[-1]))


@pytest.mark.parametrize("anyhit", [False, True])
def test_stats_plain_matches_pallas_without_filter(single, anyhit):
    """K3 alone (use_ac off): the counters of the unfiltered walk."""
    js, ts = single
    ro, rd, tl = _rays(1100, seed=13)
    _, _, jbox, jtt = jpi.bruteforce_mesh_pallas(
        js.meshes[0], jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(tl),
        backface_culling=False, use_root_filter=False, interpret=True,
        tables=js.meshes[0].itables, mode="any" if anyhit else "closest",
        collect_stats=True, rays_row=True)
    query = ci.any_hit if anyhit else ci.closest_hit
    *_, box, tri = query(ts.meshes[0].itables, *_torch(ro, rd, tl),
                         backface_culling=False, collect_stats=True)
    assert (int(box), int(tri)) == (int(jbox), int(jtt))
    assert int(tri) > 0


def test_nan_corner_accepted():
    """A ray with rd.x = 0 whose origin lies exactly on the reach box's
    x = lo plane: (lo - o) * (1/0) = 0 * inf = NaN, which the reference's
    negated comparisons accept (an interval form with fminf/fmaxf would
    reject it). A ray beside the box, at x < lo, is rejected. The JAX
    kernel agrees on both."""
    v = np.asarray([[[-1, 0, -1], [1, 0, -1], [0, 1, -1]]], np.float32)
    lo = np.asarray([[0, 0, -1]], np.float32)
    hi = np.asarray([[1, 1, -1]], np.float32)
    ro = np.asarray([[0.0, -0.5], [0.25, 0.25], [0.0, 0.0]], np.float32)
    rd = np.asarray([[0.0, 0.0], [0.0, 0.0], [-1.0, -1.0]], np.float32)
    tb = ci.build_intersect_tables(v, tri_chunk=64, reach=(lo, hi))
    t, tri = ci.closest_hit(tb, *_torch(ro, rd), root_filter=True)
    assert tri.tolist() == [0, -1] and float(t[0]) == 1.0
    jtb = jpi.build_intersect_tables(
        types.SimpleNamespace(v=v, reach_lo=lo, reach_hi=hi, morton_perm=None),
        tri_chunk=64)
    _, jtri, _, _ = jpi._intersect_tables_impl(
        jtb, jnp.asarray(ro), jnp.asarray(rd), None, backface_culling=True,
        use_root_filter=True, anyhit=False, collect_stats=False,
        ray_tile=512, interpret=True)
    assert np.asarray(jtri).tolist() == [0, -1]
    _, tri_nf = ci.closest_hit(tb, *_torch(ro, rd))
    assert tri_nf.tolist() == [0, 0]
