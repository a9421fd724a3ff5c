"""Port parity of the intersection module (ops/cuda_intersect.py): the
chunk tables and the pre-pass against the JAX package's, and the
kernels' plain versions against the Pallas kernel run in interpret mode
(`bruteforce_mesh_pallas(..., interpret=True)`), on the CPU.

Tolerance: triangle ids equal, except on rays whose two t values are
equal (an exact tie between two triangles is broken by the tile's visit
order, which comes from float sums that torch may add in another order
than XLA) — at most 0.1% of rays. t agrees to rtol=2e-5 as in
tests/test_pallas.py. Tables and live sets are bit-equal.

The CUDA kernels themselves have no CPU mode: tests/test_torch_cuda.py
holds them against the plain versions on a card.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rendering_tpu.flagship import build_flagship_scene as j_flagship
from rendering_tpu.ops import pallas_intersect as jpi
from rendering_tpu_torch.ops import cuda_intersect as ci
from torch_port_util import port_scene

FMAX = 3.4028234663852886e38


@pytest.fixture(scope="module")
def scenes():
    js = j_flagship(64, 32, n_tris=2000, with_maps=False)
    return js, port_scene(js)


def _rays(n, seed, aim=(-0.1, 0.0, -0.6)):
    """Half random rays, a quarter aimed at the mesh, a quarter leaving
    points on its surface (the shadow-ray workload)."""
    rng = np.random.default_rng(seed)
    ro = rng.normal(0, 2, (3, n)).astype(np.float32)
    rd = rng.normal(0, 1, (3, n)).astype(np.float32)
    q = n // 4
    aim = np.asarray(aim, np.float32)[:, None]
    rd[:, :q] = aim - ro[:, :q]
    ro[:, q:2 * q] = aim + rng.normal(0, 0.6, (3, q)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=0, keepdims=True)
    return ro, rd


def _limits(n, seed, pre_done=0.1):
    rng = np.random.default_rng(seed)
    tl = rng.uniform(0.05, 5.0, n).astype(np.float32)
    tl[rng.uniform(size=n) < pre_done] = -1.0  # resolved before the query
    return tl


def test_morton_and_table_rows_equal(scenes):
    js, ts = scenes
    jm, tm = js.meshes[0], ts.meshes[0]
    np.testing.assert_array_equal(np.asarray(jm.v), tm.v.numpy())
    jt = jpi.build_intersect_tables(
        jm, tri_chunk=jpi.default_tri_chunk(2000), as_numpy=True)
    tt = tm.itables
    assert (tt.tri_chunk, tt.n_sub) == (jt.tri_chunk, jt.n_sub)
    assert tt.tri.shape == jt.tri.shape
    np.testing.assert_array_equal(tt.tri[:, 0:9].numpy(), jt.tri[:, 0:9])
    assert not tt.tri[:, 9:].any()  # root-filter rows wait for a later slice
    np.testing.assert_array_equal(tt.cbox.numpy(), jt.cbox)
    np.testing.assert_array_equal(tt.sbox.numpy(), jt.sbox)


@pytest.mark.parametrize("n_tris,tri_chunk", [(700, 64), (2000, 64),
                                              (5000, 128), (90, 64)])
def test_tables_ragged_sizes(n_tris, tri_chunk):
    """Triangle counts that leave partial chunks and partial supers, and
    a mesh with fewer chunks than n_sub."""
    from rendering_tpu.flagship import procedural_mesh

    m = procedural_mesh(n_tris, pos=(0, 0, -3), size=(2, 2, 2))
    mesh = type("M", (), {"v": m.v, "reach_lo": m.v.min(1),
                          "reach_hi": m.v.max(1), "morton_perm": None})
    jt = jpi.build_intersect_tables(mesh, tri_chunk=tri_chunk, as_numpy=True)
    tt = ci.build_intersect_tables(m.v, tri_chunk=tri_chunk)
    np.testing.assert_array_equal(tt.tri[:, 0:9].numpy(), jt.tri[:, 0:9])
    np.testing.assert_array_equal(tt.cbox.numpy(), jt.cbox)
    np.testing.assert_array_equal(tt.sbox.numpy(), jt.sbox)


@pytest.mark.parametrize("with_limit", [True, False])
def test_prepass_live_sets_equal(scenes, with_limit):
    js, ts = scenes
    tb = ts.meshes[0].itables
    n = 5 * 512
    ro, rd = _rays(n, seed=3)
    tl = _limits(n, seed=4) if with_limit else None
    prep = ci.prepare(tb, torch.from_numpy(ro), torch.from_numpy(rd),
                      None if tl is None else torch.from_numpy(tl))
    aux = prep.aux.numpy()
    n_tiles = prep.n_tiles
    rows = [jnp.asarray(aux[a:a + 3].reshape(3, n_tiles, 512).swapaxes(0, 1))
            for a in (0, 6)]
    torder, counts, _ = jpi._tile_tables(
        rows[0], rows[1], jnp.asarray(aux[9].reshape(n_tiles, 512)),
        js.meshes[0].itables.sbox)
    torder, counts = np.asarray(torder), np.asarray(counts)
    np.testing.assert_array_equal(prep.counts.numpy(), counts)
    assert counts.sum() > 0
    for i in range(n_tiles):
        c = counts[i]
        assert set(prep.torder[i, :c].tolist()) == set(torder[i, :c].tolist())


def _jax_query(js, ro, rd, tl, *, anyhit, bfc):
    mesh = js.meshes[0]
    t, tri, _, _ = jpi.bruteforce_mesh_pallas(
        mesh, jnp.asarray(ro), jnp.asarray(rd),
        None if tl is None else jnp.asarray(tl),
        backface_culling=bfc, use_root_filter=False, interpret=True,
        tables=mesh.itables, mode="any" if anyhit else "closest",
        rays_row=True,
    )
    return np.asarray(t), np.asarray(tri)


@pytest.mark.parametrize("bfc", [True, False])
@pytest.mark.parametrize("with_limit", [True, False])
def test_closest_hit_plain_matches_pallas(scenes, bfc, with_limit):
    js, ts = scenes
    n = 1300  # ragged: 3 tiles, the last one partial
    ro, rd = _rays(n, seed=5)
    tl = _limits(n, seed=6) if with_limit else None
    jt, jtri = _jax_query(js, ro, rd, tl, anyhit=False, bfc=bfc)
    tt, ttri = ci.closest_hit(
        ts.meshes[0].itables, torch.from_numpy(ro), torch.from_numpy(rd),
        None if tl is None else torch.from_numpy(tl), backface_culling=bfc)
    tt, ttri = tt.numpy(), ttri.numpy()
    assert (ttri >= 0).sum() > 100
    if with_limit:
        assert (ttri[tl < 0] == -1).all()  # pre-done lanes accept nothing
    differ = jtri != ttri
    # A differing id is allowed only on an exact tie of t, on <= 0.1%.
    assert (jt[differ] == tt[differ]).all()
    assert differ.mean() <= 1e-3
    hit = (jtri >= 0) & (ttri >= 0)
    np.testing.assert_array_equal(jtri >= 0, ttri >= 0)
    np.testing.assert_allclose(jt[hit], tt[hit], rtol=2e-5)
    assert (tt[ttri < 0] == np.float32(FMAX)).all()


@pytest.mark.parametrize("bfc", [True, False])
def test_any_hit_plain_matches_pallas(scenes, bfc):
    js, ts = scenes
    n = 1700
    ro, rd = _rays(n, seed=7)
    tl = _limits(n, seed=8, pre_done=0.2)
    _, jtri = _jax_query(js, ro, rd, tl, anyhit=True, bfc=bfc)
    occ = ci.any_hit(ts.meshes[0].itables, torch.from_numpy(ro),
                     torch.from_numpy(rd), torch.from_numpy(tl),
                     backface_culling=bfc).numpy()
    assert 50 < occ.sum() < n - 50
    assert not occ[tl < 0].any()
    np.testing.assert_array_equal(jtri >= 0, occ)


def test_plain_raw_outputs_match_pallas_kernel(scenes):
    """The plain version's raw (t, chunk-space id) equal the Pallas
    kernel's raw outputs on the same rays."""
    js, ts = scenes
    tb = ts.meshes[0].itables
    n = 1024
    ro, rd = _rays(n, seed=9)
    prep = ci.prepare(tb, torch.from_numpy(ro), torch.from_numpy(rd))
    t_raw, tri_raw = ci.intersect_plain(tb, prep, anyhit=False,
                                        backface_culling=True)
    j_t, j_tri, _, _ = jpi._intersect_tables_impl(
        js.meshes[0].itables, jnp.asarray(ro), jnp.asarray(rd), None,
        backface_culling=True, use_root_filter=False, anyhit=False,
        collect_stats=False, ray_tile=512, interpret=True)
    differ = np.asarray(j_tri) != tri_raw.numpy()[:n]
    assert differ.mean() <= 1e-3
    assert (np.asarray(j_t)[differ] == t_raw.numpy()[:n][differ]).all()
    np.testing.assert_allclose(np.asarray(j_t), t_raw.numpy()[:n], rtol=2e-5)


def test_pair_count_and_resolved_lanes(scenes):
    """stats["pairs"] counts per-ray-live sub-chunks; a query of only
    resolved rays visits nothing and returns t0 and -1."""
    _, ts = scenes
    tb = ts.meshes[0].itables
    ro, rd = _rays(600, seed=10)
    tl = torch.full((600,), -1.0)
    prep = ci.prepare(tb, torch.from_numpy(ro), torch.from_numpy(rd), tl)
    assert int(prep.counts.sum()) == 0
    stats = {}
    t, tri = ci.intersect_plain(tb, prep, anyhit=False, backface_culling=True,
                                stats=stats)
    assert stats["pairs"] == 0
    assert (t == -1.0).all() and (tri == -1).all()
    stats = {}
    prep = ci.prepare(tb, torch.from_numpy(ro), torch.from_numpy(rd))
    ci.intersect_plain(tb, prep, anyhit=False, backface_culling=True,
                       stats=stats)
    assert stats["pairs"] > 0 and stats["pairs"] % tb.tri_chunk == 0


def test_empty_query(scenes):
    _, ts = scenes
    tb = ts.meshes[0].itables
    t, tri = ci.closest_hit(tb, torch.zeros((3, 0)), torch.ones((3, 0)))
    occ = ci.any_hit(tb, torch.zeros((3, 0)), torch.ones((3, 0)))
    assert t.shape == tri.shape == occ.shape == (0,)


def test_kernel_refuses_cpu_tensors(scenes):
    _, ts = scenes
    tb = ts.meshes[0].itables
    ro, rd = _rays(512, seed=11)
    prep = ci.prepare(tb, torch.from_numpy(ro), torch.from_numpy(rd))
    before = ci.closest_hit_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        ci.closest_hit_kernel(tb, prep, backface_culling=True)
    assert ci.closest_hit_kernel.launches == before


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(ci, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(ci, "_nvcc", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc"):
        ci.build_library()


def test_prepass_keeps_nan_slabs_live(scenes):
    """Axis-parallel rays starting exactly on a super box's planes make
    0 * inf = NaN slab values; the negated comparisons keep such supers
    live, as the JAX pre-pass does (a NaN-dropping min/max would cull
    them)."""
    js, ts = scenes
    tb = ts.meshes[0].itables
    sbox = tb.sbox.numpy()
    n = 512
    ro = np.zeros((3, n), np.float32)
    rd = np.zeros((3, n), np.float32)
    k = np.arange(n) % sbox.shape[0]
    axis = np.arange(n) % 3
    for c in range(3):  # start on the box's lo plane of axis c, move along it
        m = axis == c
        ro[:, m] = ((sbox[k[m], 0:3] + sbox[k[m], 3:6]) * 0.5).T
        ro[c, m] = sbox[k[m], c]
        rd[(c + 1) % 3, m] = 1.0
    prep = ci.prepare(tb, torch.from_numpy(ro), torch.from_numpy(rd))
    aux = prep.aux.numpy()
    with np.errstate(invalid="ignore"):
        assert np.isnan((sbox[k, 0] - aux[0, :n]) * aux[6, :n]).any()
    rows = [jnp.asarray(aux[a:a + 3].reshape(3, 1, 512).swapaxes(0, 1))
            for a in (0, 6)]
    _, counts, _ = jpi._tile_tables(rows[0], rows[1],
                                    jnp.asarray(aux[9].reshape(1, 512)),
                                    js.meshes[0].itables.sbox)
    assert int(prep.counts[0]) == int(counts[0]) == sbox.shape[0]


def test_duplicate_triangles_lowest_row_wins():
    """Every triangle twice: each ray ties exactly between the two copies
    (adjacent in Morton order, same chunk), and both packages return the
    lower id."""
    from rendering_tpu.flagship import procedural_mesh
    from rendering_tpu.models.parser import ObjectDef, SceneDef
    from rendering_tpu.models.scene import build_scene
    from rendering_tpu.models.settings import RenderSettings

    m = procedural_mesh(300, pos=(0, 0, -3), size=(2, 2, 2))
    for k in ("v", "n", "uv", "tangent", "bitangent"):
        setattr(m, k, np.repeat(getattr(m, k), 2, axis=0))
    sd = SceneDef(settings=RenderSettings(width=8, height=8))
    obj = ObjectDef("mesh", pos=(0, 0, -3), size=(2, 2, 2), color=(1, 1, 1))
    obj.mesh = m
    sd.objects = [obj]
    js = build_scene(sd)
    ts = port_scene(js)
    ro, rd = _rays(1024, seed=14, aim=(0, 0, -3))
    jt, jtri = _jax_query(js, ro, rd, None, anyhit=False, bfc=False)
    tt, ttri = ci.closest_hit(ts.meshes[0].itables, torch.from_numpy(ro),
                              torch.from_numpy(rd), backface_culling=False)
    v = ts.meshes[0].v.numpy()
    hit = ttri.numpy() >= 0
    assert hit.sum() > 100
    twin = np.where(ttri.numpy() % 2 == 0, ttri.numpy() + 1, ttri.numpy() - 1)
    assert (v[ttri.numpy()[hit]] == v[twin[hit]]).all()  # a real tie
    np.testing.assert_array_equal(jtri, ttri.numpy())
    # t: the port's equals the plain f32 formula, operation by operation,
    # bit for bit. XLA on the CPU evaluates the interpret-mode kernel with
    # other roundings (measured: 44% of these t differ, by up to 3.7e-5
    # relative where the cross products cancel), hence its tolerance.
    tt, ttri = tt.numpy()[hit], ttri.numpy()[hit]
    np.testing.assert_array_equal(tt, _mt_numpy(v[ttri], ro[:, hit].T,
                                                rd[:, hit].T))
    np.testing.assert_allclose(jt[hit], tt, rtol=1e-4)


def _mt_numpy(tri, ro, rd):
    """Moller-Trumbore t in numpy f32, in `_intersect_chunk`'s order."""
    v0, e1, e2 = tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
    p = [rd[:, 1] * e2[:, 2] - rd[:, 2] * e2[:, 1],
         rd[:, 2] * e2[:, 0] - rd[:, 0] * e2[:, 2],
         rd[:, 0] * e2[:, 1] - rd[:, 1] * e2[:, 0]]
    det = (e1[:, 0] * p[0] + e1[:, 1] * p[1]) + e1[:, 2] * p[2]
    tv = ro - v0
    q = [tv[:, 1] * e1[:, 2] - tv[:, 2] * e1[:, 1],
         tv[:, 2] * e1[:, 0] - tv[:, 0] * e1[:, 2],
         tv[:, 0] * e1[:, 1] - tv[:, 1] * e1[:, 0]]
    return ((e2[:, 0] * q[0] + e2[:, 1] * q[1]) + e2[:, 2] * q[2]) * (
        np.float32(1.0) / det)
