"""The closest walk of rendering_tpu_torch/csrc/mesh_intersect.cu, as far
as the CPU can hold it: the plain closest hit against the Pallas kernel
in interpret mode on the seeded closest-hit cases (ops/shadow_cases.py
`closest_case`) that chip_smoke.py and the card tests run through the
kernel, and a numpy model of the walk's cluster schedule against the
plain version's counters.

Tolerance: none. t is compared bit for bit, ids, occlusion and counters
exactly. The Pallas kernel runs in interpret mode in a child process
whose XLA targets a CPU without FMA instructions
(XLA_FLAGS=--xla_cpu_max_isa=AVX), as tests/test_torch_anyhit_walk.py
does: on an FMA-capable CPU interpret mode contracts the kernel's
multiply-adds into FMAs. The kernel itself needs a card
(tests/test_torch_cuda.py).
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rendering_tpu.flagship import build_flagship_scene as j_flagship
from rendering_tpu_torch.ops import cuda_intersect as ci
from rendering_tpu_torch.ops import shadow_cases as sc
from test_torch_anyhit_walk import _mt
from torch_port_util import port_scene

FMAX = np.float32(3.4028234663852886e38)
TESTS = os.path.dirname(os.path.abspath(__file__))
N_RAYS = 3 * 512 - 100   # ragged: the last tile holds padded lanes


def _scenes():
    js = j_flagship(64, 32, n_tris=2000, with_maps=False)
    return js, port_scene(js)


@pytest.fixture(scope="module")
def scenes():
    return _scenes()


def _case_tables(ts, kind):
    """The port's tables of a case: the mesh's own, or for `duplicates`
    its triangles each twice, four rows apart (same chunk size)."""
    tb = ts.meshes[0].itables
    if kind != "duplicates":
        return tb
    return ci.build_intersect_tables(sc.duplicated(ts.meshes[0].v.numpy()),
                                     tri_chunk=tb.tri_chunk)


def _case(ts, kind):
    tb = _case_tables(ts, kind)
    ro, rd, tl = sc.closest_case(tb, kind, N_RAYS, sc.CLOSEST_SEEDS[kind],
                                 bias=float(ts.static.settings.bias))
    return tb, ro, rd, tl


def pallas_closest(out_path):
    """Child process: the Pallas kernel's closest hit (interpret mode,
    collect_stats) on every closest case, written to out_path (npz:
    t, tri and [box_tests, tri_tests] per kind). Checks first that XLA
    contracts no multiply-add here."""
    import jax
    import jax.numpy as jnp

    from rendering_tpu.ops import pallas_intersect as jpi

    a, b, c = (jnp.float32(x) for x in (1.0 + 2.0**-12, 1.0 + 2.0**-12, -1.0))
    fused = jax.jit(lambda a, b, c: a * b + c)(a, b, c)
    if float(fused) != float(np.float32(np.float32(a) * np.float32(b)) - 1):
        raise RuntimeError("XLA contracted a * b + c into an FMA")
    js, ts = _scenes()
    out = {}
    for kind in sc.CLOSEST_KINDS:
        tb, ro, rd, tl = _case(ts, kind)
        v = np.asarray(js.meshes[0].v)
        if kind == "duplicates":
            v = sc.duplicated(v)
        mesh = type("M", (), {"v": v, "reach_lo": v.min(1),
                              "reach_hi": v.max(1), "morton_perm": None})
        tables = jpi.build_intersect_tables(mesh, tri_chunk=tb.tri_chunk)
        t, tri, box, tests = jpi.bruteforce_mesh_pallas(
            mesh, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(tl),
            backface_culling=True, use_root_filter=False, interpret=True,
            tables=tables, mode="closest", collect_stats=True,
            rays_row=True)
        out[f"{kind}_t"] = np.asarray(t)
        out[f"{kind}_tri"] = np.asarray(tri)
        out[f"{kind}_counters"] = np.asarray([int(box), int(tests)])
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def pallas_results(tmp_path_factory):
    out = tmp_path_factory.mktemp("pallas") / "closest.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_cpu_max_isa=AVX",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([TESTS, os.path.dirname(TESTS)]))
    code = ("import test_torch_closest_walk as t; "
            f"t.pallas_closest({str(out)!r})")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("kind", sc.CLOSEST_KINDS)
def test_plain_closest_matches_pallas_on_closest_cases(
        scenes, pallas_results, kind):
    """The plain closest hit equals the Pallas kernel (interpret mode, no
    FMA) on every ray of the seeded closest cases: t bit for bit, ids and
    the counters [box_tests, tri_tests] exactly. Rays whose own cull
    fails while the tile's union is live, rays in cull-box face planes,
    interleaved pre-resolved and padded lanes, and duplicated triangles,
    where the lower row (row mod 8 < 4) wins every hit."""
    _, ts = scenes
    tb, ro, rd, tl = _case(ts, kind)
    t, tri, box, tests = ci.closest_hit(
        tb, *(torch.from_numpy(x) for x in (ro, rd, tl)),
        backface_culling=True, collect_stats=True)
    t, tri = t.numpy(), tri.numpy()
    np.testing.assert_array_equal(tri, pallas_results[f"{kind}_tri"])
    np.testing.assert_array_equal(t.view(np.int32),
                                  pallas_results[f"{kind}_t"].view(np.int32))
    assert [int(box), int(tests)] == pallas_results[f"{kind}_counters"].tolist()
    assert (tri >= 0).sum() > 50
    assert (tri[tl < 0] == -1).all()
    if kind == "duplicates":
        assert (tri[tri >= 0] % 8 < 4).all()
    else:
        assert (tri < 0).sum() > 50
    if kind == "resolved":
        assert (tl < 0).mean() > 0.5


def _slab_all(box, ro, iv):
    """ctmin, ctmax (n_sub, R) of boxes (n_sub, 8) against rays, with
    the NaN-keeping min/max of the kernels."""
    ctmin = np.full((box.shape[0], ro.shape[1]), -FMAX, np.float32)
    ctmax = np.full((box.shape[0], ro.shape[1]), FMAX, np.float32)
    for c in range(3):
        t1 = (box[:, c, None] - ro[c]) * iv[c]
        t2 = (box[:, 3 + c, None] - ro[c]) * iv[c]
        ctmin = np.maximum(ctmin, np.minimum(t1, t2))
        ctmax = np.minimum(ctmax, np.maximum(t1, t2))
    return ctmin, ctmax


def _cluster_walk(tb, prep, bfc, cluster):
    """The closest walk's schedule (closest_walk_kernel) in numpy. Per
    tile, rank c of the cluster holds rays [c 512/G, (c+1) 512/G); per
    super each ray's cull is taken once (ctmin and the boxes its slab
    meets), and the ranks' live-ray counts per sub-chunk are summed in an
    exchange at the super's start and after each evaluated sub-chunk
    that leaves candidates; a sub-chunk runs iff its summed count is > 0.
    Returns (t, id, box_tests, tri_tests, [(exchanges, evaluated) per
    super])."""
    tc, n_sub = tb.tri_chunk, tb.n_sub
    tri = tb.tri.numpy()
    cbox = tb.cbox.numpy().reshape(-1, n_sub, 8)
    aux = prep.aux.numpy()
    per = 512 // cluster
    t_out = aux[9].copy()
    id_out = np.full(aux.shape[1], -1, np.int32)
    box_tests = tri_tests = 0
    supers = []
    with np.errstate(all="ignore"):
        for tile in range(prep.n_tiles):
            lanes = slice(tile * 512, (tile + 1) * 512)
            ro, rd, iv = aux[0:3, lanes], aux[3:6, lanes], aux[6:9, lanes]
            t = aux[9, lanes].copy()
            ids = np.full(512, -1, np.int32)
            n_live = int(prep.counts[tile])
            box_tests += n_live * n_sub * 512
            for k in range(n_live):
                sup = int(prep.torder[tile, k])
                box = cbox[sup]
                ctmin, ctmax = _slab_all(box, ro, iv)
                live0 = ~((ctmin > ctmax) | (ctmax < 0)
                          | (box[:, 0] > box[:, 3])[:, None])

                def exchange(cand):
                    live = live0 & ~((ctmin >= t) | (t < 0)) & cand[:, None]
                    return sum(live[:, c * per:(c + 1) * per].sum(axis=1)
                               for c in range(cluster))

                counts = exchange(np.ones(n_sub, bool))
                n_x, n_ev = 1, 0
                while (counts > 0).any():
                    j = int(np.argmax(counts > 0))
                    tri_tests += int(counts[j]) * tc
                    n_ev += 1
                    rows = tri[sup, 0:9, j * tc:(j + 1) * tc]
                    th, ok = _mt(rows, ro, rd, bfc)
                    ok &= th < t[None, :]
                    tm = np.where(ok, th, FMAX)
                    t_min = tm.min(axis=0)
                    better = t_min < t
                    row = np.argmax(tm == t_min[None, :], axis=0)
                    t = np.where(better, t_min, t)
                    ids = np.where(better, (sup * n_sub + j) * tc + row, ids)
                    cand = (np.arange(n_sub) > j) & (counts > 0)
                    if not cand.any():
                        break
                    counts = exchange(cand)
                    n_x += 1
                supers.append((n_x, n_ev))
            t_out[lanes] = t
            id_out[lanes] = ids
    return t_out, id_out, box_tests, tri_tests, supers


@pytest.mark.parametrize("cluster", ci.CLUSTER_SIZES)
@pytest.mark.parametrize("kind", sc.CLOSEST_KINDS)
def test_cluster_schedule_matches_plain_counters(scenes, kind, cluster):
    """The closest walk's schedule (a numpy model: rank slices, one cull
    per ray and super, exchanges only at a super's start and after an
    evaluated sub-chunk) gives the plain version's t bits, ids and K3
    counters on every closest case, at every cluster size, with at most
    1 + (evaluated sub-chunks) exchanges a super, and never more than its
    sub-chunks."""
    _, ts = scenes
    tb, ro, rd, tl = _case(ts, kind)
    prep = ci.prepare(tb, *(torch.from_numpy(x) for x in (ro, rd, tl)))
    t, tri, box, tests = ci.intersect_plain(tb, prep, anyhit=False,
                                            backface_culling=True,
                                            collect_stats=True)
    t_m, id_m, box_m, tests_m, supers = _cluster_walk(tb, prep, True, cluster)
    np.testing.assert_array_equal(tri.numpy(), id_m)
    np.testing.assert_array_equal(t.numpy().view(np.int32), t_m.view(np.int32))
    assert (box_m, tests_m) == (int(box), int(tests))
    assert tests_m > 0 and supers
    assert all(1 <= x <= min(1 + ev, tb.n_sub) for x, ev in supers)


@pytest.mark.parametrize("case", ["skewed", "uniform", "empty", "factor0"])
def test_tile_schedule_splits_heavy_tiles_first(case):
    """The walks' schedule: order is a permutation with non-increasing
    counts (ties in tile order), and the first n_split tiles of it are
    exactly those whose count is at least split_factor times the mean and
    above 0, so the heavy tiles, the ones the closest walk splits over a
    cluster, come first."""
    rng = np.random.default_rng(7)
    counts, factor = {
        "skewed": (np.r_[rng.integers(0, 4, 250), [40, 9, 30, 12, 8, 7]], 2),
        "uniform": (np.full(256, 8), 2),
        "empty": (np.zeros(64, np.int64), 2),
        "factor0": (rng.integers(0, 3, 100), 0),
    }[case]
    c = torch.from_numpy(np.asarray(counts, np.int32))
    order, n_split = ci.tile_schedule(c, factor)
    assert order.dtype == n_split.dtype == torch.int32
    assert tuple(n_split.shape) == (1,)
    o, n = order.numpy(), int(n_split)
    np.testing.assert_array_equal(np.sort(o), np.arange(len(counts)))
    assert (np.diff(counts[o]) <= 0).all()
    heavy = (counts * len(counts) >= factor * counts.sum()) & (counts > 0)
    assert set(o[:n].tolist()) == set(np.flatnonzero(heavy).tolist())
    assert n == {"skewed": 6, "uniform": 0, "empty": 0,
                 "factor0": int((counts > 0).sum())}[case]
    prep = ci.prepare(*_schedule_query())
    np.testing.assert_array_equal(prep.order.numpy(),
                                  ci.tile_order(prep.counts).numpy())
    assert int(prep.n_split) == int(ci.tile_schedule(prep.counts)[1])


def _schedule_query():
    from rendering_tpu_torch.flagship import procedural_mesh

    m = procedural_mesh(700, pos=(0, 0, -3), size=(2, 2, 2))
    tb = ci.build_intersect_tables(m.v, tri_chunk=64)
    ro, rd, tl = sc.closest_case(tb, "union_live", 1500, seed=4)
    return tb, *(torch.from_numpy(x) for x in (ro, rd, tl))


def test_closest_cases_are_seeded(scenes):
    """The same seed gives the same rays; `duplicated` repeats every
    block of four triangles right after it."""
    _, ts = scenes
    for kind in sc.CLOSEST_KINDS:
        tb = _case_tables(ts, kind)
        a = sc.closest_case(tb, kind, 999, seed=3)
        b = sc.closest_case(tb, kind, 999, seed=3)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == np.float32 and x.shape[-1] == 999
    v = ts.meshes[0].v.numpy()
    d = sc.duplicated(v).reshape(-1, 8, 3, 3)
    n = v.shape[0] // 4 * 4
    np.testing.assert_array_equal(d[:, :4].reshape(-1, 3, 3), v[:n])
    np.testing.assert_array_equal(d[:, 4:].reshape(-1, 3, 3), v[:n])
    with pytest.raises(ValueError):
        sc.closest_case(_case_tables(ts, "grazing"), "nope", 8, seed=0)


def test_closest_walk_takes_no_cpu_tensors(scenes):
    """The closest walk's wrapper launches or raises: CPU tensors and a
    cluster size the kernel does not take are refused before any launch;
    the query entry points take the plain version for CPU tensors."""
    _, ts = scenes
    tb = ts.meshes[0].itables
    ro, rd, tl = sc.closest_case(tb, "union_live", 600, seed=1)
    prep = ci.prepare(tb, *(torch.from_numpy(x) for x in (ro, rd, tl)))
    k = ci.KERNELS["closest_hit"]
    before = k.launches
    with pytest.raises(ValueError, match="CUDA"):
        k(tb, prep, backface_culling=True)
    assert k.launches == before
    assert ci.CLOSEST_CLUSTER in ci.CLUSTER_SIZES
    for fused in (False, True):
        for rf in (False, True):
            for cs in (False, True):
                assert ci.variant_name(anyhit=False, fused=fused,
                                       root_filter=rf,
                                       collect_stats=cs) in ci.KERNELS
    out = ci.run_query(tb, prep, anyhit=False, backface_culling=True)
    ref = ci.intersect_plain(tb, prep, anyhit=False, backface_culling=True)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert k.launches == before
