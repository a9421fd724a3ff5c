"""The any-hit walk of rendering_tpu_torch/csrc/mesh_intersect.cu, as far
as the CPU can hold it: the work counts of the plain version
(ops/cuda_intersect.py intersect_plain), the walk's tile schedule, and
the plain any hit against the Pallas kernel in interpret mode on the
adversarial shadow queries (ops/shadow_cases.py) that chip_smoke.py
runs through the kernel at full width.

Tolerance: none. Counts are integers and equal a numpy walk written
here; occlusion equals the Pallas kernel's on every ray. The Pallas
kernel runs in interpret mode in a child process whose XLA targets a
CPU without FMA instructions (XLA_FLAGS=--xla_cpu_max_isa=AVX):
interpret mode executes the kernel body as jitted XLA CPU code, which on
an FMA-capable CPU contracts its multiply-adds into FMAs, and on rays
that graze a shared edge that flips u + v <= 1 (5 of the 1536 grazing
rays; eager JAX, numpy, torch and the kernel's -fmad=false arithmetic
agree on all of them). The kernel itself needs a card
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
from torch_port_util import port_scene

FMAX = np.float32(3.4028234663852886e38)
TESTS = os.path.dirname(os.path.abspath(__file__))
N_ADVERSARIAL = 3 * 512


def _scenes():
    js = j_flagship(64, 32, n_tris=2000, with_maps=False)
    return js, port_scene(js)


@pytest.fixture(scope="module")
def scenes():
    return _scenes()


def pallas_adversarial(out_path):
    """Child process: occlusion of every adversarial query by the Pallas
    kernel in interpret mode (bruteforce_mesh_pallas, mode="any"),
    written to out_path (npz, one bool array per kind). Checks first that
    XLA contracts no multiply-add here."""
    import jax
    import jax.numpy as jnp

    from rendering_tpu.ops import pallas_intersect as jpi

    a, b, c = (jnp.float32(x) for x in (1.0 + 2.0**-12, 1.0 + 2.0**-12, -1.0))
    fused = jax.jit(lambda a, b, c: a * b + c)(a, b, c)
    if float(fused) != float(np.float32(np.float32(a) * np.float32(b)) - 1):
        raise RuntimeError("XLA contracted a * b + c into an FMA")
    js, ts = _scenes()
    tb = ts.meshes[0].itables
    mesh = js.meshes[0]
    occ = {}
    for kind in sc.KINDS:
        ro, rd, tl = sc.shadow_case(tb, kind, N_ADVERSARIAL, sc.SEEDS[kind],
                                    bias=float(ts.static.settings.bias))
        _, tri, _, _ = jpi.bruteforce_mesh_pallas(
            mesh, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(tl),
            backface_culling=True, use_root_filter=False, interpret=True,
            tables=mesh.itables, mode="any", rays_row=True)
        occ[kind] = np.asarray(tri) >= 0
    np.savez(out_path, **occ)


@pytest.fixture(scope="module")
def pallas_occlusion(tmp_path_factory):
    out = tmp_path_factory.mktemp("pallas") / "occ.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_cpu_max_isa=AVX",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([TESTS, os.path.dirname(TESTS)]))
    code = ("import test_torch_anyhit_walk as t; "
            f"t.pallas_adversarial({str(out)!r})")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def _rays(n, seed, resolved_every):
    """Shadow-like rays toward the mesh (half of them) and random ones,
    t0 = -1 on an interleaved share of the lanes: all but every
    `resolved_every`-th lane (0: none resolved)."""
    rng = np.random.default_rng(seed)
    ro = rng.normal(0, 2, (3, n)).astype(np.float32)
    rd = np.asarray([[-0.1], [0.0], [-0.6]], np.float32) - ro
    rd[:, n // 2:] = rng.normal(0, 1, (3, n - n // 2))
    rd /= np.linalg.norm(rd, axis=0, keepdims=True)
    tl = rng.uniform(0.05, 5.0, n).astype(np.float32)
    if resolved_every:
        tl[np.arange(n) % resolved_every != 0] = -1.0
    return ro, rd, tl


def _mt(rows, ro, rd, bfc):
    """Moller-Trumbore of (9, tc) triangle rows against (3, R) rays in
    float32 numpy, _intersect_chunk's operation order: (t, ok) (tc, R)."""
    v0, e1, e2 = (rows[3 * i:3 * i + 3, :, None] for i in range(3))
    o, d = ro[:, None, :], rd[:, None, :]
    p = [d[1] * e2[2] - d[2] * e2[1], d[2] * e2[0] - d[0] * e2[2],
         d[0] * e2[1] - d[1] * e2[0]]
    det = (e1[0] * p[0] + e1[1] * p[1]) + e1[2] * p[2]
    ok = det >= 1e-8 if bfc else np.abs(det) >= 1e-8
    inv = np.float32(1.0) / np.where(ok, det, np.float32(1.0))
    tv = [o[c] - v0[c] for c in range(3)]
    u = ((tv[0] * p[0] + tv[1] * p[1]) + tv[2] * p[2]) * inv
    q = [tv[1] * e1[2] - tv[2] * e1[1], tv[2] * e1[0] - tv[0] * e1[2],
         tv[0] * e1[1] - tv[1] * e1[0]]
    v = ((d[0] * q[0] + d[1] * q[1]) + d[2] * q[2]) * inv
    t = ((e2[0] * q[0] + e2[1] * q[1]) + e2[2] * q[2]) * inv
    ok = ok & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t >= 0)
    return t, ok


def _numpy_walk(tb, prep, bfc, anyhit=True):
    """The TPU formulation's walk tile by tile in numpy, any hit (t = -1
    and id 0 on a hit) or closest hit (the running min t per ray, the
    lowest row winning a tie within a sub-chunk), counting per tile-live
    sub-chunk: the rays its per-ray cull needs, the tile's unresolved
    rays, the 32-lane warps holding one, and the warps of the packed
    layout (the rays unresolved at the super's start, compacted stably
    into the lowest lanes); and the heaviest tile's union. Returns
    (counts dict, t (Rp,), id (Rp,)) as the plain version returns them."""
    tc, n_sub = tb.tri_chunk, tb.n_sub
    tri = tb.tri.numpy()
    cbox = tb.cbox.numpy()
    aux = prep.aux.numpy()
    pairs = union = warp = packed = tile_max = 0
    t_out = aux[9].copy()
    id_out = np.full(aux.shape[1], -1, np.int32)
    with np.errstate(all="ignore"):
        for tile in range(prep.n_tiles):
            lanes = slice(tile * 512, (tile + 1) * 512)
            ro, iv, rd = aux[0:3, lanes], aux[6:9, lanes], aux[3:6, lanes]
            t = aux[9, lanes].copy()
            ids = np.full(512, -1, np.int32)
            tile_union = 0
            for k in range(int(prep.counts[tile])):
                sup = int(prep.torder[tile, k])
                held = ~(t < 0)
                slot = np.cumsum(held) - 1
                for j in range(n_sub):
                    box = cbox[sup * n_sub + j]
                    ctmin = np.full(512, -FMAX, np.float32)
                    ctmax = np.full(512, FMAX, np.float32)
                    for c in range(3):
                        t1 = (box[c] - ro[c]) * iv[c]
                        t2 = (box[3 + c] - ro[c]) * iv[c]
                        ctmin = np.maximum(ctmin, np.minimum(t1, t2))
                        ctmax = np.minimum(ctmax, np.maximum(t1, t2))
                    live = (~((ctmin > ctmax) | (ctmax < 0) | (box[0] > box[3]))
                            & ~((ctmin >= t) | (t < 0)))
                    pairs += int(live.sum()) * tc
                    if not live.any():
                        continue
                    unres = t >= 0
                    union += int(unres.sum()) * tc
                    tile_union += int(unres.sum()) * tc
                    warp += int(unres.reshape(16, 32).any(axis=1).sum()) * 32 * tc
                    packed += len(set((slot[unres & held] // 32).tolist())) * 32 * tc
                    rows = tri[sup, 0:9, j * tc:(j + 1) * tc]
                    th, ok = _mt(rows, ro, rd, bfc)
                    ok &= th < t[None, :]
                    if anyhit:
                        hit = ok.any(axis=0)
                        t = np.where(hit, np.float32(-1.0), t)
                        ids = np.where(hit, 0, ids)
                        continue
                    tm = np.where(ok, th, FMAX)
                    t_min = tm.min(axis=0)
                    better = t_min < t
                    row = np.argmax(tm == t_min[None, :], axis=0)
                    t = np.where(better, t_min, t)
                    ids = np.where(better, (sup * n_sub + j) * tc + row, ids)
            t_out[lanes] = t
            id_out[lanes] = ids
            tile_max = max(tile_max, tile_union)
    return ({"pairs": pairs, "union_pairs": union, "warp_pairs": warp,
             "packed_pairs": packed, "tile_union_max": tile_max},
            t_out, id_out)


@pytest.mark.parametrize("anyhit,resolved_every", [
    pytest.param(True, 0, id="none_resolved"),
    pytest.param(True, 2, id="half_resolved"),
    pytest.param(True, 10, id="90pct_resolved"),
    pytest.param(False, 0, id="closest-none_resolved"),
    pytest.param(False, 2, id="closest-half_resolved"),
    pytest.param(False, 10, id="closest-90pct_resolved"),
])
def test_work_counts_match_numpy_walk(scenes, anyhit, resolved_every):
    """pairs, union_pairs, warp_pairs, packed_pairs and tile_union_max of
    the plain version, and its t (bits) and ids, equal a numpy walk's on
    a 3-tile query whose lanes enter resolved on an interleaved 0%, 50%
    and 90%, for the any hit and the closest hit; pairs <= union_pairs
    <= packed_pairs <= warp_pairs."""
    _, ts = scenes
    tb = ts.meshes[0].itables
    ro, rd, tl = _rays(3 * 512 - 100, seed=21, resolved_every=resolved_every)
    prep = ci.prepare(tb, *(torch.from_numpy(x) for x in (ro, rd, tl)))
    stats: dict = {}
    t, tri = ci.intersect_plain(tb, prep, anyhit=anyhit,
                                backface_culling=True, stats=stats)
    want, t_np, id_np = _numpy_walk(tb, prep, bfc=True, anyhit=anyhit)
    assert {k: stats[k] for k in want} == want
    np.testing.assert_array_equal(tri.numpy(), id_np)
    np.testing.assert_array_equal(t.numpy().view(np.int32), t_np.view(np.int32))
    assert (tri >= 0).sum() > 10
    assert 0 < want["pairs"] <= want["union_pairs"]
    assert want["union_pairs"] <= want["packed_pairs"] <= want["warp_pairs"]
    assert 0 < want["tile_union_max"] <= want["union_pairs"]
    if resolved_every:  # packing removes the resolved lanes' warps
        assert want["packed_pairs"] < want["warp_pairs"]


@pytest.mark.parametrize("case", ["random", "all_equal", "descending"])
def test_tile_order_is_stable_heaviest_first(case):
    """The walk's tile schedule is a permutation of the tiles with
    non-increasing live-super counts, ties in tile order."""
    rng = np.random.default_rng(5)
    counts = {"random": rng.integers(0, 6, 300),
              "all_equal": np.full(300, 3),
              "descending": np.arange(300)[::-1]}[case].astype(np.int32)
    order = ci.tile_order(torch.from_numpy(counts))
    assert order.dtype == torch.int32
    o = order.numpy()
    np.testing.assert_array_equal(np.sort(o), np.arange(300))
    c = counts[o]
    assert (np.diff(c) <= 0).all()
    for value in np.unique(c):
        assert (np.diff(o[c == value]) > 0).all()


@pytest.mark.parametrize("kind", sc.KINDS)
def test_plain_any_hit_matches_pallas_on_adversarial_queries(
        scenes, pallas_occlusion, kind):
    """Occlusion of the plain any hit equals the Pallas kernel's (interpret
    mode, no FMA) on every ray of the seeded adversarial queries:
    interleaved pre-resolved lanes, shadow rays leaving the mesh's
    triangles at the scene's bias, rays grazing cull-box faces."""
    _, ts = scenes
    tb = ts.meshes[0].itables
    bias = float(ts.static.settings.bias)
    ro, rd, tl = sc.shadow_case(tb, kind, N_ADVERSARIAL, sc.SEEDS[kind],
                                bias=bias)
    occ = ci.any_hit(tb, *(torch.from_numpy(x) for x in (ro, rd, tl)),
                     backface_culling=True).numpy()
    np.testing.assert_array_equal(occ, pallas_occlusion[kind])
    assert 20 < occ.sum() < occ.size - 20
    assert not occ[tl < 0].any()
    if kind == "interleaved":
        assert (tl < 0).mean() > 0.5
    if kind == "grazing":  # directions with a component of exactly 0
        assert (rd == 0).any(axis=0).mean() > 0.3


def test_shadow_cases_are_seeded():
    """The same seed gives the same rays; the interleaved mask resolves
    every other lane, all but lane 0 of each warp, every other warp."""
    from rendering_tpu_torch.flagship import procedural_mesh

    m = procedural_mesh(700, pos=(0, 0, -3), size=(2, 2, 2))
    tb = ci.build_intersect_tables(m.v, tri_chunk=64)
    for kind in sc.KINDS:
        a = sc.shadow_case(tb, kind, 999, seed=3)
        b = sc.shadow_case(tb, kind, 999, seed=3)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == np.float32 and np.isfinite(x[..., :5]).all()
    mask = sc.interleaved_mask(3 * 512)
    assert mask[:512].sum() == 256
    assert mask[512:1024].sum() == 512 - 16
    assert mask[1024:].sum() == 256
