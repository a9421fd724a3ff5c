"""The port's CUDA kernels on a card, against their plain PyTorch
versions. Each test that launches a kernel skips without a CUDA device:
a CUDA kernel has no CPU mode, and the CPU tests
(tests/test_torch_intersect.py) hold the plain versions against the JAX
package. The control of K9's TF32 limits needs only plain versions and
runs everywhere.

This file imports neither JAX nor the JAX package, so it also runs on a
machine without JAX; there, skip the JAX-pinning conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from rendering_tpu_torch.accel.bvh import build_bvh, morton_order
from rendering_tpu_torch.diff.inverse import apply_params, extract_params
from rendering_tpu_torch.flagship import (
    build_flagship_scene,
    build_multimesh_scene,
    build_tiny_scene,
    procedural_mesh,
)
from rendering_tpu_torch.ops import cuda_intersect as ci
from rendering_tpu_torch.ops import microbench as mb
from rendering_tpu_torch.ops import shadow_cases
from rendering_tpu_torch.render.pipeline import quantize_u8, render_scene


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    ro = rng.normal(0, 2, (3, n)).astype(np.float32)
    rd = np.asarray([[-0.1], [0.0], [-0.6]], np.float32) - ro
    rd[:, n // 2:] = rng.normal(0, 1, (3, n - n // 2))
    rd /= np.linalg.norm(rd, axis=0, keepdims=True)
    tl = rng.uniform(0.05, 5.0, n).astype(np.float32)
    tl[rng.uniform(size=n) < 0.1] = -1.0
    return [torch.from_numpy(a) for a in (ro, rd, tl)]


@pytest.mark.cuda
@pytest.mark.parametrize("anyhit", [False, True])
@pytest.mark.parametrize("bfc", [True, False])
def test_kernel_matches_plain(cuda, anyhit, bfc):
    """Triangle ids equal and t bit-equal, on a ragged ray count with
    limits and resolved lanes."""
    scene = build_flagship_scene(128, 64, n_tris=20_000, device=cuda)
    tb = scene.meshes[0].itables
    ro, rd, tl = (x.to(cuda) for x in _rays(8 * 512 + 77, seed=1))
    prep = ci.prepare(tb, ro, rd, tl)
    kernel = ci.any_hit_kernel if anyhit else ci.closest_hit_kernel
    before = kernel.launches
    tk, rk = kernel(tb, prep, backface_culling=bfc)
    tp, rp = ci.intersect_plain(tb, prep, anyhit=anyhit, backface_culling=bfc)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert int((rk >= 0).sum()) > 100
    assert torch.equal(rk, rp)
    assert torch.equal(tk.view(torch.int32), tp.view(torch.int32))


@pytest.mark.cuda
def test_render_on_card_matches_cpu(cuda):
    """The render through the kernels equals the CPU render of the same
    scene in u8 (within tests/test_golden.py's DEFAULT_TOL measures) and
    launches each kernel once per ray block."""
    scene = build_flagship_scene(128, 64, n_tris=20_000, device="cpu")
    cpu_u8 = quantize_u8(render_scene(scene)[0]).numpy()
    ci.closest_hit_kernel.launches = ci.any_hit_kernel.launches = 0
    gpu_u8 = quantize_u8(render_scene(scene.to(cuda))[0]).cpu().numpy()
    assert ci.closest_hit_kernel.launches == 1
    assert ci.any_hit_kernel.launches == 1
    d = np.abs(cpu_u8.astype(np.int16) - gpu_u8.astype(np.int16))[1:-1, 1:-1]
    assert (d > 1).mean() <= 0.006 and (d > 8).mean() <= 0.005


def _multimesh_rays(n, seed):
    """Rays from near the camera towards the 16-mesh grid, half of them
    in random directions, with limits and resolved lanes."""
    rng = np.random.default_rng(seed)
    ro = rng.normal(0, 0.3, (3, n)).astype(np.float32)
    aim = np.stack([rng.uniform(-2.5, 2.5, n), rng.uniform(-2.0, 2.0, n),
                    np.full(n, -3.4)]).astype(np.float32)
    rd = aim - ro
    rd[:, n // 2:] = rng.normal(0, 1, (3, n - n // 2))
    rd /= np.linalg.norm(rd, axis=0, keepdims=True)
    tl = rng.uniform(0.5, 8.0, n).astype(np.float32)
    tl[rng.uniform(size=n) < 0.1] = -1.0
    return [torch.from_numpy(a) for a in (ro, rd, tl)]


@pytest.mark.cuda
@pytest.mark.parametrize("anyhit", [False, True])
@pytest.mark.parametrize("bfc", [True, False])
def test_fused_kernel_matches_plain(cuda, anyhit, bfc):
    """K5 against its plain version over the 16-mesh scene's fused
    tables (pad cull chunks inside the table): mesh and column ids
    equal, t bit-equal (closest); occlusion and t equal (any)."""
    scene = build_multimesh_scene(96, 54, n_meshes=16, tris_per_mesh=2000,
                                  device=cuda)
    ft = scene.fused_itables
    ro, rd, tl = (x.to(cuda) for x in _multimesh_rays(8 * 512 + 77, seed=2))
    prep = ci.prepare(ft.geo, ro, rd, tl)
    if anyhit:
        kernel = ci.fused_any_hit_kernel
        before = kernel.launches
        out_k = kernel(ft.geo, prep, backface_culling=bfc)
    else:
        kernel = ci.fused_closest_hit_kernel
        before = kernel.launches
        out_k = kernel(ft.geo, prep, idmap=ft.idmap, backface_culling=bfc)
    out_p = ci.intersect_fused_plain(ft, prep, anyhit=anyhit,
                                     backface_culling=bfc)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert int((out_k[1] >= 0).sum()) > 100
    if not anyhit:
        assert len(torch.unique(out_k[1][out_k[1] >= 0])) >= 8  # many meshes
    for a, b in zip(out_k[1:], out_p[1:]):
        assert torch.equal(a, b)
    assert torch.equal(out_k[0].view(torch.int32), out_p[0].view(torch.int32))


@pytest.mark.cuda
def test_grads_on_card_match_cpu(cuda):
    """The train step's gradients through the fused path (K5 on the
    card, the plain version on the CPU) agree: each parameter's to 1e-3
    of its norm. The kernel and its plain version pick the same
    triangles, but the card's libm (pow, exp) rounds differently from the
    CPU's, and a shadow-ray origin an ulp apart can flip one pixel's
    visibility, so bit equality is not expected."""
    paths = (("lights", 0, "intensity"), ("obj_color",), ("meshes", 4, "v"),
             ("meshes", 5, "v"))
    cpu = build_multimesh_scene(96, 54, n_meshes=16, tris_per_mesh=500,
                                device="cpu")
    w = torch.from_numpy(((np.arange(3 * 54 * 96) % 7 + 1) / 7.0)
                         .astype(np.float32).reshape(3, 54, 96))
    grads = []
    for scene in (cpu, cpu.to(cuda)):
        params = extract_params(scene, paths)
        frame, _ = render_scene(apply_params(scene, params, paths))
        (frame * w.to(scene.device)).sum().backward()
        grads.append({k: v.grad.cpu() for k, v in params.items()})
    for k, g_cpu in grads[0].items():
        g_gpu = grads[1][k]
        assert torch.isfinite(g_gpu).all() and g_cpu.abs().sum() > 0, k
        assert float((g_gpu - g_cpu).norm()) <= 1e-3 * float(g_cpu.norm()), k


def _clipped(n_tris, pos, seed=0):
    """Morton-ordered vertices of a procedural mesh and its BVH reach
    boxes under a root box that clips it (0.7 of its extent)."""
    m = procedural_mesh(n_tris, pos=pos, size=(2, 2, 2), seed=seed)
    v = m.v[morton_order(m.v)]
    c = m.root_bounds.mean(axis=0)
    root = (c + (m.root_bounds - c) * np.float32(0.7)).astype(np.float32)
    bvh = build_bvh(v, root, ac_penalty=3)
    return v, (bvh.reach_lo, bvh.reach_hi)


@pytest.mark.cuda
@pytest.mark.parametrize("root_filter,collect_stats",
                         [(True, False), (False, True), (True, True)])
@pytest.mark.parametrize("anyhit", [False, True])
def test_rootfilter_stats_kernel_matches_plain(cuda, anyhit, root_filter,
                                               collect_stats):
    """K4 (root filter) and K3 (counters) against their plain versions
    on a clipped mesh: ids equal, t bit-equal, counters exactly equal."""
    v, reach = _clipped(20_000, pos=(-0.1, 0, -0.6))
    tb = ci.build_intersect_tables(v, tri_chunk=64, reach=reach).to(cuda)
    ro, rd, tl = (x.to(cuda) for x in _rays(8 * 512 + 77, seed=3))
    prep = ci.prepare(tb, ro, rd, tl)
    kernel = ci.KERNELS[ci.variant_name(
        anyhit=anyhit, fused=False, root_filter=root_filter,
        collect_stats=collect_stats)]
    before = kernel.launches
    out_k = ci.run_query(tb, prep, anyhit=anyhit, backface_culling=True,
                         root_filter=root_filter, collect_stats=collect_stats)
    out_p = ci.intersect_plain(tb, prep, anyhit=anyhit, backface_culling=True,
                               root_filter=root_filter,
                               collect_stats=collect_stats)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert len(out_k) == len(out_p) == (4 if collect_stats else 2)
    assert int((out_k[1] >= 0).sum()) > 100
    assert torch.equal(out_k[0].view(torch.int32), out_p[0].view(torch.int32))
    for a, b in zip(out_k[1:], out_p[1:]):
        assert torch.equal(a.cpu(), b.cpu())
    if collect_stats:
        assert int(out_k[2]) > 0 and int(out_k[3]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("anyhit", [False, True])
def test_fused_rootfilter_stats_kernel_matches_plain(cuda, anyhit):
    """K5 with the root filter and the counters over a clipped and an
    unclipped mesh against its plain version."""
    va, ra = _clipped(6000, pos=(-0.8, 0, -3.0), seed=1)
    vb = procedural_mesh(4000, pos=(0.9, 0.2, -3.5), size=(1.2, 1.2, 1.2),
                         seed=2).v
    vb = vb[morton_order(vb)]
    ft = ci.build_fused_tables([va, vb], [True, False],
                               reach=[ra, None]).to(cuda)
    assert ft.any_clipped
    ro, rd, tl = (x.to(cuda) for x in _multimesh_rays(8 * 512 + 77, seed=4))
    prep = ci.prepare(ft.geo, ro, rd, tl)
    name = ci.variant_name(anyhit=anyhit, fused=True, root_filter=True,
                           collect_stats=True)
    before = ci.KERNELS[name].launches
    out_k = ci.run_fused_query(ft, prep, anyhit=anyhit, backface_culling=True,
                               root_filter=True, collect_stats=True)
    out_p = ci.intersect_fused_plain(ft, prep, anyhit=anyhit,
                                     backface_culling=True, root_filter=True,
                                     collect_stats=True)
    torch.cuda.synchronize()
    assert ci.KERNELS[name].launches == before + 1
    assert int((out_k[1] >= 0).sum()) > 100
    assert torch.equal(out_k[0].view(torch.int32), out_p[0].view(torch.int32))
    for a, b in zip(out_k[1:], out_p[1:]):
        assert torch.equal(a.cpu(), b.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("root_filter,collect_stats",
                         [(False, False), (True, True)])
@pytest.mark.parametrize("kind", shadow_cases.KINDS)
def test_anyhit_walks_match_plain_on_adversarial_queries(
        cuda, kind, root_filter, collect_stats):
    """The any-hit walk against the plain version on the seeded
    adversarial shadow queries (interleaved
    pre-resolved lanes, rays leaving the mesh at the scene's bias, rays
    grazing cull-box faces) over a clipped mesh: t bit-equal, ids and
    counters equal."""
    v, reach = _clipped(20_000, pos=(-0.1, 0, -0.6))
    tb = ci.build_intersect_tables(v, tri_chunk=64, reach=reach).to(cuda)
    ro, rd, tl = (torch.from_numpy(x).to(cuda) for x in shadow_cases.shadow_case(
        tb, kind, 8 * 512 + 77, shadow_cases.SEEDS[kind]))
    prep = ci.prepare(tb, ro, rd, tl)
    flags = dict(anyhit=True, fused=False, root_filter=root_filter,
                 collect_stats=collect_stats)
    out_p = ci.intersect_plain(tb, prep, anyhit=True, backface_culling=True,
                               root_filter=root_filter,
                               collect_stats=collect_stats)
    assert int((out_p[1] >= 0).sum()) > 20
    out_k = ci.KERNELS[ci.variant_name(**flags)](tb, prep,
                                                 backface_culling=True)
    torch.cuda.synchronize()
    assert torch.equal(out_k[0].view(torch.int32), out_p[0].view(torch.int32))
    for a, b in zip(out_k[1:], out_p[1:]):
        assert torch.equal(a.cpu(), b.cpu())


def _closest_tables(fused):
    """A clipped mesh's tables with its reach rows, or fused tables of a
    clipped and an unclipped mesh (pad cull chunks inside the table)."""
    if not fused:
        v, reach = _clipped(20_000, pos=(-0.1, 0, -0.6))
        return ci.build_intersect_tables(v, tri_chunk=64, reach=reach)
    va, ra = _clipped(6000, pos=(-0.8, 0, -3.0), seed=1)
    vb = procedural_mesh(4000, pos=(0.9, 0.2, -3.5), size=(1.2, 1.2, 1.2),
                         seed=2).v
    vb = vb[morton_order(vb)]
    return ci.build_fused_tables([va, vb], [True, False], reach=[ra, None])


CLOSEST_WALKS = ci.CLUSTER_SIZES


def _closest_on_walk(name, walk, tables, prep):
    """Closest-hit variant `name` on the closest walk at `walk` CTAs per
    tile."""
    fused = isinstance(tables, ci.FusedTables)
    return ci.KERNELS[name](
        tables.geo if fused else tables, prep, backface_culling=True,
        idmap=tables.idmap if fused else None, cluster=walk)


@pytest.mark.cuda
@pytest.mark.parametrize("walk", CLOSEST_WALKS)
@pytest.mark.parametrize("fused,root_filter,collect_stats",
                         list(itertools.product((False, True), repeat=3)))
def test_closest_walk_matches_plain(cuda, fused, root_filter, collect_stats,
                                    walk):
    """Every closest-hit variant (fused, root filter, counters) on the
    closest walk at each cluster size against its plain version, on a
    ragged tile count with limits and resolved lanes: t bit-equal, ids
    and counters equal; one launch counted."""
    tables = _closest_tables(fused).to(cuda)
    geo = tables.geo if fused else tables
    make = _multimesh_rays if fused else _rays
    ro, rd, tl = (x.to(cuda) for x in make(8 * 512 + 77, seed=7))
    prep = ci.prepare(geo, ro, rd, tl)
    name = ci.variant_name(anyhit=False, fused=fused, root_filter=root_filter,
                           collect_stats=collect_stats)
    plain = ci.intersect_fused_plain if fused else ci.intersect_plain
    out_p = plain(tables, prep, anyhit=False, backface_culling=True,
                  root_filter=root_filter, collect_stats=collect_stats)
    counts = {k: v.launches for k, v in ci.KERNELS.items()}
    out_k = _closest_on_walk(name, walk, tables, prep)
    torch.cuda.synchronize()
    launched = {k for k, v in ci.KERNELS.items() if v.launches != counts[k]}
    assert launched == {name}
    assert int((out_k[1] >= 0).sum()) > 100
    assert torch.equal(out_k[0].view(torch.int32), out_p[0].view(torch.int32))
    for a, b in zip(out_k[1:], out_p[1:]):
        assert torch.equal(a.cpu(), b.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("walk", CLOSEST_WALKS)
@pytest.mark.parametrize("kind", shadow_cases.CLOSEST_KINDS)
def test_closest_walk_matches_plain_on_closest_cases(cuda, kind, walk):
    """The closest walk at each cluster size against the plain version,
    counters on, on the seeded closest cases (rays whose own cull fails while the tile is
    live, cull-box face planes, pre-resolved and padded lanes, duplicated
    triangles) at a ragged width."""
    m = procedural_mesh(20_000, pos=(-0.1, 0, -0.6), size=(2, 2, 2))
    v = m.v[morton_order(m.v)]
    if kind == "duplicates":
        v = shadow_cases.duplicated(v)
    tb = ci.build_intersect_tables(v, tri_chunk=64).to(cuda)
    ro, rd, tl = (torch.from_numpy(x).to(cuda) for x in shadow_cases.closest_case(
        tb, kind, 8 * 512 + 77, shadow_cases.CLOSEST_SEEDS[kind]))
    prep = ci.prepare(tb, ro, rd, tl)
    out_p = ci.intersect_plain(tb, prep, anyhit=False, backface_culling=True,
                               collect_stats=True)
    out_k = _closest_on_walk("closest_hit_stats", walk, tb, prep)
    torch.cuda.synchronize()
    assert int((out_p[1] >= 0).sum()) > 100
    assert torch.equal(out_k[0].view(torch.int32), out_p[0].view(torch.int32))
    for a, b in zip(out_k[1:], out_p[1:]):
        assert torch.equal(a.cpu(), b.cpu())
    if kind == "duplicates":
        assert bool((out_k[1][out_k[1] >= 0] % 8 < 4).all())


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", ci.CLUSTER_SIZES[1:])
@pytest.mark.parametrize("split_factor", [0, 1, 10**6])
def test_closest_walk_split_and_whole_tiles_match_plain(cuda, split_factor,
                                                        cluster):
    """The closest walk with every tile split (factor 0), the ones at or
    above the mean (1: 8 of the 9 tiles here, so split and whole tiles
    in one launch), and none (a factor no tile reaches), root filter and
    counters on, against the plain version: t bit-equal, ids and
    counters equal."""
    import dataclasses

    tb = _closest_tables(False).to(cuda)
    ro, rd, tl = (torch.from_numpy(x).to(cuda) for x in shadow_cases.closest_case(
        tb, "union_live", 8 * 512 + 77, shadow_cases.CLOSEST_SEEDS["union_live"]))
    prep = ci.prepare(tb, ro, rd, tl)
    prep = dataclasses.replace(
        prep, n_split=ci.tile_schedule(prep.counts, split_factor)[1])
    n_split = int(prep.n_split)
    n_live = int((prep.counts > 0).sum())
    assert n_split == {0: n_live, 1: 8, 10**6: 0}[split_factor]
    assert n_live == 9
    out_p = ci.intersect_plain(tb, prep, anyhit=False, backface_culling=True,
                               root_filter=True, collect_stats=True)
    out_k = ci.KERNELS["closest_hit_rootfilter_stats"](
        tb, prep, backface_culling=True, cluster=cluster)
    torch.cuda.synchronize()
    assert int((out_p[1] >= 0).sum()) > 100
    assert torch.equal(out_k[0].view(torch.int32), out_p[0].view(torch.int32))
    for a, b in zip(out_k[1:], out_p[1:]):
        assert torch.equal(a.cpu(), b.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("name", [n for n in ci.KERNELS if n != "prepass"])
def test_walk_resources_fit_the_card(cuda, name):
    """Every walk variant's resources: at least one resident CTA of 512
    threads an SM, the card's SM count, and for a closest hit at least
    one resident cluster at each cluster size (none for an any hit)."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for g in ci.CLUSTER_SIZES:
        res = ci.resources(name, cluster=g)
        assert res["ctas_per_sm"] >= 1 and res["sms"] == sms
        assert res["registers"] >= 1 and res["local_bytes"] >= 0
        assert (res["clusters"] >= 1) == (not ci.KERNELS[name].anyhit)


@pytest.mark.cuda
def test_closest_walk_refuses_unsupported_cluster(cuda):
    """A cluster size the kernel does not take raises before a launch."""
    scene = build_flagship_scene(128, 64, n_tris=20_000, device=cuda)
    tb = scene.meshes[0].itables
    ro, rd, tl = (x.to(cuda) for x in _rays(2 * 512, seed=9))
    prep = ci.prepare(tb, ro, rd, tl)
    before = ci.closest_hit_kernel.launches
    for g in (0, 3, 16):
        with pytest.raises(ValueError, match="cluster"):
            ci.closest_hit_kernel(tb, prep, backface_culling=True, cluster=g)
    assert ci.closest_hit_kernel.launches == before


@pytest.mark.cuda
def test_scene_file_on_card_matches_cpu(cuda, tmp_path, monkeypatch, capsys):
    """The CLI on a scene file with a rotated (clipped) OBJ, SSAA on and
    collectStatistics=1: the card's BMP equals the CPU's within
    tests/test_golden.py's DEFAULT_TOL measures, the printed statistics
    are equal, and the root-filter counting kernels carried the render."""
    from rendering_tpu_torch import cli
    from rendering_tpu_torch.models.objloader import write_obj
    from rendering_tpu_torch.utils.bmp import bmp_to_image, load_bmp

    m = procedural_mesh(3000, pos=(0, 0, 0), size=(2, 2, 2))
    write_obj(str(tmp_path / "m.obj"), m.v, m.uv, m.n)
    (tmp_path / "s.scene").write_text(
        "[options]\nwidth=96\nheight=54\nac_penalty=3\n"
        "background_color=0.52,0.8,0.92\nenableOutput=0\n"
        "outputProgress=0\ncollectStatistics=1\n\n"
        "[light]\ntype=point\nposition=0,0,0\ncolor=1,1,1\nintensity=1.0\n\n"
        "[object]\ntype=mesh\npos=-0.1,0,-0.6\nsize=2,2,2\ncolor=1,1,1\n"
        "rot=0,100,0\nmaterial=phong,0.4,0.1,0.7,10.0\nname=m.obj\n\n[end]\n")
    monkeypatch.chdir(tmp_path)
    frames, printed = [], []
    for dev in ("cpu", cuda):
        for k in ci.KERNELS.values():
            k.launches = 0
        cli.main(["s.scene", "--output", f"{dev}.bmp"], device=dev)
        printed.append(capsys.readouterr().out)
        frames.append(bmp_to_image(load_bmp(f"{dev}.bmp")))
    assert ci.KERNELS["closest_hit_rootfilter_stats"].launches == 2
    assert ci.KERNELS["any_hit_rootfilter_stats"].launches == 2
    assert printed[0] == printed[1] and "Ray triangle tests" in printed[0]
    d = np.abs(frames[0].astype(np.int16) - frames[1].astype(np.int16))
    d = d[1:-1, 1:-1]
    assert (d > 1).mean() <= 0.006 and (d > 8).mean() <= 0.005


@pytest.mark.cuda
@pytest.mark.parametrize("root_filter,collect_stats",
                         [(False, False), (True, True)])
@pytest.mark.parametrize("frac", [0.25, 0.5])
def test_two_phase_kernel_matches_plain(cuda, frac, root_filter,
                                        collect_stats):
    """K6 (two launches of the two-phase any-hit variant, the
    compaction between them in torch) against its plain version on the
    CPU: occlusion equal, counters equal, and the same occlusion as the
    single-pass query."""
    v, reach = _clipped(20_000, pos=(-0.1, 0, -0.6))
    tb = ci.build_intersect_tables(v, tri_chunk=64, reach=reach)
    ro, rd, tl = _rays(8 * 512 + 77, seed=5)
    kw = dict(frac=frac, backface_culling=True, root_filter=root_filter,
              collect_stats=collect_stats)
    name = ci.variant_name(anyhit=True, fused=False, root_filter=root_filter,
                           collect_stats=collect_stats, two_phase=True)
    before = ci.KERNELS[name].launches
    out_k = ci.any_hit_two_phase(tb.to(cuda), *(x.to(cuda) for x in
                                                (ro, rd, tl)), **kw)
    out_p = ci.any_hit_two_phase(tb, ro, rd, tl, **kw)
    torch.cuda.synchronize()
    assert ci.KERNELS[name].launches == before + 2
    out_k = out_k if collect_stats else (out_k,)
    out_p = out_p if collect_stats else (out_p,)
    for a, b in zip(out_k, out_p):
        assert torch.equal(a.cpu(), b)
    assert 100 < int(out_p[0].sum()) < len(out_p[0]) - 100
    single = ci.any_hit(tb, ro, rd, tl, backface_culling=True,
                        root_filter=root_filter)
    assert torch.equal(out_p[0], single)


@pytest.mark.cuda
@pytest.mark.parametrize("frac", [0.0, 0.5])
def test_bouncing_render_on_card_matches_cpu(cuda, frac):
    """The tiny scene (all four materials, max_ray_depth 4, SSAA on) on
    the card against the CPU: u8 frames within tests/test_golden.py's
    DEFAULT_TOL measures, rays_casted equal, no path dropped; the shadow
    rays of its mesh go through K6 at frac > 0."""
    overrides = dict(enable_ssaa=True, anyhit_compact_frac=frac)
    scene = build_tiny_scene(96, 54, n_tris=6000, device="cpu",
                             settings_overrides=overrides)
    cpu_u8, cpu_aux = render_scene(scene, out_u8=True)
    for k in ci.KERNELS.values():
        k.launches = 0
    gpu_u8, gpu_aux = render_scene(scene.to(cuda), out_u8=True)
    two_phase = ci.KERNELS["any_hit_two_phase"].launches
    assert (two_phase > 0) == (frac > 0)
    assert ci.KERNELS["closest_hit"].launches > 0
    assert cpu_aux["stats"]["rays_casted"] == gpu_aux["stats"]["rays_casted"]
    assert int(gpu_aux["stats"]["paths_dropped"]) == 0
    d = np.abs(cpu_u8.numpy().astype(np.int16)
               - gpu_u8.cpu().numpy().astype(np.int16))[1:-1, 1:-1]
    assert (d > 1).mean() <= 0.006 and (d > 8).mean() <= 0.005


def _bits_equal(a, b):
    """f32 tensors equal bit for bit, NaN in the same places."""
    a, b = a.cpu(), b.cpu()
    nan = torch.isnan(a)
    return (torch.equal(nan, torch.isnan(b))
            and torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32)))


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["fused", "unfused", "triton"])
def test_fma_chain_kernel_matches_plain(cuda, route):
    """K7 (both variants) and its Triton twin against the plain version,
    bit for bit, on a ragged element count whose chains overflow (inf,
    NaN), with the block repeated 3 times."""
    x = torch.from_numpy(np.random.default_rng(0).normal(
        0, 2, (7, 300)).astype(np.float32))
    kw = dict(inner=200, grid=3, n_chains=5)
    name = f"fma_chain_{route}"
    before = mb.KERNELS[name].launches
    if route == "triton":
        out = mb.fma_chain_triton(x.to(cuda), **kw)
    else:
        out = mb.fma_chain(x.to(cuda), fused=route == "fused", **kw)
    torch.cuda.synchronize()
    assert mb.KERNELS[name].launches == before + 1
    want = mb.fma_chain_plain(x, inner=200, n_chains=5,
                              fused=route != "unfused")
    assert not bool(torch.isfinite(want).all())
    assert _bits_equal(out, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n_steps", [1, 4096])
def test_grid_overhead_kernel_copies(cuda, n_steps):
    x = torch.randn((8, 1024), device=cuda)
    before = mb.KERNELS["grid_overhead"].launches
    out = mb.grid_overhead(x, n_steps)
    torch.cuda.synchronize()
    assert mb.KERNELS["grid_overhead"].launches == before + 1
    assert torch.equal(out, x)


@pytest.mark.cuda
@pytest.mark.parametrize("n_steps", [1, 4096, 16384])
def test_grid_overhead_loop_kernel_copies(cuda, n_steps):
    """K8's loop form: one CTA per SM takes the steps in turn; the block
    is copied at every step count."""
    x = torch.randn((8, 1024), device=cuda)
    before = mb.KERNELS["grid_overhead_loop"].launches
    out = mb.grid_overhead_loop(x, n_steps)
    torch.cuda.synchronize()
    assert mb.KERNELS["grid_overhead_loop"].launches == before + 1
    assert torch.equal(out, x)


@pytest.mark.cuda
@pytest.mark.parametrize("tc,k", [(32, 13), (256, 13), (512, 128), (64, 1)])
def test_pack_tables_kernel_matches_plain(cuda, tc, k):
    coef = torch.from_numpy(np.random.default_rng(tc + k).normal(
        size=(mb.N_TAB, 4 * tc, k)).astype(np.float32)).to(cuda)
    before = mb.KERNELS["pair_pack_tf32"].launches
    out = mb.pack_tables(coef, tc)
    torch.cuda.synchronize()
    assert mb.KERNELS["pair_pack_tf32"].launches == before + 1
    assert torch.equal(out.view(torch.int32),
                       mb.pack_tables_plain(coef, tc).view(torch.int32))


def _tf32_within(out, want, feats, coef, epilogue) -> bool:
    """`out` within `mb.tf32_disagreement`'s limit of `want` (70 steps)."""
    reading, limit = mb.tf32_disagreement(out, want, feats, coef,
                                          n_steps=70, epilogue=epilogue)
    return reading <= limit


def _pair_inputs(k, epilogue, tc=32, br=256):
    rng = np.random.default_rng(k)
    coef = torch.from_numpy(rng.normal(size=(mb.N_TAB, 4 * tc, k))
                            .astype(np.float32))
    feats = torch.from_numpy(rng.normal(size=(k, br)).astype(np.float32))
    o_init = torch.full((1, br), mb.T_NONE if epilogue else 0.0)
    return feats, coef, o_init


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("epilogue", [False, True])
@pytest.mark.parametrize("k", [13, 40])
def test_pair_product_kernel_matches_plain(cuda, precision, epilogue, k):
    """K9 against its plain version over 70 steps of 64 seeded normal
    tables: bit-equal at highest; at default within the TF32 limits, which
    the f32 kernel (highest) on the same inputs must fail."""
    tc, br, n_steps = 32, 256, 70
    feats, coef, o_init = _pair_inputs(k, epilogue, tc, br)
    kw = dict(tc=tc, n_steps=n_steps, precision=precision, epilogue=epilogue)
    name = mb.pair_name(precision, epilogue)
    before = mb.KERNELS[name].launches
    out = mb.pair_product(feats.to(cuda), coef.to(cuda), o_init.to(cuda),
                          **kw).cpu()
    assert mb.KERNELS[name].launches == before + 1
    want = mb.pair_product_plain(feats, coef, o_init, **kw)
    if precision == "highest":
        assert _bits_equal(out, want)
    else:
        assert _tf32_within(out, want, feats, coef, epilogue)
        f32 = mb.pair_product(feats.to(cuda), coef.to(cuda), o_init.to(cuda),
                              **dict(kw, precision="highest")).cpu()
        assert not _tf32_within(f32, want, feats, coef, epilogue)
    if epilogue:
        assert int((want < mb.T_NONE).sum()) > br // 2


@pytest.mark.parametrize("epilogue", [False, True])
@pytest.mark.parametrize("k", [13, 40])
def test_tf32_limits_reject_f32_and_truncation(epilogue, k, monkeypatch):
    """K9's TF32 limits (mb.tf32_disagreement) tell a TF32 product from two
    wrong ones: the f32 product and the product of inputs truncated to
    TF32 fail; the same TF32 inputs summed in another order (each sum
    exact in float64, rounded once) pass. Plain versions only, so it runs
    without a card."""
    feats, coef, o_init = _pair_inputs(k, epilogue)
    kw = dict(tc=32, n_steps=70, epilogue=epilogue)
    want = mb.pair_product_plain(feats, coef, o_init, precision="default",
                                 **kw)
    f32 = mb.pair_product_plain(feats, coef, o_init, precision="highest",
                                **kw)
    truncated = mb.pair_product_plain(mb.truncate_tf32(feats),
                                      mb.truncate_tf32(coef), o_init,
                                      precision="highest", **kw)
    assert not _tf32_within(f32, want, feats, coef, epilogue)
    assert not _tf32_within(truncated, want, feats, coef, epilogue)
    monkeypatch.setattr(mb, "_products", lambda c, f: torch.einsum(
        "nmk,kb->nmb", c.double(), f.double()).float())
    reordered = mb.pair_product_plain(feats, coef, o_init,
                                      precision="default", **kw)
    assert not torch.equal(reordered, want)
    assert _tf32_within(reordered, want, feats, coef, epilogue)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "default"])
def test_pair_product_kernel_rejects_unsupported_tc(cuda, precision):
    """A tc that is no multiple of the kernel's row group raises on the
    card (no fall-back to the plain version) and launches nothing."""
    tc, br, k = 12, 128, 13
    coef = torch.ones((mb.N_TAB, 4 * tc, k), device=cuda)
    feats = torch.ones((k, br), device=cuda)
    o_init = torch.zeros((1, br), device=cuda)
    before = {n: v.launches for n, v in mb.KERNELS.items()}
    with pytest.raises(ValueError, match="multiple"):
        mb.pair_product(feats, coef, o_init, tc=tc, n_steps=4,
                        precision=precision)
    assert before == {n: v.launches for n, v in mb.KERNELS.items()}


# (tc, br) of the tool's configurations with the fewest rows, the fewest
# columns and the most rows.
TOOL_SHAPES = [(128, 1024), (256, 512), (512, 1024)]
# The TF32 flips limit (TF32_MAX_FLIPS) was set from k = 13 readings; at
# k = 128 with the epilogue the tensor cores' own accumulation moves more
# column minima past rtol 1e-3 (in K9's first form too, before its
# second existed), so that combination has a test of its own below.
PAIR_CASES = [
    (precision, epilogue, k, tc, br)
    for precision in ("highest", "default")
    for epilogue in (False, True) for k in (13, 128) for tc, br in TOOL_SHAPES
    if not (precision == "default" and epilogue and k == 128)]


def _seeded_pair(cuda, tc, br, k, epilogue):
    gen = torch.Generator(device=cuda).manual_seed(tc + br + k)
    coef = torch.randn((mb.N_TAB, 4 * tc, k), generator=gen, device=cuda)
    feats = torch.randn((k, br), generator=gen, device=cuda)
    o_init = torch.full((1, br), mb.T_NONE if epilogue else 0.0, device=cuda)
    return feats, coef, o_init


@pytest.mark.cuda
@pytest.mark.parametrize("precision,epilogue,k,tc,br", PAIR_CASES)
def test_pair_product_forms_match_plain_at_tool_shapes(cuda, precision,
                                                       epilogue, k, tc, br):
    """K9 at three (tc, br) of the tool's configurations, k
    13 and 128, over 70 steps of 64 seeded normal tables, against the
    plain version on the card: bit-equal at highest, within the TF32
    limits at default."""
    feats, coef, o_init = _seeded_pair(cuda, tc, br, k, epilogue)
    kw = dict(tc=tc, n_steps=70, precision=precision, epilogue=epilogue)
    name = mb.pair_name(precision, epilogue)
    before = mb.KERNELS[name].launches
    out = mb.pair_product(feats, coef, o_init, **kw)
    torch.cuda.synchronize()
    assert mb.KERNELS[name].launches == before + 1
    want = mb.pair_product_plain(feats, coef, o_init, **kw)
    if precision == "highest":
        assert _bits_equal(out, want)
    else:
        assert _tf32_within(out, want, feats, coef, epilogue)


@pytest.mark.cuda
@pytest.mark.parametrize("tc,br", TOOL_SHAPES)
def test_tf32_epilogue_at_k128_readings(cuda, tc, br, capsys):
    """K9 at TF32 with the epilogue at k = 128: it runs and agrees with the
    plain version on the accepted columns (finite minima, no column
    accepted by one and not the other), and the TF32 limit still holds
    for an exactly summed TF32 product and rejects the f32 product. The
    flip share is printed, not held to TF32_MAX_FLIPS: the tensor cores'
    accumulation over 128 terms exceeds it (PERF.md, section 6)."""
    feats, coef, o_init = _seeded_pair(cuda, tc, br, 128, True)
    kw = dict(tc=tc, n_steps=70, precision="default", epilogue=True)
    want = mb.pair_product_plain(feats, coef, o_init, **kw)
    how = dict(n_steps=70, epilogue=True)
    out = mb.pair_product(feats, coef, o_init, **kw)
    assert torch.equal(out < mb.T_NONE, want < mb.T_NONE)
    reading = mb.tf32_disagreement(out, want, feats, coef, **how)[0]
    real = mb._products
    try:
        mb._products = lambda c, f: torch.einsum(
            "nmk,kb->nmb", c.double(), f.double()).float()
        exact = mb.pair_product_plain(feats, coef, o_init, **kw)
    finally:
        mb._products = real
    assert _tf32_within(exact, want, feats, coef, True)
    f32 = mb.pair_product_plain(feats, coef, o_init,
                                **dict(kw, precision="highest"))
    assert not _tf32_within(f32, want, feats, coef, True)
    with capsys.disabled():
        print(f"\nK9 TF32 epilogue k=128 tc={tc} br={br}: flip share "
              f"{reading:.4f}, limit {mb.TF32_MAX_FLIPS}")


@pytest.mark.cuda
def test_pair_product_forms_reject_what_their_kernels_refuse(cuda):
    """K9 raises on a tc or br its tiles do not take, on the card, and
    launches nothing."""
    k = 13
    before = {n: v.launches for n, v in mb.KERNELS.items()}
    for precision, tc, br in (("highest", 16, 128), ("default", 32, 128)):
        coef = torch.ones((mb.N_TAB, 4 * tc, k), device=cuda)
        feats = torch.ones((k, br), device=cuda)
        o_init = torch.zeros((1, br), device=cuda)
        with pytest.raises(ValueError, match="multiple"):
            mb.pair_product(feats, coef, o_init, tc=tc, n_steps=4,
                            precision=precision)
    with pytest.raises(ValueError, match="multiple"):
        mb.pack_tables(torch.ones((2, 4 * 16, k), device=cuda), 16)
    assert before == {n: v.launches for n, v in mb.KERNELS.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("use_ac", [True, False])
def test_ac_walk_kernel_matches_plain(cuda, use_ac):
    """The showAC walk's kernel (csrc/bvh_walk.cu) against its plain
    version on a rotated 20k mesh's BVH: seeded rays from outside and
    inside the mesh, axis-parallel ones among them, a ragged count;
    counts equal, one launch."""
    from rendering_tpu_torch.ops import traversal

    scene = build_flagship_scene(64, 32, n_tris=20_000, device=cuda)
    m = scene.meshes[0]
    rng = np.random.default_rng(3)
    n = 3 * 4096 + 77
    ro = rng.normal(0, 1.5, (n, 3)).astype(np.float32)
    rd = rng.normal(0, 1, (n, 3)).astype(np.float32)
    rd[: n // 8, rng.integers(0, 3, n // 8)] = 0.0
    ro, rd = (torch.from_numpy(a).to(cuda) for a in (ro, rd))
    before = traversal.KERNELS["ac_walk"].launches
    got = traversal.count_ac_nodes(m, ro, rd, use_ac=use_ac)
    want, tests = traversal.count_ac_nodes_plain(
        m.node_min, m.node_max, m.skip, m.real_flag, ro, rd, use_ac=use_ac)
    torch.cuda.synchronize()
    assert traversal.KERNELS["ac_walk"].launches == before + 1
    assert torch.equal(got, want)
    assert int(want.max()) > 1 and (int(tests) > n) == use_ac


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    dict(), dict(limit=True), dict(limit=True, use_ac=False),
    dict(limit=True, prune=False), dict(backface_culling=False)],
    ids=["closest", "t_limit", "no_ac", "no_prune", "no_culling"])
def test_bvh_closest_kernel_matches_plain(cuda, case):
    """The closest-hit walk's kernel (csrc/bvh_walk.cu `bvh_closest`)
    against its plain version on a rotated 20k mesh's BVH: seeded rays
    from outside and inside the mesh, axis-parallel ones among them,
    limits with resolved (-1) lanes, a ragged count; ids, t, u, v
    bit-equal and both counters equal, one launch."""
    from rendering_tpu_torch.ops import traversal

    scene = build_flagship_scene(64, 32, n_tris=20_000, device=cuda)
    m = scene.meshes[0]
    rng = np.random.default_rng(4)
    n = 3 * 4096 + 77
    ro = rng.normal(0, 1.5, (n, 3)).astype(np.float32)
    rd = rng.normal(0, 1, (n, 3)).astype(np.float32)
    rd[: n // 8, rng.integers(0, 3, n // 8)] = 0.0
    tl = rng.uniform(0.05, 4.0, n).astype(np.float32)
    tl[rng.uniform(size=n) < 0.1] = -1.0
    ro, rd, tl = (torch.from_numpy(a).to(cuda) for a in (ro, rd, tl))
    kw = dict(case)
    if not kw.pop("limit", False):
        tl = None
    before = traversal.KERNELS["bvh_closest"].launches
    got = traversal.traverse_bvh(m, ro, rd, tl, **kw)
    want = traversal.traverse_bvh_plain(m, ro, rd, tl, **kw)
    torch.cuda.synchronize()
    assert traversal.KERNELS["bvh_closest"].launches == before + 1
    assert torch.equal(got.tri, want.tri)
    assert int((want.tri >= 0).sum()) > n // 20
    for a, b in ((got.t, want.t), (got.u, want.u), (got.v, want.v)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert int(got.box_tests) == int(want.box_tests)
    assert int(got.tri_tests) == int(want.tri_tests) > n


@pytest.mark.cuda
def test_walk_render_on_card_matches_plain(cuda, monkeypatch):
    """With use_pallas_intersect off, the flagship's 20k mesh (above the
    dense threshold) renders through the walk's kernel, one launch per
    ray block and query, and no tile-walk kernel: u8-equal, counters
    equal, to the card's render through the plain walk, and within
    tests/test_golden.py's DEFAULT_TOL measures of the CPU render (torch
    on the card and on the CPU round the rays and shading apart by an
    ulp here and there)."""
    from rendering_tpu_torch.ops import traversal
    from rendering_tpu_torch.render import integrator

    scene = build_flagship_scene(
        128, 64, n_tris=20_000, device="cpu",
        settings_overrides=dict(use_pallas_intersect=False))
    before = {k: v.launches for k, v in ci.KERNELS.items()}
    walks = traversal.KERNELS["bvh_closest"].launches
    with torch.no_grad():
        frame, aux = render_scene(scene.to(cuda))
        torch.cuda.synchronize()
        assert traversal.KERNELS["bvh_closest"].launches == walks + 2
        assert {k: v.launches for k, v in ci.KERNELS.items()} == before
        cpu_u8 = quantize_u8(render_scene(scene)[0]).numpy()
        monkeypatch.setattr(
            integrator, "traverse_bvh",
            lambda m, ro, rd, tl=None, **kw: traversal.traverse_bvh_plain(
                m, ro, rd, tl, **kw))
        plain, plain_aux = render_scene(scene.to(cuda))
    u8 = quantize_u8(frame).cpu().numpy()
    np.testing.assert_array_equal(u8, quantize_u8(plain).cpu().numpy())
    for k in ("accel_struct_tests", "ray_tri_tests"):
        assert int(aux["stats"][k]) == int(plain_aux["stats"][k]) > 0
    d = np.abs(cpu_u8.astype(np.int16) - u8.astype(np.int16))[1:-1, 1:-1]
    assert (d > 1).mean() <= 0.006 and (d > 8).mean() <= 0.005


@pytest.mark.cuda
def test_progress_render_on_card_matches_render(cuda):
    """A 384x216 progress render of the flagship scene with SSAA through
    the kernels: within JAX's strip tolerance of render() on the card,
    with the primary strips' closest- and any-hit launches, one a ray
    block of each strip."""
    from rendering_tpu_torch.render.pipeline import (
        render,
        render_with_progress,
    )

    scene = build_flagship_scene(384, 216, n_tris=20_000, enable_ssaa=True,
                                 device=cuda)
    ref, _ = render(scene)
    for k in ci.KERNELS.values():
        k.launches = 0
    frame, aux = render_with_progress(scene, strip_rows=64,
                                      _print=lambda s: None)
    torch.cuda.synchronize()
    strips = 4  # rows 64, 64, 64, 24: one ray block each
    ssaa = -(-4 * int(384 * 216 * 0.25) // (1 << 17))
    assert ci.KERNELS["closest_hit"].launches == strips + ssaa
    assert ci.KERNELS["any_hit"].launches == strips + ssaa
    np.testing.assert_allclose(frame, ref, atol=2e-6, rtol=3e-4)
    assert aux["ssaa_masked"] > 0


# ---- the pre-pass kernel ---------------------------------------------------


@pytest.fixture(scope="module")
def flagship():
    """The flagship scene at 128x64 with its 250k-triangle mesh on the
    card (Cs = 489), built once for this file's pre-pass tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return build_flagship_scene(128, 64, n_tris=250_000, device="cuda")


def _plain_tables(aux, sbox, dist2=None):
    """tile_tables, the plain pre-pass, on prepared rows aux (on the
    card: PyTorch's kernels); dist2 is the kernel's argument, unused."""
    rows = aux.reshape(10, -1, ci.RAY_TILE).transpose(0, 1)
    return ci.tile_tables(rows[:, 0:3], rows[:, 6:9], rows[:, 9], sbox)


def _check_prepass(tb, prep):
    """The visit tables `prepare` made on the card (the kernel's) equal
    tile_tables' bit for bit; so do two more launches of the kernel on
    the same inputs. Returns the live counts."""
    torder, counts = _plain_tables(prep.aux, tb.sbox)
    torch.cuda.synchronize()
    assert prep.torder.dtype == prep.counts.dtype == torch.int32
    assert torch.equal(prep.torder, torder)
    assert torch.equal(prep.counts, counts)
    rows = prep.aux.reshape(10, prep.n_tiles, ci.RAY_TILE).transpose(0, 1)
    dist2 = ci.super_dist2(rows[:, 0:3], rows[:, 9], tb.sbox).contiguous()
    for _ in range(2):
        out = ci.KERNELS["prepass"](prep.aux, tb.sbox, dist2)
        assert torch.equal(out[0], torder)
        assert torch.equal(out[1], counts)
    return counts


@pytest.mark.cuda
def test_prepass_kernel_matches_plain_on_flagship_render(cuda, flagship,
                                                         monkeypatch):
    """Every pre-pass of a flagship render (the 250k mesh: its primary
    rays and its batched shadow rays) on the kernel equals the plain
    tile_tables on the same card inputs, and each `prepare` launched the
    kernel once."""
    tb = flagship.meshes[0].itables
    seen = []
    real = ci.prepare

    def record(tables, ro3, rd3, t_limit=None):
        prep = real(tables, ro3, rd3, t_limit)
        seen.append((tables, prep))
        return prep

    monkeypatch.setattr(ci, "prepare", record)
    before = ci.KERNELS["prepass"].launches
    with torch.no_grad():
        render_scene(flagship)
    torch.cuda.synchronize()
    assert len(seen) >= 2
    assert ci.KERNELS["prepass"].launches == before + len(seen)
    for tables, prep in seen:
        assert tables.sbox.shape[0] == tb.sbox.shape[0] == 489
        assert int(_check_prepass(tables, prep).sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("with_limit", [False, True])
def test_prepass_kernel_matches_plain_with_and_without_limits(cuda, flagship,
                                                              with_limit):
    """Rays at and around the flagship mesh on a ragged tile count, with
    and without t_limit (resolved lanes among the limits)."""
    tb = flagship.meshes[0].itables
    ro, rd, tl = (x.to(cuda) for x in _rays(12 * 512 + 77, seed=21))
    prep = ci.prepare(tb, ro, rd, tl if with_limit else None)
    counts = _check_prepass(tb, prep)
    assert 0 < int(counts.sum()) < prep.n_tiles * tb.sbox.shape[0]


@pytest.mark.cuda
def test_prepass_kernel_matches_plain_on_edge_rays(cuda, flagship):
    """A ragged last tile, resolved lanes (t0 < 0) and a wholly resolved
    tile, NaN limits, rays with zero direction components starting on
    super box planes (NaN slabs, kept live), and pad boxes (lo.x > hi.x,
    never live)."""
    tb = flagship.meshes[0].itables
    sbox = tb.sbox.cpu().numpy()
    pads = np.arange(5, sbox.shape[0], 40)
    padded = sbox.copy()
    padded[pads, 0] = padded[pads, 3] + 1.0
    tbp = dataclasses.replace(tb, sbox=torch.from_numpy(padded).to(cuda))
    n = 6 * 512 + 77
    ro, rd, tl = (x.numpy() for x in _rays(n, seed=22))
    k = np.arange(512) % sbox.shape[0]
    axis = np.arange(512) % 3
    ro_nan = ((sbox[k, 0:3] + sbox[k, 3:6]) * 0.5).T.copy()
    rd_nan = np.zeros((3, 512), np.float32)
    for c in range(3):
        m = axis == c
        ro_nan[c, m] = sbox[k[m], c]
        rd_nan[(c + 1) % 3, m] = 1.0
    ro[:, 512:1024], rd[:, 512:1024], tl[512:1024] = ro_nan, rd_nan, 10.0
    tl[1024:1536] = -1.0
    tl[1536:1540] = np.nan
    with np.errstate(divide="ignore", invalid="ignore"):
        assert np.isnan((sbox[k, 0] - ro_nan[0]) / rd_nan[0]).any()
    ro, rd, tl = (torch.from_numpy(x).to(cuda) for x in (ro, rd, tl))
    for tables in (tb, tbp):
        prep = ci.prepare(tables, ro, rd, tl)
        counts = _check_prepass(tables, prep).cpu()
        assert int(counts[2]) == 0
        assert torch.equal(prep.torder[2].cpu(),
                           torch.arange(tb.sbox.shape[0], dtype=torch.int32))
        assert int(counts[1]) == tb.sbox.shape[0] - (
            len(pads) if tables is tbp else 0)
    live = torch.zeros(tb.sbox.shape[0], dtype=torch.bool)
    for i in range(prep.n_tiles):
        live[prep.torder[i, :int(counts[i])].long().cpu()] = True
    assert not live[torch.from_numpy(pads)].any()


@pytest.mark.cuda
def test_prepass_kernel_matches_plain_on_other_super_counts(cuda, flagship):
    """Other Cs values through the same kernel: the 16-mesh scene's fused
    tables, `slice_supers` ranges of the flagship tables (K6's halves,
    a short range, a single super), and synthetic box sets above 512
    supers and above 48 KiB of sort keys."""
    scene = build_multimesh_scene(96, 54, n_meshes=16, tris_per_mesh=2000,
                                  device=cuda)
    geo = scene.fused_itables.geo
    ro, rd, tl = (x.to(cuda) for x in _multimesh_rays(8 * 512 + 77, seed=23))
    assert int(_check_prepass(geo, ci.prepare(geo, ro, rd, tl)).sum()) > 0
    tb = flagship.meshes[0].itables
    ro, rd, tl = (x.to(cuda) for x in _rays(8 * 512 + 77, seed=24))
    for lo, hi in ((0, 245), (245, 489), (7, 40), (100, 101)):
        part = ci.slice_supers(tb, lo, hi)
        _check_prepass(part, ci.prepare(part, ro, rd, tl))
    rng = np.random.default_rng(25)
    for cs in (1500, 7000):
        lo = rng.normal(0, 2, (cs, 3)).astype(np.float32)
        hi = lo + rng.uniform(0.01, 1.0, (cs, 3)).astype(np.float32)
        sbox = np.concatenate([lo, hi, np.zeros((cs, 2), np.float32)], 1)
        fake = ci.IntersectTables(64, 8, None, None,
                                  torch.from_numpy(sbox).to(cuda))
        counts = _check_prepass(fake, ci.prepare(fake, ro, rd, tl))
        assert 0 < int(counts.sum()) < counts.numel() * cs


@pytest.mark.cuda
def test_queries_bit_equal_with_the_prepass_kernel(cuda, flagship,
                                                   monkeypatch):
    """closest_hit, any_hit and the two-phase any hit on the flagship
    tables return bit-equal results with the kernel's visit tables and
    with the plain ones; `prepare` launches the kernel once a call."""
    tb = flagship.meshes[0].itables
    ro, rd, tl = (x.to(cuda) for x in _rays(16 * 512 + 77, seed=26))
    kernel = ci.KERNELS["prepass"]

    def queries():
        return (ci.closest_hit(tb, ro, rd), ci.closest_hit(tb, ro, rd, tl),
                (ci.any_hit(tb, ro, rd, tl),),
                (ci.any_hit_two_phase(tb, ro, rd, tl, frac=0.5),))

    before = kernel.launches
    after = queries()
    torch.cuda.synchronize()
    assert kernel.launches == before + 5

    monkeypatch.setattr(ci, "prepass_kernel", _plain_tables)
    plain = queries()
    assert kernel.launches == before + 5
    assert int((after[0][1] >= 0).sum()) > 100
    assert 100 < int(after[2][0].sum()) < len(ro[0]) - 100
    for a, b in zip(after, plain):
        for x, y in zip(a, b):
            assert (_bits_equal(x, y) if x.is_floating_point()
                    else torch.equal(x, y))


@pytest.mark.cuda
def test_prepare_on_card_reads_nothing_back_and_counts_tiles(cuda, flagship):
    """`prepare` on the card makes no host sync (PyTorch's sync debug
    mode raises on one), and under a recording profiler the tracing
    counter `prepass_tiles` adds the tiles it sent through the kernel."""
    from rendering_tpu_torch.utils import tracing

    tb = flagship.meshes[0].itables
    ro, rd, tl = (x.to(cuda) for x in _rays(8 * 512 + 77, seed=27))
    ci.prepare(tb, ro, rd, tl)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        prep = ci.prepare(tb, ro, rd, tl)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _check_prepass(tb, prep)
    tracing.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        ci.prepare(tb, ro, rd, tl)
        ci.prepare(tb, ro[:, :600], rd[:, :600], tl[:600])
    torch.cuda.synchronize()
    assert tracing.counters()["prepass_tiles"] == prep.n_tiles + 2
    tracing.reset()
