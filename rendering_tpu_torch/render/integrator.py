"""Wavefront integrator — `rendering_tpu.render.integrator`: the
reference's recursive `Render::castRay` (src/scene.cpp:672-946) unrolled
into a fixed-depth bounce loop over blocks of rays in (3, B) row layout.

Each bounce runs, per block, the closest hit, surface data, direct
lighting with shadow rays, the material combine, and spawns the
continuations: a reflective hit one child with weight x 0.8, a
transparent one its fresnel-weighted reflection and refraction. The
weighted path sum equals the reference's recursion tree. With
transparent objects the two children of every lane are compacted back to
the queue's capacity (the largest weights kept, drops counted in
stats["paths_dropped"]); the continuation queue is ordered by a Morton
key of its origins, so the intersection kernel's ray tiles stay
coherent. Radiance is scattered into the pixel buffer, except in a scene
without bouncing materials, whose slots stay pixel-aligned and
accumulate in place.

Discrete hit topology (the mesh oracle, the object argmin, shadow
visibility, the queue order) is computed under torch.no_grad; hit t/u/v
are then re-evaluated from gathered triangle rows with plain tensor math,
so the render stays differentiable with fixed topology. Nothing writes in
place into scene tensors. A scene of one mesh queries that mesh's tables
(K1, K2, or with settings.anyhit_compact_frac > 0 its shadow rays the
two-phase K6); a scene of two or more queries the fused tables of all of
them at once (K5). With useAC, a mesh clipped by its root box is queried
through the root filter (K4); with collectStatistics the queries count
their tests (K3) into the stats. Under geometry sharding
(`parallel.geoshard`) the fused queries run on this rank's shard of the
tables and combine over the scene's geo group. The gather tables come from
`pipeline.derive_mesh_tables`. `shade_normals` is the showNormals pass:
the closest hit and its normal, one bounce.

With settings.use_pallas_intersect off, every mesh is queried on its own
(a scene of several meshes too) by JAX's non-Pallas oracles
(`_mesh_oracle`): a mesh of at most bruteforce_threshold triangles by the
dense scan (`ops/bruteforce_mxu.py` with use_mxu_intersect, else
`ops/bruteforce.py`), a larger one by the threaded-BVH walk
(`ops/traversal.traverse_bvh`: the `bvh_closest` kernel on a card); their
counters go into the stats whether or not collectStatistics is set, as
JAX's do.

Inside `growing_queue` (the train steps) the transparent queue drops
nothing: each compaction keeps every live child, in as many ray blocks
as hold them (`QueueGrowth`), so bounce 0 carries no padding and the
later bounces only the blocks their children fill.

In a recorded trace (`utils.tracing`) each bounce of `integrate` is the
span `rt.integrator.bounce`, holding per ray block `rt.integrator.trace`
(the closest hit), `rt.integrator.shade` (the rest of `bounce_block`)
with `rt.integrator.shadow` (the occlusion queries) inside it, then the
radiance scatter `rt.integrator.scatter` and the continuations' re-sort
or compaction `rt.integrator.compact`; a compaction that enlarges a
`QueueGrowth`'s capacity is the span `rt.train.regrow`. The counters
`lanes` and `live_lanes` take each bounce block's lanes and those above
min_weight, `queue_lanes` and `queue_live_lanes` the same of the
continuation queue on bounces 1 and later; the scatters' lanes count in
`accum_lanes` (`ops.accumulate`).
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import math
from typing import NamedTuple

import torch

from rendering_tpu_torch.models.scene import (
    KIND_MESH,
    KIND_PLANE,
    KIND_SPHERE,
    MAT_DIFFUSE,
    MAT_PHONG,
    MAT_REFLECTIVE,
    MAT_TRANSPARENT,
)
from rendering_tpu_torch.ops import cuda_intersect
from rendering_tpu_torch.ops.accumulate import gather_rows, index_accumulate
from rendering_tpu_torch.ops.bruteforce import bruteforce_mesh
from rendering_tpu_torch.ops.bruteforce_mxu import bruteforce_mesh_mxu
from rendering_tpu_torch.ops.geometry import (
    FLT_MAX,
    MORTON_INACTIVE,
    dot_r,
    morton_key_r,
    normalize_r,
)
from rendering_tpu_torch.ops.intersect import (
    intersect_planes_r,
    intersect_spheres_r,
    ray_triangle_r,
)
from rendering_tpu_torch.ops.shading import (
    fresnel_r,
    reflect_r,
    refract_r,
    spec_pow,
)
from rendering_tpu_torch.ops.skybox import sample_skybox_r
from rendering_tpu_torch.ops.texture import (
    sample_map_bilinear_r,
    sample_map_r,
    sample_packed_bilinear_r,
    sample_packed_r,
)
from rendering_tpu_torch.ops.traversal import traverse_bvh
from rendering_tpu_torch.parallel import collectives
from rendering_tpu_torch.utils import tracing
from rendering_tpu_torch.utils.tracing import span, traced

# Rays per block of the bounce body (bounds every per-ray temporary):
# 131072 rays = 256 kernel tiles per closest-hit launch.
DEFAULT_RAY_BLOCK = 1 << 17

# Upper bound of the transparent queue, in multiples of a pass's first
# queue: the frames' headroom escalation (`render.pipeline.
# escalating_render`) and a growing queue's capacity (`QueueGrowth`).
# Headroom h costs h x the queue's lanes per bounce (dead lanes are
# culled in the kernel but still shade).
MAX_QUEUE_HEADROOM = 8


class QueueOverflow(RuntimeError):
    """A growing queue reached MAX_QUEUE_HEADROOM and dropped paths."""


class QueueGrowth:
    """The capacities of a growing transparent queue (`growing_queue`):
    at each compaction one host read of the live children, which are
    then all kept, in the ray blocks that hold them (one at least) and
    never fewer than were held at the same bounce of the same pass
    before (`held`, keyed by (rays in, bounce)). A train step keeps one
    across its steps, so the capacities settle in the first step and the
    shapes repeat. Past MAX_QUEUE_HEADROOM x the pass's first queue the
    compaction keeps the largest weights, as the capped queue does, and
    `dropped` counts the rest (a host int, since `growing_queue` was
    entered)."""

    def __init__(self):
        self.held: dict = {}
        self.dropped = 0

    def lanes(self, key, n_live: int, block: int, limit: int):
        """(lanes of the next queue, whether that enlarged the held
        capacity) for n_live live children."""
        held = self.held.get(key, 0)
        need = min(limit, max(1, -(-n_live // block)) * block)
        if need <= held:
            return held, False
        self.held[key] = need
        return need, True


_GROWTH: contextvars.ContextVar = contextvars.ContextVar("queue_growth",
                                                         default=None)


@contextlib.contextmanager
def growing_queue(growth: QueueGrowth):
    """Within the block, `integrate` sizes every transparent pass's
    continuation queue by `growth` (in place of its queue_headroom);
    growth.dropped restarts at 0."""
    growth.dropped = 0
    token = _GROWTH.set(growth)
    try:
        yield growth
    finally:
        _GROWTH.reset(token)


def _samplers(settings):
    """(packed (rows, R) sampler, per-map (C, R) sampler) for the
    configured texture_filter."""
    if settings.texture_filter == "bilinear":
        return sample_packed_bilinear_r, sample_map_bilinear_r
    if settings.texture_filter != "nearest":
        raise ValueError(
            f"texture_filter must be 'nearest' or 'bilinear', "
            f"got {settings.texture_filter!r}"
        )
    return sample_packed_r, sample_map_r


class Hit(NamedTuple):
    t: torch.Tensor      # (Q,) f32, re-evaluated
    obj: torch.Tensor    # (Q,) int64
    hit: torch.Tensor    # (Q,) bool
    tri: torch.Tensor    # (Q,) int32 (mesh hits; -1 otherwise)
    u: torch.Tensor      # (Q,)
    v: torch.Tensor      # (Q,)
    # Gathered surface rows of the winning mesh (30, Q); None without meshes.
    geo: torch.Tensor | None = None


def zero_stats() -> dict:
    """Render counters: rays traced, the intersection kernels' box and
    triangle tests (K3, counted only under collectStatistics), and the
    active paths the transparent queue's compaction dropped (int64
    tensors on the scene's device once counted)."""
    return {"rays_casted": 0.0, "accel_struct_tests": 0, "ray_tri_tests": 0,
            "paths_dropped": 0}


def add_stats(into: dict, other: dict) -> None:
    """into[k] += other[k] for every counter."""
    for k in into:
        into[k] = into[k] + other[k]


def _add_counters(stats: dict, counters) -> None:
    """Add a query's (box_tests, tri_tests), if it counted, to stats."""
    if counters:
        box, tri = counters
        stats["accel_struct_tests"] = stats["accel_struct_tests"] + box
        stats["ray_tri_tests"] = stats["ray_tri_tests"] + tri


def _occlusion(out, stats: dict, settings):
    """An any-hit query's occlusion bits; its counters, when it counted,
    go into stats."""
    if not settings.collect_statistics:
        return out
    occ, *counters = out
    _add_counters(stats, counters)
    return occ


def _query_flags(settings, clipped: bool) -> dict:
    """The intersection query's root filter (useAC on a mesh its root
    box clips) and counters (collectStatistics)."""
    return dict(backface_culling=settings.use_backface_culling,
                root_filter=bool(settings.use_ac and clipped),
                collect_stats=settings.collect_statistics)


def _per_obj(table, obj, n_objects: int):
    """table[obj], broadcast for single-object scenes. A table that
    requires grad adds its gradient into its rows through
    `ops.accumulate.index_accumulate` (`gather_rows`)."""
    if n_objects == 1:
        return table[0].expand(obj.shape + table.shape[1:])
    return gather_rows(table, obj)


def _per_obj3(table, obj, n_objects: int):
    """Per-object 3-vector table (No, 3) -> (3, Q) rows, as `_per_obj`."""
    if n_objects == 1:
        return table[0][:, None].expand(3, obj.shape[0])
    return gather_rows(table, obj, transpose=True)


@torch.no_grad()
def _mesh_oracle(mesh, ms, settings, ro3, rd3, t_limit):
    """One mesh's closest hit without the tile-walk kernels (JAX
    `_mesh_oracle` with use_pallas_intersect off): the dense scan up to
    bruteforce_threshold triangles (bilinear with use_mxu_intersect),
    the BVH walk above. ro3/rd3 (3, Q); t_limit (Q,) or None. Returns
    (tri (Q,) int32, -1 on a miss or at or beyond t_limit, box_tests,
    tri_tests)."""
    ro, rd = ro3.T, rd3.T
    if ms.n_tris <= settings.bruteforce_threshold:
        fn = (bruteforce_mesh_mxu if settings.use_mxu_intersect
              else bruteforce_mesh)
        _, tri, box, tris = fn(
            mesh, ro, rd, t_limit,
            backface_culling=settings.use_backface_culling,
            tri_chunk=settings.tri_chunk,
            use_root_filter=bool(settings.use_ac and ms.clipped_by_root))
        return tri, box, tris
    r = traverse_bvh(mesh, ro, rd, t_limit,
                     backface_culling=settings.use_backface_culling,
                     use_ac=settings.use_ac)
    return r.tri, r.box_tests, r.tri_tests


def _mesh_hits(scene, ro3, rd3, t_limit, stats):
    """Per-mesh closest hits, one query per mesh (K1, or `_mesh_oracle`
    with use_pallas_intersect off): lists over meshes of (t, tri, u, v,
    geo), t re-evaluated and differentiable, FLT_MAX where the mesh is
    not hit. Adds the queries' counters to stats."""
    settings = scene.static.settings
    q = ro3.shape[1]
    dev = ro3.device
    cols = [], [], [], [], []
    for mesh, ms in zip(scene.meshes, scene.static.meshes):
        if ms.n_tris == 0:
            hit = (torch.full((q,), FLT_MAX, device=dev),
                   torch.full((q,), -1, dtype=torch.int32, device=dev),
                   torch.zeros((q,), device=dev), torch.zeros((q,), device=dev),
                   torch.zeros((30, q), device=dev))
        else:
            t_lim = t_limit.detach() if t_limit is not None else None
            if settings.use_pallas_intersect:
                _, tri_d, *counters = cuda_intersect.closest_hit(
                    mesh.itables, ro3.detach(), rd3.detach(), t_lim,
                    **_query_flags(settings, ms.clipped_by_root),
                )
            else:
                tri_d, *counters = _mesh_oracle(mesh, ms, settings,
                                                ro3.detach(), rd3.detach(),
                                                t_lim)
            _add_counters(stats, counters)
            # One gather of every per-triangle surface row: rows 0-8 feed
            # the differentiable hit re-evaluation, the rest surface_data.
            g = mesh.vgeoT[:, torch.clamp_min(tri_d, 0).long()]  # (30, Q)
            t_r, u_r, v_r, _ = ray_triangle_r(
                ro3, rd3, g[0:3], g[3:6], g[6:9],
                settings.use_backface_culling
            )
            found = tri_d >= 0
            hit = (torch.where(found, t_r, FLT_MAX),
                   torch.where(found, tri_d, -1),
                   torch.where(found, u_r, 0.0), torch.where(found, v_r, 0.0),
                   g)
        for col, x in zip(cols, hit):
            col.append(x)
    return cols


def _fused_mesh_hits(scene, ro3, rd3, t_limit, stats):
    """_mesh_hits through the fused tables: one query over every mesh
    (K5). The winner comes back as (mesh sub index, column of the
    concatenated vgeoT), so the row gather and the re-evaluation also run
    once; every mesh's geo is that one gathered block."""
    st = scene.static
    settings = st.settings
    ft = scene.fused_itables
    t_d, mid, vid, *counters = cuda_intersect.intersect_fused(
        ft, ro3.detach(), rd3.detach(),
        t_limit.detach() if t_limit is not None else None,
        mode="closest", **_query_flags(settings, ft.any_clipped),
    )
    comm = scene.geo_comm
    if comm is not None:
        # Geometry sharding: this rank queried its shard of the tables;
        # the winner over the geo axis, first rank on equal t.
        mid, vid, counters = collectives.combine_closest(comm, t_d, mid, vid,
                                                         counters)
    _add_counters(stats, counters)
    if scene.vgeoT_sharded is not None:
        # The gather table is sharded by columns too.
        g = collectives.gather_sharded_rows(comm, scene.vgeoT_sharded, vid)
    else:
        g = scene.fused_vgeoT[:, vid.long()]  # (30, Q); vid is 0 on a miss
    t_r, u_r, v_r, _ = ray_triangle_r(
        ro3, rd3, g[0:3], g[3:6], g[6:9], settings.use_backface_culling
    )
    cols = [], [], [], [], []
    vofs = 0  # local triangle ids through the meshes' column offsets
    for sub, ms in enumerate(st.meshes):
        selm = mid == sub  # only where the oracle found a hit
        hit = (torch.where(selm, t_r, FLT_MAX),
               torch.where(selm, vid - vofs, -1),
               torch.where(selm, u_r, 0.0), torch.where(selm, v_r, 0.0), g)
        for col, x in zip(cols, hit):
            col.append(x)
        vofs += ms.n_tris
    return cols


@traced("rt.integrator.trace")
def trace_closest(scene, ro3, rd3, *, t_limit=None):
    """Closest hit over all scene objects in scene order
    (Render::trace, src/scene.cpp:724-756). ro3/rd3: (3, Q).
    Returns (Hit, stats)."""
    st = scene.static
    q = ro3.shape[1]
    dev = ro3.device
    stats = zero_stats()
    stats["rays_casted"] = float(q)

    t_sph = (intersect_spheres_r(ro3, rd3, scene.sph_pos, scene.sph_r)
             if st.n_spheres else None)  # (Ns, Q)
    t_pln = (intersect_planes_r(ro3, rd3, scene.pln_pos, scene.pln_n)
             if st.n_planes else None)   # (Np, Q)
    hits = (_fused_mesh_hits if scene.fused_itables is not None
            and st.settings.use_pallas_intersect else _mesh_hits)
    mesh_t, mesh_tri, mesh_u, mesh_v, mesh_geo = hits(scene, ro3, rd3,
                                                      t_limit, stats)

    cols = []
    for oi, kind in enumerate(st.obj_kinds):
        sub = st.obj_subs[oi]
        if kind == KIND_SPHERE:
            cols.append(t_sph[sub])
        elif kind == KIND_PLANE:
            cols.append(t_pln[sub])
        else:
            cols.append(mesh_t[sub])
    if not cols:
        miss = torch.full((q,), FLT_MAX, device=dev)
        zi = torch.zeros((q,), dtype=torch.int64, device=dev)
        return Hit(miss, zi, torch.zeros((q,), dtype=torch.bool, device=dev),
                   (zi - 1).to(torch.int32), torch.zeros((q,), device=dev),
                   torch.zeros((q,), device=dev)), stats

    if len(cols) == 1:
        obj = torch.zeros((q,), dtype=torch.int64, device=dev)
        t = cols[0]
    else:
        t_mat = torch.stack(cols, dim=0)  # (No, Q) in scene order
        # First minimum wins ties: the reference's strict `<` in order.
        obj = torch.argmin(t_mat.detach(), dim=0)
        t = torch.gather(t_mat, 0, obj[None, :])[0]
    hit = t < FLT_MAX

    tri = torch.full((q,), -1, dtype=torch.int32, device=dev)
    u = torch.zeros((q,), device=dev)
    v = torch.zeros((q,), device=dev)
    geo = None
    for oi, kind in enumerate(st.obj_kinds):
        if kind == KIND_MESH:
            sub = st.obj_subs[oi]
            sel = obj == oi
            tri = torch.where(sel, mesh_tri[sub], tri)
            u = torch.where(sel, mesh_u[sub], u)
            v = torch.where(sel, mesh_v[sub], v)
            # The fused meshes share one gathered row block.
            geo = (mesh_geo[sub] if geo is None or geo is mesh_geo[sub]
                   else torch.where(sel[None, :], mesh_geo[sub], geo))
    return Hit(t, obj, hit, tri, u, v, geo), stats


@traced("rt.integrator.shadow")
@torch.no_grad()
def trace_occlusion(scene, ro3, rd3, dist):
    """Does any non-transparent object intersect strictly closer than
    `dist`? (trace() with tNear preset to the light distance,
    scene.cpp:785-787.) ro3/rd3: (3, Q). Visibility is a step function
    and carries no gradient. Returns (occluded (Q,) bool, stats)."""
    st = scene.static
    settings = st.settings
    q = ro3.shape[1]
    stats = zero_stats()
    stats["rays_casted"] = float(q)
    occluded = torch.zeros((q,), dtype=torch.bool, device=ro3.device)

    def opaque(kind):
        return [st.mat_types[oi] != MAT_TRANSPARENT
                for oi, k in enumerate(st.obj_kinds) if k == kind]

    for kind, fn, pos, prm in (
        (KIND_SPHERE, intersect_spheres_r, scene.sph_pos, scene.sph_r),
        (KIND_PLANE, intersect_planes_r, scene.pln_pos, scene.pln_n),
    ):
        mask = opaque(kind)
        if any(mask):
            t = fn(ro3, rd3, pos, prm)
            with span("rt.sync.occluder_mask"):
                keep = torch.tensor(mask, device=ro3.device)[:, None]
            occluded = occluded | torch.any(keep & (t < dist[None, :]), dim=0)
    fts = scene.fused_shadow_itables
    if fts is not None and settings.use_pallas_intersect:
        # One fused any-hit query (K5) over every opaque mesh; rays that
        # spheres or planes already occlude enter resolved.
        dist_m = torch.where(occluded, -1.0, dist)
        out = cuda_intersect.intersect_fused(
            fts, ro3, rd3, dist_m, mode="any",
            **_query_flags(settings, fts.any_clipped),
        )
        if scene.geo_comm is not None:
            # Geometry sharding: occluded where any shard occludes.
            occ, *counters = out if settings.collect_statistics else (out,)
            occ, counters = collectives.combine_any(scene.geo_comm, occ,
                                                    counters)
            out = (occ, *counters) if counters else occ
        return occluded | _occlusion(out, stats, settings), stats
    for mesh, ms, opq in zip(scene.meshes, st.meshes, opaque(KIND_MESH)):
        if not opq or ms.n_tris == 0:
            continue
        # Rays already occluded enter resolved (t0 = -1 culls every chunk).
        dist_m = torch.where(occluded, -1.0, dist)
        if not settings.use_pallas_intersect:
            tri, *counters = _mesh_oracle(mesh, ms, settings, ro3, rd3,
                                          dist_m)
            _add_counters(stats, counters)
            occluded = occluded | (tri >= 0)
            continue
        flags = _query_flags(settings, ms.clipped_by_root)
        if settings.anyhit_compact_frac > 0:
            out = cuda_intersect.any_hit_two_phase(
                mesh.itables, ro3, rd3, dist_m,
                frac=settings.anyhit_compact_frac, **flags)
        else:
            out = cuda_intersect.any_hit(mesh.itables, ro3, rd3, dist_m,
                                         **flags)
        occluded = occluded | _occlusion(out, stats, settings)
    return occluded, stats


def surface_data(scene, hit: Hit, hit_point3, *, want_maps: bool = False):
    """Normal and texture coordinate at the hit (getSurfaceData: mesh
    objects.cpp:121-151, sphere :788-796, plane :816-824). hit_point3:
    (3, Q). Returns (normal3 (3, Q), tex2 (2, Q)); with want_maps also a
    {obj_index: (7, Q)} dict of packed map rows (diffuse rgb | normal
    xyz | specular), gathered once and reused by object_color and
    specular_coefficient."""
    st = scene.static
    q = hit_point3.shape[1]
    dev = hit_point3.device
    normal3 = torch.zeros((3, q), device=dev)
    tex2 = torch.zeros((2, q), device=dev)
    msamp: dict[int, torch.Tensor] = {}

    for oi, kind in enumerate(st.obj_kinds):
        sub = st.obj_subs[oi]
        sel = ((hit.obj == oi) & hit.hit)[None, :]
        if kind == KIND_SPHERE:
            n3 = normalize_r(hit_point3 - scene.sph_pos[sub][:, None])
            normal3 = torch.where(sel, n3, normal3)
            # Sphere UV (objects.cpp:793-795), detached: acos' has a pole.
            n_sg = n3.detach()
            tx = (1.0 + torch.atan2(n_sg[2], n_sg[0]) / math.pi) * 0.5
            ty = torch.acos(torch.clamp(n_sg[1], -1.0, 1.0)) / math.pi
            tex2 = torch.where(sel, torch.stack([tx, ty]), tex2)
        elif kind == KIND_PLANE:
            n3 = scene.pln_n[sub][:, None].expand(3, q)
            normal3 = torch.where(sel, n3, normal3)
            d3 = hit_point3 - scene.pln_pos[sub][:, None]
            tex2 = torch.where(
                sel, torch.stack([d3[0] / 15.0, d3[2] / 15.0]), tex2
            )
        else:
            ms = st.meshes[sub]
            mesh = scene.meshes[sub]
            g = hit.geo[9:]  # (21, Q): normals 9 | uv 6 | tan 3 | bit 3
            uvg = g[9:15]
            w0 = 1.0 - hit.u - hit.v
            # texCoord = t_b*u + t_c*v + (1-u-v)*t_a (objects.cpp:124)
            tc2 = torch.stack([
                uvg[2] * hit.u + uvg[4] * hit.v + uvg[0] * w0,
                uvg[3] * hit.u + uvg[5] * hit.v + uvg[1] * w0,
            ])
            # Smooth vertex normal; the /3 is a no-op under normalize
            # (objects.cpp:127).
            n3 = normalize_r(
                (g[3:6] * hit.u[None] + g[6:9] * hit.v[None]
                 + g[0:3] * w0[None]) / 3.0
            )
            packed_fn, map_fn = _samplers(st.settings)
            g7 = None
            if ms.has_packed_maps:
                g7 = packed_fn(mesh.mapsT, ms.pmap_wh, tc2)  # (7, Q)
                msamp[oi] = g7
            if ms.has_normal_map:
                # Tangent-space normal through the unorthonormalized TBN
                # rows, as objects.cpp:129-150.
                raw = (g7[3:6] if g7 is not None
                       else map_fn(mesh.normal_map, ms.nmap_wh, tc2))
                tn = normalize_r(raw)
                n3 = normalize_r(
                    tn[0:1] * g[15:18] + tn[1:2] * g[18:21] + tn[2:3] * n3
                )
            normal3 = torch.where(sel, n3, normal3)
            tex2 = torch.where(sel, tc2, tex2)
    if want_maps:
        return normal3, tex2, msamp
    return normal3, tex2


def object_color(scene, hit: Hit, tex2, msamp=None):
    """Mesh -> diffuse map or color (objects.cpp:153-163); sphere/plane
    -> object color. Returns (3, Q)."""
    st = scene.static
    color3 = _per_obj3(scene.obj_color, hit.obj, st.n_objects)
    for oi, kind in enumerate(st.obj_kinds):
        if kind != KIND_MESH:
            continue
        sub = st.obj_subs[oi]
        ms = st.meshes[sub]
        if ms.has_diffuse_map:
            if msamp is not None and oi in msamp:
                smp = msamp[oi][0:3]
            else:
                smp = _samplers(st.settings)[1](
                    scene.meshes[sub].diffuse_map, ms.dmap_wh, tex2)
            color3 = torch.where((hit.obj == oi)[None, :], smp, color3)
    return color3


def specular_coefficient(scene, hit: Hit, tex2, msamp=None):
    """Phong specular coefficient: the mesh's specular map if it has one
    (scene.cpp:849-852, objects.cpp:165-175), else the object's."""
    st = scene.static
    spec = _per_obj(scene.obj_specular, hit.obj, st.n_objects)
    for oi, kind in enumerate(st.obj_kinds):
        if kind != KIND_MESH:
            continue
        sub = st.obj_subs[oi]
        ms = st.meshes[sub]
        if ms.has_specular_map:
            if msamp is not None and oi in msamp:
                smp = msamp[oi][6]
            else:
                smp = _samplers(st.settings)[1](
                    scene.meshes[sub].specular_map, ms.smap_wh, tex2)[0]
            spec = torch.where(hit.obj == oi, smp, spec)
    return spec


def _area_points(light):
    """AreaLight::setPoints (src/lights.cpp:46-63): samples^2 grid
    including both edges; samples == 1 -> the center point."""
    s = light.samples
    if s <= 1:
        return light.pos[None, :]
    ii = (torch.arange(s, dtype=torch.float32, device=light.pos.device)
          / float(s - 1))
    corner = light.pos - light.ivec / 2.0 - light.jvec / 2.0
    pts = (
        corner[None, None, :]
        + ii[:, None, None] * light.ivec[None, None, :]
        + ii[None, :, None] * light.jvec[None, None, :]
    )
    return pts.reshape(s * s, 3)


def _point_falloff(intensity, d2):
    """min(1, I / (4*pi*d2/1000)) (lights.cpp:35, scene.cpp:796)."""
    safe = torch.clamp_min(d2, 1e-30)
    return torch.clamp_max(intensity / (4.0 * math.pi * safe / 1000.0), 1.0)


class ShadowBatch(NamedTuple):
    """The point and distant lights' shadow rays of one ray block, as
    one occlusion query (rays concatenated light-major), with the
    per-light terms the lighting sum multiplies by visibility."""

    ro3: torch.Tensor     # (3, L*Q)
    rd3: torch.Tensor     # (3, L*Q)
    dist: torch.Tensor    # (L*Q,); -1 where visibility cannot matter
    terms: list           # per light (inten3 (3, Q), ndl (Q,), spec_f (Q,))


def point_shadow_batch(scene, hit_point3, normal3, rd3, nspec, mask=None):
    """Build the batched shadow query of the point and distant lights
    (one any-hit launch instead of one per light). Rays whose result is
    provably unused enter resolved (dist = -1): miss/inactive lanes and
    lanes where both the diffuse (ndl <= 0) and specular (spec_f <= 0)
    factors vanish. Returns None when the scene has no such light."""
    q = hit_point3.shape[1]
    shadow_orig3 = hit_point3 + normal3 * scene.bias
    ldirs, dists, terms = [], [], []
    for light in scene.lights:
        if light.kind == "distant":
            ldir3 = light.dir[:, None].expand(3, q)
            inten3 = (light.color * light.intensity)[:, None].expand(3, q)
            dist = torch.full((q,), FLT_MAX, device=hit_point3.device)
        elif light.kind == "point":
            delta3 = hit_point3 - light.pos[:, None]
            d2 = dot_r(delta3, delta3)
            inten3 = (light.color[:, None]
                      * _point_falloff(light.intensity, d2)[None, :])
            ldir3 = normalize_r(delta3)
            dist = torch.sqrt(d2)
        else:
            continue
        ndl = torch.clamp_min(dot_r(normal3, -ldir3), 0.0)
        spec_f = spec_pow(
            torch.clamp_min(dot_r(reflect_r(ldir3, normal3), -rd3), 0.0),
            nspec,
        )
        unused = (ndl <= 0.0) & (spec_f <= 0.0)
        if mask is not None:
            unused = unused | ~mask
        ldirs.append(ldir3)
        dists.append(torch.where(unused.detach(), -1.0, dist))
        terms.append((inten3, ndl, spec_f))
    if not terms:
        return None
    return ShadowBatch(
        shadow_orig3.repeat(1, len(terms)),
        torch.cat([-d for d in ldirs], dim=1),
        torch.cat(dists),
        terms,
    )


def lighting(scene, hit_point3, normal3, rd3, nspec, *, stats, mask=None):
    """Direct lighting over all lights (the per-branch light loops at
    scene.cpp:780-941 compute the same two sums). All vectors (3, Q).
    Returns (diffuse_comp (3, Q), spec_comp (3, Q)). Area lights keep
    the pow-of-mean quirk (scene.cpp:846)."""
    q = hit_point3.shape[1]
    dev = hit_point3.device
    diffuse_c3 = torch.zeros((3, q), device=dev)
    spec_c3 = torch.zeros((3, q), device=dev)

    batch = point_shadow_batch(scene, hit_point3, normal3, rd3, nspec, mask)
    if batch is not None:
        occ_all, s_stats = trace_occlusion(scene, batch.ro3, batch.rd3,
                                           batch.dist)
        add_stats(stats, s_stats)
        for li, (inten3, ndl, spec_f) in enumerate(batch.terms):
            vis = (~occ_all[li * q:(li + 1) * q]).to(torch.float32)
            diffuse_c3 = diffuse_c3 + inten3 * (vis * ndl)[None, :]
            spec_c3 = spec_c3 + (vis * spec_f)[None, :] * inten3

    shadow_orig3 = hit_point3 + normal3 * scene.bias
    for light in scene.lights:
        if light.kind != "area":
            continue
        # Area light: sample grid (scene.cpp:790-806 / 826-846).
        pts3 = _area_points(light).T                          # (3, S)
        s_count = pts3.shape[1]
        delta3 = hit_point3[:, :, None] - pts3[:, None, :]    # (3, Q, S)
        dist_s = torch.sqrt(dot_r(delta3, delta3))            # (Q, S)
        if mask is not None:  # miss/inactive lanes enter resolved
            dist_s = torch.where(mask.detach()[:, None], dist_s, -1.0)
        ldn3 = normalize_r(delta3)
        occ, s_stats = trace_occlusion(
            scene,
            shadow_orig3[:, :, None].expand(delta3.shape).reshape(3, -1),
            (-ldn3).reshape(3, -1),
            dist_s.reshape(-1),
        )
        add_stats(stats, s_stats)
        vis = (~occ).reshape(q, s_count).to(torch.float32)
        ndl = torch.clamp_min(dot_r(normal3[:, :, None], -ldn3), 0.0)
        refl_s3 = reflect_r(ldn3, normal3[:, :, None])        # (3, Q, S)
        rdv = torch.clamp_min(dot_r(refl_s3, -rd3[:, :, None]), 0.0)
        dsum = torch.sum(vis * ndl, dim=1) / s_count
        ssum = torch.sum(vis * rdv, dim=1) / s_count
        dc3 = hit_point3 - light.pos[:, None]
        inten3 = (light.color[:, None]
                  * _point_falloff(light.intensity, dot_r(dc3, dc3))[None, :])
        diffuse_c3 = diffuse_c3 + dsum[None, :] * inten3
        spec_c3 = spec_c3 + spec_pow(ssum, nspec)[None, :] * inten3
    return diffuse_c3, spec_c3


class BlockOut(NamedTuple):
    """One castRay level of a ray block: the weighted radiance to add and
    the continuations (None in a scene without bouncing materials; c2
    also None without transparent ones)."""

    contrib3: torch.Tensor          # (3, B)
    c1_ro3: torch.Tensor | None     # (3, B) reflective / transparent reflection
    c1_rd3: torch.Tensor | None
    c1_w: torch.Tensor | None       # (B,)
    c2_ro3: torch.Tensor | None     # (3, B) transparent refraction
    c2_rd3: torch.Tensor | None
    c2_w: torch.Tensor | None
    stats: dict


def bounce_block(scene, ro3, rd3, weight, active) -> BlockOut:
    """One castRay level for a block of rays (JAX `_bounce_block`), (3, B)
    rows throughout: closest hit, surface data, direct lighting, the
    material combine (scene.cpp:780-941), and the continuations of
    reflective hits (scene.cpp:856-858: direction not normalized, weight
    x 0.8) and transparent ones (scene.cpp:892-941: the fresnel-weighted
    reflection and refraction, their origins biased by which side the ray
    came from)."""
    stats = zero_stats()
    # Inactive lanes get t_limit = -1: the pre-pass and the kernel treat
    # them as resolved, so they cost no intersection work.
    hit, t_stats = trace_closest(
        scene, ro3, rd3,
        t_limit=torch.where(active, FLT_MAX, -1.0),
    )
    add_stats(stats, t_stats)
    with span("rt.integrator.shade"):
        return _shade_block(scene, ro3, rd3, weight, active, hit, stats)


def _shade_block(scene, ro3, rd3, weight, active, hit, stats) -> BlockOut:
    """The rest of `bounce_block` after the closest hit: surface data,
    colours and maps, direct lighting, the material combine and the
    continuations."""
    st = scene.static
    hit_m = hit.hit & active
    miss_m = (~hit.hit) & active

    sky3 = sample_skybox_r(
        scene.skybox if st.settings.use_skybox else None, rd3, scene.bg_color
    )
    contrib3 = torch.where(miss_m[None, :], weight[None, :] * sky3, 0.0)

    # Miss lanes get a finite t so masked values stay finite.
    t_safe = torch.where(hit.hit, hit.t, 1.0)
    hit_point3 = ro3 + rd3 * t_safe[None, :]
    normal3, tex2, msamp = surface_data(scene, hit, hit_point3,
                                        want_maps=True)
    obj_col3 = object_color(scene, hit, tex2, msamp)
    nspec = _per_obj(scene.obj_nspec, hit.obj, st.n_objects)
    mat = _per_obj(scene.mat_type, hit.obj, st.n_objects)

    diffuse_c3, spec_c3 = lighting(
        scene, hit_point3, normal3, rd3, nspec, stats=stats, mask=hit_m
    )

    # Material combine (scene.cpp:780-941).
    spec_coef = specular_coefficient(scene, hit, tex2, msamp)
    hc_diffuse = obj_col3 * diffuse_c3
    hc_phong = (
        obj_col3 * _per_obj(scene.obj_ambient, hit.obj, st.n_objects)[None, :]
        + diffuse_c3
        * _per_obj(scene.obj_diffuse, hit.obj, st.n_objects)[None, :]
        + spec_c3 * spec_coef[None, :]
    )
    if st.any_transparent:
        ior = _per_obj(scene.obj_ior, hit.obj, st.n_objects)
        kr = fresnel_r(rd3, normal3, ior)
        hc_last = torch.where((mat == MAT_REFLECTIVE)[None, :], spec_c3,
                              spec_c3 * kr[None, :])
    else:
        # No transparent object: the fresnel term is never selected.
        hc_last = spec_c3
    hc = torch.where(
        (mat == MAT_DIFFUSE)[None, :],
        hc_diffuse,
        torch.where((mat == MAT_PHONG)[None, :], hc_phong, hc_last),
    )
    contrib3 = contrib3 + torch.where(hit_m[None, :], weight[None, :] * hc,
                                      0.0)
    if not st.any_bouncing:
        return BlockOut(contrib3, None, None, None, None, None, None, stats)

    # ---- continuations ----
    bias_v3 = scene.bias * normal3
    rdn = dot_r(rd3, normal3)
    is_refl = hit_m & (mat == MAT_REFLECTIVE)
    is_trans = hit_m & (mat == MAT_TRANSPARENT)
    refl_dir_r3 = rd3 - 2.0 * rdn[None, :] * normal3
    refl_orig_r3 = hit_point3 + bias_v3
    if not st.any_transparent:
        return BlockOut(contrib3, refl_orig_r3, refl_dir_r3,
                        torch.where(is_refl, weight * 0.8, 0.0),
                        None, None, None, stats)
    outside = (rdn < 0)[None, :]
    refr_dir3 = normalize_r(refract_r(rd3, normal3, ior))
    refr_orig3 = torch.where(outside, hit_point3 - bias_v3,
                             hit_point3 + bias_v3)
    refl_dir_t3 = normalize_r(reflect_r(rd3, normal3))
    refl_orig_t3 = torch.where(outside, hit_point3 + bias_v3,
                               hit_point3 - bias_v3)
    c1_w = torch.where(is_refl, weight * 0.8,
                       torch.where(is_trans, weight * kr, 0.0))
    c2_w = torch.where(is_trans & (kr < 1.0), weight * (1.0 - kr), 0.0)
    return BlockOut(
        contrib3,
        torch.where(is_refl[None, :], refl_orig_r3, refl_orig_t3),
        torch.where(is_refl[None, :], refl_dir_r3, refl_dir_t3),
        c1_w, refr_orig3, refr_dir3, c2_w, stats,
    )


class Queue(NamedTuple):
    """The bounce queue in blocks: vectors (nb, 3, B), weights and pixel
    ids (nb, B)."""

    ro3: torch.Tensor
    rd3: torch.Tensor
    weight: torch.Tensor
    pix: torch.Tensor  # int64


def _flat3(a):
    """(nb, 3, B) -> (3, nb * B)."""
    return a.transpose(0, 1).reshape(3, -1)


def _blocks3(a, nb: int, b: int):
    """(3, nb * B) -> (nb, 3, B)."""
    return a.reshape(3, nb, b).transpose(0, 1)


def _to_blocks(ro, rd, pix, weight, block: int) -> Queue:
    """Pack (Q, 3) rays into the blocked queue; pad lanes have weight 0,
    ro = 0 and rd = 1."""
    q = ro.shape[0]
    nb = max(1, -(-q // block))
    pad = nb * block - q
    pad_f = torch.nn.functional.pad
    return Queue(
        ro3=_blocks3(pad_f(ro, (0, 0, 0, pad)).T, nb, block),
        rd3=_blocks3(pad_f(rd, (0, 0, 0, pad), value=1.0).T, nb, block),
        weight=pad_f(weight, (0, pad)).reshape(nb, block),
        pix=pad_f(pix.to(torch.int64), (0, pad)).reshape(nb, block),
    )


def _scatter(accum3, pix, values3):
    """accum3 (3, n_pixels) with values3 (3, Q) added at columns pix (Q,)
    (`ops.accumulate.index_accumulate`): on a card its kernel, whose
    order of summation follows from the ids alone, so repeat frames and
    train steps are bit-equal; on the CPU index_add, in lane order."""
    with span("rt.integrator.scatter"):
        return index_accumulate(accum3, pix, values3)


def _bounce(scene, queue: Queue, accum3, stats, *, slot_accum: bool,
            grow=None):
    """One castRay level for the whole queue (JAX `_bounce`). Returns
    (next queue, accum3); the next queue is None in a non-bouncing scene.

    slot_accum: radiance accumulates per queue slot ((3, Q), None before
    the first bounce), valid while slot -> pixel stays fixed (no
    transparent compaction); else it is scattered into the (3, n_pixels)
    accumulator through the queue's pixel ids. The continuations: in
    slot mode the single one in place; in scatter mode it is re-sorted by
    the Morton key of its origins (inactive lanes last), so the next
    bounce's ray tiles stay spatially coherent; with transparent objects
    the two children of every lane compact to the queue's capacity
    (`_compact_children`), or with `grow` to the capacity it gives."""
    st = scene.static
    min_w = st.settings.min_weight
    nb, _, b = queue.ro3.shape
    q = nb * b
    outs = []
    for i in range(nb):
        w = queue.weight[i]
        active = w > min_w
        tracing.count("lanes", b)
        tracing.count("live_lanes", active)
        out = bounce_block(scene, queue.ro3[i].contiguous(),
                           queue.rd3[i].contiguous(), w, active)
        add_stats(stats, out.stats)
        outs.append(out)
    contrib3 = torch.cat([o.contrib3 for o in outs], dim=1)
    pix = queue.pix.reshape(q)
    if slot_accum:
        accum3 = contrib3 if accum3 is None else accum3 + contrib3
    else:
        accum3 = _scatter(accum3, pix, contrib3)
    if not st.any_bouncing:
        return None, accum3
    with span("rt.integrator.compact"):
        return _continuations(st, outs, queue, pix, stats,
                              slot_accum=slot_accum, grow=grow), accum3


def _continuations(st, outs, queue: Queue, pix, stats, *,
                   slot_accum: bool, grow=None) -> Queue:
    """The next queue from the blocks' continuations (`_bounce`)."""
    min_w = st.settings.min_weight
    nb, _, b = queue.ro3.shape

    def cat(field):
        return torch.cat([getattr(o, field) for o in outs], dim=-1)

    c_ro, c_rd, c_w = cat("c1_ro3"), cat("c1_rd3"), cat("c1_w")
    if not st.any_transparent:
        if slot_accum:
            # The single continuation in place: slots stay pixel-aligned.
            return Queue(_blocks3(c_ro, nb, b), _blocks3(c_rd, nb, b),
                         c_w.reshape(nb, b), queue.pix)
        key = torch.where(c_w > min_w, morton_key_r(c_ro), MORTON_INACTIVE)
        order = torch.argsort(key, stable=True)
        return Queue(_blocks3(c_ro[:, order], nb, b),
                     _blocks3(c_rd[:, order], nb, b),
                     c_w[order].reshape(nb, b),
                     pix[order].reshape(nb, b))
    k_ro, k_rd, k_w, k_pix = _compact_children(
        torch.cat([c_ro, cat("c2_ro3")], dim=1),
        torch.cat([c_rd, cat("c2_rd3")], dim=1),
        torch.cat([c_w, cat("c2_w")]),
        torch.cat([pix, pix]), nb * b, min_w, stats, grow=grow)
    nk = k_w.shape[0] // b
    return Queue(_blocks3(k_ro, nk, b), _blocks3(k_rd, nk, b),
                 k_w.reshape(nk, b), k_pix.reshape(nk, b))


def _compact_children(cand_ro, cand_rd, cand_w, cand_pix, capacity: int,
                      min_w: float, stats: dict, *, grow=None):
    """Compact the 2Q candidate children to the queue capacity Q (JAX
    `_compact_children`): the Q largest weights are kept (a stable
    argsort of -weight, so ties keep queue order), the kept set is
    ordered by the Morton key of its origins, inactive lanes last. Active
    paths that do not fit are counted in stats["paths_dropped"].

    grow(n_live) -> (capacity, grew) replaces Q by what a `QueueGrowth`
    gives for the live count, read on the host: every live child fits
    unless the growth is at its limit, and the kept set is the same as
    the capped queue's with room enough. A compaction that grew is the
    span `rt.train.regrow`."""
    cand_w = torch.where(cand_w > min_w, cand_w, 0.0)
    active = cand_w > min_w
    fits, grew = False, False
    if grow is not None:
        with span("rt.sync.queue_live"):
            n_live = int(active.sum())
        capacity, grew = grow(n_live)
        fits = n_live <= capacity
    with span("rt.train.regrow") if grew else contextlib.nullcontext(), \
            torch.no_grad():
        if fits:
            key = torch.where(active, morton_key_r(cand_ro), MORTON_INACTIVE)
        else:
            worder = torch.argsort(torch.where(active, -cand_w, math.inf),
                                   stable=True)
            keep = torch.zeros_like(active)
            with span("rt.sync.compact_keep"):  # True is copied from the host
                keep[worder[:capacity]] = True
            key = torch.where(keep & active, morton_key_r(cand_ro),
                              MORTON_INACTIVE)
        order = torch.argsort(key, stable=True)[:capacity]
    kept_w = cand_w[order]
    if grow is not None:
        # Every kept lane is live when the children overflow the limit.
        dropped = n_live - min(n_live, capacity)
        stats["paths_dropped"] = stats["paths_dropped"] + dropped
    else:
        n_kept = (kept_w > min_w).sum()
        stats["paths_dropped"] = (stats["paths_dropped"]
                                  + (active.sum() - n_kept))
    return cand_ro[:, order], cand_rd[:, order], kept_w, cand_pix[order]


def integrate(scene, ro, rd, pix, weight, n_pixels: int, *,
              ray_block: int = DEFAULT_RAY_BLOCK, out_slots: bool = False,
              queue_headroom: int = 1):
    """Run the bounce loop for a ray batch (ro, rd (R, 3); pix (R,) pixel
    ids; weight (R,)) in blocks of `ray_block` rays. Returns (accum3,
    stats): the weighted radiance scattered into (3, n_pixels), or with
    `out_slots` the radiance of each input ray, (3, R), slot i = ray i's
    bounce tree (the caller owns the slot -> pixel map; not with
    transparent objects, whose compaction reassigns slots).

    A scene with reflective or transparent objects runs max_ray_depth + 1
    bounces (castRay at depth > max returns the skybox, scene.cpp:760:
    the paths that survive them take the skybox colour); others one.
    queue_headroom > 1 appends that many times the queue in dead blocks
    on transparent scenes, so the compaction keeps up to headroom x R
    paths (`render.pipeline.escalating_render` raises it while paths are
    dropped). Dead lanes still run the plain-torch pre-pass and shading
    and count in rays_casted, as in the JAX package. Inside
    `growing_queue` a transparent scene's queue follows its live
    children instead, and the headroom is not used."""
    st = scene.static
    if out_slots and st.any_transparent:
        raise ValueError("slot accumulation needs fixed slots; a "
                         "transparent scene's compaction reassigns them")
    n_bounces = st.settings.max_ray_depth + 1 if st.any_bouncing else 1
    r_in = ro.shape[0]
    dev = ro.device
    stats = zero_stats()
    if r_in == 0:
        return torch.zeros((3, 0 if out_slots else n_pixels), device=dev), stats
    queue = _to_blocks(ro, rd, pix, weight, min(ray_block, r_in))
    nb0, _, b0 = queue.ro3.shape
    growth = _GROWTH.get() if st.any_transparent else None
    if queue_headroom > 1 and st.any_transparent and growth is None:
        extra = nb0 * (queue_headroom - 1)
        queue = Queue(
            torch.cat([queue.ro3, torch.zeros((extra, 3, b0), device=dev)]),
            torch.cat([queue.rd3, torch.ones((extra, 3, b0), device=dev)]),
            torch.cat([queue.weight, torch.zeros((extra, b0), device=dev)]),
            torch.cat([queue.pix, torch.zeros((extra, b0), dtype=torch.int64,
                                              device=dev)]),
        )
    accum3 = None if out_slots else torch.zeros((3, n_pixels), device=dev)
    min_w = st.settings.min_weight
    for k in range(n_bounces):
        if k:
            tracing.count("queue_lanes", queue.weight.numel())
            tracing.count("queue_live_lanes", queue.weight > min_w)
        grow = None if growth is None else functools.partial(
            growth.lanes, (r_in, k), block=b0,
            limit=MAX_QUEUE_HEADROOM * nb0 * b0)
        with span("rt.integrator.bounce"):
            queue, accum3 = _bounce(scene, queue, accum3, stats,
                                    slot_accum=out_slots, grow=grow)
    if growth is not None:
        growth.dropped += stats["paths_dropped"]
    if st.any_bouncing:
        # Depth guard: the surviving continuations return the skybox.
        rd3, w = _flat3(queue.rd3), queue.weight.reshape(-1)
        sky3 = sample_skybox_r(
            scene.skybox if st.settings.use_skybox else None, rd3,
            scene.bg_color)
        tail3 = torch.where((w > min_w)[None, :], w[None, :] * sky3, 0.0)
        accum3 = (accum3 + tail3 if out_slots
                  else _scatter(accum3, queue.pix.reshape(-1), tail3))
    if out_slots:
        accum3 = accum3[:, :r_in]
    return accum3, stats


def shade_normals(scene, ro, rd, *, ray_block: int = DEFAULT_RAY_BLOCK):
    """showNormals (scene.cpp:771-772, JAX `shade_normals`): the first
    hit's normal as n / 2 + 0.5, a miss the skybox or the background.
    One bounce whatever the materials: the reference returns before any
    recursion. ro/rd (Q, 3), in blocks of `ray_block` rays (the closest
    hit of each block, K1 or its K4/K5 variant); returns (3, Q). The
    queries' counters are not kept: the pass reports only its rays."""
    st = scene.static
    q = ro.shape[0]
    if q == 0:
        return torch.zeros((3, 0), device=ro.device)
    zeros = torch.zeros((q,), device=ro.device)
    queue = _to_blocks(ro, rd, zeros, zeros, min(ray_block, q))
    sky = scene.skybox if st.settings.use_skybox else None
    out = []
    for ro3, rd3 in zip(queue.ro3, queue.rd3):
        ro3, rd3 = ro3.contiguous(), rd3.contiguous()
        hit, _ = trace_closest(scene, ro3, rd3)
        hit_point3 = ro3 + rd3 * torch.where(hit.hit, hit.t, 1.0)[None, :]
        normal3, _ = surface_data(scene, hit, hit_point3)
        sky3 = sample_skybox_r(sky, rd3, scene.bg_color)
        out.append(torch.where(hit.hit[None, :], normal3 / 2.0 + 0.5, sky3))
    return torch.cat(out, dim=1)[:, :q]
