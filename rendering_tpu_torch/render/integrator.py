"""Wavefront integrator, the non-bouncing subset of
`rendering_tpu.render.integrator`: closest hit, surface data, direct
lighting with shadow rays, and the diffuse/phong combine, over blocks of
rays in (3, B) row layout.

Discrete hit topology (the mesh oracle, the object argmin, shadow
visibility) is computed under torch.no_grad; hit t/u/v are then
re-evaluated from gathered triangle rows with plain tensor math, so the
render stays differentiable with fixed topology. Nothing writes in place
into scene tensors.

Reflective and transparent materials (continuation rays, the queue
compaction) come with the bouncing slice: `integrate` raises
NotImplementedError for them.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from rendering_tpu_torch.models.scene import (
    KIND_MESH,
    KIND_PLANE,
    KIND_SPHERE,
    MAT_DIFFUSE,
    MAT_PHONG,
    MAT_TRANSPARENT,
)
from rendering_tpu_torch.ops import cuda_intersect
from rendering_tpu_torch.ops.geometry import FLT_MAX, dot_r, normalize_r
from rendering_tpu_torch.ops.intersect import (
    intersect_planes_r,
    intersect_spheres_r,
    ray_triangle_r,
)
from rendering_tpu_torch.ops.shading import reflect_r, spec_pow
from rendering_tpu_torch.ops.skybox import sample_skybox_r
from rendering_tpu_torch.ops.texture import (
    sample_map_bilinear_r,
    sample_map_r,
    sample_packed_bilinear_r,
    sample_packed_r,
)

# Rays per block of the bounce body (bounds every per-ray temporary):
# 131072 rays = 256 kernel tiles per closest-hit launch.
DEFAULT_RAY_BLOCK = 1 << 17


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
    """Render counters. The kernel's test counters (collectStatistics)
    come with a later slice, so only rays_casted is counted."""
    return {"rays_casted": 0.0}


def _per_obj(table, obj, n_objects: int):
    """table[obj], broadcast for single-object scenes."""
    if n_objects == 1:
        return table[0].expand(obj.shape + table.shape[1:])
    return table[obj]


def _per_obj3(table, obj, n_objects: int):
    """Per-object 3-vector table (No, 3) -> (3, Q) rows."""
    if n_objects == 1:
        return table[0][:, None].expand(3, obj.shape[0])
    return table.T[:, obj]


def trace_closest(scene, ro3, rd3, *, t_limit=None):
    """Closest hit over all scene objects in scene order
    (Render::trace, src/scene.cpp:724-756). ro3/rd3: (3, Q).
    Returns (Hit, stats)."""
    st = scene.static
    settings = st.settings
    q = ro3.shape[1]
    dev = ro3.device
    stats = zero_stats()
    stats["rays_casted"] = float(q)

    t_sph = (intersect_spheres_r(ro3, rd3, scene.sph_pos, scene.sph_r)
             if st.n_spheres else None)  # (Ns, Q)
    t_pln = (intersect_planes_r(ro3, rd3, scene.pln_pos, scene.pln_n)
             if st.n_planes else None)   # (Np, Q)

    mesh_t, mesh_tri, mesh_u, mesh_v, mesh_geo = [], [], [], [], []
    for mesh in scene.meshes:
        if mesh.itables is None:  # a mesh without triangles
            mesh_t.append(torch.full((q,), FLT_MAX, device=dev))
            mesh_tri.append(torch.full((q,), -1, dtype=torch.int32, device=dev))
            mesh_u.append(torch.zeros((q,), device=dev))
            mesh_v.append(torch.zeros((q,), device=dev))
            mesh_geo.append(torch.zeros((30, q), device=dev))
            continue
        _, tri_d = cuda_intersect.closest_hit(
            mesh.itables, ro3.detach(), rd3.detach(),
            t_limit.detach() if t_limit is not None else None,
            backface_culling=settings.use_backface_culling,
        )
        # One gather of every per-triangle surface row: rows 0-8 feed
        # the differentiable hit re-evaluation, the rest surface_data.
        g = mesh.vgeoT[:, torch.clamp_min(tri_d, 0).long()]  # (30, Q)
        t_r, u_r, v_r, _ = ray_triangle_r(
            ro3, rd3, g[0:3], g[3:6], g[6:9], settings.use_backface_culling
        )
        found = tri_d >= 0
        mesh_t.append(torch.where(found, t_r, FLT_MAX))
        mesh_tri.append(torch.where(found, tri_d, -1))
        mesh_u.append(torch.where(found, u_r, 0.0))
        mesh_v.append(torch.where(found, v_r, 0.0))
        mesh_geo.append(g)

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
            geo = (mesh_geo[sub] if geo is None
                   else torch.where(sel[None, :], mesh_geo[sub], geo))
    return Hit(t, obj, hit, tri, u, v, geo), stats


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
            keep = torch.tensor(mask, device=ro3.device)[:, None]
            occluded = occluded | torch.any(keep & (t < dist[None, :]), dim=0)
    for mesh, opq in zip(scene.meshes, opaque(KIND_MESH)):
        if not opq or mesh.itables is None:
            continue
        # Rays already occluded enter resolved (t0 = -1 culls every chunk).
        dist_m = torch.where(occluded, -1.0, dist)
        occluded = occluded | cuda_intersect.any_hit(
            mesh.itables, ro3, rd3, dist_m,
            backface_culling=settings.use_backface_culling,
        )
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
        stats["rays_casted"] += s_stats["rays_casted"]
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
        stats["rays_casted"] += s_stats["rays_casted"]
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


def bounce_block(scene, ro3, rd3, weight, active):
    """One castRay level for a block of rays of a non-bouncing scene —
    (3, B) rows throughout. Returns (contrib3 (3, B), stats)."""
    st = scene.static
    stats = zero_stats()
    # Inactive lanes get t_limit = -1: the pre-pass and the kernel treat
    # them as resolved, so they cost no intersection work.
    hit, t_stats = trace_closest(
        scene, ro3, rd3,
        t_limit=torch.where(active, FLT_MAX, -1.0),
    )
    stats["rays_casted"] += t_stats["rays_casted"]
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

    # Material combine (scene.cpp:780-941): diffuse and phong.
    spec_coef = specular_coefficient(scene, hit, tex2, msamp)
    hc_diffuse = obj_col3 * diffuse_c3
    hc_phong = (
        obj_col3 * _per_obj(scene.obj_ambient, hit.obj, st.n_objects)[None, :]
        + diffuse_c3
        * _per_obj(scene.obj_diffuse, hit.obj, st.n_objects)[None, :]
        + spec_c3 * spec_coef[None, :]
    )
    hc = torch.where(
        (mat == MAT_DIFFUSE)[None, :],
        hc_diffuse,
        torch.where((mat == MAT_PHONG)[None, :], hc_phong, spec_c3),
    )
    contrib3 = contrib3 + torch.where(hit_m[None, :], weight[None, :] * hc,
                                      0.0)
    return contrib3, stats


def integrate(scene, ro, rd, weight, *, ray_block: int = DEFAULT_RAY_BLOCK):
    """Radiance of a ray batch (ro, rd (R, 3); weight (R,)), in blocks of
    `ray_block` rays: returns (3, R), slot i = radiance of ray i (the
    caller owns the slot -> pixel map). This is the JAX integrate's
    out_slots=True mode on a non-bouncing scene; the pixel scatter and
    the bounce loop come with the bouncing slice."""
    st = scene.static
    if st.any_bouncing:
        raise NotImplementedError(
            "only the non-bouncing slot-accumulating integrate is ported; "
            "reflective/transparent materials come with the bouncing slice"
        )
    stats = zero_stats()
    r_in = ro.shape[0]
    if r_in == 0:
        return torch.zeros((3, 0), device=ro.device), stats
    block = min(ray_block, r_in)
    nb = -(-r_in // block)
    pad = nb * block - r_in
    ro = torch.nn.functional.pad(ro, (0, 0, 0, pad))
    rd = torch.nn.functional.pad(rd, (0, 0, 0, pad), value=1.0)
    weight = torch.nn.functional.pad(weight, (0, pad))
    ro3 = ro.T.reshape(3, nb, block)
    rd3 = rd.T.reshape(3, nb, block)
    w = weight.reshape(nb, block)
    min_w = st.settings.min_weight
    outs = []
    for b in range(nb):
        contrib3, s = bounce_block(scene, ro3[:, b].contiguous(),
                                   rd3[:, b].contiguous(), w[b], w[b] > min_w)
        stats["rays_casted"] += s["rays_casted"]
        outs.append(contrib3)
    return torch.cat(outs, dim=1)[:, :r_in], stats
