"""By-primitive geometry sharding — the port of
`rendering_tpu.parallel.geoshard` on torch.distributed.

The ray-sharded renderer replicates the scene. For a scene whose tables
outgrow one card, this layer also cuts the fused chunk tables along the
super axis over a second mesh axis:

  ranks = (rays R, geo G), rank = r * G + g

* the fused tables are padded to a G-divisible super count
  (`pad_fused_for_shards`) and rank (r, g) stages only shard g: 1/G of
  the scene's triangles in kernel format, cut from the host copy that a
  scene built with settings.geo_shard_axis="geo" keeps
  (`models.scene.to_keeping_host_tables`);
* every rank intersects its ray shard (the rays axis, as in
  `parallel.shard`) against its table shard with the same kernels (K5),
  the pre-pass and the kernel rejecting the padded supers;
* trace_closest combines each ray's hit over the geo axis (a MIN of t,
  the first rank among the equal ones, a masked SUM of the winner's ids)
  and trace_occlusion an any over it (`parallel.collectives`), so every
  rank of a geo row shades the same combined hits;
* idmap values are global (mesh sub index, gather column), so a shard's
  hit needs no rebasing.

With shade_sharded=True the (30, T) gather table is cut by columns too
(`pad_vgeo_for_shards`; the winner's rows gathered locally and summed
over the geo axis) and every replicated per-triangle tensor is stripped
to zero size: each rank then holds 1/G of all per-triangle data.
`geo_shard_memory_accounting` measures it from the staged tensors.

Coverage matches the ray-sharded renderer, which each function here runs
on the rank's local scene: the primary pass, adaptive SSAA, showNormals,
showAC (the BVH node arrays staged replicated: it shows the BVH), the
strips of the progress and resumable renders, u8 output, and the two
escalations in `render_geo_sharded`. As in the JAX package, this path
renders forward only: it runs under torch.no_grad and carries no
gradient.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from rendering_tpu_torch.models.scene import BVH_FIELDS, PER_TRIANGLE
from rendering_tpu_torch.ops.cuda_intersect import FusedTables, IntersectTables
from rendering_tpu_torch.ops.geometry import FLT_MAX as FMAX
from rendering_tpu_torch.parallel import collectives
from rendering_tpu_torch.parallel.collectives import Comm
from rendering_tpu_torch.parallel.multihost import TIMEOUT
from rendering_tpu_torch.parallel.shard import (
    _show_ac_sharded,
    comm_for,
    render_scene_sharded,
    render_strip_sharded,
    ssaa_pass_sharded,
)
from rendering_tpu_torch.render.integrator import DEFAULT_RAY_BLOCK, zero_stats


@dataclasses.dataclass(frozen=True)
class GeoMesh:
    """A 2-D (rays, geo) mesh of ranks as this rank sees it: its ray axis
    (the ranks holding the same table shard), its geo axis (the ranks
    sharing its rays), the axis of every rank, and its device."""

    rays: Comm
    geo: Comm
    all: Comm
    device: torch.device
    axis_names = ("rays", "geo")


def make_geo_mesh(n_geo: int = 2, device=None) -> GeoMesh:
    """The (world / n_geo, n_geo) mesh over every rank (without a process
    group, this process alone, n_geo = 1). Every rank makes the group of
    each row and each column in the same order; an axis of one rank has
    no group."""
    from rendering_tpu_torch.parallel.multihost import rank_device

    dev = rank_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_geo < 1 or world % n_geo:
        raise ValueError(f"n_geo={n_geo} must divide the {world} ranks")
    n_rays = world // n_geo
    if world == 1:
        one = collectives.single()
        return GeoMesh(one, one, one, dev)
    me = dist.get_rank()
    rows = [[r * n_geo + g for g in range(n_geo)] for r in range(n_rays)]
    cols = [[r * n_geo + g for r in range(n_rays)] for g in range(n_geo)]

    def axis(groups):
        mine = collectives.single()
        if len(groups[0]) == 1:
            return mine
        for ranks in groups:
            group = dist.new_group(ranks, timeout=TIMEOUT)
            if me in ranks:
                mine = comm_for(group)
        return mine

    geo = axis(rows)
    rays = axis(cols)
    return GeoMesh(rays, geo, comm_for(None), dev)


def pad_fused_for_shards(ft: FusedTables, g: int) -> FusedTables:
    """The fused tables with the super count padded to a multiple of g,
    so each shard holds whole supers (JAX `pad_fused_for_shards`): the
    padding supers carry zero triangles (the det test rejects them) and
    inverted boxes (the pre-pass never finds them live); their idmap
    entries are 0. The tables stay on their device (host memory for a
    geometry-sharded scene)."""
    cs = ft.geo.sbox.shape[0]
    pad = (-cs) % g
    if pad == 0:
        return ft
    tc, ns = ft.geo.tri_chunk, ft.geo.n_sub
    dev = ft.geo.sbox.device
    f32 = dict(dtype=torch.float32, device=dev)
    inv_box = torch.cat([torch.full((pad, 3), FMAX, **f32),
                         torch.full((pad, 3), -FMAX, **f32),
                         torch.zeros((pad, 2), **f32)], dim=1)
    geo = IntersectTables(
        tc, ns,
        torch.cat([ft.geo.tri,
                   torch.zeros((pad,) + tuple(ft.geo.tri.shape[1:]), **f32)]),
        torch.cat([ft.geo.cbox, inv_box.repeat_interleave(ns, dim=0)]),
        torch.cat([ft.geo.sbox, inv_box]),
    )
    idmap = torch.cat([ft.idmap, torch.zeros((2, pad * ns * tc),
                                             dtype=torch.int32, device=dev)],
                      dim=1)
    return FusedTables(geo, idmap, ft.n_meshes, ft.any_clipped, ft.t_total)


def pad_vgeo_for_shards(vgeo, g: int):
    """The (30, T) gather table with the column count padded to a
    multiple of g by zero columns (no winner's vid points at them)."""
    pad = (-vgeo.shape[1]) % g
    if pad == 0:
        return vgeo
    return torch.cat([vgeo, vgeo.new_zeros((vgeo.shape[0], pad))], dim=1)


def _shard(x, g: int, i: int, dim: int = 0):
    """Block i of g along `dim`."""
    n = x.shape[dim] // g
    return x.narrow(dim, i * n, n)


def _local_tables(ft: FusedTables, g: int, i: int, device) -> FusedTables:
    """Shard i of padded fused tables, staged on `device`: supers
    [i * Cs/g, (i + 1) * Cs/g) and their idmap columns; chunk ids are
    local to the shard, the idmap's ids global."""
    def put(x, dim=0):
        return _shard(x, g, i, dim).contiguous().to(device)

    geo = IntersectTables(ft.geo.tri_chunk, ft.geo.n_sub, put(ft.geo.tri),
                          put(ft.geo.cbox), put(ft.geo.sbox))
    return FusedTables(geo, put(ft.idmap, 1), ft.n_meshes, ft.any_clipped,
                       ft.t_total)


def _host_vgeo(m):
    """A mesh's (30, T) gather table (`pipeline.derive_mesh_tables`' rows)
    from its host tensors."""
    return torch.cat([m.v.reshape(-1, 9).T, m.n.reshape(-1, 9).T,
                      m.uv.reshape(-1, 6).T, m.tangent.T, m.bitangent.T])


_NO_BVH = {k: None for k in (*BVH_FIELDS, "reach_lo", "reach_hi")}


def _strip_mesh_heavy(m, device):
    """A mesh with every per-triangle tensor zero-sized (the BVH arrays
    and reach boxes dropped): the fused trace reads the table shards,
    shading the gathered rows and the kept maps."""
    z = torch.zeros
    return dataclasses.replace(
        m, v=z((0, 3, 3), device=device), n=z((0, 3, 3), device=device),
        uv=z((0, 3, 2), device=device), tangent=z((0, 3), device=device),
        bitangent=z((0, 3), device=device), itables=None, vgeoT=None,
        **_NO_BVH)


@dataclasses.dataclass
class GeoPrepared:
    """A rank's staged inputs of a geometry-sharded render: `scene`, the
    local scene (its table shards, the shading shard when
    shade_sharded, the geo axis to combine over, the rest replicated),
    and the bytes of the padded whole tables it was cut from."""

    scene: object
    shard_names: tuple
    sharded_bytes_total: int


def prepare_geo_scene(scene, mesh: GeoMesh, shade_sharded: bool) -> GeoPrepared:
    """Pad and cut a scene built with geo_shard_axis="geo" for this rank,
    and stage its shard and the replicated remainder on the mesh's
    device (JAX `prepare_geo_scene` and `stage_geo_prepared`): nothing
    per-triangle reaches the device whole. Run once per render; the strip
    loops keep it (`make_geo_strip_fns`)."""
    st = scene.static
    if st.settings.geo_shard_axis != "geo":
        raise ValueError("build the scene with "
                         "RenderSettings(geo_shard_axis='geo')")
    if scene.fused_itables is None:
        raise ValueError("geometry sharding needs meshes")
    if not st.settings.use_pallas_intersect:
        # The per-mesh oracles would walk the (stripped) meshes whole on
        # every rank instead of the rank's table shard.
        raise ValueError("geometry sharding needs the tile-walk kernels "
                         "(settings.use_pallas_intersect=True)")
    g, i, dev = mesh.geo.size, mesh.geo.rank, mesh.device
    ft = pad_fused_for_shards(scene.fused_itables, g)
    fts = scene.fused_shadow_itables
    alias = fts is scene.fused_itables
    fts_p = ft if alias else (pad_fused_for_shards(fts, g)
                              if fts is not None else None)
    ft_l = _local_tables(ft, g, i, dev)
    fts_l = (ft_l if alias else (_local_tables(fts_p, g, i, dev)
                                 if fts_p is not None else None))
    total = sum(x.numel() * x.element_size()
                for t in {id(ft): ft, id(fts_p): fts_p}.values()
                if t is not None
                for x in (t.geo.tri, t.geo.cbox, t.geo.sbox, t.idmap))
    names = ["fused_itables"] + ([] if alias or fts_l is None
                                 else ["fused_shadow_itables"])
    vsh = None
    if shade_sharded:
        vgeo = pad_vgeo_for_shards(
            torch.cat([_host_vgeo(m) for m in scene.meshes], dim=1), g)
        total += vgeo.numel() * vgeo.element_size()
        vsh = _shard(vgeo, g, i, 1).contiguous().to(dev)
        names.append("vgeoT_sharded")
        meshes = tuple(_strip_mesh_heavy(m, dev) for m in scene.meshes)
    else:
        # The per-mesh arrays that shading gathers from, replicated.
        meshes = tuple(dataclasses.replace(
            m, **_NO_BVH,
            **{k: getattr(m, k).to(dev) for k in ("v", "n", "uv", "tangent",
                                                  "bitangent")})
            for m in scene.meshes)
    local = dataclasses.replace(
        scene, meshes=meshes, fused_itables=ft_l, fused_shadow_itables=fts_l,
        vgeoT_sharded=vsh, geo_comm=mesh.geo)
    return GeoPrepared(local, tuple(names), int(total))


def _show_ac_geo(scene, mesh: GeoMesh, *, ray_block=DEFAULT_RAY_BLOCK):
    """The showAC heatmap on the 2-D mesh: the BVH walk over the ray
    axis, the same on every geo rank. The node arrays are what the pass
    shows, so they stage replicated (O(T / leaf_chunk)); the fused tables
    and the shading arrays stay in host memory."""
    dev = mesh.device
    meshes = tuple(dataclasses.replace(
        _strip_mesh_heavy(m, dev),
        **{k: getattr(m, k).to(dev) for k in ("node_min", "node_max",
                                              "skip", "real_flag")})
        for m in scene.meshes)
    scene_ac = dataclasses.replace(scene, meshes=meshes, fused_itables=None,
                                   fused_shadow_itables=None)
    return _show_ac_sharded(scene_ac, mesh, ray_block=ray_block)


@torch.no_grad()
def render_scene_geo_sharded(scene, mesh: GeoMesh,
                             ray_block: int = DEFAULT_RAY_BLOCK,
                             shade_sharded: bool = False,
                             ssaa_capacity: int | None = None,
                             queue_headroom: int = 1, out_u8: bool = False,
                             _prepared: GeoPrepared | None = None):
    """The whole render with the rays sharded over the ray axis and the
    fused tables over the geo axis: the primary pass, adaptive SSAA and
    the debug passes, u8-equal to `pipeline.render_scene`. Returns
    (frame3 (3, H, W), aux) on every rank, as `render_scene`
    (out_u8: the (H, W, 3) u8 frame). shade_sharded=True also cuts the
    (30, T) gather table and strips every replicated per-triangle
    tensor; the output is the same."""
    from rendering_tpu_torch.render.pipeline import quantize_u8

    if scene.static.settings.show_ac:
        frame3 = _show_ac_geo(scene, mesh, ray_block=ray_block)
        return (quantize_u8(frame3) if out_u8 else frame3), {
            "stats": zero_stats(), "ssaa_masked": 0}
    prep = _prepared or prepare_geo_scene(scene, mesh, shade_sharded)
    return render_scene_sharded(prep.scene, mesh, ray_block=ray_block,
                                ssaa_capacity=ssaa_capacity,
                                queue_headroom=queue_headroom, out_u8=out_u8)


def render_geo_sharded(scene, mesh: GeoMesh, shade_sharded: bool = True,
                       ray_block: int = DEFAULT_RAY_BLOCK,
                       out_u8: bool = False):
    """Host-facing geometry-sharded render: ((H, W, 3) numpy frame, aux)
    with `pipeline.render`'s SSAA-capacity and queue-headroom
    escalations (`escalating_render`, the capacity padded to the ray
    ranks); the preparation runs once for every redo."""
    from rendering_tpu_torch.render.pipeline import escalating_render

    prep = (None if scene.static.settings.show_ac
            else prepare_geo_scene(scene, mesh, shade_sharded))
    frame, aux = escalating_render(
        lambda cap, headroom: render_scene_geo_sharded(
            scene, mesh, ray_block=ray_block, shade_sharded=shade_sharded,
            ssaa_capacity=cap, queue_headroom=headroom, out_u8=out_u8,
            _prepared=prep),
        scene.static.settings, cap_pad=mesh.rays.size)
    if not out_u8:
        frame = frame.permute(1, 2, 0)
    return frame.cpu().numpy(), aux


def make_geo_strip_fns(mesh: GeoMesh, ray_block: int,
                       queue_headroom: int = 1):
    """(prepare, strip_fn, ssaa_fn) with `pipeline._make_strip_fns`'
    contract for the progress and resumable strip loops over a (rays,
    geo) mesh: prepare(scene) stages this rank's shard once, the gather
    table sharded too (the loop then moves no table bytes per strip), and
    derives the gather tables;
    strip_fn(prepared, y0=, rows=) and ssaa_fn(prepared, frame3,
    capacity) run the sharded strip and SSAA on it."""
    from rendering_tpu_torch.render.pipeline import derive_mesh_tables

    def prepare(scene):
        return derive_mesh_tables(
            prepare_geo_scene(scene, mesh, shade_sharded=True).scene)

    @torch.no_grad()
    def strip_fn(derived, *, y0, rows: int):
        return render_strip_sharded(derived, y0=y0, rows=rows, mesh=mesh,
                                    ray_block=ray_block,
                                    queue_headroom=queue_headroom)

    @torch.no_grad()
    def ssaa_fn(derived, frame3, capacity):
        return ssaa_pass_sharded(derived, frame3, mesh, capacity=capacity,
                                 ray_block=ray_block,
                                 queue_headroom=queue_headroom)

    return prepare, strip_fn, ssaa_fn


def _tensor_bytes(x, device) -> int:
    """Bytes of the tensors under x (dataclasses, tuples) on `device`."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size() if x.device == device else 0
    if dataclasses.is_dataclass(x):
        return sum(_tensor_bytes(getattr(x, f.name), device)
                   for f in dataclasses.fields(x) if f.name != "static")
    if isinstance(x, (tuple, list)):
        return sum(_tensor_bytes(y, device) for y in x)
    return 0


def geo_shard_memory_accounting(scene, mesh: GeoMesh,
                                shade_sharded: bool = True) -> dict:
    """Stage this rank's inputs (`prepare_geo_scene`) and measure their
    bytes on its device (JAX `geo_shard_memory_accounting`, per rank):
    sharded_bytes_rank (the table and gather-table shards),
    replicated_bytes_rank (everything else staged), per_triangle_bytes_rank
    (the shards plus the per-triangle mesh tensors staged, zero-sized when
    shade_sharded), sharded_bytes_total (the padded whole tables on the
    host) and per_triangle_bytes_replicated (what the replicated scene
    holds per triangle: its fused tables and mesh tensors)."""
    prep = prepare_geo_scene(scene, mesh, shade_sharded)
    dev = mesh.device
    local = prep.scene
    sharded = sum(_tensor_bytes(getattr(local, k), dev)
                  for k in prep.shard_names)
    everything = _tensor_bytes(local, dev)
    per_tri_meshes = sum(_tensor_bytes(getattr(m, k), dev)
                         for m in local.meshes for k in PER_TRIANGLE)
    cpu = torch.device("cpu")
    fts = scene.fused_shadow_itables
    repl = (_tensor_bytes(scene.fused_itables, cpu)
            + (0 if fts is None or fts is scene.fused_itables
               else _tensor_bytes(fts, cpu))
            + sum(_tensor_bytes(getattr(m, k), cpu)
                  for m in scene.meshes for k in PER_TRIANGLE))
    return {
        "sharded_bytes_rank": int(sharded),
        "replicated_bytes_rank": int(everything - sharded),
        "per_triangle_bytes_rank": int(sharded + per_tri_meshes),
        "sharded_bytes_total": prep.sharded_bytes_total,
        "per_triangle_bytes_replicated": int(repl),
        "n_geo": mesh.geo.size,
    }
