"""Scene tensors — the port's counterpart of `rendering_tpu.models.scene`.

The scene is a dataclass of tensors with a `.to(device)`: spheres and
planes as (N, 3) tables, each mesh as Morton-ordered per-triangle
arrays plus its kernel chunk tables (or, with two or more meshes, the
scene's fused tables), lights as small per-light records. The build
runs the SAH BVH of each mesh on the host for its reach boxes (the
kernels' root filter), its node arrays (the showAC walk) and its
statistics counts. `load_scene` parses a
`.scene` file and builds it. The gather
tables that surface shading reads (vgeoT, mapsT) are derived from the
canonical arrays in every render (`render.pipeline.derive_mesh_tables`),
so gradients reach vertices and texels. Everything that decides shapes
or branches lives in `SceneStatic`.

Material enum order matches the reference (include/objects.h:17):
0=Diffuse, 1=Reflective, 2=Transparent, 3=Phong.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from rendering_tpu_torch.accel.bvh import build_bvh, morton_order
from rendering_tpu_torch.device import resolve_device
from rendering_tpu_torch.models.objloader import euler_matrix
from rendering_tpu_torch.models.parser import SceneDef, parse_scene
from rendering_tpu_torch.models.settings import RenderSettings
from rendering_tpu_torch.ops.cuda_intersect import (
    FusedTables,
    IntersectTables,
    build_fused_tables,
    build_intersect_tables,
    default_tri_chunk,
)
from rendering_tpu_torch.utils.tracing import span

MAT_DIFFUSE, MAT_REFLECTIVE, MAT_TRANSPARENT, MAT_PHONG = 0, 1, 2, 3
_MAT_IDS = {
    "diffuse": MAT_DIFFUSE,
    "reflective": MAT_REFLECTIVE,
    "transparent": MAT_TRANSPARENT,
    "phong": MAT_PHONG,
}
KIND_SPHERE, KIND_PLANE, KIND_MESH = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class MeshStatic:
    n_tris: int
    dmap_wh: tuple[int, int] = (0, 0)
    nmap_wh: tuple[int, int] = (0, 0)
    smap_wh: tuple[int, int] = (0, 0)
    # Common (W, H) when >= 2 maps share dims: one 7-row gather
    # (diffuse rgb | normal xyz | specular) then serves all of them.
    pmap_wh: tuple[int, int] = (0, 0)
    # The mesh pokes outside the reference's root box; only then do its
    # queries need the kernels' root filter (with use_ac).
    clipped_by_root: bool = False
    # BVH build counts for the statistics (stats::acCount and
    # stats::triCopiesCount).
    n_real_nodes: int = 0
    tri_copies: int = 0

    @property
    def has_diffuse_map(self) -> bool:
        return self.dmap_wh[0] > 0

    @property
    def has_normal_map(self) -> bool:
        return self.nmap_wh[0] > 0

    @property
    def has_specular_map(self) -> bool:
        return self.smap_wh[0] > 0

    @property
    def has_packed_maps(self) -> bool:
        return self.pmap_wh[0] > 0


@dataclasses.dataclass(frozen=True)
class SceneStatic:
    settings: RenderSettings
    obj_kinds: tuple[int, ...]      # KIND_* per object, scene order
    obj_subs: tuple[int, ...]       # index within the kind's table
    mat_types: tuple[int, ...]      # MAT_* per object
    light_kinds: tuple[str, ...]    # "distant" | "point" | "area"
    light_samples: tuple[int, ...]
    meshes: tuple[MeshStatic, ...]
    skybox_wh: tuple[int, int] = (0, 0)

    @property
    def n_objects(self) -> int:
        return len(self.obj_kinds)

    @property
    def n_spheres(self) -> int:
        return sum(1 for k in self.obj_kinds if k == KIND_SPHERE)

    @property
    def n_planes(self) -> int:
        return sum(1 for k in self.obj_kinds if k == KIND_PLANE)

    @property
    def n_meshes(self) -> int:
        return len(self.meshes)

    @property
    def any_bouncing(self) -> bool:
        """True if any material spawns secondary rays."""
        return any(m in (MAT_REFLECTIVE, MAT_TRANSPARENT)
                   for m in self.mat_types)

    @property
    def any_transparent(self) -> bool:
        return any(m == MAT_TRANSPARENT for m in self.mat_types)


def _to(x, device):
    """Move tensors (and records holding them) to `device`."""
    if isinstance(x, torch.Tensor) or hasattr(x, "to"):
        return x.to(device)
    if isinstance(x, tuple):
        return tuple(_to(y, device) for y in x)
    return x


class _Movable:
    def to(self, device):
        """A copy of this record with every tensor on `device`."""
        return dataclasses.replace(self, **{
            f.name: _to(getattr(self, f.name), device)
            for f in dataclasses.fields(self) if f.name != "static"
        })


@dataclasses.dataclass
class MeshData(_Movable):
    v: torch.Tensor          # (T, 3, 3)
    n: torch.Tensor          # (T, 3, 3)
    uv: torch.Tensor         # (T, 3, 2)
    tangent: torch.Tensor    # (T, 3)
    bitangent: torch.Tensor  # (T, 3)
    diffuse_map: Optional[torch.Tensor]   # (Hd*Wd, 3) or None
    normal_map: Optional[torch.Tensor]    # (Hn*Wn, 3) or None
    specular_map: Optional[torch.Tensor]  # (Hs*Ws, 1) or None
    # Kernel chunk tables; None for a mesh without triangles and in a
    # scene of two or more meshes, which reads the fused tables instead.
    itables: Optional[IntersectTables]
    # The flat BVH (accel.bvh.FlatBVH) that the showAC walk and the
    # closest-hit walk read (ops/traversal.py), kept in a fused scene too:
    # node boxes, the jump target on a box miss, the first-flat-node-of-
    # an-AC-node flag, and each leaf chunk's triangles (leaf_count of them
    # from leaf_start in leaf_tris; 0 for an inner node).
    node_min: Optional[torch.Tensor] = None    # (N, 3) f32
    node_max: Optional[torch.Tensor] = None    # (N, 3) f32
    skip: Optional[torch.Tensor] = None        # (N,) int32
    real_flag: Optional[torch.Tensor] = None   # (N,) int32
    leaf_start: Optional[torch.Tensor] = None  # (N,) int32
    leaf_count: Optional[torch.Tensor] = None  # (N,) int32
    leaf_tris: Optional[torch.Tensor] = None   # (L,) int32
    # Each triangle's reach box (the union of the BVH leaf boxes holding
    # it), which the dense paths' root filter reads (ops/bruteforce.py).
    reach_lo: Optional[torch.Tensor] = None    # (T, 3) f32
    reach_hi: Optional[torch.Tensor] = None    # (T, 3) f32
    # Derived in each render from the arrays above, None on a built
    # scene (render.pipeline.derive_mesh_tables):
    # one transposed gather table, component-major: rows 0-8 vertices,
    # 9-17 vertex normals, 18-23 uvs, 24-26 tangent, 27-29 bitangent,
    vgeoT: Optional[torch.Tensor] = None  # (30, T)
    # and the packed transposed maps (7, W*H): diffuse rgb | normal xyz |
    # specular, zero rows for absent maps; None unless pmap_wh is set.
    mapsT: Optional[torch.Tensor] = None


@dataclasses.dataclass
class LightData(_Movable):
    color: torch.Tensor      # (3,)
    intensity: torch.Tensor  # ()
    dir: torch.Tensor        # (3,) distant (as given, not normalized)
    pos: torch.Tensor        # (3,) point / area
    ivec: torch.Tensor       # (3,) area basis
    jvec: torch.Tensor       # (3,)
    kind: str = "point"
    samples: int = 1


@dataclasses.dataclass
class SceneData(_Movable):
    cam_pos: torch.Tensor    # (3,)
    cam_rmat: torch.Tensor   # (3, 3) row-vector convention: d' = d @ R
    scale: torch.Tensor      # () tan(fov/2)
    bg_color: torch.Tensor   # (3,)
    bias: torch.Tensor       # ()
    obj_color: torch.Tensor  # (No, 3)
    obj_ior: torch.Tensor    # (No,)
    obj_ambient: torch.Tensor   # (No,)
    obj_diffuse: torch.Tensor   # (No,)
    obj_specular: torch.Tensor  # (No,)
    obj_nspec: torch.Tensor     # (No,)
    mat_type: torch.Tensor      # (No,) int32
    sph_pos: torch.Tensor    # (Ns, 3)
    sph_r: torch.Tensor      # (Ns,)
    pln_pos: torch.Tensor    # (Np, 3)
    pln_n: torch.Tensor      # (Np, 3) as given
    meshes: tuple            # tuple[MeshData, ...]
    lights: tuple            # tuple[LightData, ...]
    skybox: Optional[torch.Tensor]  # (6, H, W, 3)
    # With two or more meshes: the fused chunk tables of every mesh (one
    # K5 launch per query) and the shadow tables, which leave out
    # transparent meshes and are the same object when none is.
    fused_itables: Optional[FusedTables] = None
    fused_shadow_itables: Optional[FusedTables] = None
    # The meshes' vgeoT concatenated (30, T_total), derived in each render
    # of a fused scene; the fused oracle's vid indexes its columns.
    fused_vgeoT: Optional[torch.Tensor] = None
    # Geometry sharding (`parallel.geoshard`), set only on a rank's local
    # scene: this rank's column range of the padded fused vgeoT (None
    # unless the shading table is sharded too), and the group of ranks
    # that hold the other shards, over which trace_closest and
    # trace_occlusion combine each ray's result (`parallel.collectives`).
    vgeoT_sharded: Optional[torch.Tensor] = None
    geo_comm: object = None
    static: SceneStatic = None

    @property
    def device(self) -> torch.device:
        return self.cam_pos.device

    def to(self, device):
        """A copy with every tensor on `device`; shadow tables that alias
        the fused tables stay one object."""
        out = super().to(device)
        if self.fused_shadow_itables is self.fused_itables:
            out.fused_shadow_itables = out.fused_itables
        return out


def _packable_wh(whs) -> tuple[int, int]:
    """Shared (W, H) if >= 2 of a mesh's maps exist (given as their
    (W, H), None when absent) with identical dims, else (0, 0)."""
    whs = [tuple(wh) for wh in whs if wh is not None]
    if len(whs) >= 2 and all(wh == whs[0] for wh in whs):
        return whs[0]
    return (0, 0)


def mesh_data(ms: MeshStatic, v, n, uv, tangent, bitangent,
              diffuse_map=None, normal_map=None, specular_map=None, *,
              reach=None, nodes=None, fused: bool = False) -> MeshData:
    """MeshData from host numpy arrays already in Morton order, as CPU
    tensors, with the BVH reach boxes `reach` = (lo, hi), the kernel chunk
    tables (host numpy, rows 9-14 the reach boxes) unless the scene fuses
    its meshes (`fused`), and the BVH node arrays `nodes`, a tuple in
    `BVH_FIELDS` order."""
    t_count = ms.n_tris

    def tensor(a):
        return (None if a is None
                else torch.from_numpy(np.array(a, dtype=np.float32)))

    def index(a):
        return (None if a is None
                else torch.from_numpy(np.array(a, dtype=np.int32)))

    node_min, node_max, skip, real_flag, *leaves = nodes or (None,) * 7
    leaf_start, leaf_count, leaf_tris = leaves
    reach_lo, reach_hi = reach or (None, None)
    return MeshData(
        v=tensor(v), n=tensor(n), uv=tensor(uv), tangent=tensor(tangent),
        bitangent=tensor(bitangent), diffuse_map=tensor(diffuse_map),
        normal_map=tensor(normal_map), specular_map=tensor(specular_map),
        itables=(build_intersect_tables(
            v, tri_chunk=default_tri_chunk(t_count), reach=reach)
            if t_count and not fused else None),
        node_min=tensor(node_min), node_max=tensor(node_max),
        skip=index(skip), real_flag=index(real_flag),
        leaf_start=index(leaf_start), leaf_count=index(leaf_count),
        leaf_tris=index(leaf_tris), reach_lo=tensor(reach_lo),
        reach_hi=tensor(reach_hi),
    )


# The FlatBVH arrays a MeshData keeps, in `mesh_data`'s `nodes` order.
BVH_FIELDS = ("node_min", "node_max", "skip", "real_flag", "leaf_start",
              "leaf_count", "leaf_tris")


def uses_fused_tables(settings: RenderSettings, n_meshes: int) -> bool:
    """Whether a scene's meshes go through the fused tables alone (the
    JAX package's will_fuse): two or more meshes, or any under geometry
    sharding, whose shards are cut from the fused tables."""
    return n_meshes >= 2 or (settings.geo_shard_axis is not None
                             and n_meshes >= 1)


def fused_tables(static: SceneStatic, vs, reach):
    """(fused_itables, fused_shadow_itables) of a scene whose meshes have
    Morton-ordered vertices vs and BVH reach boxes reach = [(lo, hi)]
    (host numpy, scene sub order): both None unless the meshes fuse
    (`uses_fused_tables`); the shadow tables leave out transparent meshes
    (scene.cpp:733-734) and are the fused tables themselves when every
    mesh is opaque (None when every mesh is transparent)."""
    if not uses_fused_tables(static.settings, static.n_meshes):
        return None, None
    clipped = [ms.clipped_by_root for ms in static.meshes]
    ft = build_fused_tables(vs, clipped, reach=reach)
    mesh_mats = [m for k, m in zip(static.obj_kinds, static.mat_types)
                 if k == KIND_MESH]
    opaque = [m != MAT_TRANSPARENT for m in mesh_mats]
    if all(opaque):
        return ft, ft
    return ft, build_fused_tables(vs, clipped, include=opaque, reach=reach)


def build_scene(sd: SceneDef, device=None) -> SceneData:
    """Build the scene tensors on `device` (default: the CUDA device;
    raises without one unless device="cpu" is passed)."""
    device = resolve_device(device)
    st = sd.settings
    f32 = np.float32

    obj_kinds, obj_subs, mat_types = [], [], []
    colors, iors, ambients, diffuses, speculars, nspecs = [], [], [], [], [], []
    sph_pos, sph_r = [], []
    pln_pos, pln_n = [], []
    meshes, mesh_statics, mesh_vs, mesh_reach = [], [], [], []
    # Fused meshes go through the fused tables alone, so the per-mesh
    # chunk tables are not built.
    fused = uses_fused_tables(st, sum(1 for o in sd.objects
                                      if o.kind == "mesh"))

    for o in sd.objects:
        mat_types.append(_MAT_IDS[o.material])
        colors.append(o.color)
        iors.append(o.ior)
        ambients.append(o.ambient)
        diffuses.append(o.diffuse)
        speculars.append(o.specular)
        nspecs.append(o.n_specular)
        if o.kind == "sphere":
            obj_kinds.append(KIND_SPHERE)
            obj_subs.append(len(sph_pos))
            sph_pos.append(o.pos)
            sph_r.append(o.radius)
        elif o.kind == "plane":
            obj_kinds.append(KIND_PLANE)
            obj_subs.append(len(pln_pos))
            pln_pos.append(o.pos)
            # Not normalized: the scene parser assigns `normal=` raw
            # (scene.cpp:299-301), bypassing the Plane ctor.
            pln_n.append(np.asarray(o.normal, dtype=f32))
        elif o.kind == "mesh":
            obj_kinds.append(KIND_MESH)
            obj_subs.append(len(meshes))
            m = o.mesh
            if m is None:
                raise ValueError("mesh object without loaded OBJ (missing name=)")
            t_count = m.n_tris
            v, nrm, uv, tan, bit = m.v, m.n, m.uv, m.tangent, m.bitangent
            clipped = False
            if t_count:
                # Canonical Morton triangle order (scene.py:314-319):
                # triangle ids everywhere downstream are Morton ids, and
                # the BVH is built on this order, so its reach rows line
                # up with the table rows.
                mp = np.asarray(morton_order(v))
                v, nrm, uv, tan, bit = v[mp], nrm[mp], uv[mp], tan[mp], bit[mp]
                clipped = bool(
                    np.any(v.min(axis=(0, 1)) < m.root_bounds[0])
                    or np.any(v.max(axis=(0, 1)) > m.root_bounds[1])
                )
            bvh = build_bvh(v, m.root_bounds, ac_penalty=st.ac_penalty,
                            leaf_chunk=st.leaf_chunk)
            reach = (bvh.reach_lo, bvh.reach_hi)
            ms = MeshStatic(
                n_tris=t_count,
                dmap_wh=tuple(o.diffuse_map_wh) if o.diffuse_map is not None else (0, 0),
                nmap_wh=tuple(o.normal_map_wh) if o.normal_map is not None else (0, 0),
                smap_wh=tuple(o.specular_map_wh) if o.specular_map is not None else (0, 0),
                pmap_wh=_packable_wh([
                    o.diffuse_map_wh if o.diffuse_map is not None else None,
                    o.normal_map_wh if o.normal_map is not None else None,
                    o.specular_map_wh if o.specular_map is not None else None,
                ]),
                clipped_by_root=clipped,
                n_real_nodes=bvh.n_real_nodes,
                tri_copies=bvh.tri_copies,
            )
            mesh_statics.append(ms)
            mesh_vs.append(v)
            mesh_reach.append(reach)
            meshes.append(mesh_data(ms, v, nrm, uv, tan, bit, o.diffuse_map,
                                    o.normal_map, o.specular_map,
                                    reach=reach, fused=fused,
                                    nodes=tuple(getattr(bvh, k)
                                                for k in BVH_FIELDS)))
        else:
            raise ValueError(f"unknown object kind {o.kind}")

    static = SceneStatic(
        settings=st,
        obj_kinds=tuple(obj_kinds),
        obj_subs=tuple(obj_subs),
        mat_types=tuple(mat_types),
        light_kinds=tuple(li.kind for li in sd.lights),
        light_samples=tuple(li.samples for li in sd.lights),
        meshes=tuple(mesh_statics),
        skybox_wh=sd.skybox_wh,
    )

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype)

    lights = tuple(
        LightData(
            color=t(li.color), intensity=t(li.intensity),
            # Not normalized: `direction=` is assigned raw by the parser
            # (scene.cpp:219-223), bypassing the DistantLight ctor.
            dir=t(li.dir), pos=t(li.pos), ivec=t(li.i), jvec=t(li.j),
            kind=li.kind, samples=li.samples,
        )
        for li in sd.lights
    )
    no = len(sd.objects)
    scale = np.tan(f32(st.fov) * f32(0.5) / f32(180.0) * f32(np.pi))
    ft, fts = fused_tables(static, mesh_vs, mesh_reach)
    scene = SceneData(
        cam_pos=t(np.asarray(sd.cam_pos, f32)),
        cam_rmat=t(euler_matrix(sd.cam_rot)),
        scale=t(np.asarray(scale, f32)),
        bg_color=t(np.asarray(st.background_color, f32)),
        bias=t(np.asarray(st.bias, f32)),
        obj_color=t(np.asarray(colors, f32).reshape(no, 3)),
        obj_ior=t(np.asarray(iors, f32)),
        obj_ambient=t(np.asarray(ambients, f32)),
        obj_diffuse=t(np.asarray(diffuses, f32)),
        obj_specular=t(np.asarray(speculars, f32)),
        obj_nspec=t(np.asarray(nspecs, f32)),
        mat_type=t(np.asarray(mat_types, np.int32), torch.int32),
        sph_pos=t(np.asarray(sph_pos, f32).reshape(len(sph_pos), 3)),
        sph_r=t(np.asarray(sph_r, f32)),
        pln_pos=t(np.asarray(pln_pos, f32).reshape(len(pln_pos), 3)),
        pln_n=t(np.asarray(pln_n, f32).reshape(len(pln_n), 3)),
        meshes=tuple(meshes),
        lights=lights,
        skybox=t(sd.skybox) if sd.skybox is not None else None,
        fused_itables=ft,
        fused_shadow_itables=fts,
        static=static,
    )
    with span("rt.sync.upload"):
        if st.geo_shard_axis is not None:
            return to_keeping_host_tables(scene, device)
        return scene.to(device)


# MeshData fields that grow with the mesh's triangles (the BVH arrays
# and reach boxes with them).
PER_TRIANGLE = ("v", "n", "uv", "tangent", "bitangent", *BVH_FIELDS,
                "reach_lo", "reach_hi")


def to_keeping_host_tables(scene: SceneData, device) -> SceneData:
    """scene.to(device) with every per-triangle tensor (`PER_TRIANGLE`
    and the fused tables) left where it is, in host memory: a scene
    built for geometry sharding stages on a card only the shards that a
    rank cuts from them (`parallel.geoshard.prepare_geo_scene`; JAX
    `build_fused_tables(as_numpy=True)`)."""
    heavy = [{k: getattr(m, k) for k in PER_TRIANGLE} for m in scene.meshes]
    light = dataclasses.replace(
        scene, fused_itables=None, fused_shadow_itables=None,
        meshes=tuple(dataclasses.replace(m, **{k: None for k in PER_TRIANGLE})
                     for m in scene.meshes)).to(device)
    return dataclasses.replace(
        light, fused_itables=scene.fused_itables,
        fused_shadow_itables=scene.fused_shadow_itables,
        meshes=tuple(dataclasses.replace(m, **h)
                     for m, h in zip(light.meshes, heavy)))


def load_scene(path: str, base_settings: RenderSettings | None = None,
               device=None) -> SceneData:
    """Parse a `.scene` file and build it on `device` (the `Scene(path)`
    constructor's counterpart; default: the CUDA device). In a recorded
    trace the load is the span `rt.scene.load`, holding `rt.scene.parse`
    (the OBJ loads `rt.scene.obj` inside it), the BVH builds
    `rt.scene.bvh`, the tables `rt.scene.tables` and the copy to the
    device `rt.sync.upload`."""
    device = resolve_device(device)
    with span("rt.scene.load"):
        with span("rt.scene.parse"):
            sd = parse_scene(path, base_settings)
        return build_scene(sd, device=device)
