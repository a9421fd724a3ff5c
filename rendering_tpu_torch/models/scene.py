"""Scene tensors — the port's counterpart of `rendering_tpu.models.scene`.

The scene is a dataclass of tensors with a `.to(device)`: spheres and
planes as (N, 3) tables, each mesh as Morton-ordered per-triangle
arrays plus its (30, T) gather table and kernel chunk tables, lights as
small per-light records. Everything that decides shapes or branches
lives in `SceneStatic`.

Material enum order matches the reference (include/objects.h:17):
0=Diffuse, 1=Reflective, 2=Transparent, 3=Phong.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from rendering_tpu_torch.accel.bvh import morton_order
from rendering_tpu_torch.device import resolve_device
from rendering_tpu_torch.models.objloader import euler_matrix
from rendering_tpu_torch.models.parser import SceneDef
from rendering_tpu_torch.models.settings import RenderSettings
from rendering_tpu_torch.ops.cuda_intersect import (
    IntersectTables,
    build_intersect_tables,
    default_tri_chunk,
)

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
    # The mesh pokes outside the reference's root box; only then does
    # intersection need the root filter (a later slice).
    clipped_by_root: bool = False

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
    # One transposed gather table, component-major: rows 0-8 vertices,
    # 9-17 vertex normals, 18-23 uvs, 24-26 tangent, 27-29 bitangent.
    vgeoT: torch.Tensor      # (30, T)
    diffuse_map: Optional[torch.Tensor]   # (Hd*Wd, 3) or None
    normal_map: Optional[torch.Tensor]    # (Hn*Wn, 3) or None
    specular_map: Optional[torch.Tensor]  # (Hs*Ws, 1) or None
    # Packed transposed maps (7, W*H): diffuse rgb | normal xyz |
    # specular, zero rows for absent maps; None unless pmap_wh is set.
    mapsT: Optional[torch.Tensor]
    itables: Optional[IntersectTables]    # None for a mesh without triangles


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
    static: SceneStatic = None

    @property
    def device(self) -> torch.device:
        return self.cam_pos.device


def _packable_wh(whs) -> tuple[int, int]:
    """Shared (W, H) if >= 2 of a mesh's maps exist (given as their
    (W, H), None when absent) with identical dims, else (0, 0)."""
    whs = [tuple(wh) for wh in whs if wh is not None]
    if len(whs) >= 2 and all(wh == whs[0] for wh in whs):
        return whs[0]
    return (0, 0)


def mesh_data(ms: MeshStatic, v, n, uv, tangent, bitangent,
              diffuse_map=None, normal_map=None, specular_map=None) -> MeshData:
    """MeshData from host numpy arrays already in Morton order: builds
    the (30, T) gather table, the packed map table and the kernel chunk
    tables (host numpy), all as CPU tensors."""
    t_count = ms.n_tris
    f32 = np.float32
    vgeoT = np.concatenate([
        np.asarray(v, f32).reshape(t_count, 9).T,
        np.asarray(n, f32).reshape(t_count, 9).T,
        np.asarray(uv, f32).reshape(t_count, 6).T,
        np.asarray(tangent, f32).T,
        np.asarray(bitangent, f32).T,
    ], axis=0)
    mapsT = None
    if ms.has_packed_maps:
        n_tex = ms.pmap_wh[0] * ms.pmap_wh[1]
        z3 = np.zeros((3, n_tex), f32)
        mapsT = np.concatenate([
            np.asarray(diffuse_map, f32).T if diffuse_map is not None else z3,
            np.asarray(normal_map, f32).T if normal_map is not None else z3,
            (np.asarray(specular_map, f32).reshape(1, n_tex)
             if specular_map is not None else z3[:1]),
        ], axis=0)

    def tensor(a):
        return None if a is None else torch.from_numpy(np.array(a, dtype=f32))

    return MeshData(
        v=tensor(v), n=tensor(n), uv=tensor(uv), tangent=tensor(tangent),
        bitangent=tensor(bitangent), vgeoT=tensor(vgeoT),
        diffuse_map=tensor(diffuse_map), normal_map=tensor(normal_map),
        specular_map=tensor(specular_map), mapsT=tensor(mapsT),
        itables=(build_intersect_tables(
            v, tri_chunk=default_tri_chunk(t_count)) if t_count else None),
    )


def check_supported(static: SceneStatic) -> None:
    """Raise NotImplementedError for scene features whose kernels or
    modules have not been ported yet, rather than render something
    else."""
    if static.n_meshes >= 2:
        raise NotImplementedError(
            "scenes with two or more meshes need the fused multi-mesh "
            "intersection (pallas_intersect.intersect_fused, K5), which "
            "comes with the multi-mesh slice of the port"
        )
    st = static.settings
    if st.use_ac and any(ms.clipped_by_root for ms in static.meshes):
        raise NotImplementedError(
            "a mesh clipped by the reference's root box needs the "
            "kernel's root filter (K4) and the SAH BVH reach boxes, which "
            "come with the scene-file slice of the port"
        )


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
    meshes, mesh_statics = [], []

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
                # triangle ids everywhere downstream are Morton ids.
                mp = np.asarray(morton_order(v))
                v, nrm, uv, tan, bit = v[mp], nrm[mp], uv[mp], tan[mp], bit[mp]
                clipped = bool(
                    np.any(v.min(axis=(0, 1)) < m.root_bounds[0])
                    or np.any(v.max(axis=(0, 1)) > m.root_bounds[1])
                )
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
            )
            mesh_statics.append(ms)
            meshes.append(mesh_data(ms, v, nrm, uv, tan, bit, o.diffuse_map,
                                    o.normal_map, o.specular_map))
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
    check_supported(static)

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
        static=static,
    )
    return scene.to(device)
