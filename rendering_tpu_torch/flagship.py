"""Benchmark scenes — `rendering_tpu.flagship.build_flagship_scene`,
`build_tiny_scene` and `build_multimesh_scene` for the port.

The flagship workload is shotgun.scene: a 3840x1080 phong mesh with
diffuse, normal and specular maps, one point and one distant light. The
mesh is the deterministic procedural stand-in (a bumpy sphere of n_tris
triangles, 250k by default); loading the real OBJ comes with the CLI
slice. The multi-mesh scene is a grid of procedural meshes over a floor
plane, the workload of the fused intersection (K5).
"""

from __future__ import annotations

import os

import numpy as np

from rendering_tpu_torch.models.objloader import MeshArrays
from rendering_tpu_torch.models.parser import (
    LightDef,
    ObjectDef,
    SceneDef,
    decode_normal_map,
    decode_specular_map,
)
from rendering_tpu_torch.models.scene import SceneData, build_scene
from rendering_tpu_torch.models.settings import RenderSettings
from rendering_tpu_torch.utils.bmp import load_bmp_float

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def procedural_mesh(n_tris: int, pos, size, seed: int = 0) -> MeshArrays:
    """Deterministic bumpy-sphere triangle soup with UVs and smooth
    normals, already in world space (like a loaded, transformed OBJ)."""
    rows = max(2, int(np.sqrt(n_tris / 2)))
    cols = max(2, n_tris // (2 * rows) + 1)
    th = np.linspace(0.12, np.pi - 0.12, rows + 1)
    ph = np.linspace(0, 2 * np.pi, cols + 1)
    T, P = np.meshgrid(th, ph, indexing="ij")
    bump = 1.0 + 0.08 * np.sin(5 * T + seed) * np.cos(7 * P)
    x = bump * np.sin(T) * np.cos(P)
    y = bump * np.cos(T)
    z = bump * np.sin(T) * np.sin(P)
    verts = np.stack([x, y, z], -1).astype(np.float32)  # (rows+1, cols+1, 3)
    uv = np.stack([P / (2 * np.pi), T / np.pi], -1).astype(np.float32)

    # Quads (i, j) row-major, two triangles each: [a, b, c] and [a, c, d]
    # with a = (i, j), b = (i+1, j), c = (i+1, j+1), d = (i, j+1).
    a_v, b_v = verts[:-1, :-1], verts[1:, :-1]
    c_v, d_v = verts[1:, 1:], verts[:-1, 1:]
    a_t, b_t = uv[:-1, :-1], uv[1:, :-1]
    c_t, d_t = uv[1:, 1:], uv[:-1, 1:]
    # Whole quads until n_tris is reached (an odd count gets one more).
    keep = min(2 * -(-n_tris // 2), 2 * rows * cols)
    v = np.stack([np.stack([a_v, b_v, c_v], -2),
                  np.stack([a_v, c_v, d_v], -2)], 2).reshape(-1, 3, 3)[:keep]
    tuv = np.stack([np.stack([a_t, b_t, c_t], -2),
                    np.stack([a_t, c_t, d_t], -2)], 2).reshape(-1, 3, 2)[:keep]

    size = np.asarray(size, np.float32)
    pos = np.asarray(pos, np.float32)
    v = v * (size / 2.0) + pos
    # smooth normals = sphere direction at each vertex (unit-ish)
    n = (v - pos) / (size / 2.0)

    # Root bounds contain the bumps (|bump| <= 1.08, 1.0801 covers its
    # f32 rounding), so the mesh is never clipped by its root box.
    bound = np.float32(1.0801) * size / 2.0

    edge1 = v[:, 1] - v[:, 0]
    edge2 = v[:, 2] - v[:, 0]
    duv1 = tuv[:, 1] - tuv[:, 0]
    duv2 = tuv[:, 2] - tuv[:, 0]
    with np.errstate(divide="ignore", invalid="ignore"):
        f = 1.0 / (duv1[:, 0] * duv2[:, 1] - duv2[:, 0] * duv1[:, 1])
        tangent = np.nan_to_num(
            f[:, None] * (duv2[:, 1:2] * edge1 - duv1[:, 1:2] * edge2)
        ).astype(np.float32)
        bitangent = np.nan_to_num(
            f[:, None] * (-duv2[:, 0:1] * edge1 + duv1[:, 0:1] * edge2)
        ).astype(np.float32)
    bounds = np.stack([pos - bound, pos + bound]).astype(np.float32)
    return MeshArrays(
        v=v, n=n.astype(np.float32), uv=tuv, tangent=tangent,
        bitangent=bitangent, root_bounds=bounds,
    )


def _maps(prefix: str):
    """The committed synthesized maps (tests/assets/maps) through the
    parser's texel decoders; {} when they are absent."""
    base = os.path.join(REPO, "tests", "assets", "maps")
    out = {}
    for kind in ("diffuse", "normal", "specular"):
        path = os.path.join(base, f"{prefix}_{kind}.bmp")
        if not os.path.exists(path):
            return {}
        data = load_bmp_float(path)
        h, w = data.shape[:2]
        flat = data.reshape(h * w, 3)
        if kind == "normal":
            flat = decode_normal_map(flat)
        elif kind == "specular":
            flat = decode_specular_map(flat)
        out[kind] = (flat, (w, h))
    return out


def build_flagship_scene(
    width: int = 3840,
    height: int = 1080,
    n_tris: int | None = None,
    enable_ssaa: bool = False,
    with_maps: bool = True,
    settings_overrides: dict | None = None,
    device=None,
) -> SceneData:
    """shotgun.scene workload: phong mesh + point/distant lights, with
    the procedural mesh of n_tris (default 250k) triangles. Runs on the
    CUDA device unless `device` says otherwise."""
    st = RenderSettings(
        width=width, height=height, ac_penalty=3,
        background_color=(0.52, 0.8, 0.92), enable_ssaa=enable_ssaa,
        enable_output=False, output_progress=False,
        image_name="shotgun_bench",
    )
    if settings_overrides:
        st = st.replace(**settings_overrides)
    sd = SceneDef(settings=st)
    sd.lights = [
        LightDef("point", color=(1, 1, 1), intensity=1.0, pos=(0, 0, 0)),
        LightDef("distant", color=(1, 1, 1), intensity=0.2, dir=(0.3, 0, -1)),
    ]
    obj = ObjectDef(
        "mesh", pos=(-0.1, 0, -0.6), size=(2, 2, 2), color=(1, 1, 1),
        rot=(0, 100, 0), material="phong", ambient=0.4, diffuse=0.1,
        specular=0.7, n_specular=10.0,
    )
    obj.mesh = procedural_mesh(n_tris or 250_000, pos=(-0.1, 0, -0.6),
                               size=(2, 2, 2))
    if with_maps:
        maps = _maps("shotgun")
        if maps:
            obj.diffuse_map, obj.diffuse_map_wh = maps["diffuse"]
            obj.normal_map, obj.normal_map_wh = maps["normal"]
            obj.specular_map, obj.specular_map_wh = maps["specular"]
    sd.objects = [obj]
    return build_scene(sd, device=device)


def build_tiny_scene(width: int = 64, height: int = 32, n_tris: int = 128,
                     settings_overrides: dict | None = None,
                     device=None) -> SceneData:
    """The JAX package's tiny multi-material scene: a plane, a phong
    procedural mesh of n_tris triangles, and a transparent, a reflective
    and a diffuse sphere (all four materials); a point, a distant and an
    area light (2x2 samples); max_ray_depth 4. Runs on the CUDA device
    unless `device` says otherwise."""
    st = RenderSettings(
        width=width, height=height, max_ray_depth=4, enable_ssaa=False,
        enable_output=False, output_progress=False,
        background_color=(0.2, 0.25, 0.3),
    )
    if settings_overrides:
        st = st.replace(**settings_overrides)
    sd = SceneDef(settings=st)
    sd.lights = [
        LightDef("point", color=(1, 0.9, 0.8), intensity=0.7, pos=(0, 2, -1)),
        LightDef("distant", color=(1, 1, 1), intensity=0.3,
                 dir=(0.2, -1, -0.4)),
        LightDef("area", color=(1, 1, 1), intensity=40.0, pos=(0, 3, -3),
                 i=(1.5, 0, 0), j=(0, 0, 1.5), samples=2),
    ]
    mesh_obj = ObjectDef(
        "mesh", pos=(0.8, 0.1, -3), size=(1.4, 1.4, 1.4), color=(1, 1, 1),
        material="phong", ambient=0.4, diffuse=0.1, specular=0.7,
        n_specular=10.0,
    )
    mesh_obj.mesh = procedural_mesh(n_tris, pos=(0.8, 0.1, -3),
                                    size=(1.4, 1.4, 1.4))
    sd.objects = [
        ObjectDef("plane", pos=(0, -1.5, 0), normal=(0, 1, 0),
                  color=(0.85, 0.85, 0.85)),
        mesh_obj,
        ObjectDef("sphere", pos=(-1.0, 0, -2.5), radius=0.6, color=(1, 1, 1),
                  material="transparent", ior=1.4),
        ObjectDef("sphere", pos=(-0.2, 0.8, -4), radius=0.8, color=(1, 1, 1),
                  material="reflective"),
        ObjectDef("sphere", pos=(1.8, -0.6, -2.2), radius=0.4,
                  color=(0.9, 0.3, 0.2)),
    ]
    return build_scene(sd, device=device)


def build_multimesh_scene(
    width: int = 1920,
    height: int = 1080,
    n_meshes: int = 16,
    tris_per_mesh: int = 5000,
    settings_overrides: dict | None = None,
    device=None,
) -> SceneData:
    """N-mesh scene: a grid of procedural bumpy spheres (tris_per_mesh
    triangles each, seeded by their index) over a floor plane, point and
    distant lights, phong shading — the JAX package's scene of the same
    name with its procedural meshes, in the same layout, colours,
    rotations and seeds. The variant with the bunny OBJ at every grid
    position comes with the scene-file slice (it needs `load_obj` and the
    reference assets). Runs on the CUDA device unless `device` says
    otherwise."""
    st = RenderSettings(
        width=width, height=height, ac_penalty=3,
        background_color=(0.52, 0.8, 0.92), enable_ssaa=False,
        enable_output=False, output_progress=False,
        image_name="multimesh_bench",
    )
    if settings_overrides:
        st = st.replace(**settings_overrides)
    sd = SceneDef(settings=st)
    sd.lights = [
        LightDef("point", color=(1, 1, 1), intensity=1.0, pos=(0, 2, 0)),
        LightDef("distant", color=(1, 1, 1), intensity=0.25,
                 dir=(0.3, -0.4, -1)),
    ]
    cols = max(1, int(np.ceil(np.sqrt(n_meshes))))
    rows = -(-n_meshes // cols)
    objects = [
        ObjectDef("plane", pos=(0, -1.2, 0), normal=(0, 1, 0),
                  color=(0.85, 0.85, 0.85)),
    ]
    size = 1.1
    for k in range(n_meshes):
        r, c = divmod(k, cols)
        pos = (
            (c - (cols - 1) / 2.0) * 1.4,
            (r - (rows - 1) / 2.0) * 1.3,
            -3.0 - 0.45 * ((r + c) % 3),
        )
        obj = ObjectDef(
            "mesh", pos=pos, size=(size, size, size),
            color=(0.4 + 0.6 * ((k * 7) % 5) / 4.0,
                   0.4 + 0.6 * ((k * 3) % 5) / 4.0,
                   0.4 + 0.6 * ((k * 11) % 5) / 4.0),
            rot=(0.0, float((k * 37) % 360), 0.0),
            material="phong", ambient=0.3, diffuse=0.4, specular=0.3,
            n_specular=12.0,
        )
        obj.mesh = procedural_mesh(tris_per_mesh, pos=pos,
                                   size=(size, size, size), seed=k)
        objects.append(obj)
    sd.objects = objects
    return build_scene(sd, device=device)
