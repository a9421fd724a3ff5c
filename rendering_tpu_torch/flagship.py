"""Flagship benchmark scene — `rendering_tpu.flagship.build_flagship_scene`
for the port.

The workload is shotgun.scene: a 3840x1080 phong mesh with diffuse,
normal and specular maps, one point and one distant light. The mesh is
the deterministic procedural stand-in (a bumpy sphere of n_tris
triangles, 250k by default); loading the real OBJ comes with the CLI
slice.
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
        width=width, height=height, background_color=(0.52, 0.8, 0.92),
        enable_ssaa=enable_ssaa,
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
