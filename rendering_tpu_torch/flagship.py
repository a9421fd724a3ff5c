"""Benchmark scenes — `rendering_tpu.flagship.build_flagship_scene`,
`build_tiny_scene` and `build_multimesh_scene` for the port, with
`densify_mesh`.

The flagship workload is shotgun.scene: a 3840x1080 phong mesh with
diffuse, normal and specular maps, one point and one distant light. The
mesh is the reference's shotgun.obj when the environment's REFERENCE_DIR
holds the reference assets (as loaded, or densified to n_tris triangles
with `real_geometry=True`), else the deterministic procedural stand-in (a
bumpy sphere of n_tris triangles, 250k by default). The multi-mesh scene
is a grid of bunny.obj instances, or of procedural meshes, over a floor
plane: the workload of the fused intersection (K5).
"""

from __future__ import annotations

import os

import numpy as np

from rendering_tpu_torch.models.objloader import MeshArrays, load_obj
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
# The reference assets (input/objects/*.obj) live under the environment's
# REFERENCE_DIR. Unset, the builders take the procedural meshes: which
# mesh a scene gets never depends on a directory found by default.
REFERENCE_DIR = os.environ.get("REFERENCE_DIR")


def reference_obj(name: str) -> str | None:
    """Path of the reference asset input/objects/<name> under
    REFERENCE_DIR, or None when REFERENCE_DIR is unset or lacks it."""
    if not REFERENCE_DIR:
        return None
    path = os.path.join(REFERENCE_DIR, "input", "objects", name)
    return path if os.path.exists(path) else None


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


def _subdiv_bary(level: int) -> np.ndarray:
    """Barycentric corner weights of the 4**level equal subtriangles of
    a triangle (midpoint lattice): (4**level, 3 corners, 3 weights over
    the parent's A/B/C)."""
    n = 1 << level
    tris = []
    for i in range(n):
        for j in range(n - i):
            # up-triangle (i, j), (i+1, j), (i, j+1)
            tris.append(((i, j), (i + 1, j), (i, j + 1)))
            if i + j < n - 1:
                # down-triangle (i+1, j), (i+1, j+1), (i, j+1)
                tris.append(((i + 1, j), (i + 1, j + 1), (i, j + 1)))
    out = np.zeros((len(tris), 3, 3), np.float64)
    for t, corners in enumerate(tris):
        for c, (i, j) in enumerate(corners):
            a = 1.0 - (i + j) / n
            out[t, c] = (a, i / n, j / n)
    assert out.shape[0] == 4**level
    return out


def _displace_noise(p: np.ndarray) -> np.ndarray:
    """Deterministic smooth pseudo-noise in [-1, 1] of world position
    (..., 3) — a position function, so triangle-soup vertices that
    share a position displace identically (no cracks on smooth
    surfaces)."""
    acc = np.zeros(p.shape[:-1], np.float64)
    wsum = 0.0
    for f, w in ((9.0, 1.0), (23.0, 0.5), (57.0, 0.25)):
        acc += w * (
            np.sin(f * p[..., 0] + 1.7)
            * np.sin(f * p[..., 1] + 2.3)
            * np.sin(f * p[..., 2] + 3.1)
        )
        wsum += w
    return acc / wsum


def _displace_noise3(p: np.ndarray) -> np.ndarray:
    """VECTOR position-noise in [-1, 1]^3 of world position (..., 3):
    three phase-shifted copies of _displace_noise. A pure function of
    position, unlike displacement along interpolated shading normals —
    two soup triangles meeting at a crease carry different corner
    normals at the shared position, so a normal-directed displacement
    would tear every crease open; a position-pure vector field cannot
    (coincident vertices move identically, wherever they came from)."""
    return np.stack(
        [
            _displace_noise(p),
            _displace_noise(p + np.asarray([11.3, -7.1, 5.9])),
            _displace_noise(p + np.asarray([-3.7, 13.1, -9.3])),
        ],
        axis=-1,
    )


def _split_bary(level: int, mask) -> np.ndarray:
    """_subdiv_bary(level) with GREEN closure: parent edges marked in
    `mask` (edge k = the edge opposite parent corner k, where weight k
    vanishes) face a level+1 neighbor, so every subtriangle edge lying
    on a marked parent edge is bisected at its midpoint — the coarse
    side then carries exactly the finer side's 2**(level+1) boundary
    nodes and the displaced surface stays watertight (no T-junction
    cracks). Returns (S, 3 corners, 3 weights)."""
    base = _subdiv_bary(level)
    if not any(mask):
        return base

    def on_marked(b0, b1):
        # local edge (b0, b1) lies on marked parent edge k iff the
        # weight of corner k vanishes at both endpoints
        return any(mask[k] and b0[k] == 0.0 and b1[k] == 0.0
                   for k in range(3))

    out = []
    for tri in base:  # (3 corners, 3 weights)
        marked = [
            i for i in range(3)
            if on_marked(tri[i], tri[(i + 1) % 3])
        ]
        if not marked:
            out.append(tri)
            continue
        if len(marked) == 3:  # level 0 corner case: full 4-way split
            c0, c1, c2 = tri
            m01, m12, m20 = 0.5 * (c0 + c1), 0.5 * (c1 + c2), 0.5 * (c2 + c0)
            out += [np.stack(t) for t in
                    ((c0, m01, m20), (m01, c1, m12),
                     (m20, m12, c2), (m01, m12, m20))]
            continue
        # rotate local indices so the marked edges are e0 (and e1)
        rot = {(0,): 0, (1,): 1, (2,): 2,
               (0, 1): 0, (1, 2): 1, (0, 2): 2}[tuple(marked)]
        c0, c1, c2 = tri[rot], tri[(rot + 1) % 3], tri[(rot + 2) % 3]
        m01 = 0.5 * (c0 + c1)
        if len(marked) == 1:
            out += [np.stack(t) for t in ((c0, m01, c2), (m01, c1, c2))]
        else:  # marked e0 and e1 (sharing corner c1)
            m12 = 0.5 * (c1 + c2)
            out += [np.stack(t) for t in
                    ((c0, m01, c2), (m01, c1, m12), (m01, m12, c2))]
    return np.stack(out)


def densify_mesh(mesh: MeshArrays, target_tris: int,
                 displace_frac: float = 0.004) -> MeshArrays:
    """Subdivide + displace a real mesh to ~target_tris triangles (the
    JAX package's function of the same name, bit for bit): the 250k
    benchmark on real geometry, not a best-case-coherence procedural
    sphere.

    Midpoint 4-way subdivision preserves the surface EXACTLY (thin
    features, self-occlusion and silhouettes are the loaded asset's);
    per-triangle levels are area-prioritized so big flat faces carry
    the extra resolution and slivers are not over-split, and
    level-(base) triangles adjacent to level-(base+1) ones get GREEN
    bisections along the shared edges (_split_bary) so no T-junction
    survives. Vertices then displace by a smooth VECTOR position-noise
    of amplitude displace_frac * bbox diagonal — real high-frequency
    relief so chunk AABBs cannot collapse onto an idealized smooth
    surface, and pure-of-position so coincident soup vertices move
    identically (watertight input stays watertight; shading normals
    stay the asset's smooth normals). Root bounds expand to contain
    the displaced mesh (clipped_by_root stays False, like the
    procedural flagship)."""
    t0 = int(mesh.v.shape[0])
    if t0 == 0 or target_tris <= t0:
        return mesh
    v32 = np.asarray(mesh.v, np.float32)
    v = v32.astype(np.float64)
    n = np.asarray(mesh.n, np.float64)
    uv = np.asarray(mesh.uv, np.float64)

    # Base level for everyone, plus one extra level for the
    # largest-area triangles until the total reaches target.
    base = 0
    while t0 * 4 ** (base + 1) <= target_tris:
        base += 1
    area2 = np.linalg.norm(
        np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]), axis=1
    )
    promote_n = min(
        t0, (target_tris - t0 * 4**base) // max(4 ** (base + 1) - 4**base, 1)
    )
    order = np.argsort(-area2, kind="stable")
    levels = np.full((t0,), base, np.int32)
    levels[order[:promote_n]] = base + 1

    # Edge adjacency over EXACT f32 corner positions (the OBJ loader
    # emits soup from indexed vertices, so shared corners are
    # bit-identical): which of each coarse triangle's 3 edges face a
    # promoted neighbor. mask[k] = edge opposite corner k.
    corner_keys = [
        [v32[t, c].tobytes() for c in range(3)] for t in range(t0)
    ]
    edge_tris: dict = {}
    for t in range(t0):
        for k in range(3):
            a, b = corner_keys[t][(k + 1) % 3], corner_keys[t][(k + 2) % 3]
            edge_tris.setdefault((min(a, b), max(a, b)), []).append(t)
    masks = np.zeros((t0, 3), bool)
    if 0 < promote_n < t0:
        for t in range(t0):
            if levels[t] > base:
                continue
            for k in range(3):
                a, b = (corner_keys[t][(k + 1) % 3],
                        corner_keys[t][(k + 2) % 3])
                masks[t, k] = any(
                    levels[j] > base
                    for j in edge_tris[(min(a, b), max(a, b))] if j != t
                )

    outs_v, outs_n, outs_uv, outs_t, outs_b = [], [], [], [], []
    group_key = [(int(levels[t]), tuple(masks[t])) for t in range(t0)]
    for key in sorted(set(group_key)):
        lv, mask = key
        sel = np.asarray([g == key for g in group_key])
        bary = _split_bary(lv, mask)  # (S, 3, 3)
        # (T, S, 3c, 3d) = bary (S, 3c, 3w) x v[sel] (T, 3w, 3d)
        sub_v = np.einsum("scw,twd->tscd", bary, v[sel])
        sub_n = np.einsum("scw,twd->tscd", bary, n[sel])
        sub_uv = np.einsum("scw,twd->tscd", bary, uv[sel])
        s = bary.shape[0]
        outs_v.append(sub_v.reshape(-1, 3, 3))
        outs_n.append(sub_n.reshape(-1, 3, 3))
        outs_uv.append(sub_uv.reshape(-1, 3, 2))
        outs_t.append(np.repeat(np.asarray(mesh.tangent)[sel], s, axis=0))
        outs_b.append(np.repeat(np.asarray(mesh.bitangent)[sel], s, axis=0))
    v_out = np.concatenate(outs_v)
    n_out = np.concatenate(outs_n)
    uv_out = np.concatenate(outs_uv)

    # Displace by the vector position-noise (pure function of the
    # undisplaced position: watertightness-preserving, crease-safe).
    lo = v.reshape(-1, 3).min(axis=0)
    hi = v.reshape(-1, 3).max(axis=0)
    amp = displace_frac * float(np.linalg.norm(hi - lo))
    v_out = v_out + amp * _displace_noise3(v_out)

    v_out = v_out.astype(np.float32)
    dlo = v_out.reshape(-1, 3).min(axis=0) - np.float32(1e-3)
    dhi = v_out.reshape(-1, 3).max(axis=0) + np.float32(1e-3)
    return MeshArrays(
        v=v_out,
        n=n_out.astype(np.float32),
        uv=uv_out.astype(np.float32),
        tangent=np.concatenate(outs_t).astype(np.float32),
        bitangent=np.concatenate(outs_b).astype(np.float32),
        root_bounds=np.stack([dlo, dhi]),
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
    real_geometry: bool = False,
    settings_overrides: dict | None = None,
    device=None,
) -> SceneData:
    """shotgun.scene workload: phong mesh + point/distant lights,
    ac_penalty=3. The mesh is the reference's shotgun.obj as loaded when
    n_tris is None and the asset exists under REFERENCE_DIR; shotgun.obj
    densified to ~n_tris triangles (`densify_mesh`) when real_geometry
    is set, n_tris given and the asset exists; else the procedural mesh of
    n_tris (default 250k) triangles. Runs on the CUDA device unless
    `device` says otherwise."""
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
    shotgun_obj = reference_obj("shotgun.obj")
    if n_tris is None and shotgun_obj:
        obj.mesh = load_obj(shotgun_obj, obj.size, obj.rot, obj.pos,
                            bias=st.bias)
    elif real_geometry and n_tris and shotgun_obj:
        obj.mesh = densify_mesh(
            load_obj(shotgun_obj, obj.size, obj.rot, obj.pos, bias=st.bias),
            n_tris,
        )
    else:
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
    tris_per_mesh: int | None = None,
    max_ray_depth: int = 10,
    settings_overrides: dict | None = None,
    device=None,
) -> SceneData:
    """N-mesh scene, the JAX package's of the same name (layout, colours,
    rotations, seeds): a grid of meshes over a floor plane, point and
    distant lights, phong shading. Each grid cell holds the reference's
    bunny.obj when tris_per_mesh is None and the asset exists under
    REFERENCE_DIR, else a procedural bumpy sphere of tris_per_mesh (default
    5000) triangles seeded by its index. JAX's `bake_per_mesh_tables` has
    no counterpart: the port's multi-mesh scenes always take the fused
    tables. Runs on the CUDA device unless `device` says otherwise."""
    st = RenderSettings(
        width=width, height=height, ac_penalty=3,
        background_color=(0.52, 0.8, 0.92), enable_ssaa=False,
        enable_output=False, output_progress=False,
        max_ray_depth=max_ray_depth, image_name="multimesh_bench",
    )
    if settings_overrides:
        st = st.replace(**settings_overrides)
    sd = SceneDef(settings=st)
    sd.lights = [
        LightDef("point", color=(1, 1, 1), intensity=1.0, pos=(0, 2, 0)),
        LightDef("distant", color=(1, 1, 1), intensity=0.25,
                 dir=(0.3, -0.4, -1)),
    ]
    bunny_obj = reference_obj("bunny.obj")
    use_bunny = tris_per_mesh is None and bunny_obj is not None
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
        if use_bunny:
            obj.mesh = load_obj(bunny_obj, obj.size, obj.rot, obj.pos,
                                bias=st.bias)
        else:
            obj.mesh = procedural_mesh(tris_per_mesh or 5000, pos=pos,
                                       size=(size, size, size), seed=k)
        objects.append(obj)
    sd.objects = objects
    return build_scene(sd, device=device)
