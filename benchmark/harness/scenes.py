"""A configuration and a seed as the inputs both sides read: a scene
description with the mesh arrays made from the seed (`describe`), the
same written as `.scene`, OBJ and BMP files (`write_scene_files`), and
the program's SceneDef of a description (`program_scene`).

The procedural mesh is the benchmark's own frozen copy of the port's
flagship stand-in for the 250,000-triangle shotgun model
(`flagship.procedural_mesh`): a bumpy sphere of n_tris triangles with
UVs, smooth normals and tangents, in world space; the seed sets the
phase of its bumps.
"""

from __future__ import annotations

import copy
import os
import shutil

import numpy as np

F32 = np.float32


def procedural_mesh(n_tris: int, pos, size, phase: float) -> dict:
    rows = max(2, int(np.sqrt(n_tris / 2)))
    cols = max(2, n_tris // (2 * rows) + 1)
    th = np.linspace(0.12, np.pi - 0.12, rows + 1)
    ph = np.linspace(0, 2 * np.pi, cols + 1)
    T, P = np.meshgrid(th, ph, indexing="ij")
    bump = 1.0 + 0.08 * np.sin(5 * T + phase) * np.cos(7 * P)
    verts = np.stack([bump * np.sin(T) * np.cos(P), bump * np.cos(T),
                      bump * np.sin(T) * np.sin(P)], -1).astype(F32)
    uv = np.stack([P / (2 * np.pi), T / np.pi], -1).astype(F32)
    a_v, b_v, c_v, d_v = (verts[:-1, :-1], verts[1:, :-1], verts[1:, 1:],
                          verts[:-1, 1:])
    a_t, b_t, c_t, d_t = uv[:-1, :-1], uv[1:, :-1], uv[1:, 1:], uv[:-1, 1:]
    keep = min(2 * -(-n_tris // 2), 2 * rows * cols)
    v = np.stack([np.stack([a_v, b_v, c_v], -2),
                  np.stack([a_v, c_v, d_v], -2)], 2).reshape(-1, 3, 3)[:keep]
    tuv = np.stack([np.stack([a_t, b_t, c_t], -2),
                    np.stack([a_t, c_t, d_t], -2)], 2).reshape(-1, 3, 2)[:keep]
    size = np.asarray(size, F32)
    pos = np.asarray(pos, F32)
    v = v * (size / 2.0) + pos
    n = (v - pos) / (size / 2.0)
    bound = F32(1.0801) * size / 2.0
    e1, e2 = v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
    d1, d2 = tuv[:, 1] - tuv[:, 0], tuv[:, 2] - tuv[:, 0]
    with np.errstate(divide="ignore", invalid="ignore"):
        f = 1.0 / (d1[:, 0] * d2[:, 1] - d2[:, 0] * d1[:, 1])
        tangent = np.nan_to_num(f[:, None] * (d2[:, 1:2] * e1 - d1[:, 1:2] * e2))
        bitangent = np.nan_to_num(f[:, None] * (-d2[:, 0:1] * e1
                                                + d1[:, 0:1] * e2))
    return {"v": v.astype(F32), "n": n.astype(F32), "uv": tuv,
            "tangent": tangent.astype(F32),
            "bitangent": bitangent.astype(F32),
            "root_bounds": np.stack([pos - bound, pos + bound]).astype(F32)}


def describe(cfg: dict, seed: int, overrides: dict | None = None) -> dict:
    """The scene of `cfg` for `seed`, settings `overrides` applied (an
    "n_tris" override resizes every mesh: the tests' tiny scenes): every
    mesh object gains its "arrays", every map path is made absolute."""
    desc = copy.deepcopy({k: cfg[k] for k in ("settings", "camera", "lights",
                                              "objects")})
    overrides = dict(overrides or {})
    n_tris = overrides.pop("n_tris", None)
    desc["settings"].update(overrides)
    rng = np.random.default_rng(seed)
    for o in desc["objects"]:
        if o["type"] != "mesh":
            continue
        gen = o.pop("mesh")
        o["arrays"] = procedural_mesh(int(n_tris or gen["n_tris"]), o["pos"],
                                      o["size"],
                                      float(rng.uniform(0.0, 2 * np.pi)))
        o["maps"] = {k: os.path.join(cfg["_dir"], p)
                     for k, p in o.get("maps", {}).items()}
    return desc


def write_obj(path: str, m: dict) -> None:
    """The mesh as an indexed OBJ (`v`, `vt`, `vn`, then `f a/a/a`),
    floats with 9 significant digits so an f32 reads back exactly."""
    t_count = m["v"].shape[0]
    corners = np.concatenate([m["v"].reshape(-1, 3), m["uv"].reshape(-1, 2),
                              m["n"].reshape(-1, 3)], axis=1)
    uniq, inv = np.unique(corners, axis=0, return_inverse=True)
    faces = np.repeat(inv.reshape(t_count, 3) + 1, 3, axis=1)
    with open(path, "w") as fh:
        np.savetxt(fh, uniq[:, 0:3], fmt="v %.9g %.9g %.9g")
        np.savetxt(fh, uniq[:, 3:5], fmt="vt %.9g %.9g")
        np.savetxt(fh, uniq[:, 5:8], fmt="vn %.9g %.9g %.9g")
        np.savetxt(fh, faces, fmt="f %d/%d/%d %d/%d/%d %d/%d/%d")


def _vec(x) -> str:
    return ",".join(f"{float(c):.9g}" for c in x)


_BOOL_KEYS = {"output_progress": "outputProgress",
              "enable_output": "enableOutput",
              "use_backface_culling": "useBackfaceCulling", "use_ac": "useAC"}


def write_scene_files(desc: dict, workdir: str, name: str) -> str:
    """The description as `<workdir>/<name>.scene` with its OBJ and maps
    beside it (absolute paths); returns the scene file's path."""
    os.makedirs(workdir, exist_ok=True)
    st = desc["settings"]
    lines = ["[options]"]
    for key in ("width", "height", "ac_penalty", "max_ray_depth"):
        if key in st:
            lines.append(f"{key}={int(st[key])}")
    for key, flag in _BOOL_KEYS.items():
        if key in st:
            lines.append(f"{flag}={int(bool(st[key]))}")
    lines.append(f"background_color={_vec(st['background_color'])}")
    lines.append(f"image_name={os.path.join(workdir, name)}")
    lines.append(f"position={_vec(desc['camera']['position'])}")
    lines.append(f"rotation={_vec(desc['camera']['rotation'])}")
    for li in desc["lights"]:
        lines += ["", "[light]", f"type={li['type']}"]
        for key in ("position", "direction"):
            if key in li:
                lines.append(f"{key}={_vec(li[key])}")
        lines += [f"color={_vec(li['color'])}",
                  f"intensity={float(li['intensity']):.9g}"]
    for i, o in enumerate(desc["objects"]):
        lines += ["", "[object]", f"type={o['type']}", f"pos={_vec(o['pos'])}"]
        if o["type"] == "mesh":
            lines += [f"size={_vec(o['size'])}", f"rot={_vec(o['rot'])}"]
        lines.append(f"color={_vec(o['color'])}")
        mat = o.get("material", "diffuse")
        if mat == "phong":
            mat += "," + ",".join(f"{float(o[k]):.9g}" for k in
                                  ("ambient", "diffuse", "specular",
                                   "n_specular"))
        elif mat == "transparent":
            mat += f",{float(o['ior']):.9g}"
        lines.append(f"material={mat}")
        if o["type"] == "sphere":
            lines.append(f"radius={float(o['radius']):.9g}")
        elif o["type"] == "plane":
            lines.append(f"normal={_vec(o['normal'])}")
        else:
            obj = os.path.join(workdir, f"{name}_{i}.obj")
            write_obj(obj, o["arrays"])
            lines.append(f"name={obj}")
            for kind, src in o.get("maps", {}).items():
                dst = os.path.join(workdir, os.path.basename(src))
                shutil.copyfile(src, dst)
                lines.append(f"{kind}_map={dst}")
    lines += ["", "[end]", ""]
    path = os.path.join(workdir, f"{name}.scene")
    with open(path, "w") as fh:
        fh.write("\n".join(lines))
    return path


def program_scene(desc: dict, device):
    """The program's scene of a description with mesh arrays, built as
    the port's flagship builder builds it (arrays in world space)."""
    from rendering_tpu_torch.models.objloader import MeshArrays
    from rendering_tpu_torch.models.parser import (
        LightDef,
        ObjectDef,
        SceneDef,
        decode_normal_map,
        decode_specular_map,
    )
    from rendering_tpu_torch.models.scene import build_scene
    from rendering_tpu_torch.models.settings import RenderSettings
    from rendering_tpu_torch.utils.bmp import load_bmp_float

    st = dict(desc["settings"])
    st["background_color"] = tuple(st["background_color"])
    sd = SceneDef(settings=RenderSettings(**st),
                  cam_pos=tuple(desc["camera"]["position"]),
                  cam_rot=tuple(desc["camera"]["rotation"]))
    for li in desc["lights"]:
        kw = {"color": tuple(li["color"]), "intensity": float(li["intensity"])}
        if "position" in li:
            kw["pos"] = tuple(li["position"])
        if "direction" in li:
            kw["dir"] = tuple(li["direction"])
        sd.lights.append(LightDef(li["type"], **kw))
    for o in desc["objects"]:
        kw = {k: (tuple(o[k]) if isinstance(o[k], list) else o[k])
              for k in ("pos", "color", "material", "ior", "ambient",
                        "diffuse", "specular", "n_specular", "radius",
                        "normal", "size", "rot") if k in o}
        obj = ObjectDef(o["type"], **kw)
        if o["type"] == "mesh":
            a = o["arrays"]
            obj.mesh = MeshArrays(v=a["v"], n=a["n"], uv=a["uv"],
                                  tangent=a["tangent"],
                                  bitangent=a["bitangent"],
                                  root_bounds=a["root_bounds"])
            for kind, path in o.get("maps", {}).items():
                data = load_bmp_float(path)
                h, w = data.shape[:2]
                flat = data.reshape(h * w, 3)
                if kind == "normal":
                    flat = decode_normal_map(flat)
                elif kind == "specular":
                    flat = decode_specular_map(flat)
                setattr(obj, f"{kind}_map", flat)
                setattr(obj, f"{kind}_map_wh", (w, h))
        sd.objects.append(obj)
    return build_scene(sd, device=device)
