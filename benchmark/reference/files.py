"""The reference's readers: `.scene` files, OBJ files, BMP images and
texture maps, the camera's Euler matrix, and the per-triangle reach boxes
of a mesh that its root box clips.

Each follows the upstream engine (holoskii/Rendering) as documented: a
scene file is `[options]`, `[light]` and `[object]` blocks of `key=value`
lines; an OBJ is fitted into the object's `size` keeping its aspect,
rotated by the mz*my*mx Euler matrix and moved to `pos`, and its root box
is `pos +- |rotate(size)| / 2`, which can clip a rotated mesh; a BMP is
read as the engine reads it (rows bottom-up, bytes / 256); a normal map
texel is (2x - 1, -(2y - 1), z) normalized, a specular texel the mean of
its channels. Everything is float32 numpy, as the engine computes it.
"""

from __future__ import annotations

import math
import struct

import numpy as np

F32 = np.float32
FLT_MAX = np.float32(np.finfo(np.float32).max)
FLT_MIN = np.float32(np.finfo(np.float32).tiny)

MATERIALS = ("diffuse", "reflective", "transparent", "phong")


def euler_matrix(rot_deg) -> np.ndarray:
    """Rotation from Euler degrees, row-vector convention (v @ R),
    composed mz*my*mx, every product entry a left-to-right f32 sum."""
    rx, ry, rz = (math.radians(float(a)) for a in rot_deg)
    mx = np.array([[1, 0, 0], [0, math.cos(rx), -math.sin(rx)],
                   [0, math.sin(rx), math.cos(rx)]], F32)
    my = np.array([[math.cos(ry), 0, math.sin(ry)], [0, 1, 0],
                   [-math.sin(ry), 0, math.cos(ry)]], F32)
    mz = np.array([[math.cos(rz), -math.sin(rz), 0],
                   [math.sin(rz), math.cos(rz), 0], [0, 0, 1]], F32)

    def mul(a, b):
        out = np.zeros((3, 3), F32)
        for i in range(3):
            for j in range(3):
                out[i, j] = F32(F32(F32(a[i, 0] * b[0, j])
                                    + F32(a[i, 1] * b[1, j]))
                                + F32(a[i, 2] * b[2, j]))
        return out

    return mul(mul(mz, my), mx)


def rotate_rows(a: np.ndarray, rmat: np.ndarray) -> np.ndarray:
    """(N, 3) rows times the row-vector rotation, as multiply-adds."""
    return np.stack([a[:, 0] * rmat[0, j] + a[:, 1] * rmat[1, j]
                     + a[:, 2] * rmat[2, j] for j in range(3)],
                    axis=1).astype(F32)


def normalize_rows(a: np.ndarray) -> np.ndarray:
    len2 = np.sum(a * a, axis=-1, keepdims=True)
    factor = np.where(len2 > 0,
                      1.0 / np.sqrt(np.where(len2 > 0, len2, 1.0)), 1.0)
    return (a * factor).astype(F32)


# ---- BMP -------------------------------------------------------------------

def read_bmp(path: str) -> np.ndarray:
    """A 24-bit BMP as the engine reads it: (H, W, 3) u8 RGB, row 0 the
    bottom row, the 3*W*H bytes after the 54-byte header taken in order."""
    with open(path, "rb") as fh:
        data = fh.read()
    width = struct.unpack_from("<i", data, 18)[0]
    height = struct.unpack_from("<i", data, 22)[0]
    raw = np.frombuffer(data, np.uint8, count=3 * width * height, offset=54)
    return np.ascontiguousarray(raw.reshape(height, width, 3)[:, :, ::-1])


def read_image(path: str) -> np.ndarray:
    """A BMP written by the engine as a top-down (H, W, 3) u8 image
    (its widths are multiples of 4, so rows carry no padding)."""
    return read_bmp(path)[::-1]


def load_map(path: str, kind: str):
    """A texture map as the flat (W*H, C) table the shading samples,
    decoded for its kind; returns (table, (W, H))."""
    data = read_bmp(path).astype(F32) / F32(256.0)
    h, w = data.shape[:2]
    flat = data.reshape(h * w, 3)
    if kind == "normal":
        nm = flat * F32(2.0) - F32(1.0)
        nm[:, 1] = -nm[:, 1]
        nm[:, 2] = (nm[:, 2] + F32(1.0)) / F32(2.0)
        flat = normalize_rows(nm)
    elif kind == "specular":
        flat = np.mean(flat, axis=1, keepdims=True).astype(F32)
    return flat, (w, h)


# ---- scene files -----------------------------------------------------------

def _vec3(s: str):
    parts = [p for p in s.split(",") if p.strip() != ""]
    if len(parts) != 3:
        raise ValueError(f"bad vec3: {s!r}")
    return tuple(float(p) for p in parts)


_OPTION_INTS = {"width", "height", "max_ray_depth", "ac_penalty",
                "n_workers"}
_OPTION_BOOLS = {"outputProgress": "output_progress",
                 "useBackfaceCulling": "use_backface_culling",
                 "collectStatistics": "collect_statistics",
                 "enableOutput": "enable_output", "imageOutput":
                 "image_output", "useAC": "use_ac", "showAC": "show_ac",
                 "useSkybox": "use_skybox", "useTextures": "use_textures",
                 "showNormals": "show_normals"}


def parse_scene(path: str) -> dict:
    """A `.scene` file as a plain description: {"settings", "camera",
    "lights", "objects"}; a mesh object's "obj" is its OBJ path and its
    maps are {kind: path}. Settings absent from the file keep the
    engine's defaults (include/options.h)."""
    settings = dict(width=800, height=600, bias=1e-4, max_ray_depth=10,
                    background_color=(0.0, 0.0, 0.0), ac_penalty=1, fov=60.0,
                    use_backface_culling=True, use_ac=True,
                    enable_ssaa=True, use_textures=True)
    desc = {"settings": settings,
            "camera": {"position": (0.0, 0.0, 0.0),
                       "rotation": (0.0, 0.0, 0.0)},
            "lights": [], "objects": []}
    block, cur = None, None
    with open(path) as fh:
        lines = [ln.rstrip("\r\n") for ln in fh]
    for line in lines:
        if "#" in line:
            line = line[:line.index("#")]
        if not line:
            continue
        if line.startswith("["):
            if cur is not None:
                (desc["lights"] if block == "light"
                 else desc["objects"]).append(cur)
            cur = None
            block = line.strip("[]")
            if block == "end":
                break
            continue
        key, value = line.split("=", 1)
        if block == "options":
            key = key.replace(" ", "").replace("\t", "")
            if key in _OPTION_INTS:
                settings[key] = int(value)
            elif key == "fov":
                settings["fov"] = float(value)
            elif key in _OPTION_BOOLS:
                settings[_OPTION_BOOLS[key]] = bool(int(value))
            elif key == "background_color":
                settings["background_color"] = _vec3(value)
            elif key == "position":
                desc["camera"]["position"] = _vec3(value)
            elif key == "rotation":
                desc["camera"]["rotation"] = _vec3(value)
        elif block == "light":
            if key == "type":
                cur = {"type": value, "color": (1.0, 1.0, 1.0),
                       "intensity": 1.0}
            elif key == "intensity":
                cur["intensity"] = float(value)
            else:
                cur[key] = _vec3(value)
        elif block == "object":
            if key == "type":
                cur = {"type": value, "material": "diffuse", "ior": 1.4,
                       "ambient": 0.1, "diffuse": 0.1, "specular": 1.0,
                       "n_specular": 5.0, "color": (1.0, 1.0, 1.0),
                       "pos": ((0.0, 0.0, 0.0) if value == "sphere"
                               else (1.0, 1.0, 1.0))}
                if value == "mesh":
                    cur.update(size=(0.0, 0.0, 0.0), rot=(0.0, 0.0, 0.0),
                               maps={})
            elif key == "material":
                res = value.split(",")
                cur["material"] = res[0]
                if res[0] == "transparent":
                    cur["ior"] = float(res[1])
                elif res[0] == "phong":
                    cur.update(ambient=float(res[1]), diffuse=float(res[2]),
                               specular=float(res[3]),
                               n_specular=float(res[4]))
            elif key == "radius":
                cur["radius"] = float(value)
            elif key == "name":
                cur["obj"] = value
            elif key.endswith("_map"):
                if settings["use_textures"]:
                    cur["maps"][key[:-4]] = value
            else:
                cur[key] = _vec3(value)
    return desc


# ---- OBJ -------------------------------------------------------------------

def _floats(lines, n):
    if not lines:
        return np.zeros((0, n), F32)
    return np.array(" ".join(lines).split(), F32).reshape(len(lines), n)


def load_obj(path: str, size, rot, pos, bias: float = 1e-4) -> dict:
    """An OBJ of `v`, `vt`, `vn` lines before `f a/b/c` faces (every
    vertex read before the first face, as the benchmark writes them),
    placed as the engine places a mesh. Returns {"v", "n", "uv",
    "tangent", "bitangent", "root_bounds"} in file face order."""
    vs, vts, vns, fs = [], [], [], []
    with open(path) as fh:
        for line in fh:
            head = line[:2]
            if head == "v ":
                vs.append(line[2:])
            elif head == "vt":
                vts.append(line[3:])
            elif head == "vn":
                vns.append(line[3:])
            elif head == "f ":
                fs.append(line[2:].replace("/", " "))
    v = _floats(vs, 3)
    uv_tab = _floats(vts, 2)
    n_tab = normalize_rows(_floats(vns, 3))
    faces = np.array(" ".join(fs).split(), np.int64).reshape(len(fs), 3, 3)
    faces = faces - 1

    size = np.asarray(size, F32)
    pos = np.asarray(pos, F32)
    vmin = np.minimum.reduce(v, axis=0, initial=FLT_MAX).astype(F32)
    vmax = np.maximum.reduce(v, axis=0, initial=FLT_MIN).astype(F32)
    rng = (vmax - vmin).astype(F32)
    norm = size.copy()
    if not (rng < bias).any():
        stretch = size / rng
        k = int(np.flatnonzero(stretch == stretch.min())[0])
        for j in range(3):
            if j != k:
                norm[j] = norm[k] / (rng[k] / rng[j])
    rmat = euler_matrix(rot)
    vv = (norm * ((v - vmin) / rng - F32(0.5))).astype(F32)
    vv = (rotate_rows(vv, rmat) + pos).astype(F32)
    nn = rotate_rows(n_tab, rmat)
    rot_size = np.abs(rotate_rows(norm[None, :], rmat)[0]).astype(F32)
    root = np.stack([pos - rot_size / 2, pos + rot_size / 2]).astype(F32)

    tri_v = vv[faces[:, :, 0]]
    tri_uv = uv_tab[faces[:, :, 1]]
    tri_n = nn[faces[:, :, 2]]
    e1 = tri_v[:, 1] - tri_v[:, 0]
    e2 = tri_v[:, 2] - tri_v[:, 0]
    d1 = tri_uv[:, 1] - tri_uv[:, 0]
    d2 = tri_uv[:, 2] - tri_uv[:, 0]
    with np.errstate(divide="ignore", invalid="ignore"):
        f = F32(1.0) / (d1[:, 0] * d2[:, 1] - d2[:, 0] * d1[:, 1])
        tangent = (f[:, None] * (d2[:, 1:2] * e1 - d1[:, 1:2] * e2))
        bitangent = (f[:, None] * (-d2[:, 0:1] * e1 + d1[:, 0:1] * e2))
    return {"v": tri_v, "n": tri_n.astype(F32), "uv": tri_uv,
            "tangent": tangent.astype(F32),
            "bitangent": bitangent.astype(F32), "root_bounds": root}


# ---- reach boxes of a clipped mesh -------------------------------------------

def reach_boxes(tri_v: np.ndarray, root_bounds: np.ndarray,
                ac_penalty: int):
    """Each triangle's reach box: the union of the boxes of the engine's
    acceleration-structure leaves that hold it (objects.cpp:461-763: the
    node split along its longest axis at the plane a binary search on the
    SAH cost N_left*(s - min) + N_right*(max - s) picks, probing +-0.05
    until the interval is under 0.1; a triangle that spans the plane goes
    to both children; a leaf at n <= depth * ac_penalty, or when a side
    is empty or the copies reach 1.5x). The leaves partition the root
    box, so a mesh that pokes out of it is clipped: a ray that crosses
    none of a triangle's leaves never finds it. Returns (lo, hi), each
    (T, 3)."""
    t_count = tri_v.shape[0]
    tmin = tri_v.min(axis=1).astype(F32)
    tmax = tri_v.max(axis=1).astype(F32)
    lo = np.full((t_count, 3), FLT_MAX, F32)
    hi = np.full((t_count, 3), -FLT_MAX, F32)

    def sah(axis, idx, b0, b1, s):
        n_l = int(np.count_nonzero(tmin[idx, axis] <= s))
        n_r = int(np.count_nonzero(tmax[idx, axis] >= s))
        return F32(n_l * (s - b0) + n_r * (b1 - s))

    stack = [(root_bounds[0].astype(F32), root_bounds[1].astype(F32),
              np.arange(t_count), 1)]
    while stack:
        bmin, bmax, idx, depth = stack.pop()
        leaf = idx.size <= depth * ac_penalty
        if not leaf:
            dim = bmax - bmin
            axis = (0 if dim[0] > dim[1] and dim[0] > dim[2]
                    else 1 if dim[1] > dim[2] else 2)
            b0, b1 = F32(bmin[axis]), F32(bmax[axis])
            left, right = b0, b1
            while True:
                mid = F32(right - F32(right - left) / F32(2))
                if F32(right - left) < F32(0.1):
                    break
                if (sah(axis, idx, b0, b1, F32(mid - F32(0.05)))
                        < sah(axis, idx, b0, b1, F32(mid + F32(0.05)))):
                    right = mid
                else:
                    left = mid
            li = idx[tmin[idx, axis] <= mid]
            ri = idx[tmax[idx, axis] >= mid]
            leaf = (li.size == 0 or ri.size == 0
                    or li.size + ri.size >= idx.size * 1.5)
        if leaf:
            if idx.size:
                np.minimum.at(lo, idx, bmin[None, :])
                np.maximum.at(hi, idx, bmax[None, :])
            continue
        lmax = bmax.copy()
        lmax[axis] = mid
        rmin = bmin.copy()
        rmin[axis] = mid
        stack.append((bmin, lmax, li, depth + 1))
        stack.append((rmin, bmax, ri, depth + 1))
    return lo, hi
