"""Wavefront OBJ loader with the reference engine's semantics — the port's
copy of `rendering_tpu.models.objloader`. `load_obj` runs the port's C++
loader (`rendering_tpu_torch.native`, csrc/rt_native.cpp), bit-equal to
`load_obj_python`; RTPU_NATIVE=0 takes the Python loader.

Re-implements `Mesh::loadOBJ` (src/objects.cpp:177-394) as a numpy
struct-of-arrays producer. Quirks kept:

* min init = +FLT_MAX, max init = +FLT_MIN (not -inf): the reference
  uses std::numeric_limits<float>::min() (objects.cpp:228-229), a tiny
  positive number, so a mesh entirely in negative coordinates keeps
  max = FLT_MIN.
* normalize on the first face (objects.cpp:282-331): fit into `size`
  keeping the aspect through the min-stretch axis, rotate by the mz*my*mx
  Euler matrix, translate to `pos`, snap degenerate axes (range < bias)
  to pos after the rotation; vertices read after the first face stay
  raw.
* normals rotated by the same matrix, not re-normalized.
* root AABB = pos +- |rotate(normSize)|/2 (objects.cpp:328-330): the
  rotated size vector, not the rotated mesh's AABB, so it can clip a
  rotated mesh exactly as the reference does.
* faces `v`, `v/t/n`, `v//n` and `v/t` with fan triangulation; a face
  whose slash count is odd is dropped (objects.cpp:378).
* triangles without explicit normals get the unnormalized face cross
  product (b-a)x(c-a) as all three vertex normals (objects.cpp:17-21).
* tangent/bitangent from UV deltas only for faces with UVs
  (objects.cpp:41-56); zero otherwise.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from rendering_tpu_torch import native

FLT_MAX = np.float32(np.finfo(np.float32).max)
FLT_MIN = np.float32(np.finfo(np.float32).tiny)


def euler_matrix(rot_deg) -> np.ndarray:
    """3x3 rotation from Euler degrees, row-vector convention (apply as
    `v @ R`), built mz*my*mx as the reference does (objects.cpp:180-204,
    scene.cpp:22-49)."""
    rx, ry, rz = (math.radians(float(a)) for a in rot_deg)
    cx, sx = math.cos(rx), math.sin(rx)
    cy, sy = math.cos(ry), math.sin(ry)
    cz, sz = math.cos(rz), math.sin(rz)
    mx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]], dtype=np.float32)
    my = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], dtype=np.float32)
    mz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]], dtype=np.float32)
    return _mat3_mul(_mat3_mul(mz, my), mx)


def _mat3_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """f32 matrix product with the reference's rounding (geometry.h:
    244-253): each entry the left-to-right sum a0*b0 + a1*b1 + a2*b2
    (+ the 4x4 build's exact +0.0), every op rounded separately. BLAS
    would contract and block the sum and can move an entry by 1 ulp."""
    c = np.zeros((3, 3), np.float32)
    zero = np.float32(0.0)
    for i in range(3):
        for j in range(3):
            c[i, j] = (
                (a[i, 0] * b[0, j] + a[i, 1] * b[1, j]) + a[i, 2] * b[2, j]
            ) + zero
    return c


@dataclasses.dataclass
class MeshArrays:
    """A mesh as SoA numpy arrays (T triangles)."""

    v: np.ndarray        # (T, 3, 3) vertex positions [a, b, c]
    n: np.ndarray        # (T, 3, 3) vertex normals
    uv: np.ndarray       # (T, 3, 2) texture coordinates
    tangent: np.ndarray  # (T, 3)
    bitangent: np.ndarray  # (T, 3)
    root_bounds: np.ndarray  # (2, 3) AABB the reference assigns the BVH root

    @property
    def n_tris(self) -> int:
        return self.v.shape[0]


def _normalize_rows(a: np.ndarray) -> np.ndarray:
    # Vec3::normalize leaves zero vectors untouched (geometry.h:104-112).
    len2 = np.sum(a * a, axis=-1, keepdims=True)
    factor = np.where(len2 > 0, 1.0 / np.sqrt(np.where(len2 > 0, len2, 1.0)), 1.0)
    return (a * factor).astype(np.float32)


def _apply_first_face_transform(
    verts: list, normals: list, size, rot, pos, bias: float
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The normalize/rotate/translate block at objects.cpp:282-331, in
    f32 throughout. Returns (verts, normals, root_bounds)."""
    size = np.asarray(size, dtype=np.float32)
    pos = np.asarray(pos, dtype=np.float32)
    v = (
        np.array(verts, dtype=np.float32)
        if verts
        else np.zeros((0, 3), dtype=np.float32)
    )
    nrm = (
        np.array(normals, dtype=np.float32)
        if normals
        else np.zeros((0, 3), dtype=np.float32)
    )

    vmin = np.minimum.reduce(v, axis=0, initial=FLT_MAX).astype(np.float32)
    vmax = np.maximum.reduce(v, axis=0, initial=FLT_MIN).astype(np.float32)
    rng = (vmax - vmin).astype(np.float32)

    norm_size = size.copy()
    degenerate = (rng[0] < bias) or (rng[1] < bias) or (rng[2] < bias)
    if not degenerate:
        with np.errstate(divide="ignore", invalid="ignore"):
            stretch = size / rng
        min_stretch = min(stretch[0], min(stretch[1], stretch[2]))
        if min_stretch == stretch[0]:
            norm_size[1] = norm_size[0] / (rng[0] / rng[1])
            norm_size[2] = norm_size[0] / (rng[0] / rng[2])
        elif min_stretch == stretch[1]:
            norm_size[0] = norm_size[1] / (rng[1] / rng[0])
            norm_size[2] = norm_size[1] / (rng[1] / rng[2])
        else:
            norm_size[0] = norm_size[2] / (rng[2] / rng[0])
            norm_size[1] = norm_size[2] / (rng[2] / rng[1])

    rmat = euler_matrix(rot)

    def rot_rows(a):
        # Multiply-adds, not `a @ rmat`: BLAS skips 0-weighted terms,
        # but the reference's scalar multVecMatrix propagates NaN through
        # them (degenerate-axis meshes).
        return np.stack(
            [
                a[:, 0] * rmat[0, j] + a[:, 1] * rmat[1, j] + a[:, 2] * rmat[2, j]
                for j in range(3)
            ],
            axis=1,
        ).astype(np.float32)

    with np.errstate(divide="ignore", invalid="ignore"):
        vv = (norm_size * ((v - vmin) / rng - np.float32(0.5))).astype(np.float32)
    vv = rot_rows(vv)
    vv = (vv + pos).astype(np.float32)
    # Degenerate axes snapped to pos after the rotation (objects.cpp:317-319).
    for ax in range(3):
        if rng[ax] < bias:
            vv[:, ax] = pos[ax]

    nn = rot_rows(nrm) if nrm.shape[0] else nrm

    rot_size = np.abs(rot_rows(norm_size[None, :])[0]).astype(np.float32)
    root_bounds = np.stack([pos - rot_size / 2, pos + rot_size / 2]).astype(np.float32)
    return vv, nn, root_bounds


def load_obj(path: str, size, rot, pos, bias: float = 0.0001) -> MeshArrays:
    """Load an OBJ file placed by the scene's size/rot/pos: the C++ loader
    (built at first use; a failed build raises), or the Python loader
    under RTPU_NATIVE=0. A parse error in the C++ loader (None) runs the
    Python loader, which raises its own exception for the file; should
    the Python loader accept the file instead, the two loaders disagree
    and that raises."""
    res = native.load_obj_native(
        path, np.asarray(size, np.float32), euler_matrix(rot),
        np.asarray(pos, np.float32), bias,
    )
    if res is None:
        mesh = load_obj_python(path, size, rot, pos, bias)
        if not native.enabled():
            return mesh
        raise RuntimeError(f"{path}: the C++ OBJ loader rejected a file "
                           f"that the Python loader accepts")
    v, n, uv, tangent, bitangent, bounds = res
    return MeshArrays(v=v, n=n, uv=uv, tangent=tangent, bitangent=bitangent,
                      root_bounds=bounds)


def load_obj_python(path: str, size, rot, pos, bias: float = 0.0001) -> MeshArrays:
    verts: list = []
    normals: list = []
    uvs: list = []
    # Face index triples, assembled into triangles in one vectorized pass
    # at the end.
    faces_v: list = []       # (ia, ib, ic) vertex indices (0-based)
    faces_n: list = []       # normal indices or -1
    faces_uv: list = []      # uv indices or -1
    normalized = False
    root_bounds = np.zeros((2, 3), dtype=np.float32)
    arr_v: np.ndarray | None = None
    arr_n: np.ndarray | None = None
    post_v: list = []  # raw verts/normals seen after the first face
    post_n: list = []

    with open(path, "r", errors="replace") as fh:
        for raw in fh:
            line = raw.rstrip("\r\n")
            if "#" in line:
                line = line[: line.index("#")]
            if len(line) == 0:
                continue
            parts = line.split()
            if not parts:
                continue
            head = parts[0]
            if head == "v":
                verts.append(
                    (np.float32(parts[1]), np.float32(parts[2]), np.float32(parts[3]))
                )
                if normalized:
                    # Verts after the first face stay raw (only the
                    # first-face snapshot is transformed,
                    # objects.cpp:282-303); concatenated once after the
                    # loop.
                    post_v.append(verts[-1])
            elif head == "vn":
                n = _normalize_rows(
                    np.array(
                        [[parts[1], parts[2], parts[3]]], dtype=np.float32
                    )
                )[0]
                normals.append(tuple(n))
                if normalized:
                    post_n.append(normals[-1])
            elif head == "vt":
                uvs.append((np.float32(parts[1]), np.float32(parts[2])))
            elif head == "f":
                if not normalized:
                    normalized = True
                    arr_v, arr_n, root_bounds = _apply_first_face_transform(
                        verts, normals, size, rot, pos, bias
                    )
                slash_count = line.count("/")
                vi: list[int] = []
                ti: list[int] = []
                ni: list[int] = []
                if slash_count == 0:
                    for tok in parts[1:]:
                        if tok:
                            vi.append(int(tok))
                elif slash_count % 2 == 0:
                    for tok in parts[1:]:
                        if not tok:
                            continue
                        fields = tok.split("/")
                        v_idx = int(fields[0]) if fields[0] else 0
                        t_idx = int(fields[1]) if len(fields) > 1 and fields[1] else 0
                        n_idx = int(fields[2]) if len(fields) > 2 and fields[2] else 0
                        if v_idx > 0:
                            vi.append(v_idx)
                            if t_idx > 0:
                                ti.append(t_idx)
                            if n_idx > 0:
                                ni.append(n_idx)
                else:
                    # objects.cpp:378 — unhandled slash count, face dropped.
                    continue
                has_n = len(ni) > 0
                has_t = len(ti) > 0 and has_n  # ti without ni -> flat path
                for i in range(1, len(vi) - 1):
                    faces_v.append((vi[0] - 1, vi[i] - 1, vi[i + 1] - 1))
                    if has_n:
                        faces_n.append((ni[0] - 1, ni[i] - 1, ni[i + 1] - 1))
                    else:
                        faces_n.append((-1, -1, -1))
                    if has_t:
                        faces_uv.append((ti[0] - 1, ti[i] - 1, ti[i + 1] - 1))
                    else:
                        faces_uv.append((-1, -1, -1))

    if arr_v is None:
        arr_v = np.zeros((0, 3), dtype=np.float32)
        arr_n = np.zeros((0, 3), dtype=np.float32)
    if post_v:
        arr_v = np.concatenate(
            [arr_v, np.asarray(post_v, dtype=np.float32)]
        )
    if post_n:
        arr_n = np.concatenate(
            [arr_n, np.asarray(post_n, dtype=np.float32)]
        )

    t_count = len(faces_v)
    fv = np.array(faces_v, dtype=np.int64).reshape(t_count, 3)
    fn = np.array(faces_n, dtype=np.int64).reshape(t_count, 3)
    ft = np.array(faces_uv, dtype=np.int64).reshape(t_count, 3)

    if arr_n.shape[0] == 0:
        arr_n = np.zeros((1, 3), dtype=np.float32)  # gather-safe dummy

    tri_v = arr_v[fv]  # (T, 3, 3)

    # Normals: explicit where given, else the unnormalized face cross product.
    flat = np.cross(
        tri_v[:, 1] - tri_v[:, 0], tri_v[:, 2] - tri_v[:, 0]
    ).astype(np.float32)
    tri_n = np.where(
        (fn[:, :1] >= 0)[..., None],
        arr_n[np.maximum(fn, 0)],
        flat[:, None, :],
    ).astype(np.float32)

    uv_arr = (
        np.array(uvs, dtype=np.float32)
        if uvs
        else np.zeros((1, 2), dtype=np.float32)
    )
    has_uv = ft[:, 0] >= 0
    tri_uv = np.where(
        has_uv[:, None, None], uv_arr[np.maximum(ft, 0)], np.float32(0)
    ).astype(np.float32)

    # Tangent/bitangent (objects.cpp:41-56), only for faces with UVs.
    edge1 = tri_v[:, 1] - tri_v[:, 0]
    edge2 = tri_v[:, 2] - tri_v[:, 0]
    duv1 = tri_uv[:, 1] - tri_uv[:, 0]
    duv2 = tri_uv[:, 2] - tri_uv[:, 0]
    with np.errstate(divide="ignore", invalid="ignore"):
        f = np.float32(1.0) / (duv1[:, 0] * duv2[:, 1] - duv2[:, 0] * duv1[:, 1])
        tangent = (
            f[:, None] * (duv2[:, 1:2] * edge1 - duv1[:, 1:2] * edge2)
        ).astype(np.float32)
        bitangent = (
            f[:, None] * (-duv2[:, 0:1] * edge1 + duv1[:, 0:1] * edge2)
        ).astype(np.float32)
    tangent = np.where(has_uv[:, None], tangent, np.float32(0))
    bitangent = np.where(has_uv[:, None], bitangent, np.float32(0))

    return MeshArrays(
        v=tri_v.astype(np.float32),
        n=tri_n,
        uv=tri_uv,
        tangent=tangent,
        bitangent=bitangent,
        root_bounds=root_bounds,
    )


def write_obj(path: str, v: np.ndarray, uv: np.ndarray | None = None,
              n: np.ndarray | None = None) -> None:
    """Write a triangle soup v (T, 3, 3), with optional uv (T, 3, 2) and
    normals n (T, 3, 3), as an indexed OBJ: corners equal in every given
    attribute share one `v`/`vt`/`vn` index, faces are `f a/a/a ...` (or
    `a//a`, `a/a`, `a` for the attributes given). Floats are written with
    9 significant digits, so an f32 reads back exactly. The lines are
    formatted in bulk (np.savetxt), which keeps a 250k-triangle mesh to a
    second or two."""
    t_count = int(v.shape[0])
    cols = [np.asarray(v, np.float32).reshape(-1, 3)]
    if uv is not None:
        cols.append(np.asarray(uv, np.float32).reshape(-1, 2))
    if n is not None:
        cols.append(np.asarray(n, np.float32).reshape(-1, 3))
    corners = np.concatenate(cols, axis=1)
    uniq, inv = np.unique(corners, axis=0, return_inverse=True)
    faces = inv.reshape(t_count, 3) + 1
    if uv is not None and n is not None:
        face_fmt = "f %d/%d/%d %d/%d/%d %d/%d/%d"
        faces = np.repeat(faces, 3, axis=1)
    elif n is not None:
        face_fmt = "f %d//%d %d//%d %d//%d"
        faces = np.repeat(faces, 2, axis=1)
    elif uv is not None:
        face_fmt = "f %d/%d %d/%d %d/%d"
        faces = np.repeat(faces, 2, axis=1)
    else:
        face_fmt = "f %d %d %d"
    with open(path, "w") as fh:
        fh.write(f"# {t_count} triangles\n")
        np.savetxt(fh, uniq[:, 0:3], fmt="v %.9g %.9g %.9g")
        c = 3
        if uv is not None:
            np.savetxt(fh, uniq[:, c:c + 2], fmt="vt %.9g %.9g")
            c += 2
        if n is not None:
            np.savetxt(fh, uniq[:, c:c + 3], fmt="vn %.9g %.9g %.9g")
        np.savetxt(fh, faces, fmt=face_fmt)
