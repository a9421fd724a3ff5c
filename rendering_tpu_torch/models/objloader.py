"""Mesh arrays and the Euler rotation — the parts of
`rendering_tpu.models.objloader` the port uses (`load_obj` comes with
the CLI slice).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


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
