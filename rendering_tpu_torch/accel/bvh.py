"""Morton triangle order — the part of `rendering_tpu.accel.bvh` the
port uses. The SAH BVH (whose reach boxes feed the kernel's root
filter on clipped meshes) comes with a later slice."""

from __future__ import annotations

import numpy as np


def morton_order(tri_v: np.ndarray) -> np.ndarray:
    """Spatial (Morton/Z-curve) triangle permutation by centroid.

    Consecutive triangles in this order are spatially adjacent, so the
    fixed-size chunks the intersection kernel walks get tight AABBs.
    `models.scene.build_scene` stores every per-triangle array in this
    order, so hit ids everywhere downstream are Morton-order ids."""
    t_count = len(tri_v)
    if t_count == 0:
        return np.zeros((0,), np.int32)
    cent = (tri_v.min(axis=1) + tri_v.max(axis=1)) * 0.5
    lo = cent.min(axis=0)
    span = cent.max(axis=0) - lo
    span = np.where(span > 0, span, 1.0)
    q = ((cent - lo) / span * 1023.0).astype(np.uint32)
    q = np.minimum(q, 1023)

    def spread(x):
        x = x.astype(np.uint64)
        x = (x | (x << 16)) & np.uint64(0x0000FF0000FF)
        x = (x | (x << 8)) & np.uint64(0x00F00F00F00F)
        x = (x | (x << 4)) & np.uint64(0x0C30C30C30C3)
        x = (x | (x << 2)) & np.uint64(0x249249249249)
        return x

    code = (spread(q[:, 0]) << np.uint64(2)) | (
        spread(q[:, 1]) << np.uint64(1)
    ) | spread(q[:, 2])
    return np.argsort(code, kind="stable").astype(np.int32)
