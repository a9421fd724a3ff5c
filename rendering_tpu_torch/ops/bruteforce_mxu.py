"""Dense ray-mesh intersection as a bilinear form —
`rendering_tpu.ops.bruteforce_mxu`, the oracle of a mesh of at most
settings.bruteforce_threshold triangles when use_pallas_intersect is off
and use_mxu_intersect on (JAX's default off the TPU's kernel).

Moller-Trumbore's determinant and its t, u and v numerators are bilinear
in the ray origin and direction, so for the 13 features

    F = [1, ro, rd, rd_y ro_x, rd_z ro_x, rd_z ro_y, rd_x ro_y, rd_x ro_z,
         rd_y ro_z]

all four, for every triangle of a chunk, are one product F @ C with a
per-triangle coefficient table C (13, 4 Tc) built from the vertices
(`mt_coefficients`). Only the accept-and-minimum epilogue stays
elementwise. The product is `torch.matmul` in full f32, as JAX's
`Precision.HIGHEST` dot, which it computes outside any Pallas kernel;
TF32 is refused at the call. The accept conditions are
`ops.intersect.ray_triangle_r`'s in exact arithmetic, but the bilinear
sums round differently from the direct form, which can flip a grazing
hit; the integrator re-evaluates every accepted hit by the direct form.
"""

from __future__ import annotations

import torch

from rendering_tpu_torch.ops.bruteforce import (
    closest_of_chunk,
    finish,
    make_aabb_acceptor,
    no_triangles,
    pad_chunks,
)
from rendering_tpu_torch.ops.geometry import FLT_MAX


def _cross(a, b):
    """a x b on (..., 3), the component order of jnp.cross."""
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def mt_coefficients(v):
    """The bilinear coefficient table of triangles v (T, 3, 3): (13, T, 4),
    the last axis (det, t det, u det, v det), in ray_features' order."""
    v0 = v[:, 0]
    e1 = v[:, 1] - v0
    e2 = v[:, 2] - v0
    n = _cross(e1, e2)
    z = torch.zeros((v.shape[0],), dtype=v.dtype, device=v.device)

    def col(const, ro_c, rd_c, cross_c):
        return torch.stack([const, *ro_c, *rd_c, *cross_c])  # (13, T)

    # det = -rd . n
    det_c = col(z, (z, z, z), (-n[:, 0], -n[:, 1], -n[:, 2]), (z,) * 6)
    # t det = ro . n - v0 . n
    v0n = (v0[:, 0] * n[:, 0] + v0[:, 1] * n[:, 1]) + v0[:, 2] * n[:, 2]
    tdet_c = col(-v0n, (n[:, 0], n[:, 1], n[:, 2]), (z, z, z), (z,) * 6)
    # u det = (rd x e2) . (ro - v0)
    v0xe2 = _cross(v0, e2)
    udet_c = col(z, (z, z, z), (v0xe2[:, 0], v0xe2[:, 1], v0xe2[:, 2]),
                 (e2[:, 2], -e2[:, 1], e2[:, 0], -e2[:, 2], e2[:, 1],
                  -e2[:, 0]))
    # v det = ((ro - v0) x e1) . rd
    e1xv0 = _cross(e1, v0)
    vdet_c = col(z, (z, z, z), (e1xv0[:, 0], e1xv0[:, 1], e1xv0[:, 2]),
                 (-e1[:, 2], e1[:, 1], -e1[:, 0], e1[:, 2], -e1[:, 1],
                  e1[:, 0]))
    return torch.stack([det_c, tdet_c, udet_c, vdet_c], dim=-1)


def ray_features(ro, rd):
    """(B, 3) origins and directions -> the (B, 13) features."""
    one = torch.ones((ro.shape[0],), dtype=ro.dtype, device=ro.device)
    return torch.stack(
        [one, ro[:, 0], ro[:, 1], ro[:, 2], rd[:, 0], rd[:, 1], rd[:, 2],
         rd[:, 1] * ro[:, 0], rd[:, 2] * ro[:, 0], rd[:, 2] * ro[:, 1],
         rd[:, 0] * ro[:, 1], rd[:, 0] * ro[:, 2], rd[:, 1] * ro[:, 2]],
        dim=-1)


def matmul_f32(a, b):
    """a @ b in full f32. On a card it refuses TF32, and under
    deterministic algorithms it lifts the mode's cuBLAS alert for this one
    product: the alert is about a cuBLAS workspace shared by several
    streams, and the product runs on the current stream alone, where
    cuBLAS gives the same bits every run (chip_smoke.py repeats the frame
    and compares)."""
    if not a.is_cuda:
        return a @ b
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("bruteforce_mesh_mxu needs f32 products: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    if not torch.are_deterministic_algorithms_enabled():
        return a @ b
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(False)
    try:
        return a @ b
    finally:
        torch.use_deterministic_algorithms(True, warn_only=warn_only)


def bruteforce_mesh_mxu(mesh, ro, rd, t_limit=None, *,
                        backface_culling: bool = True, tri_chunk: int = 512,
                        use_root_filter: bool = True):
    """Closest hit over all of a mesh's triangles through the bilinear
    form; the interface of `ops.bruteforce.bruteforce_mesh`."""
    t_count = int(mesh.v.shape[0])
    r = ro.shape[0]
    dev = ro.device
    if t_count == 0:
        return no_triangles(r, dev)
    n_chunks = -(-t_count // tri_chunk)
    v = pad_chunks(mesh.v, n_chunks, tri_chunk).reshape(-1, 3, 3)
    # (n_chunks, 13, 4 Tc): a chunk's columns grouped by quantity.
    coef = (mt_coefficients(v).reshape(13, n_chunks, tri_chunk, 4)
            .permute(1, 0, 3, 2).reshape(n_chunks, 13, 4 * tri_chunk))
    feats = ray_features(ro, rd)  # (R, 13)
    reach_lo = pad_chunks(mesh.reach_lo, n_chunks, tri_chunk)
    reach_hi = pad_chunks(mesh.reach_hi, n_chunks, tri_chunk)
    t_best = torch.full((r,), FLT_MAX, device=dev)
    if t_limit is not None:
        t_best = torch.minimum(t_best, t_limit)
    accept = make_aabb_acceptor(mesh, ro, rd, use_root_filter)
    carry = (t_best, torch.full((r,), -1, dtype=torch.int32, device=dev))
    for c in range(n_chunks):
        out = matmul_f32(feats, coef[c])  # (R, 4 Tc)
        det, tdet, udet, vdet = out.split(tri_chunk, dim=1)
        if backface_culling:
            ok = det >= 1e-8
        else:
            ok = torch.abs(det) >= 1e-8
        inv = 1.0 / torch.where(ok, det, 1.0)
        u = udet * inv
        vq = vdet * inv
        t = tdet * inv
        ok = (ok & (u >= 0) & (u <= 1) & (vq >= 0) & (u + vq <= 1)
              & (t >= 0) & accept(reach_lo[c], reach_hi[c]))
        carry = closest_of_chunk(carry, t, ok, c * tri_chunk, t_count)
    return finish(*carry, r, t_count)
