"""Primitive intersection tests on (3, R) row tensors.

Each reproduces the f32 semantics of its counterpart in
`rendering_tpu.ops.intersect`. Misses return +FLT_MAX so that a
first-occurrence argmin over the object axis reproduces the reference's
strict `tNear < best` scene-order tie-breaking (src/scene.cpp:724-756).
"""

from __future__ import annotations

import torch

from rendering_tpu_torch.ops.geometry import FLT_MAX, cross_r, dot_r


def intersect_spheres_r(ro3, rd3, pos, radius):
    """Geometric ray-sphere test (Sphere::intersectObject,
    src/objects.cpp:774-786). ro3/rd3 (3, R); pos (Ns, 3); radius (Ns,).
    Returns t (Ns, R)."""
    r2 = (radius * radius)[:, None]                            # (Ns, 1)
    L = [pos[:, c, None] - ro3[c][None, :] for c in range(3)]  # (Ns, R)
    tca = (L[0] * rd3[0][None, :] + L[1] * rd3[1][None, :]) + (
        L[2] * rd3[2][None, :]
    )
    d2 = ((L[0] * L[0] + L[1] * L[1]) + L[2] * L[2]) - tca * tca
    inside = d2 <= r2
    # Double where, both ways: sqrt'(0) is infinite, so masked lanes AND
    # an exactly tangent live lane (d2 == r2) take the square root of a
    # safe operand; the tangent lane keeps its primal thc = 0.
    op = torch.clamp_min(r2 - d2, 0.0)
    dead = (~inside) | (op <= 0.0)
    thc = torch.where(
        dead, torch.where(inside, 0.0, 1.0),
        torch.sqrt(torch.where(dead, 1.0, op)),
    )
    t0 = tca - thc
    t1 = tca + thc
    t0 = torch.where(t0 < 0, t1, t0)
    ok = inside & (t0 >= 0)
    return torch.where(ok, t0, FLT_MAX)


def intersect_planes_r(ro3, rd3, pos, normal):
    """Ray-plane test (Plane::intersectObject, src/objects.cpp:807-814).
    Returns t (Np, R)."""
    n = [normal[:, c, None] for c in range(3)]                 # (Np, 1)
    denom = (rd3[0][None, :] * n[0] + rd3[1][None, :] * n[1]) + (
        rd3[2][None, :] * n[2]
    )
    ok_denom = torch.abs(denom) >= 1e-8
    safe = torch.where(ok_denom, denom, 1.0)
    num = (
        (pos[:, 0, None] - ro3[0][None, :]) * n[0]
        + (pos[:, 1, None] - ro3[1][None, :]) * n[1]
    ) + (pos[:, 2, None] - ro3[2][None, :]) * n[2]
    t = num / safe
    ok = ok_denom & (t >= 0)
    return torch.where(ok, t, FLT_MAX)


def ray_triangle_r(ro3, rd3, v03, v13, v23, backface_culling: bool):
    """Moller-Trumbore (Triangle::rayTriangleIntersect,
    src/objects.cpp:59-95) on rows: every vector (3, ...). With culling
    on, the signed det < 1e-8 rejects; |det| < 1e-8 always rejects;
    u/v/t bounds as in the reference. Returns (t, u, v, ok), t = FLT_MAX
    where not ok."""
    v0v1 = v13 - v03
    v0v2 = v23 - v03
    pvec = cross_r(rd3, v0v2)
    det = dot_r(v0v1, pvec)
    if backface_culling:
        ok = det >= 1e-8
    else:
        ok = torch.abs(det) >= 1e-8
    inv_det = 1.0 / torch.where(ok, det, 1.0)
    tvec = ro3 - v03
    u = dot_r(tvec, pvec) * inv_det
    ok = ok & (u >= 0) & (u <= 1)
    qvec = cross_r(tvec, v0v1)
    v = dot_r(rd3, qvec) * inv_det
    ok = ok & (v >= 0) & (u + v <= 1)
    t = dot_r(v0v2, qvec) * inv_det
    ok = ok & (t >= 0)
    return torch.where(ok, t, FLT_MAX), u, v, ok
