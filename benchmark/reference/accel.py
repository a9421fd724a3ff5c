"""The reference's ray-triangle queries: the closest and the any hit of
each ray against a triangle soup, by Moller-Trumbore on every triangle
that a conservative two-level box cull leaves.

Triangles are grouped in a Morton order of their centroids into leaves
of LEAF and groups of GROUP leaves; a ray tests every group box, then the
leaf boxes of the groups it crosses, then the triangles of the leaves it
crosses. The boxes are padded, so the cull never drops a triangle that
the exact test accepts; the answer is the exact test's. Ties of t go to
the lowest triangle id. With reach boxes (a mesh its root box clips) a
hit counts only where the ray's line also crosses the triangle's reach
box, by the engine's literal slab test.
"""

from __future__ import annotations

import torch

LEAF = 16
GROUP = 64
# Rays per step of a query: bounds the (rays x groups) cull temporaries.
RAY_STEP = 1 << 16


def morton_order(points: torch.Tensor) -> torch.Tensor:
    """Permutation sorting (N, 3) points along a 30-bit Z curve over
    their bounds."""
    p = points.float()
    lo = p.amin(0)
    span = torch.clamp_min(p.amax(0) - lo, 1e-30)
    q = torch.clamp((p - lo) / span * 1023.0, 0, 1023).to(torch.int64)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        return (x | (x << 2)) & 0x09249249

    key = spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)
    return torch.argsort(key, stable=True)


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def moller_trumbore(ro, rd, v0, e1, e2, culling: bool):
    """(t, u, v, ok) of rays against triangles (v0, e1 = v1 - v0,
    e2 = v2 - v0), broadcast over leading axes: det >= 1e-8 with backface
    culling (|det| >= 1e-8 without), u in [0, 1], v >= 0, u + v <= 1,
    t >= 0."""
    pvec = cross(rd, e2)
    det = dot(e1, pvec)
    ok = det >= 1e-8 if culling else torch.abs(det) >= 1e-8
    inv_det = 1.0 / torch.where(ok, det, torch.ones_like(det))
    tvec = ro - v0
    u = dot(tvec, pvec) * inv_det
    ok = ok & (u >= 0) & (u <= 1)
    qvec = cross(tvec, e1)
    v = dot(rd, qvec) * inv_det
    ok = ok & (v >= 0) & (u + v <= 1)
    t = dot(e2, qvec) * inv_det
    return t, u, v, ok & (t >= 0)


def _cull(ro, inv, lo, hi, t_lim):
    """Conservative slab test: the ray's segment [0, t_lim) meets the box."""
    t1 = (lo - ro) * inv
    t2 = (hi - ro) * inv
    near = torch.fmin(t1, t2).amax(-1)
    far = torch.fmax(t1, t2).amin(-1)
    return (far >= torch.clamp_min(near, 0)) & (near < t_lim)


def reach_slab(ro, rd, lo_c, hi_c):
    """The engine's literal slab test (no range check on t), as its
    clipping of a mesh by its root box applies it."""
    inv = 1.0 / rd
    neg = inv < 0
    lo = torch.where(neg, hi_c, lo_c)
    hi = torch.where(neg, lo_c, hi_c)
    tmin = (lo[..., 0] - ro[..., 0]) * inv[..., 0]
    tmax = (hi[..., 0] - ro[..., 0]) * inv[..., 0]
    tymin = (lo[..., 1] - ro[..., 1]) * inv[..., 1]
    tymax = (hi[..., 1] - ro[..., 1]) * inv[..., 1]
    hit = ~((tmin > tymax) | (tymin > tmax))
    tmin = torch.where(tymin > tmin, tymin, tmin)
    tmax = torch.where(tymax < tmax, tymax, tmax)
    tzmin = (lo[..., 2] - ro[..., 2]) * inv[..., 2]
    tzmax = (hi[..., 2] - ro[..., 2]) * inv[..., 2]
    return hit & ~((tmin > tzmax) | (tzmin > tmax))


class TriangleAccel:
    """Closest and any hit against the triangles `v` (T, 3, 3), in the
    dtype of `v`; `reach` = (lo, hi), each (T, 3), for a clipped mesh."""

    def __init__(self, v: torch.Tensor, reach=None, culling: bool = True):
        v = v.detach()
        t_count = v.shape[0]
        per_group = LEAF * GROUP
        order = morton_order((v.amin(1) + v.amax(1)) * 0.5)
        n_pad = -(-t_count // per_group) * per_group - t_count
        # Padding repeats a real triangle: its hits tie with the original.
        self.ids = torch.cat([order, order[:1].expand(n_pad)])
        vs = v[self.ids]
        self.v0 = vs[:, 0]
        self.e1 = vs[:, 1] - vs[:, 0]
        self.e2 = vs[:, 2] - vs[:, 0]
        lo, hi = vs.amin(1).float(), vs.amax(1).float()
        pad = 1e-4 * float((hi.amax(0) - lo.amin(0)).max()) + 1e-6
        self.leaf_lo = lo.reshape(-1, LEAF, 3).amin(1) - pad
        self.leaf_hi = hi.reshape(-1, LEAF, 3).amax(1) + pad
        self.group_lo = self.leaf_lo.reshape(-1, GROUP, 3).amin(1)
        self.group_hi = self.leaf_hi.reshape(-1, GROUP, 3).amax(1)
        self.reach = (None if reach is None
                      else tuple(r[self.ids] for r in reach))
        self.culling = culling

    def _candidates(self, ro, rd, t_lim):
        """(ray, triangle slots (Q, LEAF)) pairs that the cull keeps."""
        dev = ro.device
        rof, inv = ro.float(), 1.0 / rd.float()
        tl = t_lim.float()
        g = _cull(rof[:, None], inv[:, None], self.group_lo[None],
                  self.group_hi[None], tl[:, None])
        r1, g1 = torch.nonzero(g, as_tuple=True)
        leaves = g1[:, None] * GROUP + torch.arange(GROUP, device=dev)
        m = _cull(rof[r1][:, None], inv[r1][:, None], self.leaf_lo[leaves],
                  self.leaf_hi[leaves], tl[r1][:, None])
        p2, j2 = torch.nonzero(m, as_tuple=True)
        rays = r1[p2]
        slots = leaves[p2, j2][:, None] * LEAF + torch.arange(LEAF, device=dev)
        return rays, slots

    def _accept(self, ro, rd, t_lim, rays, slots):
        o, d = ro[rays][:, None], rd[rays][:, None]
        t, _, _, ok = moller_trumbore(o, d, self.v0[slots], self.e1[slots],
                                      self.e2[slots], self.culling)
        ok = ok & (t < t_lim[rays][:, None])
        if self.reach is not None:
            ok = ok & reach_slab(o, d, self.reach[0][slots],
                                 self.reach[1][slots])
        return t, ok

    @torch.no_grad()
    def closest(self, ro, rd, t_lim):
        """Triangle id (int64) of each ray's closest accepted hit with
        t < t_lim, -1 for none."""
        out = []
        for s in range(0, ro.shape[0], RAY_STEP):
            o, d, tl = ro[s:s + RAY_STEP], rd[s:s + RAY_STEP], t_lim[s:s + RAY_STEP]
            n = o.shape[0]
            rays, slots = self._candidates(o, d, tl)
            t, ok = self._accept(o, d, tl, rays, slots)
            tt = torch.where(ok, t.float(), torch.inf)
            idx = rays[:, None].expand_as(tt).reshape(-1)
            best = torch.full((n,), torch.inf, device=o.device).scatter_reduce(
                0, idx, tt.reshape(-1), "amin")
            win = ok & (tt == best[rays][:, None])
            big = torch.iinfo(torch.int64).max
            cand = torch.where(win, self.ids[slots], big)
            tri = torch.full((n,), big, device=o.device).scatter_reduce(
                0, idx, cand.reshape(-1), "amin")
            out.append(torch.where(tri == big, -1, tri))
        return torch.cat(out) if out else torch.zeros(
            (0,), dtype=torch.int64, device=ro.device)

    @torch.no_grad()
    def any_hit(self, ro, rd, t_lim):
        """Whether each ray has an accepted hit with t < t_lim."""
        out = []
        for s in range(0, ro.shape[0], RAY_STEP):
            o, d, tl = ro[s:s + RAY_STEP], rd[s:s + RAY_STEP], t_lim[s:s + RAY_STEP]
            rays, slots = self._candidates(o, d, tl)
            _, ok = self._accept(o, d, tl, rays, slots)
            occ = torch.zeros((o.shape[0],), dtype=torch.bool, device=o.device)
            occ[rays[ok.any(1)]] = True
            out.append(occ)
        return torch.cat(out) if out else torch.zeros(
            (0,), dtype=torch.bool, device=ro.device)
