"""Dense chunked ray-mesh intersection — `rendering_tpu.ops.bruteforce`,
the oracle of a mesh of at most settings.bruteforce_threshold triangles
when use_pallas_intersect and use_mxu_intersect are off.

Every ray tests every triangle by Moller-Trumbore (`ops.intersect.
ray_triangle_r`'s f32 sequence), tri_chunk triangles a step, keeping the
running closest hit: the strict `t < t_best` across chunks and the first
minimum inside one, so the lowest (Morton) triangle id wins a tie,
whatever the chunk size. The reference breaks ties by leaf depth-first
order instead, so the two differ only on two distinct triangles at the
same f32 t. With the root filter (useAC on a mesh its root box clips) a
triangle is accepted only where the ray crosses its reach box, as the
reference only finds it through a leaf that holds it
(`make_aabb_acceptor`). Plain PyTorch: the JAX package runs it in XLA,
not in a Pallas kernel.
"""

from __future__ import annotations

import torch

from rendering_tpu_torch.ops.geometry import FLT_MAX
from rendering_tpu_torch.ops.intersect import ray_triangle_r


def make_aabb_acceptor(mesh, ro, rd, use_root_filter: bool):
    """accept(lo (Tc, 3), hi (Tc, 3)) -> (R, Tc) bool for rays ro/rd
    (R, 3): without the root filter every triangle; with it, the ray
    crosses the box by a literal transcription of intersectBox
    (objects.cpp:534-570; the sign swap and the pairwise comparisons,
    false on a NaN, no t >= 0 test), as `ops.intersect.slab_test` and the
    kernels' root filter do. `mesh` is unused, as in JAX."""
    del mesh
    if not use_root_filter:
        def accept_all(lo, hi):
            return torch.ones((ro.shape[0], lo.shape[0]), dtype=torch.bool,
                              device=ro.device)

        return accept_all

    inv = 1.0 / rd  # inf on zero components, like the reference

    def accept(lo_c, hi_c):
        def tpair(c):
            neg = inv[:, c:c + 1] < 0  # (R, 1)
            lo = torch.where(neg, hi_c[None, :, c], lo_c[None, :, c])
            hi = torch.where(neg, lo_c[None, :, c], hi_c[None, :, c])
            return ((lo - ro[:, c:c + 1]) * inv[:, c:c + 1],
                    (hi - ro[:, c:c + 1]) * inv[:, c:c + 1])

        tmin, tmax = tpair(0)
        tymin, tymax = tpair(1)
        hit = ~((tmin > tymax) | (tymin > tmax))
        tmin = torch.where(tymin > tmin, tymin, tmin)
        tmax = torch.where(tymax < tmax, tymax, tmax)
        tzmin, tzmax = tpair(2)
        return hit & ~((tmin > tzmax) | (tzmin > tmax))

    return accept


def pad_chunks(a, n_chunks: int, tri_chunk: int):
    """Per-triangle rows a (T, ...) padded with copies of row 0 to
    n_chunks * tri_chunk rows and cut into (n_chunks, tri_chunk, ...)."""
    pad = n_chunks * tri_chunk - a.shape[0]
    a = torch.cat([a, a[:1].expand((pad,) + a.shape[1:])])
    return a.reshape((n_chunks, tri_chunk) + a.shape[1:])


def no_triangles(r: int, dev):
    """A mesh without triangles: (t FLT_MAX, tri -1, 0, 0)."""
    z = torch.zeros((), dtype=torch.float32, device=dev)
    return (torch.full((r,), FLT_MAX, device=dev),
            torch.full((r,), -1, dtype=torch.int32, device=dev), z, z)


def closest_of_chunk(carry, t, ok, base: int, t_count: int):
    """Fold one chunk's (R, Tc) t and ok into carry = (t_best, tri_best):
    the padded lanes and hits not below t_best dropped, the first minimum
    of the chunk taken."""
    t_best, tri_best = carry
    tc = t.shape[1]
    lane = torch.arange(tc, device=t.device)
    ok = ok & ((base + lane) < t_count)[None, :] & (t < t_best[:, None])
    t = torch.where(ok, t, FLT_MAX)
    lane_min = torch.argmin(t, dim=1, keepdim=True)  # first min: lowest id
    any_ok = ok.any(dim=1)
    t_best = torch.where(any_ok, torch.gather(t, 1, lane_min)[:, 0], t_best)
    tri_best = torch.where(any_ok, (base + lane_min[:, 0]).to(torch.int32),
                           tri_best)
    return t_best, tri_best


def finish(t_best, tri_best, r: int, t_count: int):
    """(t, tri, box_tests, tri_tests) of a dense scan: t FLT_MAX where no
    triangle was taken; the counters JAX's, 0 and R*T in f32 (R*T
    overflows int32 at the sizes the dense scan is asked about)."""
    dev = t_best.device
    t_best = torch.where(tri_best >= 0, t_best, FLT_MAX)
    return (t_best, tri_best, torch.zeros((), device=dev),
            torch.tensor(float(r) * float(t_count), dtype=torch.float32,
                         device=dev))


def bruteforce_mesh(mesh, ro, rd, t_limit=None, *,
                    backface_culling: bool = True, tri_chunk: int = 512,
                    use_root_filter: bool = True):
    """Closest hit over all of a mesh's triangles (mesh.v (T, 3, 3), its
    reach boxes mesh.reach_lo/hi (T, 3)) for rays ro/rd (R, 3); t_limit
    (R,) bounds the hits (a shadow query's). Returns (t, tri, box_tests,
    tri_tests): t FLT_MAX and tri -1 on a miss or beyond t_limit."""
    t_count = int(mesh.v.shape[0])
    r = ro.shape[0]
    dev = ro.device
    if t_count == 0:
        return no_triangles(r, dev)
    n_chunks = -(-t_count // tri_chunk)
    v = pad_chunks(mesh.v, n_chunks, tri_chunk)            # (C, Tc, 3, 3)
    reach_lo = pad_chunks(mesh.reach_lo, n_chunks, tri_chunk)
    reach_hi = pad_chunks(mesh.reach_hi, n_chunks, tri_chunk)
    t_best = torch.full((r,), FLT_MAX, device=dev)
    if t_limit is not None:
        t_best = torch.minimum(t_best, t_limit)
    accept = make_aabb_acceptor(mesh, ro, rd, use_root_filter)
    ro3 = ro.T[:, :, None]  # (3, R, 1)
    rd3 = rd.T[:, :, None]
    carry = (t_best, torch.full((r,), -1, dtype=torch.int32, device=dev))
    for c in range(n_chunks):
        vr = v[c].permute(1, 2, 0)[:, :, None, :]  # (3 verts, 3, 1, Tc)
        t, _, _, ok = ray_triangle_r(ro3, rd3, vr[0], vr[1], vr[2],
                                     backface_culling)        # (R, Tc)
        ok = ok & accept(reach_lo[c], reach_hi[c])
        carry = closest_of_chunk(carry, t, ok, c * tri_chunk, t_count)
    return finish(*carry, r, t_count)
