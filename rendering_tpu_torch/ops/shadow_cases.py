"""Seeded adversarial queries over one mesh's chunk tables, for holding
the any-hit walk and the closest walk (csrc/mesh_intersect.cu) against
their plain version: the same seed gives the same rays at any width, so
the CPU tests (a few tiles, against the Pallas kernel in interpret mode)
and `chip_smoke.py` (262,144 rays, kernel against plain version) run one
construction.

Kinds:
  interleaved  shadow rays from around the mesh toward points on it,
               with t0 = -1 on interleaved lanes: every other lane, all
               but one lane of each warp, every other warp (the packing's
               cases);
  on_surface   rays leaving points on the mesh's triangles, offset by
               the scene's bias along the face normal (either side),
               toward a light position, limited at the light: the
               self-shadowing query of the integrator;
  grazing      rays lying in a face plane of a cull box (the origin on
               the plane, the direction's component across it 0 or
               +-1e-20), so the slab test meets 0 x inf = NaN and huge
               reciprocals.

Closest-hit kinds (`closest_case`):
  union_live   in each group of four lanes: a ray aimed at a point on the
               mesh; one aimed there with t0 at half the distance (its
               own cull fails for the boxes beyond); one in a random
               direction (its cull mostly fails); one aimed just past the
               mesh's bounds. The tile's union stays live, so rays whose
               own cull fails evaluate sub-chunks as well;
  grazing      the shadow kind's rays in cull-box face planes;
  resolved     the shadow kind's interleaved lanes with t0 = -1 (the
               bounce loop's dead lanes), the others aimed at the mesh;
  duplicates   rays aimed at points on the mesh, meant for the tables of
               `duplicated(v)`, where every triangle appears twice, four
               rows apart: the lower row must win every hit.
"""

from __future__ import annotations

import numpy as np

KINDS = ("interleaved", "on_surface", "grazing")
SEEDS = {"interleaved": 11, "on_surface": 12, "grazing": 13}
CLOSEST_KINDS = ("union_live", "grazing", "resolved", "duplicates")
CLOSEST_SEEDS = {"union_live": 21, "grazing": 22, "resolved": 23,
                 "duplicates": 24}
LANES = 512       # the kernels' ray tile
FMAX = np.float32(3.4028234663852886e38)


def _triangles(tb):
    """(v0, e1, e2) (N, 3) of the tables' real triangles (pad rows are
    zero, so their cross product vanishes)."""
    rows = tb.tri.detach().cpu().numpy().transpose(0, 2, 1).reshape(-1, 16)
    v0, e1, e2 = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9]
    real = np.abs(np.cross(e1, e2)).sum(axis=1) > 0
    return v0[real], e1[real], e2[real]


def _normalize(v):
    return (v / np.linalg.norm(v, axis=0, keepdims=True)).astype(np.float32)


def interleaved_mask(n: int) -> np.ndarray:
    """(n,) bool, True on the lanes that enter resolved: in the first
    third of the rays every other lane, in the second all but lane 0 of
    each 32-lane warp, in the last every other warp."""
    lane = np.arange(n) % LANES
    third = np.arange(n) * 3 // max(n, 1)
    return np.where(third == 0, lane % 2 == 1,
                    np.where(third == 1, lane % 32 != 0, lane % 64 >= 32))


def shadow_case(tb, kind: str, n_rays: int, seed: int, *, bias=1e-4):
    """numpy float32 (ro3 (3, n), rd3 (3, n), t_limit (n,)) of one
    adversarial shadow query over the tables `tb` (IntersectTables)."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    rng = np.random.default_rng(seed)
    v0, e1, e2 = _triangles(tb)
    n = n_rays
    pick = rng.integers(0, v0.shape[0], n)
    u, v = rng.uniform(0, 1, (2, n)).astype(np.float32)
    flip = u + v > 1
    u, v = np.where(flip, 1 - u, u), np.where(flip, 1 - v, v)
    on_mesh = (v0[pick] + u[:, None] * e1[pick] + v[:, None] * e2[pick]).T
    centre = (v0.min(axis=0) + v0.max(axis=0)) / 2
    extent = float((v0.max(axis=0) - v0.min(axis=0)).max())
    if kind == "interleaved":
        ro = (centre[:, None] + rng.normal(0, extent, (3, n))).astype(np.float32)
        delta = on_mesh - ro
        rd = _normalize(delta)
        dist = np.linalg.norm(delta, axis=0)
        # Half the rays stop short of their target point, half run past.
        tl = (dist * rng.uniform(0.5, 1.5, n)).astype(np.float32)
        tl[interleaved_mask(n)] = -1.0
        return ro, rd, tl
    if kind == "on_surface":
        normal = _normalize(np.cross(e1[pick], e2[pick]).T)
        side = np.where(rng.uniform(size=n) < 0.5, 1.0, -1.0).astype(np.float32)
        ro = (on_mesh + normal * (side * np.float32(bias))).astype(np.float32)
        light = (centre[:, None]
                 + rng.normal(0, 2 * extent, (3, n))).astype(np.float32)
        delta = light - ro
        return ro, _normalize(delta), np.linalg.norm(delta, axis=0).astype(
            np.float32)
    # grazing: a face plane of a real cull box.
    cbox = tb.cbox.detach().cpu().numpy()
    boxes = cbox[cbox[:, 0] <= cbox[:, 3]]
    b = boxes[rng.integers(0, boxes.shape[0], n)]
    axis = rng.integers(0, 3, n)
    lo, hi = b[:, 0:3], b[:, 3:6]
    pad = 0.1 * (hi - lo)
    ro = rng.uniform(lo - pad, hi + pad).astype(np.float32)
    face = np.where(rng.uniform(size=n) < 0.5, lo[np.arange(n), axis],
                    hi[np.arange(n), axis])
    ro[np.arange(n), axis] = face
    rd = rng.normal(0, 1, (n, 3)).astype(np.float32)
    across = rng.choice(np.asarray([0.0, 1e-20, -1e-20], np.float32), n,
                        p=[0.5, 0.25, 0.25])
    rd[np.arange(n), axis] = across
    rd = _normalize(rd.T)
    rd[axis, np.arange(n)] = across  # exactly 0 or +-1e-20 after scaling
    tl = np.where(rng.uniform(size=n) < 0.5, FMAX,
                  rng.uniform(0.01, 2 * extent, n)).astype(np.float32)
    return ro.T.copy(), rd, tl


def duplicated(v) -> np.ndarray:
    """Vertices with every triangle of v (T, 3, 3) twice, four rows
    apart: each block of four triangles is followed by its copy (the last
    T mod 4 are dropped). A chunk of a multiple of 8 rows never splits a
    pair, the copies sit in different four-row groups (the closest walk's
    threads of a ray split a piece by such groups), and on an exact tie
    the original, whose row is lower (row mod 8 < 4), must win."""
    v = np.asarray(v, np.float32)
    blocks = v[:v.shape[0] // 4 * 4].reshape(-1, 4, 3, 3)
    return np.concatenate([blocks, blocks], axis=1).reshape(-1, 3, 3)


def closest_case(tb, kind: str, n_rays: int, seed: int, *, bias=1e-4):
    """numpy float32 (ro3 (3, n), rd3 (3, n), t_limit (n,)) of one
    seeded closest-hit query over the tables `tb` (IntersectTables)."""
    if kind not in CLOSEST_KINDS:
        raise ValueError(f"kind must be one of {CLOSEST_KINDS}, got {kind!r}")
    if kind == "grazing":
        return shadow_case(tb, "grazing", n_rays, seed, bias=bias)
    if kind == "resolved":
        ro, rd, tl = shadow_case(tb, "interleaved", n_rays, seed, bias=bias)
        return ro, rd, np.where(tl < 0, tl, FMAX).astype(np.float32)
    rng = np.random.default_rng(seed)
    v0, e1, e2 = _triangles(tb)
    n = n_rays
    pick = rng.integers(0, v0.shape[0], n)
    u, v = rng.uniform(0, 1, (2, n)).astype(np.float32)
    flip = u + v > 1
    u, v = np.where(flip, 1 - u, u), np.where(flip, 1 - v, v)
    on_mesh = (v0[pick] + u[:, None] * e1[pick] + v[:, None] * e2[pick]).T
    lo, hi = v0.min(axis=0), v0.max(axis=0)
    centre = (lo + hi) / 2
    extent = float((hi - lo).max())
    ro = (centre[:, None] + rng.normal(0, 2 * extent, (3, n))).astype(np.float32)
    target = on_mesh
    tl = np.full(n, FMAX, np.float32)
    if kind == "union_live":
        group = np.arange(n) % 4
        past = (hi + 0.05 * extent)[:, None] * np.ones((1, n), np.float32)
        target = np.where(group == 3, past + rng.normal(0, 0.02 * extent, (3, n)),
                          target)
        rand = rng.normal(0, 1, (3, n)).astype(np.float32)
        dist = np.linalg.norm(on_mesh - ro, axis=0)
        tl = np.where(group == 1, 0.5 * dist, tl).astype(np.float32)
        rd = _normalize(np.where(group == 2, rand, target - ro))
        return ro, rd, tl
    return ro, _normalize(target - ro), tl
