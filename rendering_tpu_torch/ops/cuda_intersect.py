"""Ray-mesh intersection: the hand-written CUDA closest-hit and any-hit
kernels, their plain PyTorch versions, the chunk tables and the
per-tile pre-pass, and the two-phase shadow query (K6).

The kernels (csrc/mesh_intersect.cu) replace the Pallas TPU kernel
`rendering_tpu/ops/pallas_intersect.py::_kernel` in its two modes:
closest hit for primary rays and any hit for the batched shadow rays
(K1, K2), and its fused multi-mesh entry `intersect_fused` (K5): the
same walk over every mesh's tables concatenated, with the closest hit
remapped to (mesh, gather column) through an idmap in the epilogue.
Each comes in the kernel's two optional modes as well: the root filter
(K4, `root_filter`), which accepts a hit only where the ray also crosses
the triangle's BVH reach box (table rows 9-14; it replicates the
reference's clipping of a rotated mesh by its root box), and the test
counters (K3, `collect_stats`), [tri_tests, box_tests] with the Pallas
kernel's semantics. Every combination is its own launcher with its own
launch count (`KERNELS`). K6 (`any_hit_two_phase`, the JAX package's
`anyhit_two_phase`) is the any hit launched twice, over two super ranges
of one mesh's tables, with the rays it resolved in the first launch
packed behind the others for the second; its launches count apart.
They are bound by f32 operations (57 instructions per ray-triangle pair,
each issued alone under -fmad=false; the tables are only ~16 MB at 250k
triangles), so the design keeps triangle rows in shared memory for a
whole 512-ray tile, culls sub-chunks against each ray's running t, and
skips resolved rays. Every closest hit runs the closest walk: tiles
heaviest first, a heavy tile (`tile_schedule`) split over a thread block
cluster of CLOSEST_CLUSTER CTAs that agree on its live sub-chunks
through distributed shared memory, each ray's triangles shared by as
many threads, the other tiles whole on one CTA each. Every any hit runs
the any-hit walk, which evaluates the same pairs with the unresolved
rays packed into the lowest lanes, a persistent grid of one CTA per SM
that takes the tiles heaviest first, and its row staging overlapped
with compute. The source file's header says more, and PERF.md section 6
how the walks were measured against the one-CTA-a-tile walk they
replaced; `intersect_plain`'s stats count the work each walk issues.

Pipeline of one query (`closest_hit` / `any_hit`):

  prepare    rays -> padded (10, Rp) rows [ro, rd, 1/rd, t0] and, per
             512-ray tile, the live super chunks in near-to-far order
             (an exact per-ray slab test of every super AABB, any() over
             the tile — the JAX package's XLA pre-pass: on CUDA tensors
             the pre-pass kernel, `KERNELS["prepass"]`, one launch with
             no host read; on CPU tensors its plain version tile_tables),
             and the walks' tile schedule (tile_schedule: heaviest
             first, the heavy tiles counted).
  kernel     walks each tile's live list (CUDA tensors) — or the plain
             version (CPU tensors): the TPU formulation vectorised over
             tiles, which the CPU tests hold against the Pallas kernel
             in interpret mode and the card holds against the kernel.

In a recorded trace (`utils.tracing`) `prepare` is the span
`rt.intersect.prepass` (the counter `prepass_tiles` adds the tiles
through the pre-pass kernel) and each launch (or plain version) is
`rt.intersect.kernel`; building the tables is `rt.scene.tables`.

The Pallas grid's step-table compaction (`_pair_tables`, the bucket
ladder and its all-pairs fallbacks) exists only because a Pallas grid
is static; the kernel's per-tile loop replaces it. The counters count
the fine 512-ray tiling: the Pallas kernel's coarse fallback retiling
(more than 200_000 / 12 tile-super pairs) counts box tests at its own
tile width.
"""

from __future__ import annotations

import ctypes
import dataclasses
import itertools
import os

import numpy as np
import torch

from rendering_tpu_torch.ops.geometry import FLT_MAX as FMAX
from rendering_tpu_torch.utils import nvcc
from rendering_tpu_torch.utils.tracing import count, span, traced

RAY_TILE = 512              # rays per kernel CTA and per pre-pass tile
SUB_PER_SUPER = 8           # cull chunks per super chunk
_PIECE = 64                 # the kernel stages triangles 64 at a time
_CULL_REGS = 8              # the closest walk's cull chunks a super, at most
_PREPASS_ELEMS = 1 << 24    # bound on (tiles, 512, Cs) pre-pass temporaries
_PLAIN_TILES = 64           # tiles per batch of the plain version on the CPU
# The pre-pass kernel sorts a tile's (key, id) pairs, 8 bytes each, over
# the next power of two at or above Cs in dynamic shared memory: 128 KiB
# at most, beside its 16 KiB of staged rays.
PREPASS_MAX_SUPERS = 1 << 14
# On a card the plain version's time is its Python loop (~30 launches per
# visit rank and sub-chunk), so it batches as many tiles as keep each
# (tiles, tc, 512) temporary at 2^24 elements.
_PLAIN_ELEMS_CUDA = 1 << 24
# The any-hit walk's persistent grid: one CTA per SM, so the heaviest
# tiles, which set the kernel's time, run alone on their SMs (on an H100
# every kept query took 0.65-0.95x the time of two CTAs per SM, as many
# as fit; PERF.md).
WALK_CTAS_PER_SM = 1
# The closest walk's CTAs per cluster (a heavy tile split over them; 8 is
# the portable cluster limit), and the sizes it takes. 4 by measurement on
# an H100: with SPLIT_FACTOR 2 every kept closest query ran faster than on
# the one-CTA-a-tile walk it replaced, in turns, and the bouncing frame's
# closest hits took the least kernel time (PERF.md, PR 8).
CLUSTER_SIZES = (1, 2, 4, 8)
CLOSEST_CLUSTER = 4
# A tile is heavy, and the closest walk splits it over a cluster, when its
# live-super count is at least this many times the query's mean (0 splits
# every tile with a live super: on the flagship's even tiles that cost
# 1.3x, their per-super latency outgrowing the split compute).
SPLIT_FACTOR = 2

SOURCE = os.path.join(nvcc.CSRC, "mesh_intersect.cu")


@dataclasses.dataclass
class IntersectTables:
    """Morton-ordered chunk tables of one mesh (the baked acceleration
    structure; rebuild after any geometry update that should move the
    discrete hits). The train step (`diff.inverse`) does not rebuild
    them, as in the JAX package: after a vertex step the oracle still
    picks triangles from the build-time tables, and only the
    differentiable re-evaluation of the picked triangle sees the new
    vertices.

    tri:  (Cs, 16, n_sub*tc) f32 — rows v0 xyz, e1 xyz, e2 xyz, reach_lo
          xyz, reach_hi xyz (the root filter's boxes), then zeros.
    cbox: (Cs*n_sub, 8) f32 — cull-chunk AABBs [lo xyz, hi xyz, 0, 0];
          pad chunks hold inverted boxes.
    sbox: (Cs, 8) f32 — super-chunk AABBs for the pre-pass."""

    tri_chunk: int
    n_sub: int
    tri: torch.Tensor
    cbox: torch.Tensor
    sbox: torch.Tensor

    def to(self, device) -> "IntersectTables":
        return dataclasses.replace(
            self, tri=self.tri.to(device), cbox=self.cbox.to(device),
            sbox=self.sbox.to(device),
        )


def default_tri_chunk(n_tris: int) -> int:
    """Cull-chunk size: 64 triangles, doubled until the mesh has at most
    ~512 supers (the pre-pass scales with the super count)."""
    tc = 64
    while -(-n_tris // (tc * SUB_PER_SUPER)) > 512:
        tc *= 2
    return min(tc, 2048)


@traced("rt.scene.tables")
def build_intersect_tables(v: np.ndarray, *, tri_chunk: int,
                           n_sub: int | None = None,
                           reach=None) -> IntersectTables:
    """Host numpy build of the chunk tables from Morton-ordered vertices
    v (T, 3, 3) — `pallas_intersect.build_intersect_tables`. reach:
    (reach_lo, reach_hi), each (T, 3) in the same order, the mesh's BVH
    reach boxes (rows 9-14); None puts each triangle's own bounds there,
    which makes the root filter accept every hit. Zero-padded triangles
    fail the det epsilon in both culling modes; padded cull chunks get
    inverted boxes."""
    n_sub, tri, cbox, sbox = _table_arrays(v, tri_chunk, n_sub, reach)
    return IntersectTables(tri_chunk, n_sub, torch.from_numpy(tri),
                           torch.from_numpy(cbox), torch.from_numpy(sbox))


def _table_arrays(v, tri_chunk: int, n_sub: int | None, reach=None):
    """(n_sub, tri, cbox, sbox) of `build_intersect_tables` as numpy."""
    v = np.asarray(v, np.float32)
    T = int(v.shape[0])
    if T == 0:
        raise ValueError("a mesh without triangles has no tables")
    n_chunks = -(-T // tri_chunk)
    if n_sub is None:
        n_sub = min(SUB_PER_SUPER, n_chunks)
    n_super = -(-n_chunks // n_sub)
    n_chunks = n_super * n_sub
    t_pad = n_chunks * tri_chunk - T
    reach_lo, reach_hi = ((v.min(axis=1), v.max(axis=1)) if reach is None
                          else reach)

    v0 = v[:, 0]
    e1 = v[:, 1] - v0
    e2 = v[:, 2] - v0
    rows = np.concatenate(
        [v0, e1, e2, reach_lo, reach_hi, np.zeros((T, 1), np.float32)],
        axis=1,
    ).astype(np.float32)
    rows = np.pad(rows, ((0, t_pad), (0, 0)))
    tri = np.ascontiguousarray(
        rows.reshape(n_super, n_sub * tri_chunk, 16).transpose(0, 2, 1)
    )
    ub_lo = np.pad(v.min(axis=1), ((0, t_pad), (0, 0)), constant_values=FMAX)
    ub_hi = np.pad(v.max(axis=1), ((0, t_pad), (0, 0)), constant_values=-FMAX)
    clo = ub_lo.reshape(n_chunks, tri_chunk, 3).min(axis=1)
    chi = ub_hi.reshape(n_chunks, tri_chunk, 3).max(axis=1)
    cbox = np.concatenate(
        [clo, chi, np.zeros((n_chunks, 2), np.float32)], axis=1
    ).astype(np.float32)
    sbox = np.concatenate(
        [
            clo.reshape(n_super, n_sub, 3).min(axis=1),
            chi.reshape(n_super, n_sub, 3).max(axis=1),
            np.zeros((n_super, 2), np.float32),
        ],
        axis=1,
    ).astype(np.float32)
    return n_sub, tri, cbox, sbox


@dataclasses.dataclass
class FusedTables:
    """The chunk tables of several meshes concatenated along the super
    axis, for one kernel launch over all of them (the JAX package's
    `pallas_intersect.FusedTables`).

    geo:    IntersectTables over the fused chunk space (one tri_chunk,
            n_sub = 8 for every mesh, so each mesh pads to whole supers
            and pad cull chunks sit inside the table).
    idmap:  (2, n_pad) int32 — per fused triangle slot, the mesh's scene
            sub index and its global column in the meshes' concatenated
            (30, T_total) gather table; pad slots alias their mesh's
            last real triangle.
    n_meshes, t_total: all meshes of the scene and their triangle total
            (excluded meshes still advance the column offsets).
    any_clipped: some included mesh pokes outside its root box, so the
            queries need the root filter (use_ac and any_clipped)."""

    geo: IntersectTables
    idmap: torch.Tensor
    n_meshes: int
    any_clipped: bool
    t_total: int

    def to(self, device) -> "FusedTables":
        return dataclasses.replace(self, geo=self.geo.to(device),
                                   idmap=self.idmap.to(device))


@traced("rt.scene.tables")
def build_fused_tables(vs, clipped_flags, include=None,
                       reach=None) -> FusedTables | None:
    """Host numpy build of the fused tables from every mesh's
    Morton-ordered vertices vs[i] (T_i, 3, 3), in scene sub order, equal
    bit for bit to `pallas_intersect.build_fused_tables`. A clipped mesh
    (clipped_flags[i]) puts its BVH reach boxes reach[i] = (lo, hi) into
    rows 9-14; an unclipped one its triangles' own bounds, on which the
    root filter accepts every hit, so one filter flag for the whole
    query (use_ac and any_clipped) gates each mesh exactly as per mesh.
    include[i] False leaves mesh i out (the shadow tables leave out
    transparent meshes). Returns None when no included mesh has
    triangles."""
    n = len(vs)
    if include is None:
        include = [True] * n
    ts = [int(np.shape(v)[0]) for v in vs]
    t_total_inc = sum(t for t, inc in zip(ts, include) if inc)
    if t_total_inc == 0:
        return None
    # One chunk shape for all meshes, sized by the included total.
    tc = default_tri_chunk(t_total_inc)
    tris, cboxes, sboxes, mids, vids = [], [], [], [], []
    vofs = 0
    any_clipped = False
    for i, v in enumerate(vs):
        t_i = ts[i]
        if include[i] and t_i:
            clipped = bool(clipped_flags[i])
            if clipped and (reach is None or reach[i] is None):
                raise ValueError(f"mesh {i} is clipped by its root box and "
                                 f"needs its reach boxes")
            any_clipped = any_clipped or clipped
            _, tri, cbox, sbox = _table_arrays(
                v, tc, SUB_PER_SUPER, reach[i] if clipped else None)
            tris.append(tri)
            cboxes.append(cbox)
            sboxes.append(sbox)
            n_pad = tri.shape[0] * SUB_PER_SUPER * tc
            mids.append(np.full((n_pad,), i, np.int32))
            vids.append((vofs + np.minimum(np.arange(n_pad), t_i - 1))
                        .astype(np.int32))
        vofs += t_i
    geo = IntersectTables(
        tc, SUB_PER_SUPER,
        *(torch.from_numpy(np.concatenate(a, axis=0))
          for a in (tris, cboxes, sboxes)),
    )
    idmap = np.stack([np.concatenate(mids), np.concatenate(vids)], axis=0)
    return FusedTables(geo, torch.from_numpy(idmap), n, any_clipped, vofs)


# ---- pre-pass --------------------------------------------------------


def _slab(box, ro, inv):
    """Slab interval of boxes against rays, NaN-propagating like
    jnp.minimum/maximum. box (..., C, 8); ro/inv (..., 3, BR).
    Returns ctmin, ctmax (..., BR, C)."""
    ctmin = ctmax = None
    for c in range(3):
        o = ro[..., c, :, None]
        iv = inv[..., c, :, None]
        t1 = (box[..., None, :, c] - o) * iv
        t2 = (box[..., None, :, 3 + c] - o) * iv
        lo = torch.minimum(t1, t2)
        hi = torch.maximum(t1, t2)
        if ctmin is None:
            with span("rt.sync.prepass_bounds"):
                fmin = torch.tensor(-FMAX, device=lo.device)
                fmax = torch.tensor(FMAX, device=hi.device)
            ctmin = torch.maximum(lo, fmin)
            ctmax = torch.minimum(hi, fmax)
        else:
            ctmin = torch.maximum(ctmin, lo)
            ctmax = torch.minimum(ctmax, hi)
    return ctmin, ctmax


def tile_live_exact(ro_t, inv_t, t0_t, box):
    """Per-tile chunk cull: exact per-ray slab test, any() over the
    tile's rays. ro_t/inv_t (n_tiles, 3, BR); t0_t (n_tiles, BR); box
    (C, 8). Returns live (n_tiles, C) bool. Negated comparisons keep a
    NaN slab live; resolved rays (t0 < 0) add no liveness; pad boxes
    (lo.x > hi.x) are dead. Chunked over tiles to bound temporaries."""
    n_tiles, _, br = ro_t.shape
    C = box.shape[0]
    invalid = box[:, 0] > box[:, 3]
    step = max(1, _PREPASS_ELEMS // max(1, br * C))
    out = []
    for s in range(0, n_tiles, step):
        t0 = t0_t[s:s + step, :, None]
        ctmin, ctmax = _slab(box, ro_t[s:s + step], inv_t[s:s + step])
        dead = (ctmin > ctmax) | (ctmax < 0) | (ctmin >= t0) | (t0 < 0)
        out.append((~(dead | invalid)).any(dim=1))
    if not out:  # no rays
        return torch.zeros((0, C), dtype=torch.bool, device=box.device)
    return torch.cat(out)


def super_dist2(ro_t, t0_t, sbox):
    """The visit order's sort key of a live super: the squared distance
    of its box's centre from the centroid of the tile's live ray origins,
    (n_tiles, Cs) f32. ro_t (n_tiles, 3, BR); t0_t (n_tiles, BR)."""
    lane = (t0_t >= 0).to(torch.float32)
    cnt = torch.clamp_min(lane.sum(dim=1), 1.0)
    centroid = (ro_t * lane[:, None, :]).sum(dim=2) / cnt[:, None]
    ccenter = (sbox[None, :, 0:3] + sbox[None, :, 3:6]) * 0.5
    return ((ccenter - centroid[:, None, :]) ** 2).sum(dim=-1)


def tile_tables(ro_t, inv_t, t0_t, sbox):
    """Per-tile live-first, near-to-far super visit order
    (`pallas_intersect._tile_tables`). Returns (torder (n_tiles, Cs)
    int32, counts (n_tiles,) int32). The sort key is the distance from
    the centroid of the tile's live ray origins (`super_dist2`); dead
    supers key to FMAX and, the sort being stable, keep id order behind
    the live ones. The plain version of the pre-pass kernel
    (`PrepassKernel`), which `prepare` runs on CPU tensors only."""
    live = tile_live_exact(ro_t, inv_t, t0_t, sbox)
    key = torch.where(live, super_dist2(ro_t, t0_t, sbox), FMAX)
    torder = torch.argsort(key, dim=1, stable=True).to(torch.int32)
    counts = live.sum(dim=1).to(torch.int32)
    return torder, counts


@dataclasses.dataclass
class Prepared:
    """A query ready for the kernel: padded ray rows, visit tables and
    the walks' tile schedule (`tile_schedule`)."""

    aux: torch.Tensor      # (10, Rp) f32 rows ro xyz, rd xyz, 1/rd xyz, t0
    torder: torch.Tensor   # (n_tiles, Cs) int32
    counts: torch.Tensor   # (n_tiles,) int32
    n_rays: int            # R before padding
    order: torch.Tensor    # (n_tiles,) int32, heaviest tile first
    n_split: torch.Tensor  # (1,) int32: the first n_split of order are heavy

    @property
    def n_tiles(self) -> int:
        return self.counts.shape[0]


def tile_order(counts: torch.Tensor) -> torch.Tensor:
    """The walks' tile order: tiles by live-super count, heaviest first,
    ties in tile order (a stable sort on the device; no host sync). Tiles
    are independent, so the order changes no result."""
    return torch.argsort(counts, descending=True, stable=True).to(torch.int32)


def tile_schedule(counts: torch.Tensor, split_factor: int | None = None):
    """The walks' tile schedule from the live-super counts, on the
    counts' device without a host sync: (order, n_split). order
    (`tile_order`) takes the tiles heaviest first; the first n_split of
    them are heavy, their count at least `split_factor` (default
    SPLIT_FACTOR) times the mean and above 0, and the closest walk splits
    each over a cluster, while the others run whole on one CTA each.
    Neither changes a result."""
    if split_factor is None:
        split_factor = SPLIT_FACTOR
    c = counts.to(torch.int64)
    heavy = (c * c.numel() >= split_factor * c.sum()) & (c > 0)
    return tile_order(counts), heavy.sum(dim=0, keepdim=True).to(torch.int32)


@traced("rt.intersect.prepass")
@torch.no_grad()
def prepare(tb: IntersectTables, ro3, rd3, t_limit=None) -> Prepared:
    """Pad rays to whole 512-ray tiles and run the pre-pass (the visit
    tables and the walks' tile schedule). Padded lanes have ro = 0, rd = 1
    and t0 = -1 (born resolved), as at `pallas_intersect.py:768-783`; 1/rd
    is computed here, outside the kernel. The visit tables come from the
    pre-pass kernel (`KERNELS["prepass"]`) on CUDA tensors, with no host
    sync, and from its plain version (`tile_tables`) on CPU tensors."""
    R = ro3.shape[1]
    n_tiles = -(-R // RAY_TILE)
    rp = n_tiles * RAY_TILE
    pad = rp - R
    dev = ro3.device
    t0 = torch.full((R,), FMAX, dtype=torch.float32, device=dev)
    if t_limit is not None:
        t0 = torch.minimum(t0, t_limit)
    ro_p = torch.nn.functional.pad(ro3, (0, pad))
    rd_p = torch.nn.functional.pad(rd3, (0, pad), value=1.0)
    t0 = torch.nn.functional.pad(t0, (0, pad), value=-1.0)
    inv = 1.0 / rd_p
    aux = torch.cat([ro_p, rd_p, inv, t0[None]], dim=0).contiguous()
    ro_t = ro_p.reshape(3, n_tiles, RAY_TILE).transpose(0, 1)
    t0_t = t0.reshape(n_tiles, RAY_TILE)
    if aux.is_cuda:
        torder, counts = prepass_kernel(
            aux, tb.sbox, super_dist2(ro_t, t0_t, tb.sbox).contiguous())
        count("prepass_tiles", n_tiles)
    else:
        if dev.type != "cpu":
            raise ValueError(f"no pre-pass for device {dev}")
        torder, counts = tile_tables(
            ro_t, inv.reshape(3, n_tiles, RAY_TILE).transpose(0, 1), t0_t,
            tb.sbox)
    counts = counts.contiguous()
    return Prepared(aux, torder.contiguous(), counts, R,
                    *tile_schedule(counts))


# ---- plain PyTorch version --------------------------------------------


def _mt_block(tri_rows, ray, backface_culling: bool):
    """Moller-Trumbore of a (m, 9+, tc) triangle block against (m, 6+,
    BR) rays [ro, rd], in `_intersect_chunk`'s f32 order. Returns t, ok
    (m, tc, BR)."""
    v0 = [tri_rows[:, c, :, None] for c in range(3)]
    e1 = [tri_rows[:, 3 + c, :, None] for c in range(3)]
    e2 = [tri_rows[:, 6 + c, :, None] for c in range(3)]
    ro = [ray[:, c, None, :] for c in range(3)]
    rd = [ray[:, 3 + c, None, :] for c in range(3)]
    p0 = rd[1] * e2[2] - rd[2] * e2[1]
    p1 = rd[2] * e2[0] - rd[0] * e2[2]
    p2 = rd[0] * e2[1] - rd[1] * e2[0]
    det = (e1[0] * p0 + e1[1] * p1) + e1[2] * p2
    ok = det >= 1e-8 if backface_culling else torch.abs(det) >= 1e-8
    inv = 1.0 / torch.where(ok, det, 1.0)
    tv0 = ro[0] - v0[0]
    tv1 = ro[1] - v0[1]
    tv2 = ro[2] - v0[2]
    u = ((tv0 * p0 + tv1 * p1) + tv2 * p2) * inv
    q0 = tv1 * e1[2] - tv2 * e1[1]
    q1 = tv2 * e1[0] - tv0 * e1[2]
    q2 = tv0 * e1[1] - tv1 * e1[0]
    v = ((rd[0] * q0 + rd[1] * q1) + rd[2] * q2) * inv
    t = ((e2[0] * q0 + e2[1] * q1) + e2[2] * q2) * inv
    ok = ok & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t >= 0)
    return t, ok


def _reach_block(tri_rows, ray):
    """The root filter's literal reference slab (`pallas_intersect.py:
    338-354`) of (m, 15, tc) triangle rows' reach boxes (rows 9-14)
    against (m, 9+, BR) rays [ro, rd, 1/rd]: sign swap by inv < 0, then
    (lo - ro) * inv, the negated pairwise comparisons and the select
    updates; NaN corners are accepted as the reference's comparisons
    accept them. Returns box_hit (m, tc, BR)."""
    def tpair(c):
        lo_c = tri_rows[:, 9 + c, :, None]
        hi_c = tri_rows[:, 12 + c, :, None]
        ro_c = ray[:, c, None, :]
        inv_c = ray[:, 6 + c, None, :]
        neg = inv_c < 0
        lo = torch.where(neg, hi_c, lo_c)
        hi = torch.where(neg, lo_c, hi_c)
        return (lo - ro_c) * inv_c, (hi - ro_c) * inv_c

    tmin, tmax = tpair(0)
    tymin, tymax = tpair(1)
    box_hit = ~((tmin > tymax) | (tymin > tmax))
    tmin = torch.where(tymin > tmin, tymin, tmin)
    tmax = torch.where(tymax < tmax, tymax, tmax)
    tzmin, tzmax = tpair(2)
    return box_hit & ~((tmin > tzmax) | (tzmin > tmax))


@torch.no_grad()
def intersect_plain(tb: IntersectTables, prep: Prepared, *, anyhit: bool,
                    backface_culling: bool, root_filter: bool = False,
                    collect_stats: bool = False, stats: dict | None = None):
    """The kernel's function in plain PyTorch: the TPU formulation
    vectorised over tiles. For visit rank k, every tile with a k-th live
    super gathers it; for each sub-chunk j a (tiles, tc, 512)
    Moller-Trumbore block (and with `root_filter` the reach-box slab),
    the min over rows, then `better = t_min < t_prev`. Returns raw
    (t (Rp,), tri (Rp,) int32) in padded chunk-space ids; with
    `collect_stats` also the K3 counters box_tests and tri_tests (int64
    0-d tensors). A `stats` dict receives the work that bounds the
    kernel, summed over the steps (tile, super, sub-chunk) whose
    sub-chunk is tile-live, each counted at the sub-chunk's start:
      "pairs": the ray-triangle pairs the per-ray cull requires
        (= tri_tests);
      "union_pairs": the tile's unresolved rays (t >= 0) x tc, what the
        TPU formulation evaluates and the least an exact kernel must;
      "warp_pairs": 32 x tc x the 32-lane warps (lanes in tile order)
        holding an unresolved ray, the lane-slots a walk issues that
        keeps the rays in their lanes;
      "packed_pairs": the same over the warps of the any-hit walk, whose
        rays unresolved at the super's start sit packed in the lowest
        lanes (a stable compaction);
      "tile_union_max": the largest union_pairs of one tile (a tile runs
        on one CTA, so its pairs bound the kernel's time from below);
      "accepts": the pairs Moller-Trumbore accepts below the ray's t at
        the block's start (where the kernel runs the root filter's
        slab)."""
    n_tiles = prep.n_tiles
    tc, n_sub = tb.tri_chunk, tb.n_sub
    cs = tb.sbox.shape[0]
    dev = prep.aux.device
    rays = prep.aux.reshape(10, n_tiles, RAY_TILE).transpose(0, 1)
    t_all = rays[:, 9].clone()
    tri_all = torch.full((n_tiles, RAY_TILE), -1, dtype=torch.int32,
                         device=dev)
    tri_tab = tb.tri.reshape(cs, 16, n_sub, tc)
    n_rows = 15 if root_filter else 9
    boxes_tab = tb.cbox.reshape(cs, n_sub, 8)
    rows = torch.arange(tc, dtype=torch.int32, device=dev)[None, :, None]
    count = collect_stats or stats is not None
    pairs = accepts = union = warp = packed = 0
    tile_union = torch.zeros((n_tiles,), dtype=torch.int64, device=dev)
    step = (_PLAIN_TILES if dev.type == "cpu"
            else max(1, _PLAIN_ELEMS_CUDA // (tc * RAY_TILE)))
    for s in range(0, n_tiles, step):
        tiles = torch.arange(s, min(s + step, n_tiles), device=dev)
        counts = prep.counts[tiles]
        for k in range(int(counts.max()) if len(tiles) else 0):
            idx = tiles[counts > k]
            sup = prep.torder[idx, k].long()
            ray = rays[idx]
            boxes = boxes_tab[sup]                           # (m, n_sub, 8)
            ctmin, ctmax = _slab(boxes, ray[:, 0:3], ray[:, 6:9])
            invalid = (boxes[:, :, 0] > boxes[:, :, 3])[:, None, :]
            live0 = ~((ctmin > ctmax) | (ctmax < 0) | invalid)  # (m, BR, n_sub)
            if stats is not None:  # the any-hit walk's lane of each ray
                held = ~(t_all[idx] < 0)
                slot = torch.cumsum(held, dim=1) - 1
            for j in range(n_sub):
                t_run = t_all[idx]
                live = live0[:, :, j] & ~((ctmin[:, :, j] >= t_run)
                                          | (t_run < 0))
                if count:
                    pairs += int(live.sum()) * tc
                go = live.any(dim=1)
                if not bool(go.any()):
                    continue
                sel, sup_j, ray_j = idx[go], sup[go], ray[go]
                t_prev = t_run[go]
                if stats is not None:
                    unres = t_prev >= 0
                    union += int(unres.sum()) * tc
                    tile_union[sel] += unres.sum(dim=1) * tc  # sel: distinct tiles
                    warp += int(unres.reshape(-1, RAY_TILE // 32, 32)
                                .any(dim=2).sum()) * 32 * tc
                    wid = torch.where(unres & held[go], slot[go] // 32,
                                      RAY_TILE // 32)
                    busy = torch.zeros((wid.shape[0], RAY_TILE // 32 + 1),
                                       dtype=torch.bool, device=dev)
                    busy.scatter_(1, wid, True)
                    packed += int(busy[:, :-1].sum()) * 32 * tc
                tri_j = tri_tab[sup_j, 0:n_rows, j]
                t, ok = _mt_block(tri_j, ray_j, backface_culling)
                ok = ok & (t < t_prev[:, None, :])
                if stats is not None:
                    accepts += int(ok.sum())
                if root_filter:
                    ok = ok & _reach_block(tri_j, ray_j)
                if anyhit:
                    hit = ok.any(dim=1)
                    t_all[sel] = torch.where(hit, -1.0, t_prev)
                    tri_all[sel] = torch.where(hit, 0, tri_all[sel])
                    continue
                tm = torch.where(ok, t, FMAX)
                t_min = tm.amin(dim=1)
                better = t_min < t_prev
                row = torch.where(tm == t_min[:, None, :], rows,
                                  2**30).amin(dim=1)
                base = ((sup_j * n_sub + j) * tc).to(torch.int32)[:, None]
                t_all[sel] = torch.where(better, t_min, t_prev)
                tri_all[sel] = torch.where(better, base + row, tri_all[sel])
    if stats is not None:
        for key, n in (("pairs", pairs), ("union_pairs", union),
                       ("warp_pairs", warp), ("packed_pairs", packed),
                       ("accepts", accepts)):
            stats[key] = stats.get(key, 0) + n
        heaviest = int(tile_union.max()) if n_tiles else 0
        stats["tile_union_max"] = max(stats.get("tile_union_max", 0), heaviest)
    out = (t_all.reshape(-1), tri_all.reshape(-1))
    if not collect_stats:
        return out
    box = int(prep.counts.sum()) * n_sub * RAY_TILE
    return out + tuple(torch.tensor(x, dtype=torch.int64, device=dev)
                       for x in (box, pairs))


# ---- the CUDA kernels ----------------------------------------------------

_lib = None


def _library():
    global _lib
    if _lib is None:
        path, _ = nvcc.build_library(SOURCE)
        lib = ctypes.CDLL(path)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.rt_intersect.argtypes = [ptr] * 13 + [i32] * 13 + [ptr]
        lib.rt_intersect.restype = ctypes.c_int
        lib.rt_resources.argtypes = [i32] * 5 + [ptr]
        lib.rt_resources.restype = ctypes.c_int
        lib.rt_prepass.argtypes = [ptr] * 5 + [i32] * 3 + [ptr]
        lib.rt_prepass.restype = ctypes.c_int
        lib.rt_error_string.argtypes = [ctypes.c_int]
        lib.rt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


@dataclasses.dataclass
class CudaKernel:
    """One variant of csrc/mesh_intersect.cu's kernels: closest or any
    hit, over one mesh's tables or fused ones (the fused closest hit
    remaps through the idmap), with or without the root filter (K4) and
    the counters (K3). A closest hit launches the closest walk
    (`closest_walk_kernel`), an any hit the any-hit walk
    (`anyhit_walk_kernel`). `launches` counts the launches made through
    it."""

    name: str
    anyhit: bool
    fused: bool
    root_filter: bool
    collect_stats: bool
    two_phase: bool = False
    launches: int = 0

    def __call__(self, tb: IntersectTables, prep: Prepared, *,
                 backface_culling: bool, idmap: torch.Tensor | None = None,
                 cluster: int = CLOSEST_CLUSTER):
        """Raw (t (Rp,), tri (Rp,) int32) in padded chunk-space ids; the
        fused closest hit returns (t, mid, vid) through idmap instead,
        with t = FMAX, mid = -1 and vid = 0 on a miss. With the counters
        the tuple ends in box_tests, tri_tests (int64 0-d tensors).
        `cluster` sets the closest walk's CTAs per cluster
        (CLUSTER_SIZES), for holding each size to the plain version; the
        closest walk splits the heavy tiles of `prep` (`tile_schedule`).
        The any-hit walk runs WALK_CTAS_PER_SM CTAs on every SM."""
        remap = self.fused and not self.anyhit
        aux = prep.aux
        checks = [("tri", tb.tri, torch.float32),
                  ("cbox", tb.cbox, torch.float32),
                  ("aux", aux, torch.float32),
                  ("torder", prep.torder, torch.int32),
                  ("counts", prep.counts, torch.int32),
                  ("order", prep.order, torch.int32),
                  ("n_split", prep.n_split, torch.int32)]
        if remap:
            if idmap is None:
                raise ValueError(f"{self.name}: needs the fused idmap")
            checks.append(("idmap", idmap, torch.int32))
        for name, x, dt in checks:
            if not x.is_cuda or x.dtype != dt or not x.is_contiguous():
                raise ValueError(f"{self.name}: {name} must be a contiguous "
                                 f"CUDA {dt} tensor, got {x.dtype} on "
                                 f"{x.device}")
        if tb.tri_chunk % _PIECE:
            raise ValueError(f"{self.name}: tri_chunk must be a multiple of "
                             f"{_PIECE}, got {tb.tri_chunk}")
        if tb.tri.data_ptr() % 16 or tb.cbox.data_ptr() % 16:
            raise ValueError(f"{self.name}: tri and cbox must be 16-byte "
                             f"aligned")
        if not self.anyhit and cluster not in CLUSTER_SIZES:
            raise ValueError(f"{self.name}: cluster must be one of "
                             f"{CLUSTER_SIZES}, got {cluster}")
        if not self.anyhit and tb.n_sub > _CULL_REGS:
            raise ValueError(f"{self.name}: the closest walk takes at most "
                             f"{_CULL_REGS} cull chunks a super, got "
                             f"{tb.n_sub}")
        cs = tb.sbox.shape[0]
        n_pad = cs * tb.n_sub * tb.tri_chunk
        if remap and tuple(idmap.shape) != (2, n_pad):
            raise ValueError(f"{self.name}: idmap must be (2, {n_pad}), got "
                             f"{tuple(idmap.shape)}")
        lib = _library()
        rp = aux.shape[1]
        dev = aux.device
        outs = [torch.empty((rp,), dtype=torch.float32, device=dev)]
        outs += [torch.empty((rp,), dtype=torch.int32, device=dev)
                 for _ in range(2 if remap else 1)]
        counters = (torch.zeros((2,), dtype=torch.int64, device=dev)
                    if self.collect_stats else None)

        def ptr(x):
            return None if x is None else x.data_ptr()

        # launch on the tensors' card
        with span("rt.intersect.kernel"), torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            work = (torch.zeros((1,), dtype=torch.int32, device=dev)
                    if self.anyhit else None)
            rc = lib.rt_intersect(
                tb.tri.data_ptr(), tb.cbox.data_ptr(), aux.data_ptr(),
                prep.torder.data_ptr(), prep.counts.data_ptr(),
                ptr(idmap if remap else None), prep.order.data_ptr(),
                prep.n_split.data_ptr(), ptr(work),
                outs[0].data_ptr(), outs[1].data_ptr(),
                ptr(outs[2] if remap else None), ptr(counters),
                prep.n_tiles, rp, cs, tb.n_sub, tb.tri_chunk, n_pad,
                int(backface_culling), int(self.anyhit), int(remap),
                int(self.root_filter), int(self.collect_stats),
                WALK_CTAS_PER_SM, cluster, stream)
        if rc != 0:
            raise RuntimeError(f"{self.name} launch failed: "
                               f"{lib.rt_error_string(rc).decode()}")
        self.launches += 1
        if self.collect_stats:
            return (*outs, counters[1], counters[0])
        return tuple(outs)


def variant_name(*, anyhit: bool, fused: bool, root_filter: bool,
                 collect_stats: bool, two_phase: bool = False) -> str:
    """A variant's name: closest_hit / any_hit, "fused_" before it,
    "_two_phase" (K6), "_rootfilter" and "_stats" after it."""
    return (("fused_" if fused else "") + ("any_hit" if anyhit else
                                           "closest_hit")
            + ("_two_phase" if two_phase else "")
            + ("_rootfilter" if root_filter else "")
            + ("_stats" if collect_stats else ""))


_FLAGS = ("anyhit", "fused", "root_filter", "collect_stats")
# Every variant, by name. The fused any hit is the any-hit walk over the
# fused tables, counted apart from the single-mesh one; so are the two
# launches of each two-phase shadow query (K6, `any_hit_two_phase`),
# which run the single-mesh any hit over super ranges of the tables.
KERNELS = {
    variant_name(**kw): CudaKernel(variant_name(**kw), **kw)
    for kw in [dict(zip(_FLAGS, flags))
               for flags in itertools.product((False, True), repeat=4)]
    + [dict(anyhit=True, fused=False, root_filter=rf, collect_stats=cs,
            two_phase=True)
       for rf, cs in itertools.product((False, True), repeat=2)]
}
closest_hit_kernel = KERNELS["closest_hit"]
any_hit_kernel = KERNELS["any_hit"]
fused_closest_hit_kernel = KERNELS["fused_closest_hit"]
fused_any_hit_kernel = KERNELS["fused_any_hit"]


@dataclasses.dataclass
class PrepassKernel:
    """The pre-pass kernel (csrc/mesh_intersect.cu `prepass_kernel`):
    `tile_tables` in one launch, one CTA a 512-ray tile, with no
    (tiles, 512, Cs) temporary and no host read. It replaces the JAX
    package's XLA pre-pass `pallas_intersect._tile_tables` (no Pallas
    kernel). `launches` counts its launches; every `prepare` on CUDA
    tensors makes one."""

    name: str = "prepass"
    launches: int = 0

    def __call__(self, aux: torch.Tensor, sbox: torch.Tensor,
                 dist2: torch.Tensor):
        """(torder (n_tiles, Cs) int32, counts (n_tiles,) int32) of the
        prepared rays aux (10, n_tiles * 512) f32 against the super boxes
        sbox (Cs, 8) f32, with the live supers' sort keys dist2
        (n_tiles, Cs) f32 (`super_dist2`), bit-equal to `tile_tables`."""
        cs = sbox.shape[0] if sbox.dim() == 2 else -1
        n_tiles = aux.shape[1] // RAY_TILE if aux.dim() == 2 else -1
        for name, x, shape in (("aux", aux, (10, n_tiles * RAY_TILE)),
                               ("sbox", sbox, (cs, 8)),
                               ("dist2", dist2, (n_tiles, cs))):
            if x.dtype != torch.float32 or not x.is_contiguous():
                raise ValueError(f"{self.name}: {name} must be a contiguous "
                                 f"float32 tensor, got {x.dtype}")
            if tuple(x.shape) != shape or min(shape) < 0:
                raise ValueError(f"{self.name}: {name} must be {shape} (aux "
                                 f"(10, n_tiles * {RAY_TILE}), sbox (Cs, 8)), "
                                 f"got {tuple(x.shape)}")
        if cs > PREPASS_MAX_SUPERS:
            raise ValueError(f"{self.name}: at most {PREPASS_MAX_SUPERS} "
                             f"supers, got {cs}")
        if not (aux.is_cuda and sbox.device == aux.device == dist2.device):
            raise ValueError(f"{self.name}: aux, sbox and dist2 must be CUDA "
                             f"tensors on one card, got {aux.device}, "
                             f"{sbox.device}, {dist2.device}")
        lib = _library()
        torder = torch.empty((n_tiles, cs), dtype=torch.int32,
                             device=aux.device)
        counts = torch.empty((n_tiles,), dtype=torch.int32, device=aux.device)
        with torch.cuda.device(aux.device):
            rc = lib.rt_prepass(
                aux.data_ptr(), sbox.data_ptr(), dist2.data_ptr(),
                torder.data_ptr(), counts.data_ptr(), n_tiles, aux.shape[1],
                cs, torch.cuda.current_stream(aux.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{self.name} launch failed: "
                               f"{lib.rt_error_string(rc).decode()}")
        self.launches += 1
        return torder, counts


prepass_kernel = KERNELS["prepass"] = PrepassKernel()


def resources(name: str, *, cluster: int = CLOSEST_CLUSTER) -> dict:
    """The resources on the current card of the walk that kernel variant
    `name` launches (the any-hit or the closest walk, with its flags):
    resident
    CTAs per SM at its block size (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
    registers and local (spill) bytes per thread, static shared bytes,
    the card's SM count, and for the closest walk at `cluster` CTAs per
    tile the clusters resident at once (cudaOccupancyMaxActiveClusters;
    0 for the other kernels)."""
    k = KERNELS[name]
    out = (ctypes.c_int * 6)()
    rc = _library().rt_resources(int(k.anyhit),
                                 int(k.fused and not k.anyhit),
                                 int(k.root_filter), int(k.collect_stats),
                                 cluster, out)
    if rc != 0:
        raise RuntimeError(f"rt_resources failed: "
                           f"{_library().rt_error_string(rc).decode()}")
    return dict(zip(("ctas_per_sm", "registers", "local_bytes",
                     "shared_bytes", "sms", "clusters"), out))


def _check_device(prep: Prepared) -> None:
    if prep.aux.device.type != "cpu":
        raise ValueError(f"no intersection path for device {prep.aux.device}")


def run_query(tb: IntersectTables, prep: Prepared, *, anyhit: bool,
              backface_culling: bool, root_filter: bool = False,
              collect_stats: bool = False, two_phase: bool = False):
    """The kernel variant for CUDA tensors, its plain version for CPU
    tensors. `two_phase` marks a phase of K6 (the same kernel, counted
    apart)."""
    if prep.aux.is_cuda:
        kernel = KERNELS[variant_name(anyhit=anyhit, fused=False,
                                      root_filter=root_filter,
                                      collect_stats=collect_stats,
                                      two_phase=two_phase)]
        return kernel(tb, prep, backface_culling=backface_culling)
    _check_device(prep)
    with span("rt.intersect.kernel"):
        return intersect_plain(tb, prep, anyhit=anyhit,
                               backface_culling=backface_culling,
                               root_filter=root_filter,
                               collect_stats=collect_stats)


@torch.no_grad()
def closest_hit(tb: IntersectTables, ro3, rd3, t_limit=None, *,
                backface_culling: bool = True, root_filter: bool = False,
                collect_stats: bool = False):
    """Closest accepted hit below t_limit over all mesh triangles.
    ro3/rd3 (3, R). Returns (t (R,), tri (R,) int32): Morton-order
    triangle id or -1, and t = FMAX on a miss; with `collect_stats` also
    box_tests, tri_tests."""
    prep = prepare(tb, ro3, rd3, t_limit)
    t, tri, *counters = run_query(tb, prep, anyhit=False,
                                  backface_culling=backface_culling,
                                  root_filter=root_filter,
                                  collect_stats=collect_stats)
    t, tri = t[:prep.n_rays], tri[:prep.n_rays]
    return (torch.where(tri >= 0, t, FMAX), tri, *counters)


@torch.no_grad()
def any_hit(tb: IntersectTables, ro3, rd3, t_limit=None, *,
            backface_culling: bool = True, root_filter: bool = False,
            collect_stats: bool = False):
    """Occlusion query: (R,) bool, True where some triangle is hit below
    t_limit; with `collect_stats` (occluded, box_tests, tri_tests). Rays
    entering with t_limit < 0 are resolved already and cost no
    intersection work."""
    prep = prepare(tb, ro3, rd3, t_limit)
    _, tri, *counters = run_query(tb, prep, anyhit=True,
                                  backface_culling=backface_culling,
                                  root_filter=root_filter,
                                  collect_stats=collect_stats)
    occ = tri[:prep.n_rays] >= 0
    return (occ, *counters) if collect_stats else occ


# ---- K6: the two-phase shadow query of one mesh ------------------------


def slice_supers(tb: IntersectTables, lo: int, hi: int) -> IntersectTables:
    """The super-chunk range [lo, hi) of a table set as a table set of
    its own (`pallas_intersect._slice_tables_supers`): contiguous dim-0
    views of tri, cbox and sbox, which the kernel takes as they are (a
    query over them is an any-hit query; its chunk ids are local)."""
    n = tb.n_sub
    return IntersectTables(tb.tri_chunk, n, tb.tri[lo:hi],
                           tb.cbox[lo * n:hi * n], tb.sbox[lo:hi])


def two_phase_split(cs: int, frac: float) -> int:
    """The first phase's super count of K6 over Cs supers:
    round(frac * Cs), kept within [1, Cs - 1] (Python's round, as the JAX
    package's). Cs = 1 gives 1 = Cs: no second phase."""
    return max(1, min(cs - 1, int(round(cs * frac))))


@torch.no_grad()
def two_phase_pack(occ1, ro3, rd3, t_limit):
    """K6's compaction between its phases: the destination lane pos (a
    permutation) of every ray, unresolved rays first in their order, then
    the occluded ones, by an integer cumsum; and the rays and limits so
    packed, the occluded ones with t_limit = -1. Returns (pos, ro3, rd3,
    t_limit)."""
    unres = ~occ1
    pos = torch.where(unres, torch.cumsum(unres, 0) - 1,
                      unres.sum() + torch.cumsum(occ1, 0) - 1)
    ro_p = torch.zeros_like(ro3).index_copy_(1, pos, ro3)
    rd_p = torch.zeros_like(rd3).index_copy_(1, pos, rd3)
    tl_p = torch.zeros_like(t_limit).index_copy_(
        0, pos, torch.where(occ1, -1.0, t_limit))
    return pos, ro_p, rd_p, tl_p


@torch.no_grad()
def any_hit_two_phase(tb: IntersectTables, ro3, rd3, t_limit=None, *,
                      frac: float, backface_culling: bool = True,
                      root_filter: bool = False, collect_stats: bool = False):
    """Two-phase occlusion query with mid-pass shadow-ray compaction
    (K6, `pallas_intersect.anyhit_two_phase`, settings.anyhit_compact_frac).

    Phase 1 runs the any hit (K2) over supers [0, k), k =
    `two_phase_split(Cs, frac)`. The rays it occludes retire: a stable
    partition by integer cumsum sends the unresolved lanes to the front
    of the queue and the occluded ones behind them with t_limit = -1, so
    the second pre-pass finds no live super for the trailing tiles.
    Phase 2 runs K2 over supers [k, Cs) on the packed queue; the answer
    is occ1 | occ2[pos] and the counters of the two phases add. Each
    phase is one launch of the `any_hit_two_phase*` variant on CUDA
    tensors, the plain version on CPU tensors. The permutation is plain
    torch (deterministic: `pos` is a permutation, so index_copy writes
    each lane once).

    A table of one super has no second phase (the JAX package aborts
    there): it runs the single-pass query, which gives the same answer,
    as occlusion is a union over super ranges. Same returns as
    `any_hit`."""
    cs = tb.sbox.shape[0]
    k = two_phase_split(cs, frac)
    flags = dict(backface_culling=backface_culling, root_filter=root_filter,
                 collect_stats=collect_stats)
    if k >= cs:
        return any_hit(tb, ro3, rd3, t_limit, **flags)
    q = ro3.shape[1]
    tl = (t_limit if t_limit is not None
          else torch.full((q,), FMAX, dtype=torch.float32, device=ro3.device))

    def phase(lo, hi, ro, rd, lim):
        part = slice_supers(tb, lo, hi)
        prep = prepare(part, ro, rd, lim)
        _, tri, *counters = run_query(part, prep, anyhit=True,
                                      two_phase=True, **flags)
        return tri[:q] >= 0, counters

    occ1, counters1 = phase(0, k, ro3, rd3, tl)
    pos, ro_p, rd_p, tl_p = two_phase_pack(occ1, ro3, rd3, tl)
    occ2, counters2 = phase(k, cs, ro_p, rd_p, tl_p)
    occ = occ1 | occ2[pos]
    if not collect_stats:
        return occ
    return (occ, *(a + b for a, b in zip(counters1, counters2)))


# ---- K5: one query over the fused tables of every mesh -------------------


def fused_remap(idmap, t, tri):
    """Raw (t, chunk-space tri) -> (t, mid, vid) through idmap: t = FMAX,
    mid = -1, vid = 0 where nothing was hit (vid stays gather-safe)."""
    found = tri >= 0
    mv = idmap[:, torch.clamp_min(tri, 0).long()]
    return (torch.where(found, t, FMAX), torch.where(found, mv[0], -1),
            torch.where(found, mv[1], 0))


@torch.no_grad()
def intersect_fused_plain(ft: FusedTables, prep: Prepared, *, anyhit: bool,
                          backface_culling: bool, root_filter: bool = False,
                          collect_stats: bool = False,
                          stats: dict | None = None):
    """K5's function in plain PyTorch: the single-mesh plain version over
    the fused geometry, then the idmap remap in closest mode. Returns
    (t, mid, vid) (closest) or raw (t, tri) (any), all (Rp,), then with
    `collect_stats` box_tests, tri_tests."""
    t, tri, *counters = intersect_plain(
        ft.geo, prep, anyhit=anyhit, backface_culling=backface_culling,
        root_filter=root_filter, collect_stats=collect_stats, stats=stats)
    out = (t, tri) if anyhit else fused_remap(ft.idmap, t, tri)
    return (*out, *counters)


def run_fused_query(ft: FusedTables, prep: Prepared, *, anyhit: bool,
                    backface_culling: bool, root_filter: bool = False,
                    collect_stats: bool = False):
    """K5's variant for CUDA tensors, its plain version for CPU
    tensors."""
    if prep.aux.is_cuda:
        kernel = KERNELS[variant_name(anyhit=anyhit, fused=True,
                                      root_filter=root_filter,
                                      collect_stats=collect_stats)]
        return kernel(ft.geo, prep, backface_culling=backface_culling,
                      idmap=None if anyhit else ft.idmap)
    _check_device(prep)
    with span("rt.intersect.kernel"):
        return intersect_fused_plain(ft, prep, anyhit=anyhit,
                                     backface_culling=backface_culling,
                                     root_filter=root_filter,
                                     collect_stats=collect_stats)


@torch.no_grad()
def intersect_fused(ft: FusedTables, ro3, rd3, t_limit=None, *,
                    mode: str = "closest", backface_culling: bool = True,
                    root_filter: bool = False, collect_stats: bool = False):
    """One query over every fused mesh (`pallas_intersect.intersect_fused`).
    mode="closest" returns (t, mid, vid) (R,): the winner's mesh sub
    index (-1 on a miss) and its global gather-table column (0 on a
    miss); cross-mesh ties at equal t resolve by chunk visit order, as
    within one mesh. mode="any" returns occluded (R,) bool; rays
    entering with t_limit < 0 cost nothing. With `collect_stats` the
    result ends in box_tests, tri_tests."""
    if mode not in ("closest", "any"):
        raise ValueError(f"mode must be 'closest' or 'any', got {mode!r}")
    prep = prepare(ft.geo, ro3, rd3, t_limit)
    n = prep.n_rays
    anyhit = mode == "any"
    out = run_fused_query(ft, prep, anyhit=anyhit,
                          backface_culling=backface_culling,
                          root_filter=root_filter,
                          collect_stats=collect_stats)
    counters = out[-2:] if collect_stats else ()
    if anyhit:
        occ = out[1][:n] >= 0
        return (occ, *counters) if collect_stats else occ
    return (*(x[:n] for x in out[:3]), *counters)
