"""Ray-mesh intersection: the hand-written CUDA closest-hit and any-hit
kernels, their plain PyTorch versions, the chunk tables and the
per-tile pre-pass.

The kernels (csrc/mesh_intersect.cu) replace the Pallas TPU kernel
`rendering_tpu/ops/pallas_intersect.py::_kernel` in its two modes:
closest hit for primary rays and any hit for the batched shadow rays.
They are bound by f32 operations (57 instructions per ray-triangle pair,
each issued alone under -fmad=false; the tables are only ~16 MB at 250k
triangles), so the design keeps triangle rows in shared memory for a
whole 512-ray tile, culls sub-chunks against each ray's running t, and
skips resolved rays. The source file's header says more.

Pipeline of one query (`closest_hit` / `any_hit`):

  prepare    rays -> padded (10, Rp) rows [ro, rd, 1/rd, t0] and, per
             512-ray tile, the live super chunks in near-to-far order
             (tile_tables: an exact per-ray slab test of every super
             AABB, any() over the tile — the JAX package's XLA pre-pass,
             plain torch here on every device).
  kernel     walks each tile's live list (CUDA tensors) — or the plain
             version (CPU tensors): the TPU formulation vectorised over
             tiles, which the CPU tests hold against the Pallas kernel
             in interpret mode and the card holds against the kernel.

The Pallas grid's step-table compaction (`_pair_tables`, the bucket
ladder and its all-pairs fallbacks) exists only because a Pallas grid
is static; the kernel's per-tile loop replaces it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess

import numpy as np
import torch

from rendering_tpu_torch.ops.geometry import FLT_MAX as FMAX

RAY_TILE = 512              # rays per kernel CTA and per pre-pass tile
SUB_PER_SUPER = 8           # cull chunks per super chunk
_PIECE = 64                 # the kernel stages triangles 64 at a time
_PREPASS_ELEMS = 1 << 24    # bound on (tiles, 512, Cs) pre-pass temporaries
_PLAIN_TILES = 64           # tiles per batch of the plain version

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCE = os.path.join(_PKG, "csrc", "mesh_intersect.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "rendering_tpu_torch")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


@dataclasses.dataclass
class IntersectTables:
    """Morton-ordered chunk tables of one mesh (the baked acceleration
    structure; rebuild after any geometry update).

    tri:  (Cs, 16, n_sub*tc) f32 — rows v0 xyz, e1 xyz, e2 xyz, then
          zeros (rows 9-14 hold the root filter's reach boxes in the JAX
          package; that filter comes with a later slice).
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


def build_intersect_tables(v: np.ndarray, *, tri_chunk: int,
                           n_sub: int | None = None) -> IntersectTables:
    """Host numpy build of the chunk tables from Morton-ordered vertices
    v (T, 3, 3) — `pallas_intersect.build_intersect_tables` without the
    reach rows. Zero-padded triangles fail the det epsilon in both
    culling modes; padded cull chunks get inverted boxes."""
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

    v0 = v[:, 0]
    e1 = v[:, 1] - v0
    e2 = v[:, 2] - v0
    rows = np.concatenate(
        [v0, e1, e2, np.zeros((T, 7), np.float32)], axis=1
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
    return IntersectTables(
        tri_chunk, n_sub, torch.from_numpy(tri), torch.from_numpy(cbox),
        torch.from_numpy(sbox),
    )


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
            ctmin = torch.maximum(lo, torch.tensor(-FMAX, device=lo.device))
            ctmax = torch.minimum(hi, torch.tensor(FMAX, device=hi.device))
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


def tile_tables(ro_t, inv_t, t0_t, sbox):
    """Per-tile live-first, near-to-far super visit order
    (`pallas_intersect._tile_tables`). Returns (torder (n_tiles, Cs)
    int32, counts (n_tiles,) int32). The sort key is the distance from
    the centroid of the tile's live ray origins; dead supers key to FMAX
    and, the sort being stable, keep id order behind the live ones."""
    live = tile_live_exact(ro_t, inv_t, t0_t, sbox)
    lane = (t0_t >= 0).to(torch.float32)
    cnt = torch.clamp_min(lane.sum(dim=1), 1.0)
    centroid = (ro_t * lane[:, None, :]).sum(dim=2) / cnt[:, None]
    ccenter = (sbox[None, :, 0:3] + sbox[None, :, 3:6]) * 0.5
    dist2 = ((ccenter - centroid[:, None, :]) ** 2).sum(dim=-1)
    key = torch.where(live, dist2, FMAX)
    torder = torch.argsort(key, dim=1, stable=True).to(torch.int32)
    counts = live.sum(dim=1).to(torch.int32)
    return torder, counts


@dataclasses.dataclass
class Prepared:
    """A query ready for the kernel: padded ray rows and visit tables."""

    aux: torch.Tensor      # (10, Rp) f32 rows ro xyz, rd xyz, 1/rd xyz, t0
    torder: torch.Tensor   # (n_tiles, Cs) int32
    counts: torch.Tensor   # (n_tiles,) int32
    n_rays: int            # R before padding

    @property
    def n_tiles(self) -> int:
        return self.counts.shape[0]


@torch.no_grad()
def prepare(tb: IntersectTables, ro3, rd3, t_limit=None) -> Prepared:
    """Pad rays to whole 512-ray tiles and run the pre-pass. Padded lanes
    have ro = 0, rd = 1 and t0 = -1 (born resolved), as at
    `pallas_intersect.py:768-783`; 1/rd is computed here, outside the
    kernel."""
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
    torder, counts = tile_tables(
        ro_p.reshape(3, n_tiles, RAY_TILE).transpose(0, 1),
        inv.reshape(3, n_tiles, RAY_TILE).transpose(0, 1),
        t0.reshape(n_tiles, RAY_TILE),
        tb.sbox,
    )
    return Prepared(aux, torder.contiguous(), counts.contiguous(), R)


# ---- plain PyTorch version --------------------------------------------


def _mt_block(tri_rows, ray, backface_culling: bool):
    """Moller-Trumbore of a (m, 9, tc) triangle block against (m, 6, BR)
    rays [ro, rd], in `_intersect_chunk`'s f32 order. Returns t, ok
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


@torch.no_grad()
def intersect_plain(tb: IntersectTables, prep: Prepared, *, anyhit: bool,
                    backface_culling: bool, stats: dict | None = None):
    """The kernel's function in plain PyTorch: the TPU formulation
    vectorised over tiles. For visit rank k, every tile with a k-th live
    super gathers it; for each sub-chunk j a (tiles, tc, 512)
    Moller-Trumbore block, the min over rows, then `better = t_min <
    t_prev`. Returns raw (t (Rp,), tri (Rp,) int32) in padded
    chunk-space ids. With a `stats` dict, adds the ray-triangle pairs
    the per-ray cull requires under "pairs" (the work bound)."""
    n_tiles = prep.n_tiles
    tc, n_sub = tb.tri_chunk, tb.n_sub
    cs = tb.sbox.shape[0]
    dev = prep.aux.device
    rays = prep.aux.reshape(10, n_tiles, RAY_TILE).transpose(0, 1)
    t_all = rays[:, 9].clone()
    tri_all = torch.full((n_tiles, RAY_TILE), -1, dtype=torch.int32,
                         device=dev)
    tri_tab = tb.tri.reshape(cs, 16, n_sub, tc)
    boxes_tab = tb.cbox.reshape(cs, n_sub, 8)
    rows = torch.arange(tc, dtype=torch.int32, device=dev)[None, :, None]
    pairs = 0
    for s in range(0, n_tiles, _PLAIN_TILES):
        tiles = torch.arange(s, min(s + _PLAIN_TILES, n_tiles), device=dev)
        counts = prep.counts[tiles]
        for k in range(int(counts.max()) if len(tiles) else 0):
            idx = tiles[counts > k]
            sup = prep.torder[idx, k].long()
            ray = rays[idx]
            boxes = boxes_tab[sup]                           # (m, n_sub, 8)
            ctmin, ctmax = _slab(boxes, ray[:, 0:3], ray[:, 6:9])
            invalid = (boxes[:, :, 0] > boxes[:, :, 3])[:, None, :]
            live0 = ~((ctmin > ctmax) | (ctmax < 0) | invalid)  # (m, BR, n_sub)
            for j in range(n_sub):
                t_run = t_all[idx]
                live = live0[:, :, j] & ~((ctmin[:, :, j] >= t_run)
                                          | (t_run < 0))
                if stats is not None:
                    pairs += int(live.sum()) * tc
                go = live.any(dim=1)
                if not bool(go.any()):
                    continue
                sel, sup_j, ray_j = idx[go], sup[go], ray[go]
                t_prev = t_run[go]
                t, ok = _mt_block(tri_tab[sup_j, 0:9, j], ray_j,
                                  backface_culling)
                ok = ok & (t < t_prev[:, None, :])
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
        stats["pairs"] = stats.get("pairs", 0) + pairs
    return t_all.reshape(-1), tri_all.reshape(-1)


# ---- the CUDA kernels ----------------------------------------------------

_lib = None


def _nvcc() -> str | None:
    """Path of nvcc: on PATH, else the toolkit's default location."""
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    return path if os.path.exists(path) else None


def build_library() -> tuple[str, str]:
    """Compile csrc/mesh_intersect.cu with nvcc for sm_90a into
    build/rendering_tpu_torch/ (named by the source's hash, so an edit
    rebuilds). Returns (library path, compiler output). Raises when nvcc
    is missing or the build fails."""
    with open(_SOURCE, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode())
    path = os.path.join(BUILD_DIR,
                        f"libmesh_intersect-{digest.hexdigest()[:12]}.so")
    if os.path.exists(path):
        return path, ""
    nvcc = _nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is required to "
                           "build rendering_tpu_torch's kernels")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, _SOURCE],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed building {_SOURCE}:\n{proc.stderr}")
    os.replace(tmp, path)
    return path, proc.stdout + proc.stderr


def _library():
    global _lib
    if _lib is None:
        path, _ = build_library()
        lib = ctypes.CDLL(path)
        args = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        for name in ("rt_closest_hit", "rt_any_hit"):
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        lib.rt_error_string.argtypes = [ctypes.c_int]
        lib.rt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


class CudaKernel:
    """One launcher of csrc/mesh_intersect.cu. `launches` counts the
    launches made through it."""

    def __init__(self, symbol: str):
        self.symbol = symbol
        self.launches = 0

    def __call__(self, tb: IntersectTables, prep: Prepared, *,
                 backface_culling: bool):
        """Raw (t (Rp,), tri (Rp,) int32) in padded chunk-space ids."""
        aux = prep.aux
        for name, x, dt in (("tri", tb.tri, torch.float32),
                            ("cbox", tb.cbox, torch.float32),
                            ("aux", aux, torch.float32),
                            ("torder", prep.torder, torch.int32),
                            ("counts", prep.counts, torch.int32)):
            if not x.is_cuda or x.dtype != dt or not x.is_contiguous():
                raise ValueError(f"{self.symbol}: {name} must be a contiguous "
                                 f"CUDA {dt} tensor, got {x.dtype} on "
                                 f"{x.device}")
        if tb.tri_chunk % _PIECE:
            raise ValueError(f"{self.symbol}: tri_chunk must be a multiple of "
                             f"{_PIECE}, got {tb.tri_chunk}")
        lib = _library()
        n_tiles = prep.n_tiles
        rp = aux.shape[1]
        t = torch.empty((rp,), dtype=torch.float32, device=aux.device)
        tri = torch.empty((rp,), dtype=torch.int32, device=aux.device)
        with torch.cuda.device(aux.device):  # launch on the tensors' card
            rc = getattr(lib, self.symbol)(
                tb.tri.data_ptr(), tb.cbox.data_ptr(), aux.data_ptr(),
                prep.torder.data_ptr(), prep.counts.data_ptr(), t.data_ptr(),
                tri.data_ptr(), n_tiles, rp, tb.sbox.shape[0], tb.n_sub,
                tb.tri_chunk, int(backface_culling),
                torch.cuda.current_stream(aux.device).cuda_stream,
            )
        if rc != 0:
            raise RuntimeError(f"{self.symbol} launch failed: "
                               f"{lib.rt_error_string(rc).decode()}")
        self.launches += 1
        return t, tri


closest_hit_kernel = CudaKernel("rt_closest_hit")
any_hit_kernel = CudaKernel("rt_any_hit")


def run_query(tb: IntersectTables, prep: Prepared, *, anyhit: bool,
              backface_culling: bool):
    """The kernel for CUDA tensors, its plain version for CPU tensors."""
    if prep.aux.is_cuda:
        kernel = any_hit_kernel if anyhit else closest_hit_kernel
        return kernel(tb, prep, backface_culling=backface_culling)
    if prep.aux.device.type != "cpu":
        raise ValueError(f"no intersection path for device {prep.aux.device}")
    return intersect_plain(tb, prep, anyhit=anyhit,
                           backface_culling=backface_culling)


@torch.no_grad()
def closest_hit(tb: IntersectTables, ro3, rd3, t_limit=None, *,
                backface_culling: bool = True):
    """Closest accepted hit below t_limit over all mesh triangles.
    ro3/rd3 (3, R). Returns (t (R,), tri (R,) int32): Morton-order
    triangle id or -1, and t = FMAX on a miss."""
    prep = prepare(tb, ro3, rd3, t_limit)
    t, tri = run_query(tb, prep, anyhit=False,
                       backface_culling=backface_culling)
    t, tri = t[:prep.n_rays], tri[:prep.n_rays]
    return torch.where(tri >= 0, t, FMAX), tri


@torch.no_grad()
def any_hit(tb: IntersectTables, ro3, rd3, t_limit=None, *,
            backface_culling: bool = True):
    """Occlusion query: (R,) bool, True where some triangle is hit below
    t_limit. Rays entering with t_limit < 0 are resolved already and
    cost no intersection work."""
    prep = prepare(tb, ro3, rd3, t_limit)
    _, tri = run_query(tb, prep, anyhit=True,
                       backface_culling=backface_culling)
    return tri[:prep.n_rays] >= 0
