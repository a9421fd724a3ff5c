"""The threaded-BVH walks over a mesh's flat BVH (accel.bvh.FlatBVH: a
hit box steps to the next node in depth-first order, a missed one jumps
to skip[node]), the JAX package's `rendering_tpu.ops.traversal`.

`count_ac_nodes` is the showAC walk, the stackless skip walk of the
reference's `AccelerationStructure::recCountAC` (src/objects.cpp:572-585):
for each ray, the number of real nodes (`real_flag`, the first flat node
of each reference AC node) whose box the ray hits while the boxes of all
their ancestors were hit. No t-pruning (the reference has none here), and
a box behind the origin counts as hit, as `ops.intersect.slab_test` does.
With use_ac=False every box counts as hit. It takes the hand-written
kernel (csrc/bvh_walk.cu, `ac_walk_kernel`: one thread per ray, the same
walk and the literal slab test) for CUDA tensors and the plain PyTorch
version for CPU tensors; it raises for another device. The kernel exists
because the plain version, a torch loop over walk steps, costs more on
the card than the frame it draws: 24.4 s against 1.3 s for t09's layout
with a 250k mesh at 3840x1080 on an H100 (PERF.md section 6). Its
launches count in `KERNELS["ac_walk"]`.

`traverse_bvh` is the closest-hit walk (JAX `traverse_bvh`, the
reference's `intersectAccelStruct`, src/objects.cpp:587-631), the oracle
of a mesh above settings.bruteforce_threshold triangles when
use_pallas_intersect is off: every ray walks the tree from node 0; at a
hit leaf chunk it tests the chunk's leaf_count (<= leaf_chunk) triangles
of leaf_tris by Moller-Trumbore with the strict `t < t_best`, so the
first triangle in leaf depth-first order wins a tie. With prune, a
subtree whose box lies behind the origin or beyond t_best is skipped
(never on a NaN: every comparison is literal). With use_ac=False every
box counts as hit, the prune still reading the slab's own interval. It
counts box tests (steps on real nodes, x use_ac) and triangle tests.
`bvh_closest_kernel` (csrc/bvh_walk.cu) runs it for CUDA tensors, one
thread a ray; `traverse_bvh_plain`, a torch loop over walk steps line
for line after JAX's, for CPU tensors. Neither has a Pallas counterpart:
the JAX package runs the walk as an XLA while loop. Its launches count in
`KERNELS["bvh_closest"]`. In a recorded trace (`utils.tracing`) each
walk, kernel or plain version, is the span `rt.intersect.kernel`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
from typing import NamedTuple

import torch

from rendering_tpu_torch.ops.geometry import FLT_MAX
from rendering_tpu_torch.ops.intersect import ray_triangle_r, slab_test
from rendering_tpu_torch.utils import nvcc
from rendering_tpu_torch.utils.tracing import span

SOURCE = os.path.join(nvcc.CSRC, "bvh_walk.cu")
# The plain walk reads any(active) from the device once every this many
# steps: a lane that has left the tree stays put, so the extra steps of a
# finished walk change nothing.
CHECK_EVERY = 8


@dataclasses.dataclass
class Launches:
    """Launch count of one kernel."""

    name: str
    launches: int = 0


KERNELS = {"ac_walk": Launches("ac_walk"),
           "bvh_closest": Launches("bvh_closest")}


def count_ac_nodes_plain(node_min, node_max, skip, real_flag, ro, rd, *,
                         use_ac: bool = True):
    """The walk in plain PyTorch: every lane steps from node 0, to cur + 1
    where its box is hit and to skip[cur] where it is not, until it
    leaves the tree. ro/rd (R, 3) f32. Returns (counts (R,) int32, box
    tests (0-d int64): the slab tests the walk made, one per lane and
    step taken). With use_ac=False every box counts as hit, so every lane
    visits nodes 0..N-1 in order and counts the real ones: that sum,
    without the loop."""
    n_nodes = int(node_min.shape[0])
    r = ro.shape[0]
    dev = ro.device
    real = real_flag > 0
    if n_nodes == 0 or not use_ac:
        n_real = int(real.sum()) if n_nodes else 0
        return (torch.full((r,), n_real, dtype=torch.int32, device=dev),
                torch.zeros((), dtype=torch.int64, device=dev))
    skip = skip.long()
    cur = torch.zeros((r,), dtype=torch.int64, device=dev)
    count = torch.zeros((r,), dtype=torch.int32, device=dev)
    tests = torch.zeros((), dtype=torch.int64, device=dev)
    while bool((cur < n_nodes).any()):
        for _ in range(CHECK_EVERY):
            active = cur < n_nodes
            node = torch.clamp(cur, 0, n_nodes - 1)
            box_hit, _, _ = slab_test(ro, rd, node_min[node], node_max[node])
            descend = box_hit & active
            count = count + (descend & real[node]).to(torch.int32)
            tests = tests + active.sum()
            cur = torch.where(active, torch.where(descend, cur + 1,
                                                  skip[node]), cur)
    return count, tests


_lib = None


def _library():
    global _lib
    if _lib is None:
        path, _ = nvcc.build_library(SOURCE)
        lib = ctypes.CDLL(path)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.bw_ac_walk.argtypes = [ptr] * 7 + [i32] * 3 + [ptr]
        lib.bw_ac_walk.restype = ctypes.c_int
        lib.bw_bvh_closest.argtypes = [ptr] * 16 + [i32] * 5 + [ptr]
        lib.bw_bvh_closest.restype = ctypes.c_int
        lib.bw_error_string.argtypes = [ctypes.c_int]
        lib.bw_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def count_ac_nodes_kernel(node_min, node_max, skip, real_flag, ro, rd, *,
                          use_ac: bool = True):
    """The walk as csrc/bvh_walk.cu's `ac_walk_kernel`, one thread a ray,
    on CUDA tensors. Returns counts (R,) int32."""
    n_nodes = int(node_min.shape[0])
    r = ro.shape[0]
    for name, x, dt, shape in (("ro", ro, torch.float32, (r, 3)),
                               ("rd", rd, torch.float32, (r, 3)),
                               ("node_min", node_min, torch.float32,
                                (n_nodes, 3)),
                               ("node_max", node_max, torch.float32,
                                (n_nodes, 3)),
                               ("skip", skip, torch.int32, (n_nodes,)),
                               ("real_flag", real_flag, torch.int32,
                                (n_nodes,))):
        if not x.is_cuda or x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"ac_walk: {name} must be a contiguous CUDA "
                             f"{dt} tensor, got {x.dtype} on {x.device}")
        if tuple(x.shape) != shape:
            raise ValueError(f"ac_walk: {name} must have shape {shape}, got "
                             f"{tuple(x.shape)}")
    lib = _library()
    counts = torch.empty((r,), dtype=torch.int32, device=ro.device)
    with span("rt.intersect.kernel"), torch.cuda.device(ro.device):
        stream = torch.cuda.current_stream(ro.device).cuda_stream
        rc = lib.bw_ac_walk(ro.data_ptr(), rd.data_ptr(),
                            node_min.data_ptr(), node_max.data_ptr(),
                            skip.data_ptr(), real_flag.data_ptr(),
                            counts.data_ptr(), r, n_nodes, int(use_ac),
                            stream)
    if rc != 0:
        raise RuntimeError(f"ac_walk launch failed: "
                           f"{lib.bw_error_string(rc).decode()}")
    KERNELS["ac_walk"].launches += 1
    return counts


def count_ac_nodes(mesh, ro, rd, *, use_ac: bool = True):
    """showAC counts of one mesh (its node_min, node_max, skip and
    real_flag) for rays ro/rd (R, 3): the kernel for CUDA tensors, the
    plain version for CPU tensors. Returns (R,) int32."""
    nodes = (mesh.node_min, mesh.node_max, mesh.skip, mesh.real_flag)
    if ro.is_cuda:
        return count_ac_nodes_kernel(*nodes, ro.contiguous(),
                                     rd.contiguous(), use_ac=use_ac)
    if ro.device.type != "cpu":
        raise ValueError(f"no showAC walk for device {ro.device}")
    with span("rt.intersect.kernel"):
        return count_ac_nodes_plain(*nodes, ro, rd, use_ac=use_ac)[0]


class TraversalResult(NamedTuple):
    t: torch.Tensor          # (R,) f32 closest hit t, FLT_MAX on a miss
    tri: torch.Tensor        # (R,) int32 triangle id, -1 on a miss
    u: torch.Tensor          # (R,) f32
    v: torch.Tensor          # (R,) f32
    box_tests: torch.Tensor  # () int64, accelStructTests' analogue
    tri_tests: torch.Tensor  # () int64, rayTriTests' analogue


def _no_tree(r: int, dev) -> TraversalResult:
    """The walk's result over a tree without nodes: FLT_MAX (not the
    t_limit: callers test t < FLT_MAX) and -1 everywhere."""
    z = torch.zeros((), dtype=torch.int64, device=dev)
    return TraversalResult(
        torch.full((r,), FLT_MAX, device=dev),
        torch.full((r,), -1, dtype=torch.int32, device=dev),
        torch.zeros((r,), device=dev), torch.zeros((r,), device=dev), z, z)


def traverse_bvh_plain(mesh, ro, rd, t_limit=None, *,
                       backface_culling: bool = True, use_ac: bool = True,
                       prune: bool = True) -> TraversalResult:
    """The closest-hit walk in plain PyTorch, JAX's while loop step for
    step: every lane tests its node's box, descends (cur + 1) or skips
    (skip[cur]), and at a hit leaf chunk tests its triangles in lanes,
    the first minimum of t winning. mesh: node_min, node_max, skip,
    leaf_start, leaf_count, real_flag, leaf_tris and v (T, 3, 3); ro/rd
    (R, 3) f32; t_limit (R,) or None, read only with prune."""
    n_nodes = int(mesh.node_min.shape[0])
    r = ro.shape[0]
    dev = ro.device
    t_best = torch.full((r,), FLT_MAX, device=dev)
    limited = t_limit is not None and prune
    if limited:
        t_best = torch.minimum(t_best, t_limit)
    if n_nodes == 0:
        return _no_tree(r, dev)
    # JAX's lanes are settings.leaf_chunk wide; lanes past a chunk's count
    # are masked, so the widest chunk's count gives the same result.
    k = max(1, int(mesh.leaf_count.max()))
    karange = torch.arange(k, device=dev)
    skip = mesh.skip.long()
    leaf_start = mesh.leaf_start.long()
    leaf_tris = mesh.leaf_tris.long()
    real = mesh.real_flag > 0
    ro3 = ro.T[:, :, None]  # (3, R, 1)
    rd3 = rd.T[:, :, None]
    cur = torch.zeros((r,), dtype=torch.int64, device=dev)
    tri_best = torch.full((r,), -1, dtype=torch.int32, device=dev)
    u_best = torch.zeros((r,), device=dev)
    v_best = torch.zeros((r,), device=dev)
    box_ct = torch.zeros((), dtype=torch.int64, device=dev)
    tri_ct = torch.zeros((), dtype=torch.int64, device=dev)
    while bool((cur < n_nodes).any()):
        for _ in range(CHECK_EVERY):
            active = cur < n_nodes
            node = torch.clamp(cur, 0, n_nodes - 1)
            box_hit, tmin, tmax = slab_test(ro, rd, mesh.node_min[node],
                                            mesh.node_max[node])
            if not use_ac:
                box_hit = torch.ones_like(box_hit)
            descend = box_hit & active
            if prune:
                # A NaN compares false, so a NaN lane never skips more.
                descend = descend & ~((tmax < 0) | (tmin > t_best))
            cnt = mesh.leaf_count[node]
            is_leaf_hit = descend & (cnt > 0)
            idx = leaf_start[node][:, None] + karange[None, :]    # (R, K)
            lane_ok = (karange[None, :] < cnt[:, None]) & is_leaf_hit[:, None]
            safe_ids = torch.where(lane_ok, leaf_tris[idx], 0)
            tv = mesh.v[safe_ids].permute(2, 3, 0, 1)  # (3 verts, 3, R, K)
            t, u, v, ok = ray_triangle_r(ro3, rd3, tv[0], tv[1], tv[2],
                                         backface_culling)
            ok = ok & lane_ok & (t < t_best[:, None])
            t = torch.where(ok, t, FLT_MAX)
            lane = torch.argmin(t, dim=1, keepdim=True)  # first min wins
            any_ok = ok.any(dim=1)
            t_best = torch.where(any_ok, torch.gather(t, 1, lane)[:, 0],
                                 t_best)
            tri_best = torch.where(
                any_ok, torch.gather(safe_ids, 1, lane)[:, 0].to(torch.int32),
                tri_best)
            u_best = torch.where(any_ok, torch.gather(u, 1, lane)[:, 0],
                                 u_best)
            v_best = torch.where(any_ok, torch.gather(v, 1, lane)[:, 0],
                                 v_best)
            cur = torch.where(active, torch.where(descend, cur + 1,
                                                  skip[node]), cur)
            # One reference intersectBox call per real node visited: a
            # leaf's further chunks share its box.
            if use_ac:
                box_ct = box_ct + (active & real[node]).sum()
            tri_ct = tri_ct + lane_ok.sum()
    if limited:
        # No hit within the limit reads FLT_MAX, as the reference's.
        t_best = torch.where(tri_best >= 0, t_best, FLT_MAX)
    return TraversalResult(t_best, tri_best, u_best, v_best, box_ct, tri_ct)


# The mesh arrays the walk's kernel reads, in its argument order.
_WALK_ARRAYS = ("node_min", "node_max", "skip", "leaf_start", "leaf_count",
                "real_flag", "leaf_tris", "v")


def traverse_bvh_kernel(mesh, ro, rd, t_limit=None, *,
                        backface_culling: bool = True, use_ac: bool = True,
                        prune: bool = True) -> TraversalResult:
    """The closest-hit walk as csrc/bvh_walk.cu's `bvh_closest_kernel`,
    one thread a ray, on contiguous CUDA tensors (the arrays of
    `traverse_bvh_plain`, ro/rd (R, 3)). The counters are summed per
    block into int64 on the card."""
    n_nodes = int(mesh.node_min.shape[0])
    r = ro.shape[0]
    limited = t_limit is not None and prune
    f32, i32 = torch.float32, torch.int32
    node, box = (n_nodes,), (n_nodes, 3)
    checks = [("ro", ro, f32, (r, 3)), ("rd", rd, f32, (r, 3)),
              ("node_min", mesh.node_min, f32, box),
              ("node_max", mesh.node_max, f32, box),
              *((k, getattr(mesh, k), i32, node)
                for k in ("skip", "leaf_start", "leaf_count", "real_flag")),
              ("leaf_tris", mesh.leaf_tris, i32, (mesh.leaf_tris.shape[0],)),
              ("v", mesh.v, f32, (mesh.v.shape[0], 3, 3))]
    if limited:
        checks.append(("t_limit", t_limit, f32, (r,)))
    for name, x, dt, shape in checks:
        if not x.is_cuda or x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"bvh_closest: {name} must be a contiguous "
                             f"CUDA {dt} tensor, got {x.dtype} on {x.device}")
        if tuple(x.shape) != shape:
            raise ValueError(f"bvh_closest: {name} must have shape {shape}, "
                             f"got {tuple(x.shape)}")
    if n_nodes == 0:
        return _no_tree(r, ro.device)
    dev = ro.device
    t = torch.empty((r,), dtype=torch.float32, device=dev)
    tri = torch.empty((r,), dtype=torch.int32, device=dev)
    u = torch.empty((r,), dtype=torch.float32, device=dev)
    v = torch.empty((r,), dtype=torch.float32, device=dev)
    counters = torch.zeros((2,), dtype=torch.int64, device=dev)
    lib = _library()
    with span("rt.intersect.kernel"), torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.bw_bvh_closest(
            ro.data_ptr(), rd.data_ptr(),
            t_limit.data_ptr() if limited else None,
            *(getattr(mesh, name).data_ptr() for name in _WALK_ARRAYS),
            t.data_ptr(), tri.data_ptr(), u.data_ptr(), v.data_ptr(),
            counters.data_ptr(), r, n_nodes, int(backface_culling),
            int(use_ac), int(prune), stream)
    if rc != 0:
        raise RuntimeError(f"bvh_closest launch failed: "
                           f"{lib.bw_error_string(rc).decode()}")
    KERNELS["bvh_closest"].launches += 1
    return TraversalResult(t, tri, u, v, counters[0], counters[1])


def traverse_bvh(mesh, ro, rd, t_limit=None, *, backface_culling: bool = True,
                 use_ac: bool = True, prune: bool = True) -> TraversalResult:
    """Closest hits of rays ro/rd (R, 3) on one mesh by its BVH (JAX
    `traverse_bvh`): the kernel for CUDA tensors, the plain version for
    CPU tensors. t_limit (R,): hits at or beyond it are not taken (a
    shadow query's light distance, -1 for a ray already resolved)."""
    kw = dict(backface_culling=backface_culling, use_ac=use_ac, prune=prune)
    if ro.is_cuda:
        return traverse_bvh_kernel(
            mesh, ro.contiguous(), rd.contiguous(),
            t_limit.contiguous() if t_limit is not None else None, **kw)
    if ro.device.type != "cpu":
        raise ValueError(f"no BVH walk for device {ro.device}")
    with span("rt.intersect.kernel"):
        return traverse_bvh_plain(mesh, ro, rd, t_limit, **kw)
