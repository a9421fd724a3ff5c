"""The showAC walk — `rendering_tpu.ops.traversal.count_ac_nodes`, the
stackless skip walk of the reference's `AccelerationStructure::
recCountAC` (src/objects.cpp:572-585) over a mesh's flat BVH: for each
ray, the number of real nodes (`real_flag`, the first flat node of each
reference AC node) whose box the ray hits while the boxes of all their
ancestors were hit. No t-pruning (the reference has none here), and a
box behind the origin counts as hit, as `ops.intersect.slab_test` does.
With use_ac=False every box counts as hit.

`count_ac_nodes` takes the hand-written kernel (csrc/bvh_walk.cu,
`ac_walk_kernel`: one thread per ray, the same walk and the literal slab
test) for CUDA tensors and the plain PyTorch version for CPU tensors;
it raises for another device. The kernel has no Pallas counterpart: the
JAX package runs this walk as an XLA while loop. It exists because the
plain version, a torch loop over walk steps, costs more on the card than
the frame it draws: 24.4 s against 1.3 s for t09's layout with a 250k
mesh at 3840x1080 on an H100 (PERF.md section 6). Its launches count in
`KERNELS["ac_walk"]`.

The JAX package's `traverse_bvh` (its closest-hit fallback for backends
without Pallas) is not ported: the intersection kernels cover every mesh
size.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os

import torch

from rendering_tpu_torch.ops.intersect import slab_test
from rendering_tpu_torch.utils import nvcc

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


KERNELS = {"ac_walk": Launches("ac_walk")}


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
    with torch.cuda.device(ro.device):
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
    return count_ac_nodes_plain(*nodes, ro, rd, use_ac=use_ac)[0]
