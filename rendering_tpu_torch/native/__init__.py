"""ctypes bindings of the port's host runtime (csrc/rt_native.cpp): OBJ
loading and the SAH BVH build in C++, bit for bit equal to the Python
paths (`models/objloader.py::load_obj_python`,
`accel/bvh.py::build_bvh_python`; tests/test_torch_native.py).

The library is built with g++ at first use (`utils/nvcc.py`
`build_library`, into build/rendering_tpu_torch/) and loaded once per
process. A failed build or load raises. The one way to the Python paths
is `RTPU_NATIVE=0` in the environment, read at every call: then
`get_lib` returns None and so do `load_obj_native` and
`build_bvh_native`.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from rendering_tpu_torch.utils import nvcc

SOURCE = os.path.join(nvcc.CSRC, "rt_native.cpp")

_lib = None


def enabled() -> bool:
    """False when the environment sets RTPU_NATIVE=0."""
    return os.environ.get("RTPU_NATIVE", "1") != "0"


def get_lib():
    """The loaded library (built at its first use), or None under
    RTPU_NATIVE=0."""
    global _lib
    if not enabled():
        return None
    if _lib is not None:
        return _lib
    path, _ = nvcc.build_library(SOURCE)
    lib = ctypes.CDLL(path)

    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)

    lib.rtn_load_obj.restype = ctypes.c_void_p
    lib.rtn_load_obj.argtypes = [ctypes.c_char_p, f32p, f32p, f32p,
                                 ctypes.c_float]
    lib.rtn_mesh_ntris.restype = ctypes.c_int64
    lib.rtn_mesh_ntris.argtypes = [ctypes.c_void_p]
    lib.rtn_mesh_copy.argtypes = [ctypes.c_void_p] + [f32p] * 6
    lib.rtn_mesh_copy.restype = None
    lib.rtn_mesh_free.argtypes = [ctypes.c_void_p]
    lib.rtn_mesh_free.restype = None

    lib.rtn_build_bvh.restype = ctypes.c_void_p
    lib.rtn_build_bvh.argtypes = [f32p, ctypes.c_int64, f32p, ctypes.c_int,
                                  ctypes.c_int]
    lib.rtn_bvh_sizes.argtypes = [ctypes.c_void_p] + [i64p] * 5
    lib.rtn_bvh_sizes.restype = None
    lib.rtn_bvh_copy.argtypes = [ctypes.c_void_p, f32p, f32p, i32p, i32p,
                                 i32p, i32p, i32p, f32p, f32p]
    lib.rtn_bvh_copy.restype = None
    lib.rtn_bvh_free.argtypes = [ctypes.c_void_p]
    lib.rtn_bvh_free.restype = None
    _lib = lib
    return _lib


def _f32(a, shape, name: str) -> np.ndarray:
    """a as a contiguous float32 array of `shape` (-1: any length), the
    layout the C functions read; raises on another shape."""
    a = np.ascontiguousarray(a, np.float32)
    if len(a.shape) != len(shape) or any(
            n != m for n, m in zip(a.shape, shape) if m != -1):
        raise ValueError(f"{name} must have shape {shape}, got {a.shape}")
    return a


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _ip(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def load_obj_native(path: str, size, rmat9: np.ndarray, pos, bias: float):
    """The OBJ at `path` placed by size, the row-vector rotation matrix
    rmat9 (3x3) and pos: (v, n, uv, tangent, bitangent, root_bounds) as
    the Python loader's MeshArrays fields. None under RTPU_NATIVE=0, for a
    missing file, or on a parse error (the Python loader then raises)."""
    lib = get_lib()
    if lib is None:
        return None
    size = _f32(size, (3,), "size")
    rmat = _f32(rmat9, (3, 3), "rmat9")
    pos = _f32(pos, (3,), "pos")
    h = lib.rtn_load_obj(os.fsencode(path), _fp(size), _fp(rmat), _fp(pos),
                         ctypes.c_float(bias))
    if not h:
        return None
    try:
        t = int(lib.rtn_mesh_ntris(h))
        v = np.empty((t, 3, 3), np.float32)
        n = np.empty((t, 3, 3), np.float32)
        uv = np.empty((t, 3, 2), np.float32)
        tangent = np.empty((t, 3), np.float32)
        bitangent = np.empty((t, 3), np.float32)
        bounds = np.empty((2, 3), np.float32)
        lib.rtn_mesh_copy(h, _fp(v), _fp(n), _fp(uv), _fp(tangent),
                          _fp(bitangent), _fp(bounds))
        return v, n, uv, tangent, bitangent, bounds
    finally:
        lib.rtn_mesh_free(h)


def build_bvh_native(tri_v: np.ndarray, root_bounds: np.ndarray,
                     ac_penalty: int, leaf_chunk: int):
    """The SAH BVH of tri_v (T, 3, 3) under root_bounds (2, 3): a dict of
    FlatBVH's fields, or None under RTPU_NATIVE=0."""
    lib = get_lib()
    if lib is None:
        return None
    tri_v = _f32(tri_v, (-1, 3, 3), "tri_v")
    bounds = _f32(root_bounds, (2, 3), "root_bounds")
    t = tri_v.shape[0]
    h = lib.rtn_build_bvh(_fp(tri_v), ctypes.c_int64(t), _fp(bounds),
                          ctypes.c_int(ac_penalty), ctypes.c_int(leaf_chunk))
    if not h:
        raise MemoryError("rtn_build_bvh returned no result")
    try:
        sizes = [ctypes.c_int64() for _ in range(5)]
        lib.rtn_bvh_sizes(h, *(ctypes.byref(s) for s in sizes))
        nn, nl, n_real, copies, _ = (int(s.value) for s in sizes)
        node_min = np.empty((nn, 3), np.float32)
        node_max = np.empty((nn, 3), np.float32)
        skip = np.empty((nn,), np.int32)
        leaf_start = np.empty((nn,), np.int32)
        leaf_count = np.empty((nn,), np.int32)
        real_flag = np.empty((nn,), np.int32)
        leaf_tris = np.empty((nl,), np.int32)
        reach_lo = np.empty((t, 3), np.float32)
        reach_hi = np.empty((t, 3), np.float32)
        lib.rtn_bvh_copy(h, _fp(node_min), _fp(node_max), _ip(skip),
                         _ip(leaf_start), _ip(leaf_count), _ip(real_flag),
                         _ip(leaf_tris), _fp(reach_lo), _fp(reach_hi))
        return dict(
            node_min=node_min, node_max=node_max, skip=skip,
            leaf_start=leaf_start, leaf_count=leaf_count,
            real_flag=real_flag, leaf_tris=leaf_tris,
            n_real_nodes=n_real, tri_copies=copies,
            leaf_chunk=leaf_chunk, reach_lo=reach_lo, reach_hi=reach_hi,
        )
    finally:
        lib.rtn_bvh_free(h)
