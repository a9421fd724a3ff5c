"""The port's C++ host runtime (rendering_tpu_torch/native,
csrc/rt_native.cpp) on the CPU: the OBJ loader and the SAH BVH builder
against the port's Python paths and the JAX package's, bit for bit; every
malformed input of tests/test_native.py; the dispatch (native by default,
RTPU_NATIVE=0 read at every call, a failed build raises); six processes
building the library at once into one empty directory; and `cli.main`
writing byte-equal BMPs with the native path on and off.

The JAX package's Python loader and builder are called directly, never
its `get_lib()` (whose `make -C native` races between test workers).
Tolerance: none; every array is compared bit for bit.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from rendering_tpu.accel import bvh as j_bvh
from rendering_tpu.models import objloader as j_objloader
from rendering_tpu_torch import cli, native
from rendering_tpu_torch.accel import bvh as t_bvh
from rendering_tpu_torch.flagship import procedural_mesh
from rendering_tpu_torch.models import objloader as t_objloader
from rendering_tpu_torch.utils import nvcc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH_FIELDS = ("v", "n", "uv", "tangent", "bitangent", "root_bounds")
# t10_shotgun.scene's placement (rotated: the root box clips the mesh)
# and an identity one.
PLACEMENTS = {
    "t10": ((2, 2, 2), (0, 100, 0), (-0.1, 0, -0.6)),
    "identity": ((2, 2, 2), (0, 0, 0), (0, 0, 0)),
}
FORMATS = ("v", "v__n", "v_t_n")


def _bits_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype, a.shape) == (b.dtype, b.shape) and np.array_equal(
        a.view(np.uint8), b.view(np.uint8))


def _assert_mesh_equal(m, ref, what):
    for f in MESH_FIELDS:
        assert _bits_equal(getattr(m, f), getattr(ref, f)), (what, f)


@pytest.fixture(autouse=True)
def _native_on(monkeypatch):
    monkeypatch.delenv("RTPU_NATIVE", raising=False)


@pytest.fixture(scope="module")
def objs(tmp_path_factory):
    """The procedural flagship mesh at 20k triangles written as OBJ in
    the three face formats: `f v`, `f v//vn`, `f v/vt/vn`."""
    d = tmp_path_factory.mktemp("objs")
    m = procedural_mesh(20_000, pos=(0, 0, 0), size=(2, 2, 2))
    out = {}
    for fmt, kw in zip(FORMATS, ({}, {"n": m.n}, {"uv": m.uv, "n": m.n})):
        out[fmt] = str(d / f"{fmt}.obj")
        t_objloader.write_obj(out[fmt], m.v, **kw)
    return out


def _native(path, size, rot, pos, bias=1e-4):
    return native.load_obj_native(
        path, np.asarray(size, np.float32), t_objloader.euler_matrix(rot),
        np.asarray(pos, np.float32), bias)


@pytest.mark.parametrize("placement", sorted(PLACEMENTS))
@pytest.mark.parametrize("fmt", FORMATS)
def test_load_obj_bit_equal(objs, fmt, placement):
    size, rot, pos = PLACEMENTS[placement]
    nat = _native(objs[fmt], size, rot, pos)
    assert nat is not None
    m = t_objloader.MeshArrays(*nat)
    assert m.n_tris == 20_000
    _assert_mesh_equal(m, t_objloader.load_obj_python(objs[fmt], size, rot,
                                                       pos), "port python")
    _assert_mesh_equal(m, j_objloader.load_obj_python(objs[fmt], size, rot,
                                                       pos), "jax python")
    _assert_mesh_equal(t_objloader.load_obj(objs[fmt], size, rot, pos), m,
                       "load_obj")
    if fmt == "v_t_n":
        assert np.abs(m.tangent).sum() > 0


@pytest.mark.parametrize("clipped", [True, False])
@pytest.mark.parametrize("penalty,chunk", [(1, 8), (3, 8), (2, 4)])
def test_build_bvh_bit_equal(objs, penalty, chunk, clipped):
    size, rot, pos = PLACEMENTS["t10" if clipped else "identity"]
    m = t_objloader.load_obj(objs["v_t_n"], size, rot, pos)
    nat = t_bvh.build_bvh(m.v, m.root_bounds, penalty, chunk)
    # The rotated mesh pokes out of its rotated-size root box.
    assert (nat.reach_lo.min(0) >= m.root_bounds[0]).all()
    poke = (m.v.min((0, 1)) < m.root_bounds[0]).any() or (
        m.v.max((0, 1)) > m.root_bounds[1]).any()
    assert poke == clipped
    for ref in (t_bvh.build_bvh_python(m.v, m.root_bounds, penalty, chunk),
                j_bvh.build_bvh_python(m.v, m.root_bounds, penalty, chunk)):
        for f in dataclasses.fields(t_bvh.FlatBVH):
            a, b = getattr(nat, f.name), getattr(ref, f.name)
            if isinstance(a, np.ndarray):
                assert _bits_equal(a, b), f.name
            else:
                assert a == b, f.name
    assert nat.tri_copies >= m.n_tris and nat.n_real_nodes > 1


# ---- tests/test_native.py's edge cases --------------------------------------

_TRI = "v 0 0 0\nv 1 0 0\nv 0 1 0\n"
# Files the Python loader rejects: the native loader returns None.
MALFORMED = {
    "face_token": _TRI + "f 1 2 x\n",
    "vtn_field": _TRI + "f 1/x/1 2/1/1 3/1/1\n",
    "index_range": _TRI + "f 1 2 9\n",
    **{f"vertex_line_{k}": f"{line}\n{_TRI}f 1 2 3\n" for k, line in
       enumerate(["v 1 2", "v 1 2 3x", "vn 1 2", "vt 0.5", "v nan(1) 0 0"])},
}
# Files both loaders accept: negative indices, indented statements,
# empty trailing v//n fields.
EDGE_OK = {
    "negative_indices": "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 0 0 1\nf 0 -1 -2\n"
                        "f 2 3 4\n",
    "leading_whitespace": "  v 0 0 0\n\tv 1 0 0\n v 0 1 0\n  f 1 2 3\n",
    "empty_trailing_fields": _TRI + "f 1// 2// 3//\n",
}


def _python_error(loader, path):
    with pytest.raises(Exception) as info:
        loader(path, (1, 1, 1), (0, 0, 0), (0, 0, 0))
    return info.value


@pytest.mark.parametrize("name", sorted(MALFORMED))
def test_malformed_obj_raises_like_python(tmp_path, name):
    path = str(tmp_path / "edge.obj")
    with open(path, "w") as fh:
        fh.write(MALFORMED[name])
    assert native.load_obj_native(
        path, np.ones(3, np.float32), np.eye(3, dtype=np.float32),
        np.zeros(3, np.float32), 1e-4) is None
    want = _python_error(t_objloader.load_obj_python, path)
    assert type(want) is type(_python_error(j_objloader.load_obj_python,
                                            path))
    got = _python_error(t_objloader.load_obj, path)
    assert (type(got), str(got)) == (type(want), str(want))
    if name in ("face_token", "vtn_field"):
        assert isinstance(got, ValueError)
    if name == "index_range":
        assert isinstance(got, IndexError)


def test_loaders_disagreeing_raises(objs, monkeypatch):
    """A file that the C++ loader rejects (None) but the Python loader
    accepts is a disagreement between the two: `load_obj` raises rather
    than serve the Python loader's mesh."""
    monkeypatch.setattr(native, "load_obj_native", lambda *a: None)
    with pytest.raises(RuntimeError, match="rejected a file that the "
                       "Python loader accepts"):
        t_objloader.load_obj(objs["v"], *PLACEMENTS["identity"])


@pytest.mark.parametrize("name", sorted(EDGE_OK))
def test_edge_obj_matches_python(tmp_path, name):
    path = str(tmp_path / "edge.obj")
    with open(path, "w") as fh:
        fh.write(EDGE_OK[name])
    nat = _native(path, (2, 2, 2), (0, 0, 0), (0, 0, 0))
    assert nat is not None
    m = t_objloader.MeshArrays(*nat)
    assert m.n_tris == (2 if name == "negative_indices" else 1)
    py = t_objloader.load_obj_python(path, (2, 2, 2), (0, 0, 0), (0, 0, 0))
    _assert_mesh_equal(m, py, name)
    _assert_mesh_equal(m, j_objloader.load_obj_python(
        path, (2, 2, 2), (0, 0, 0), (0, 0, 0)), name)


# ---- the dispatch -----------------------------------------------------------


def _spy(monkeypatch, module, attr, calls):
    real = getattr(module, attr)

    def wrapper(*a, **k):
        out = real(*a, **k)
        calls.append(out is not None)
        return out

    monkeypatch.setattr(module, attr, wrapper)


def test_dispatch_native_by_default_env_read_per_call(objs, monkeypatch):
    calls = {k: [] for k in ("obj", "bvh", "obj_py", "bvh_py")}
    _spy(monkeypatch, native, "load_obj_native", calls["obj"])
    _spy(monkeypatch, native, "build_bvh_native", calls["bvh"])
    _spy(monkeypatch, t_objloader, "load_obj_python", calls["obj_py"])
    _spy(monkeypatch, t_bvh, "build_bvh_python", calls["bvh_py"])
    size, rot, pos = PLACEMENTS["t10"]

    def run():
        m = t_objloader.load_obj(objs["v"], size, rot, pos)
        return m, t_bvh.build_bvh(m.v, m.root_bounds, 3)

    m1, b1 = run()
    assert calls == {"obj": [True], "bvh": [True], "obj_py": [],
                     "bvh_py": []}
    monkeypatch.setenv("RTPU_NATIVE", "0")
    assert native.get_lib() is None
    m2, b2 = run()
    assert calls["obj"][1:] == calls["bvh"][1:] == [False]
    assert calls["obj_py"] == calls["bvh_py"] == [True]
    monkeypatch.setenv("RTPU_NATIVE", "1")
    run()
    assert calls["obj"][2:] == calls["bvh"][2:] == [True]
    assert len(calls["obj_py"]) == 1
    _assert_mesh_equal(m1, m2, "native vs RTPU_NATIVE=0")
    assert all(_bits_equal(getattr(b1, f), getattr(b2, f))
               for f in ("node_min", "skip", "leaf_tris", "reach_hi"))


def test_failed_build_raises(monkeypatch, tmp_path):
    """No g++, or a source that does not compile: the first use raises,
    with the compiler's message; nothing falls back to Python."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(nvcc, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(nvcc, "_gxx", lambda: None)
    obj = tmp_path / "m.obj"
    obj.write_text(_TRI + "f 1 2 3\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        t_objloader.load_obj(str(obj), (1, 1, 1), (0, 0, 0), (0, 0, 0))
    monkeypatch.undo()
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(nvcc, "BUILD_DIR", str(tmp_path / "build"))
    bad = tmp_path / "broken.cpp"
    bad.write_text("extern \"C\" int rtn_load_obj( {\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    with pytest.raises(RuntimeError,
                       match="(?s)g\\+\\+ failed building .*error:"):
        t_bvh.build_bvh(np.zeros((1, 3, 3), np.float32),
                        np.zeros((2, 3), np.float32))
    assert native._lib is None


def test_native_checks_shapes(tmp_path):
    """Arrays the C functions would read out of bounds are refused."""
    obj = tmp_path / "m.obj"
    obj.write_text(_TRI + "f 1 2 3\n")
    with pytest.raises(ValueError, match="tri_v"):
        native.build_bvh_native(np.zeros((4, 3), np.float32),
                                np.zeros((2, 3), np.float32), 1, 8)
    with pytest.raises(ValueError, match="root_bounds"):
        native.build_bvh_native(np.zeros((4, 3, 3), np.float32),
                                np.zeros(3, np.float32), 1, 8)
    with pytest.raises(ValueError, match="rmat9"):
        native.load_obj_native(str(obj), np.ones(3), np.eye(2),
                               np.zeros(3), 1e-4)


_RACER = """
import os, sys, time
sys.path.insert(0, {repo!r})
from rendering_tpu_torch.utils import nvcc
nvcc.BUILD_DIR = {build!r}
from rendering_tpu_torch import native
while not os.path.exists({go!r}):
    time.sleep(0.001)
path, _ = nvcc.build_library(native.SOURCE)
m = native.load_obj_native({obj!r}, (2, 2, 2), [[1, 0, 0], [0, 1, 0],
                           [0, 0, 1]], (0, 0, 0), 1e-4)
assert native.get_lib() is not None and m is not None and len(m[0]) == 1
print(os.path.basename(path))
"""


def test_six_processes_build_at_once(tmp_path):
    """Six processes build the library into one fresh, empty directory at
    the same moment: every one loads it and loads an OBJ through it."""
    build, go = tmp_path / "build", tmp_path / "go"
    obj = tmp_path / "m.obj"
    obj.write_text(_TRI + "f 1 2 3\n")
    code = _RACER.format(repo=REPO, build=str(build), go=str(go),
                         obj=str(obj))
    env = {k: v for k, v in os.environ.items() if k != "RTPU_NATIVE"}
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(6)]
    time.sleep(1.0)  # every process waits at the start line
    go.write_text("")
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0] * 6, [e for _, e in outs]
    names = {o.strip() for o, _ in outs}
    assert len(names) == 1
    assert os.listdir(build) == [names.pop()]


# ---- the scene-file entry point ---------------------------------------------

_SCENE = """[options]
width=48
height=32
ac_penalty=3
background_color=0.52,0.8,0.92
image_name=native
enableOutput=1
outputProgress=0

[light]
type=point
position=0,0,0
color=1,1,1
intensity=1.0

[object]
type=mesh
pos=-0.1,0,-2.6
size=2,2,2
color=1,1,1
rot=0,100,0
material=phong,0.4,0.1,0.7,10.0
name=mesh.obj

[end]
"""


def test_cli_bmp_equal_native_on_and_off(tmp_path, monkeypatch):
    m = procedural_mesh(1500, pos=(0, 0, 0), size=(2, 2, 2), seed=4)
    t_objloader.write_obj(str(tmp_path / "mesh.obj"), m.v, m.uv, m.n)
    (tmp_path / "s.scene").write_text(_SCENE)
    monkeypatch.chdir(tmp_path)
    calls: list = []
    _spy(monkeypatch, native, "load_obj_native", calls)
    bmps = {}
    for flag in ("1", "0"):
        monkeypatch.setenv("RTPU_NATIVE", flag)
        assert cli.main(["s.scene", "--output", f"{flag}.bmp"],
                        device="cpu") == 0
        bmps[flag] = (tmp_path / f"{flag}.bmp").read_bytes()
    assert calls == [True, False]
    assert bmps["1"] == bmps["0"]
    assert len(set(bmps["1"][54:])) > 10  # not a blank frame
