"""The port's scene-file path against the JAX package on the CPU: the OBJ
loader, the scene parser, the SAH BVH and the kernel chunk tables (the
reach boxes in rows 9-14 included), all bit-equal. Inputs are small OBJ
and scene files written into tmp_path; the JAX builders run in Python
(RTPU_NATIVE=0), which is their bit-equal reference."""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import pytest

from rendering_tpu.accel import bvh as j_bvh
from rendering_tpu.flagship import procedural_mesh as j_procedural_mesh
from rendering_tpu.models import objloader as j_objloader
from rendering_tpu.models import parser as j_parser
from rendering_tpu.models.scene import build_scene as j_build_scene
from rendering_tpu.ops import pallas_intersect as jpi
from rendering_tpu_torch.accel import bvh as t_bvh
from rendering_tpu_torch.models import objloader as t_objloader
from rendering_tpu_torch.models import parser as t_parser
from rendering_tpu_torch.models.scene import build_scene as t_build_scene
from rendering_tpu_torch.ops import cuda_intersect as ci


@pytest.fixture(autouse=True)
def _python_builders(monkeypatch):
    """The JAX package's OBJ loader and BVH builder in Python: no build
    of its native library (and no race between test workers over it)."""
    monkeypatch.setenv("RTPU_NATIVE", "0")


def assert_same(t, j, path="") -> None:
    """Every field of the port's value t equals the JAX value j: numpy
    arrays in dtype, shape and bits, dataclasses field by field over the
    port's fields (the JAX settings carry more)."""
    if dataclasses.is_dataclass(t):
        for f in dataclasses.fields(t):
            assert_same(getattr(t, f.name), getattr(j, f.name),
                        f"{path}.{f.name}")
    elif isinstance(t, np.ndarray):
        j = np.asarray(j)
        assert (t.dtype, t.shape) == (j.dtype, j.shape), path
        assert np.array_equal(t.view(np.uint8), j.view(np.uint8)), path
    elif isinstance(t, (list, tuple)):
        assert len(t) == len(j), path
        for k, (a, b) in enumerate(zip(t, j)):
            assert_same(a, b, f"{path}[{k}]")
    else:
        assert t == j or (t != t and j != j), (path, t, j)


# ---- OBJ loader -----------------------------------------------------------

_ICOSA_V = """v 0 -0.525731 0.850651
v 0.850651 0 0.525731
v 0.850651 0 -0.525731
v -0.850651 0 -0.525731
v -0.850651 0 0.525731
v -0.525731 0.850651 0
v 0.525731 0.850651 0
v 0.525731 -0.850651 0
v -0.525731 -0.850651 0
v 0 -0.525731 -0.850651
v 0 0.525731 -0.850651
v 0 0.525731 0.850651
"""
_ICOSA_F = [(2, 3, 7), (2, 8, 3), (4, 5, 6), (5, 4, 9), (7, 6, 12),
            (6, 7, 11), (10, 11, 3), (11, 10, 4), (8, 9, 10), (9, 8, 1),
            (12, 1, 2), (1, 12, 5), (7, 3, 11), (2, 7, 12), (4, 6, 11),
            (6, 5, 12), (3, 8, 10), (8, 2, 1), (4, 10, 9), (5, 9, 1)]


def _icosahedron(face_fmt: str, extra: str = "") -> str:
    """A hand-written icosahedron; face_fmt formats one corner from its
    index i (1-based), e.g. "{i}/{i}/{i}"."""
    rng = np.random.default_rng(5)
    vt = "".join(f"vt {a:.6f} {b:.6f}\n" for a, b in rng.uniform(size=(12, 2)))
    vn = "".join(f"vn {x:.6f} {y:.6f} {z:.6f}\n"
                 for x, y, z in rng.normal(size=(12, 3)))
    faces = "".join("f " + " ".join(face_fmt.format(i=i) for i in f) + "\n"
                    for f in _ICOSA_F)
    return "# icosahedron\n" + _ICOSA_V + vt + vn + extra + faces


OBJS = {
    "v": _icosahedron("{i}"),
    "v_t_n": _icosahedron("{i}/{i}/{i}"),
    "v__n": _icosahedron("{i}//{i}"),
    # three corners of v/t have an odd slash count, so only the quad stays
    "v_t": _icosahedron("{i}/{i}") + "f 1/1 2/2 3/3 4/4\n",
    # quads and a pentagon, fan-triangulated; comments and blank lines
    "fans": ("v 0 0 0\nv 1 0 0 # corner\nv 1 1 0\nv 0 1 0\n\n"
             "v 0.5 1.5 0.2\n# a comment line\nf 1 2 3 4\n"
             "f 1 2 3 5 4\nf 1/1/1 2/2/2\n"),
    # vertices after the first face stay raw, and a face of odd slash
    # count (v/t/n mixed with v/t) is dropped
    "late_verts": ("v 0 0 -1\nv 2 0 -1\nv 0 3 -2\nf 1 2 3\nv 5 5 5\n"
                   "v 6 5 5\nf 3 4 5\nf 1/1/1 2/2\n"),
    # all coordinates negative: the max keeps its FLT_MIN init
    "negative": "v -3 -2 -5\nv -1 -2 -4\nv -2 -0.5 -4.5\nv -1.5 -1 -6\n"
                "f 1 2 3\nf 1 3 4\n",
    # a flat mesh: the z range is 0, snapped to pos after the rotation
    "degenerate": "v 0 0 0\nv 2 0 0\nv 2 1 0\nv 0 1 0\nf 1 2 3\nf 1 3 4\n",
}
PLACEMENTS = [
    ((2, 2, 2), (0, 100, 0), (-0.1, 0, -0.6)),
    ((1, 3, 0.5), (30, -45, 10), (1, 2, -3)),
]


@pytest.mark.parametrize("placement", range(len(PLACEMENTS)))
@pytest.mark.parametrize("name", sorted(OBJS))
def test_load_obj_bit_equal(tmp_path, name, placement):
    path = tmp_path / f"{name}.obj"
    path.write_text(OBJS[name])
    size, rot, pos = PLACEMENTS[placement]
    t = t_objloader.load_obj(str(path), size, rot, pos)
    j = j_objloader.load_obj_python(str(path), size, rot, pos)
    assert t.n_tris > 0
    assert_same(t, j)


def test_write_obj_round_trip(tmp_path):
    """write_obj's indexed OBJ loads back (unrotated, unit placement) to
    the JAX loader's arrays of the same file, and with the mesh's own
    corners where the placement is the identity."""
    m = j_procedural_mesh(500, pos=(0, 0, 0), size=(2, 2, 2))
    path = str(tmp_path / "m.obj")
    t_objloader.write_obj(path, m.v, m.uv, m.n)
    t = t_objloader.load_obj(path, (2, 2, 2), (0, 100, 0), (-0.1, 0, -0.6))
    assert_same(t, j_objloader.load_obj_python(
        path, (2, 2, 2), (0, 100, 0), (-0.1, 0, -0.6)))
    np.testing.assert_array_equal(t.uv, m.uv)
    assert t.n_tris == m.v.shape[0]


# ---- scene parser ---------------------------------------------------------

_MESH_SCENE = """[options]
width=64
height=32
ac_penalty=3
background_color=0.52,0.8,0.92
enableOutput=0
outputProgress=0
collectStatistics={stats}

[light]
type=point
position=0,0,0
color=1,1,1
intensity=1.0

[light]
type=distant
direction=0.3,0,-1
color=1,1,1
intensity=0.2

[object]
type=mesh
pos=-0.1,0,-0.6
size=2,2,2
color=1,1,1
rot=0,100,0
material=phong,0.4,0.1,0.7,10.0
name=ico.obj
diffuse_map=input/maps/shotgun_diffuse.bmp
normal_map=input/maps/shotgun_normal.bmp
specular_map=input/maps/shotgun_specular.bmp

[object]
type=mesh
pos=0.9,0.2,-3.5
size=1.2,1.2,1.2
color=0.3,0.5,0.9
name=fans.obj

[end]
"""


def _mesh_workspace(ws, stats=0):
    (ws / "ico.obj").write_text(OBJS["v_t_n"])
    (ws / "fans.obj").write_text(OBJS["fans"])
    (ws / "mesh.scene").write_text(_MESH_SCENE.format(stats=stats))
    return "mesh.scene"


@pytest.mark.parametrize("scene", ["t01_simple_shapes", "t05_area", "mesh"])
def test_parse_scene_field_equal(in_workspace, scene):
    path = (_mesh_workspace(in_workspace) if scene == "mesh"
            else f"{scene}.scene")
    t = t_parser.parse_scene(path)
    j = j_parser.parse_scene(path)
    assert_same(t, j)
    if scene == "mesh":
        assert t.objects[0].mesh.n_tris == 20 and t.objects[0].diffuse_map is not None


@pytest.mark.parametrize("text", [
    "[light]\ntype=spot\n[end]\n",                      # unknown light type
    "[object]\ntype=sphere\nradius=+a\n[end]\n",        # bad number
    "[object]\ntype=sphere\nradius=nan\n[end]\n",       # not a C++ float
    "[object]\ntype=mesh\nname=missing.obj\n[end]\n",   # no OBJ file
    "[object]\ntype=mesh\nname=ico.obj\nsize=1,1,1\n"
    "diffuse_map=missing.bmp\n[end]\n",                 # no map file
    "[object]\ntype=sphere\nmaterial=phong,1,2\n[end]\n",  # short material
])
def test_parse_scene_errors_match(tmp_path, monkeypatch, text):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "ico.obj").write_text(OBJS["v"])
    (tmp_path / "bad.scene").write_text(text)
    errors = []
    for parser in (t_parser, j_parser):
        try:
            parser.parse_scene("bad.scene")
        except Exception as e:  # noqa: BLE001 - compared below
            errors.append(e)
    assert len(errors) == 2, errors
    assert isinstance(errors[0], t_parser.SceneError) == isinstance(
        errors[1], j_parser.SceneError)
    assert type(errors[0]).__name__ == type(errors[1]).__name__


# ---- SAH BVH and the kernel tables ----------------------------------------

def _clipped_mesh(n_tris, seed=0):
    """The JAX package's procedural mesh with a root box of 0.7 of its
    extent, so that it is clipped."""
    m = j_procedural_mesh(n_tris, pos=(-0.1, 0, -0.6), size=(2, 2, 2),
                          seed=seed)
    c = m.root_bounds.mean(axis=0)
    root = (c + (m.root_bounds - c) * np.float32(0.7)).astype(np.float32)
    return dataclasses.replace(m, root_bounds=root)


@pytest.mark.parametrize("clipped", [False, True])
@pytest.mark.parametrize("ac_penalty", [1, 3])
def test_build_bvh_field_equal(clipped, ac_penalty):
    m = (_clipped_mesh(3000) if clipped
         else j_procedural_mesh(3000, pos=(0, 0, -3), size=(1, 2, 1)))
    v = m.v[np.asarray(t_bvh.morton_order(m.v))]
    t = t_bvh.build_bvh(v, m.root_bounds, ac_penalty=ac_penalty)
    j = j_bvh.build_bvh_python(v, m.root_bounds, ac_penalty=ac_penalty)
    assert_same(t, j)
    lo, hi = t.reach_lo, t.reach_hi
    inside = (v.min(axis=1) >= lo) & (v.max(axis=1) <= hi)
    assert inside.all() != clipped


def test_scene_tables_bit_equal(in_workspace):
    """The port's build_scene of a two-OBJ scene (one mesh rotated, so
    clipped) and of each mesh alone: the BVH counts, the fused tables and
    the single-mesh tables equal the JAX package's, rows 9-14 included."""
    path = _mesh_workspace(in_workspace)
    tsd, jsd = t_parser.parse_scene(path), j_parser.parse_scene(path)
    ts, js = t_build_scene(tsd, device="cpu"), j_build_scene(jsd)
    assert [m.clipped_by_root for m in js.meshes] == [True, False]
    assert [m.clipped_by_root for m in ts.static.meshes] == [True, False]
    for tm, jm in zip(ts.static.meshes, js.static.meshes):
        assert (tm.n_real_nodes, tm.tri_copies) == (jm.n_real_nodes,
                                                     jm.tri_copies)
    for tf, jf in ((ts.fused_itables, js.fused_itables),
                   (ts.fused_shadow_itables, js.fused_shadow_itables)):
        assert tf.any_clipped == jf.any_clipped is True
        for k in ("tri", "cbox", "sbox"):
            np.testing.assert_array_equal(getattr(tf.geo, k).numpy(),
                                          np.asarray(getattr(jf.geo, k)))
        np.testing.assert_array_equal(tf.idmap.numpy(), np.asarray(jf.idmap))
    for k in (0, 1):  # each mesh alone: its own single-mesh tables
        tsd, jsd = t_parser.parse_scene(path), j_parser.parse_scene(path)
        tsd.objects, jsd.objects = [tsd.objects[k]], [jsd.objects[k]]
        tt = t_build_scene(tsd, device="cpu").meshes[0].itables
        jt = j_build_scene(jsd).meshes[0].itables
        assert tt.tri[:, 9:15].abs().sum() > 0
        for key in ("tri", "cbox", "sbox"):
            np.testing.assert_array_equal(getattr(tt, key).numpy(),
                                          np.asarray(getattr(jt, key)))


def test_single_tables_of_reach_boxes_bit_equal():
    """build_intersect_tables with a clipped mesh's BVH reach boxes equals
    the JAX builder on the same host mesh."""
    m = _clipped_mesh(2000, seed=1)
    v = m.v[np.asarray(t_bvh.morton_order(m.v))]
    b = j_bvh.build_bvh_python(v, m.root_bounds, ac_penalty=3)
    host = types.SimpleNamespace(v=v, reach_lo=b.reach_lo,
                                 reach_hi=b.reach_hi, morton_perm=None)
    jt = jpi.build_intersect_tables(host, tri_chunk=64, as_numpy=True)
    tt = ci.build_intersect_tables(v, tri_chunk=64,
                                   reach=(b.reach_lo, b.reach_hi))
    for k in ("tri", "cbox", "sbox"):
        np.testing.assert_array_equal(getattr(tt, k).numpy(),
                                      getattr(jt, k))
