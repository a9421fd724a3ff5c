"""The port's `flagship.densify_mesh` and its helpers, and the asset
branches of its scene builders, against the JAX package on the CPU.

`_subdiv_bary`, `_split_bary`, the two position noises and
`densify_mesh` equal JAX's bit for bit, on tests/test_densify.py's cases
(mixed levels, uniform, displace_frac=0) and on a procedural mesh; the
port's functions pass that file's watertightness and boundary checks,
and its pinhole probe through the port's plain closest hit. The builders'
asset branches run on stand-in OBJ files written here (the procedural
mesh as shotgun.obj and bunny.obj) under a temporary REFERENCE_DIR, set
in both packages: scene tensors carried across through convert.py equal
the port's own build bit for bit, and frames at 64x32 from shared
primary rays agree to atol 2e-5 (f32 op order, as
tests/test_torch_render.py). The procedural branch runs at 2000
triangles, as tests/test_torch_render.py's flagship frames do: at an
even ring count (1200) a ring of vertices lies on the horizon row,
where rays graze shared edges and the JAX reference's interpret mode,
which contracts multiply-adds into FMAs, flips u + v <= 1 on 6 pixels.
REFERENCE_DIR comes from the environment only: unset, the builders take
the procedural meshes whatever lies beside the checkout.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import rendering_tpu.flagship as j_flagship
import rendering_tpu_torch.flagship as t_flagship
from rendering_tpu.models.objloader import MeshArrays as JMeshArrays
from rendering_tpu_torch.models.objloader import MeshArrays, write_obj
from rendering_tpu_torch.ops import cuda_intersect as ci
from rendering_tpu_torch.render.pipeline import render_scene
from torch_port_util import j_render_fresh, port_scene, shared_primary_rays

FIELDS = ("v", "n", "uv", "tangent", "bitangent", "root_bounds")
INTERPRET = dict(pallas_interpret=True)
STAND_IN_TRIS = {"shotgun.obj": 300, "bunny.obj": 200}


def _bits_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype, a.shape) == (b.dtype, b.shape) and np.array_equal(
        a.view(np.uint8), b.view(np.uint8))


def _octahedron(cls=MeshArrays):
    """tests/test_densify.py's closed octahedron: a triangle soup with
    corners bit-shared across faces and unit normals."""
    p = np.asarray([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                    [0, 0, 1], [0, 0, -1]], np.float32)
    faces = [(0, 2, 4), (2, 1, 4), (1, 3, 4), (3, 0, 4),
             (2, 0, 5), (1, 2, 5), (3, 1, 5), (0, 3, 5)]
    v = np.stack([p[list(f)] for f in faces])
    return cls(v=v, n=v.copy(), uv=np.zeros((8, 3, 2), np.float32),
               tangent=np.zeros((8, 3), np.float32),
               bitangent=np.zeros((8, 3), np.float32),
               root_bounds=np.stack([p.min(0) - 1, p.max(0) + 1]))


def _procedural(cls=MeshArrays):
    m = t_flagship.procedural_mesh(120, pos=(0.2, -0.1, -3), size=(1, 2, 1))
    return cls(**{f: getattr(m, f) for f in FIELDS})


def _edge_counts(v: np.ndarray) -> dict:
    """Soup edges counted by quantized endpoint positions."""
    q = np.round(v.astype(np.float64) * (1 << 20)).astype(np.int64)
    counts: dict = {}
    for t in range(q.shape[0]):
        for k in range(3):
            a, b = q[t, k].tobytes(), q[t, (k + 1) % 3].tobytes()
            key = (min(a, b), max(a, b))
            counts[key] = counts.get(key, 0) + 1
    return counts


# ---- the helpers and densify_mesh, bit for bit ------------------------------


@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_subdiv_and_split_bary_bit_equal(level):
    assert _bits_equal(t_flagship._subdiv_bary(level),
                       j_flagship._subdiv_bary(level))
    if level == 3:
        return
    for bits in range(8):
        mask = tuple(bool(bits >> k & 1) for k in range(3))
        assert _bits_equal(t_flagship._split_bary(level, mask),
                           j_flagship._split_bary(level, mask)), mask


def test_displace_noise_bit_equal():
    p = np.random.default_rng(11).normal(size=(4, 257, 3)) * 3.0
    assert _bits_equal(t_flagship._displace_noise(p),
                       j_flagship._displace_noise(p))
    assert _bits_equal(t_flagship._displace_noise3(p),
                       j_flagship._displace_noise3(p))
    n3 = t_flagship._displace_noise3(p)
    assert n3.shape == (4, 257, 3) and np.abs(n3).max() <= 1.0


@pytest.mark.parametrize("mesh,target,frac", [
    ("octahedron", 80, 0.02),        # mixed levels
    ("octahedron", 8 * 16, 0.0),     # uniform, no displacement
    ("octahedron", 8, 0.004),        # at the target already: unchanged
    ("procedural", 1000, 0.004),
])
def test_densify_mesh_bit_equal(mesh, target, frac):
    make = _octahedron if mesh == "octahedron" else _procedural
    t = t_flagship.densify_mesh(make(), target, displace_frac=frac)
    j = j_flagship.densify_mesh(make(JMeshArrays), target,
                                displace_frac=frac)
    for f in FIELDS:
        assert _bits_equal(getattr(t, f), getattr(j, f)), f
    if target > 8:
        assert t.v.shape[0] > make().v.shape[0]


# ---- tests/test_densify.py's checks on the port's functions -----------------


@pytest.mark.parametrize("level", [0, 1, 2])
def test_split_bary_doubles_marked_boundary_nodes(level):
    plain = t_flagship._subdiv_bary(level)
    split = t_flagship._split_bary(level, (True, False, False))

    def boundary_nodes(bary, k):
        pts = bary.reshape(-1, 3)
        return {tuple(x) for x in pts[np.abs(pts[:, k]) == 0.0]}

    assert len(boundary_nodes(split, 0)) == (1 << (level + 1)) + 1
    assert len(boundary_nodes(split, 1)) == (1 << level) + 1
    assert len(boundary_nodes(plain, 0)) == (1 << level) + 1
    d1 = split[:, 1, 1:] - split[:, 0, 1:]
    d2 = split[:, 2, 1:] - split[:, 0, 1:]
    area = np.abs(d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]).sum() * 0.5
    np.testing.assert_allclose(area, 0.5, rtol=1e-12)


def test_densify_mixed_levels_watertight():
    out = t_flagship.densify_mesh(_octahedron(), 80, displace_frac=0.02)
    assert out.v.shape[0] > 8 * 4
    bad = {k: c for k, c in _edge_counts(out.v).items() if c != 2}
    assert not bad, f"{len(bad)} non-manifold/T-junction edges"


def test_densify_uniform_watertight_and_exact():
    out = t_flagship.densify_mesh(_octahedron(), 8 * 16, displace_frac=0.0)
    assert out.v.shape[0] == 8 * 16
    assert all(c == 2 for c in _edge_counts(out.v).values())
    s = np.abs(out.v.reshape(-1, 3)).sum(axis=1)
    np.testing.assert_allclose(s, 1.0, atol=1e-6)


def test_densify_rays_cannot_escape_level_boundary():
    """A dense ray grid through the displaced mixed-level octahedron's
    silhouette interior: every ray hits (a T-junction crack would let
    some through), by the port's plain closest hit."""
    out = t_flagship.densify_mesh(_octahedron(), 80, displace_frac=0.02)
    g = np.linspace(-0.4, 0.4, 40, dtype=np.float32)
    xx, yy = np.meshgrid(g, g)
    ro = np.stack([xx.ravel(), yy.ravel(), np.full(xx.size, 3.0,
                                                    np.float32)])
    rd = np.tile(np.asarray([[0], [0], [-1]], np.float32), (1, ro.shape[1]))
    tb = ci.build_intersect_tables(
        out.v, tri_chunk=ci.default_tri_chunk(out.v.shape[0]))
    _, tri = ci.closest_hit(tb, torch.from_numpy(ro), torch.from_numpy(rd),
                            backface_culling=False)
    assert int((tri < 0).sum()) == 0, "rays escaped the mesh"


# ---- the builders' asset branches -------------------------------------------


@pytest.fixture()
def reference(tmp_path, monkeypatch):
    """A REFERENCE_DIR holding stand-in shotgun.obj and bunny.obj (the
    procedural mesh written as OBJ), set in both packages' flagship
    modules; the JAX loader runs in Python (set per JAX build)."""
    objects = tmp_path / "input" / "objects"
    objects.mkdir(parents=True)
    for seed, (name, n) in enumerate(sorted(STAND_IN_TRIS.items())):
        m = t_flagship.procedural_mesh(n, pos=(0, 0, 0), size=(2, 2, 2),
                                       seed=seed)
        write_obj(str(objects / name), m.v, m.uv, m.n)
    for mod in (j_flagship, t_flagship):
        monkeypatch.setattr(mod, "REFERENCE_DIR", str(tmp_path))
    return objects


def _jax_build(monkeypatch, fn, **kw):
    monkeypatch.setenv("RTPU_NATIVE", "0")
    try:
        return fn(**kw, settings_overrides=INTERPRET)
    finally:
        monkeypatch.delenv("RTPU_NATIVE")


def _assert_scenes_equal(cs, ts):
    """The JAX scene carried across equals the port's own build: static,
    each mesh's arrays and chunk tables, the fused tables."""
    assert cs.static == ts.static
    for cm, tm in zip(cs.meshes, ts.meshes, strict=True):
        for k in ("v", "n", "uv", "tangent", "bitangent"):
            assert torch.equal(getattr(cm, k), getattr(tm, k)), k
        if cm.itables is not None:
            for k in ("tri", "cbox", "sbox"):
                assert torch.equal(getattr(cm.itables, k),
                                   getattr(tm.itables, k)), k
    if cs.fused_itables is not None:
        for k in ("tri", "cbox", "sbox"):
            assert torch.equal(getattr(cs.fused_itables.geo, k),
                               getattr(ts.fused_itables.geo, k)), k
        assert torch.equal(cs.fused_itables.idmap, ts.fused_itables.idmap)


def _assert_frames_agree(js, ts):
    with shared_primary_rays(js):
        j_frame = np.asarray(j_render_fresh(js))
        t_frame = render_scene(ts)[0].detach().numpy()
    assert np.isfinite(t_frame).all() and j_frame.shape == t_frame.shape
    np.testing.assert_allclose(t_frame, j_frame, rtol=0, atol=2e-5)
    return t_frame


@pytest.mark.parametrize("branch", ["loaded", "densified", "absent"])
def test_flagship_asset_branches_match_jax(reference, monkeypatch, branch):
    if branch == "absent":
        (reference / "shotgun.obj").unlink()
    kw = dict(width=64, height=32,
              n_tris=None if branch == "loaded" else 2000,
              real_geometry=branch != "loaded")
    js = _jax_build(monkeypatch, j_flagship.build_flagship_scene, **kw)
    ts = t_flagship.build_flagship_scene(**kw, device="cpu")
    want = {"loaded": STAND_IN_TRIS["shotgun.obj"], "absent": 2000}
    if branch in want:
        assert ts.static.meshes[0].n_tris == want[branch]
    else:
        assert 1200 < ts.static.meshes[0].n_tris < 2400  # ~2000, closed
    assert ts.static.meshes[0].n_tris == js.static.meshes[0].n_tris
    # The loaded stand-in is placed rotated, so its root box clips it.
    assert ts.static.meshes[0].clipped_by_root == (branch == "loaded")
    _assert_scenes_equal(port_scene(js), ts)
    frame = _assert_frames_agree(js, ts)
    assert (frame[:, :-1, :-1] != frame[:, :1, :1]).any()


def test_multimesh_bunny_branch_matches_jax(reference, monkeypatch):
    kw = dict(width=64, height=32, n_meshes=4, tris_per_mesh=None)
    js = _jax_build(monkeypatch, j_flagship.build_multimesh_scene, **kw)
    ts = t_flagship.build_multimesh_scene(**kw, device="cpu")
    assert [m.n_tris for m in ts.static.meshes] == [200] * 4
    assert ts.static.settings.max_ray_depth == 10
    _assert_scenes_equal(port_scene(js), ts)
    _assert_frames_agree(js, ts)
    (reference / "bunny.obj").unlink()
    procedural = t_flagship.build_multimesh_scene(**kw, device="cpu")
    assert [m.n_tris for m in procedural.static.meshes] == [5000] * 4


@pytest.mark.parametrize("env", ["unset", "set"])
def test_reference_dir_read_from_environment_only(tmp_path, env):
    """The module reads REFERENCE_DIR from the environment at import and
    has no default: unset, it is None."""
    environ = {k: v for k, v in os.environ.items() if k != "REFERENCE_DIR"}
    if env == "set":
        environ["REFERENCE_DIR"] = str(tmp_path)
    out = subprocess.run(
        [sys.executable, "-c", "import rendering_tpu_torch.flagship as f; "
         "print(f.REFERENCE_DIR)"],
        env=environ, cwd=t_flagship.REPO, capture_output=True, text=True,
        check=True)
    assert out.stdout.strip() == ("None" if env == "unset" else str(tmp_path))


def test_builders_procedural_without_reference_dir(reference, monkeypatch):
    """With REFERENCE_DIR unset the asset branches are off, though the
    stand-ins exist: the multi-mesh builder takes 5,000 procedural
    triangles a cell, the flagship's loaded branch the procedural mesh."""
    monkeypatch.setattr(t_flagship, "REFERENCE_DIR", None)
    assert t_flagship.reference_obj("bunny.obj") is None
    assert t_flagship.reference_obj("shotgun.obj") is None
    ms = t_flagship.build_multimesh_scene(64, 32, n_meshes=2, device="cpu")
    assert [m.n_tris for m in ms.static.meshes] == [5000] * 2
    fs = t_flagship.build_flagship_scene(64, 32, n_tris=2000,
                                         real_geometry=True, device="cpu")
    assert fs.static.meshes[0].n_tris == 2000
