"""The port's by-primitive geometry sharding
(`rendering_tpu_torch.parallel.geoshard`) on the CPU, as
tests/test_geoshard.py holds the JAX package's: ranks are spawned
processes in a gloo group (`torch_dist_util`) laid out (rays, geo) =
(1, 2) and (2, 2).

* The padding of the fused tables and of the gather table bit-equal to
  JAX's `pad_fused_for_shards` / `pad_vgeo_for_shards`.
* A scene built with geo_shard_axis="geo" keeps every per-triangle
  tensor in host memory (built for the "meta" device here, everything
  else lands there).
* Frames u8-equal to the replicated `render` of the same world: the tiny
  scene (one mesh, so the fused tables; all four materials, SSAA) with
  the shading table sharded and not, the 16-mesh scene with SSAA, its
  showNormals pass, and showAC; the counters equal too.
* Each rank's per-triangle bytes are its share of the padded tables
  (the total over G), nothing per-triangle staged whole.
* The strips of render_with_progress / render_resumable over a geo mesh,
  and `cli.main --geo-shard 2` on two ranks, byte-equal to one process.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from rendering_tpu.flagship import build_multimesh_scene as j_build_multimesh
from rendering_tpu.parallel.geoshard import (
    pad_fused_for_shards as j_pad_fused,
    pad_vgeo_for_shards as j_pad_vgeo,
)
from rendering_tpu_torch.flagship import build_multimesh_scene
from rendering_tpu_torch.models.scene import PER_TRIANGLE
from rendering_tpu_torch.parallel.geoshard import (
    pad_fused_for_shards,
    pad_vgeo_for_shards,
)
from rendering_tpu_torch.render.pipeline import render
import torch_dist_util as du

GEO_CASES = [
    ("tiny", {}, True),
    ("tiny", {}, False),
    ("multimesh", {"enable_ssaa": True}, True),
    ("multimesh", {"enable_ssaa": True, "show_normals": True}, True),
    ("multimesh", {"show_ac": True}, True),
]
CASE_IDS = ["tiny-shade", "tiny", "multimesh-ssaa", "multimesh-normals",
            "multimesh-showac"]


def _tables(ft):
    return [np.asarray(x) for x in (ft.geo.tri, ft.geo.cbox, ft.geo.sbox,
                                    ft.idmap)]


@pytest.mark.parametrize("g", [2, 3, 4, 5])
def test_pad_fused_for_shards_bit_equal_to_jax(g):
    """Padded fused tables of the same 3-mesh world: every array equal
    to JAX's, the padding supers inverted boxes with zero triangles."""
    jft = j_build_multimesh(64, 48, n_meshes=3, tris_per_mesh=90,
                            settings_overrides=dict(pallas_interpret=True,
                                                    geo_shard_axis="geo"))
    tft = build_multimesh_scene(64, 48, n_meshes=3, tris_per_mesh=90,
                                device="cpu").fused_itables
    jp, tp = j_pad_fused(jft.fused_itables, g), pad_fused_for_shards(tft, g)
    for a, b in zip(_tables(tp), _tables(jp)):
        np.testing.assert_array_equal(a, b)
    cs = tft.geo.sbox.shape[0]
    assert tp.geo.sbox.shape[0] % g == 0
    pad = tp.geo.sbox[cs:]
    assert bool((pad[:, 0:3] > pad[:, 3:6]).all())
    assert not bool(tp.geo.tri[cs:].any())


@pytest.mark.parametrize("g", [2, 3, 4, 7])
def test_pad_vgeo_for_shards_bit_equal_to_jax(g):
    v = np.arange(30 * 7, dtype=np.float32).reshape(30, 7)
    got = pad_vgeo_for_shards(torch.from_numpy(v), g).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_pad_vgeo(v, g)))
    assert got.shape[1] % g == 0 and not got[:, 7:].any()


@pytest.mark.parametrize("n_meshes", [1, 2])
def test_geo_build_keeps_per_triangle_tensors_on_host(n_meshes):
    """Built for geometry sharding on a device ("meta" stands in for a
    card): the fused tables, taken even for one mesh, and every
    per-triangle mesh tensor stay in host memory; the rest moves."""
    scene = build_multimesh_scene(
        32, 24, n_meshes=n_meshes, tris_per_mesh=60,
        settings_overrides=dict(geo_shard_axis="geo"), device="meta")
    ft = scene.fused_itables
    assert ft is not None
    for t in (ft.geo.tri, ft.geo.cbox, ft.geo.sbox, ft.idmap):
        assert t.device.type == "cpu"
    for m in scene.meshes:
        assert m.itables is None
        for k in PER_TRIANGLE:
            assert getattr(m, k).device.type == "cpu", k
    assert scene.cam_pos.device.type == "meta"
    assert scene.obj_color.device.type == "meta"


# ---- frames over (1, 2) and (2, 2) --------------------------------------


@pytest.fixture(scope="module", params=[(2, 2), (4, 2)],
                ids=["rays1-geo2", "rays2-geo2"])
def geo_runs(request, tmp_path_factory):
    world, n_geo = request.param
    res = du.run_ranks(du.geo_worker, world, tmp_path_factory.mktemp("geo"),
                       n_geo, GEO_CASES)
    return world, n_geo, res


def test_geo_mesh_layout(geo_runs):
    """rank = r * G + g: the ray axis and the geo axis of each rank."""
    world, n_geo, res = geo_runs
    for rank, r in enumerate(res):
        assert r["ranks"] == (rank // n_geo, world // n_geo, rank % n_geo,
                              n_geo)


@pytest.mark.parametrize("i", range(len(GEO_CASES)), ids=CASE_IDS)
def test_geo_frame_u8_equal_to_replicated(geo_runs, i):
    _world, _g, res = geo_runs
    name, kw, _shade = GEO_CASES[i]
    want, aux = render(du.make_scene(name, **kw), out_u8=True)
    for r in res:
        u8, stats, _acct, _shapes = r["cases"][i]
        np.testing.assert_array_equal(u8, want)
        assert stats == {k: float(v) for k, v in aux["stats"].items()}


@pytest.mark.parametrize("i", [0, 1, 2], ids=CASE_IDS[:3])
def test_geo_rank_bytes_are_a_share(geo_runs, i):
    """Each rank's per-triangle bytes: its 1/G of the padded tables (and
    of the gather table when sharded); with the gather table replicated,
    the mesh tensors on top. The table shards hold ceil(Cs / G) supers."""
    _world, n_geo, res = geo_runs
    name, kw, shade = GEO_CASES[i]
    scene = du.make_scene(name, geo_shard_axis="geo", **kw)
    cs = scene.fused_itables.geo.sbox.shape[0]
    for r in res:
        _u8, _stats, acct, shapes = r["cases"][i]
        assert acct["sharded_bytes_rank"] * n_geo == acct["sharded_bytes_total"]
        assert shapes["tri"][0] == -(-cs // n_geo)
        assert shapes["idmap"][1] * n_geo >= scene.fused_itables.idmap.shape[1]
        if shade:
            assert acct["per_triangle_bytes_rank"] == acct["sharded_bytes_rank"]
            assert all(v[0] == 0 for v in shapes["v"])
            t_total = sum(m.n_tris for m in scene.static.meshes)
            assert shapes["vgeo"] == (30, -(-t_total // n_geo))
        else:
            assert shapes["vgeo"] is None
        assert (acct["per_triangle_bytes_rank"]
                < acct["per_triangle_bytes_replicated"])


# ---- strips and the CLI -------------------------------------------------


@pytest.fixture(scope="module")
def geo_strip_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("geostrips")
    return du.run_ranks(
        du.strips_worker, 2, tmp, str(tmp / "ck.npz"), "geo",
        ("multimesh", {"enable_ssaa": True, "geo_shard_axis": "geo"}))


def test_geo_progress_and_resumable_strips(geo_strip_run):
    """The strips over the (1, 2) mesh: the progress frame within the
    strip tolerance of the one-shot geometry-sharded frame, the
    resumable one bit-equal to it, and a resume rendering only the
    cleared last strip."""
    want, _ = render(du.make_scene("multimesh", enable_ssaa=True))
    for r in geo_strip_run:
        np.testing.assert_allclose(r["progress"], r["oneshot"], **du.STRIP_TOL)
        np.testing.assert_allclose(r["oneshot"], want, atol=2e-6, rtol=0)
        np.testing.assert_array_equal(r["resumed_from_scratch"],
                                      r["progress"])
        np.testing.assert_array_equal(r["resumed"], r["progress"])
        assert r["strips"] == [32]
    assert geo_strip_run[0]["prints"] == ["33%", "67%", "100%"]
    assert geo_strip_run[1]["prints"] == []


def test_cli_geo_shard_two_ranks_bmp_byte_equal(tmp_path, monkeypatch):
    """cli.main --geo-shard 2 on two ranks (outputProgress=1: the
    geometry-sharded strips) writes the one-process BMP byte for byte."""
    monkeypatch.setenv("RTPU_NATIVE", "0")
    monkeypatch.chdir(tmp_path)
    name = du.write_mesh_scene(tmp_path)
    one, two, res = du.run_cli_both(tmp_path, name,
                                    extra=("--geo-shard", "2"))
    assert one == two
    assert [rc for rc, _ in res] == [0, 0]
