"""The port's scene-file entry point on the CPU: `cli.main(..., device=
"cpu")` on two committed golden scenes (t05_area; t01_simple_shapes, a
bouncing scene), and scene files with a rotated OBJ
(clipped by its root box, so every query runs the root filter, K4) with
adaptive SSAA on, against the JAX package's `load_scene` + `render` with
its Pallas kernel in interpret mode; with outputProgress=1 (the strip
renderer), showNormals=1 and showAC=1 against the frame JAX's CLI path
renders.

Tolerances: the golden scene as tests/test_golden.py holds the JAX
package (its per-scene fractions and mean |diff|). Against JAX: Sobel
masks of one frame bit-equal; frames from shared primary rays within
atol 2e-5 (f32 op order); each package's own render within
test_golden.py's DEFAULT_TOL u8 measures; the printed statistics equal.
The OBJ scenes carry no maps and stay small, so their Sobel mask fits
the SSAA queue and the JAX render compiles once per test.
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rendering_tpu.models.scene import load_scene as j_load_scene
from rendering_tpu.models.settings import RenderSettings as JSettings
from rendering_tpu.ops.sobel import sobel_mask as j_sobel_mask
from rendering_tpu.render.pipeline import render as j_render
from rendering_tpu.render.pipeline import (
    render_with_progress as j_render_with_progress,
)
from rendering_tpu.utils.stats import RenderStats as JRenderStats
from rendering_tpu_torch import cli
from rendering_tpu_torch.flagship import procedural_mesh
from rendering_tpu_torch.models.objloader import write_obj
from rendering_tpu_torch.models.scene import load_scene
from rendering_tpu_torch.ops.sobel import sobel_mask
from rendering_tpu_torch.render.pipeline import render_scene
from rendering_tpu_torch.utils.bmp import bmp_to_image, load_bmp
from rendering_tpu_torch.utils.profiling import find_traces, op_profile
from test_golden import (
    DEFAULT_TOL,
    REPO,
    SCENE_MAD,
    SCENE_TOL,
    neighborhood_violations,
)
from torch_port_util import golden_fractions, j_render_fresh, shared_primary_rays

_SCENE = """[options]
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
name=mesh.obj
{second}
[end]
"""
# A second, unrotated (unclipped) mesh: the scene then takes the fused
# tables (K5) with the root filter.
_SECOND = """
[object]
type=mesh
pos=0.5,0.3,-2.5
size=0.8,0.8,0.8
color=0.3,0.5,0.9
material=diffuse
name=second.obj
"""


@pytest.fixture()
def obj_workspace(in_workspace, monkeypatch):
    """The golden workspace with two OBJ files of the procedural mesh
    (the 1500 triangles keep the JAX kernel's interpret mode fast); the
    JAX loader and BVH run in Python (no native build)."""
    monkeypatch.setenv("RTPU_NATIVE", "0")
    for name, n, seed in (("mesh.obj", 1500, 0), ("second.obj", 400, 3)):
        m = procedural_mesh(n, pos=(0, 0, 0), size=(2, 2, 2), seed=seed)
        write_obj(os.path.join(in_workspace, name), m.v, m.uv, m.n)
    return in_workspace


def _write_scene(ws, name, *, stats=0, second=False):
    with open(os.path.join(ws, name), "w") as fh:
        fh.write(_SCENE.format(stats=stats, second=_SECOND if second else ""))
    return name


def _golden_measures(name, bmp):
    """test_golden.py's measures of a BMP against the committed golden:
    (> 1, > 8, neighbourhood violations, mean |diff|) with their limits."""
    ours = bmp_to_image(load_bmp(bmp))
    gold = bmp_to_image(load_bmp(os.path.join(REPO, "tests", "goldens",
                                              f"{name}.bmp")))
    assert ours.shape == gold.shape
    inner = np.abs(ours.astype(np.int16) - gold.astype(np.int16))[1:-1, 1:-1]
    measured = ((inner > 1).mean(), (inner > 8).mean(),
                neighborhood_violations(ours, gold)[1:-1, 1:-1].mean(),
                inner.mean())
    return ours.shape, measured, (*SCENE_TOL[name], SCENE_MAD[name])


def test_cli_t05_area_matches_golden(in_workspace):
    """The port's CLI renders the committed t05_area scene (no assets,
    SSAA on) to a BMP that test_golden.py's measures accept."""
    assert cli.main(["t05_area.scene", "--output", "t05.bmp"],
                    device="cpu") == 0
    shape, measured, tolerance = _golden_measures("t05_area", "t05.bmp")
    assert shape == (150, 200, 3)
    assert all(m <= t for m, t in zip(measured, tolerance)), (measured,
                                                               tolerance)


def test_cli_t01_simple_shapes_matches_golden(in_workspace, capsys):
    """The reference's first scene: a glass, a mirror, a phong and a
    diffuse sphere over a plane, max_ray_depth 10, SSAA on. The port's
    CLI renders it within test_golden.py's t01 measures, and no path is
    dropped (no drop warning)."""
    assert cli.main(["t01_simple_shapes.scene", "--output", "t01.bmp"],
                    device="cpu") == 0
    assert "dropped" not in capsys.readouterr().out
    shape, measured, tolerance = _golden_measures("t01_simple_shapes",
                                                  "t01.bmp")
    assert shape == (240, 320, 3)
    assert all(m <= t for m, t in zip(measured, tolerance)), (measured,
                                                               tolerance)


@pytest.mark.parametrize("second", [False, True])
def test_clipped_obj_scene_matches_jax(obj_workspace, second):
    """From the same primary rays, the port's SSAA frame of a clipped-OBJ
    scene equals JAX's within f32 op order; the Sobel masks of one frame
    are bit-equal."""
    path = _write_scene(obj_workspace, "clip.scene", second=second)
    js = j_load_scene(path, JSettings(pallas_interpret=True))
    ts = load_scene(path, device="cpu")
    assert js.meshes[0].clipped_by_root and ts.static.meshes[0].clipped_by_root
    assert ts.static.settings.enable_ssaa and (
        (ts.fused_itables is not None) == second)
    with shared_primary_rays(js):
        j_frame = np.array(j_render_fresh(js))
        with torch.no_grad():
            t_frame, aux = render_scene(ts)
    np.testing.assert_allclose(t_frame.numpy(), j_frame, rtol=0, atol=2e-5)
    assert 0 < aux["ssaa_masked"] <= 512  # refined, within the capacity
    tm = sobel_mask(torch.from_numpy(j_frame)).numpy()
    jm = np.asarray(j_sobel_mask(jnp.asarray(j_frame)))
    np.testing.assert_array_equal(tm, jm)
    assert tm.any()


def _jax_render(path, capsys):
    """JAX's u8 frame and the statistics block its CLI prints, from its
    render with the Pallas kernel in interpret mode (its CLI on the CPU
    would count the dense fallback's tests instead)."""
    js = j_load_scene(path, JSettings(pallas_interpret=True))
    frame, aux = j_render(js, out_u8=True)
    rs = JRenderStats()
    rs.add_device_counts({k: int(v) for k, v in aux["stats"].items()})
    rs.mesh_count = sum(m.n_tris for m in js.static.meshes)
    rs.tri_copies_count = sum(m.tri_copies for m in js.static.meshes)
    rs.ac_count = sum(m.n_real_nodes for m in js.static.meshes)
    capsys.readouterr()
    rs.print_stats()
    return np.asarray(frame), capsys.readouterr().out


def test_statistics_match_jax(obj_workspace, capsys):
    """collectStatistics=1: the port's CLI prints JAX's statistics block
    (the counters of K3 through the root filter included), and its BMP,
    each package from its own rays, is within DEFAULT_TOL of JAX's
    frame. (The fused counters are held against the Pallas kernel in
    tests/test_torch_rootfilter.py.)"""
    path = _write_scene(obj_workspace, "stats.scene", stats=1)
    j_u8, expected = _jax_render(path, capsys)
    assert cli.main([path, "--output", "stats.bmp"], device="cpu") == 0
    printed = capsys.readouterr().out
    assert printed == expected
    assert "Statistics:" in printed and "0.00e+00" not in printed
    t_u8 = bmp_to_image(load_bmp("stats.bmp"))
    assert t_u8.shape == j_u8.shape == (32, 64, 3)
    gt1, gt8 = golden_fractions(t_u8, j_u8)
    assert gt1 <= DEFAULT_TOL[0] and gt8 <= DEFAULT_TOL[1]


def _progress_scene(ws, name, **options):
    """The clipped-OBJ scene file with outputProgress=1 (the scene-file
    default) and further [options] lines."""
    path = _write_scene(ws, name)
    with open(path) as fh:
        text = fh.read().replace("outputProgress=0", "outputProgress=1")
    extra = "".join(f"{k}={v}\n" for k, v in options.items())
    with open(path, "w") as fh:
        fh.write(text.replace("[options]\n", "[options]\n" + extra))
    return path


def test_cli_unported_options_raise(obj_workspace):
    """outputProgress=1 (the scene-file default) renders through the strip
    renderer: the BMP is within DEFAULT_TOL of JAX's render_with_progress
    u8 frame, each package from its own rays. With --trace-dir the CLI
    also writes a profiler trace there, whose op_profile has rows, and a
    BMP within DEFAULT_TOL of JAX's frame too. --geo-shard G in this one
    process raises unless G divides the one rank; --geo-shard 1 renders
    the geometry-sharded strips, a BMP within DEFAULT_TOL of JAX's frame
    too (tests/test_torch_geoshard.py runs G = 2 on two ranks)."""
    path = _progress_scene(obj_workspace, "prog.scene")
    js = j_load_scene(path, JSettings(pallas_interpret=True))
    assert js.static.settings.output_progress
    j_u8, _ = j_render_with_progress(js, out_u8=True, _print=lambda s: None)
    assert cli.main([path, "--output", "prog.bmp"], device="cpu") == 0
    t_u8 = bmp_to_image(load_bmp("prog.bmp"))
    assert t_u8.shape == np.shape(j_u8) == (32, 64, 3)
    gt1, gt8 = golden_fractions(t_u8, np.asarray(j_u8))
    assert gt1 <= DEFAULT_TOL[0] and gt8 <= DEFAULT_TOL[1]
    with pytest.raises(ValueError, match="must divide the 1 ranks"):
        cli.main([path, "--geo-shard", "2"], device="cpu")
    assert cli.main([path, "--geo-shard", "1", "--output", "geo.bmp"],
                    device="cpu") == 0
    gt1, gt8 = golden_fractions(bmp_to_image(load_bmp("geo.bmp")),
                                np.asarray(j_u8))
    assert gt1 <= DEFAULT_TOL[0] and gt8 <= DEFAULT_TOL[1]
    assert cli.main([path, "--trace-dir", "tr", "--output", "traced.bmp"],
                    device="cpu") == 0
    assert len(find_traces("tr")) == 1 and op_profile("tr")
    traced = bmp_to_image(load_bmp("traced.bmp"))
    gt1, gt8 = golden_fractions(traced, np.asarray(j_u8))
    assert gt1 <= DEFAULT_TOL[0] and gt8 <= DEFAULT_TOL[1]


@pytest.mark.parametrize("option", ["showNormals", "showAC"])
def test_cli_debug_passes_match_jax(obj_workspace, option):
    """A scene file with showNormals=1 (through the strip renderer, SSAA
    on) or showAC=1 (one pass) renders through the port's CLI to a BMP
    within DEFAULT_TOL of the frame JAX's CLI path renders (its
    render_with_progress or render), each package from its own rays."""
    path = _progress_scene(obj_workspace, "debug.scene", **{option: 1})
    js = j_load_scene(path, JSettings(pallas_interpret=True))
    if option == "showAC":
        j_u8, _ = j_render(js, out_u8=True)
    else:
        j_u8, _ = j_render_with_progress(js, out_u8=True,
                                         _print=lambda s: None)
    assert cli.main([path, "--output", "debug.bmp"], device="cpu") == 0
    t_u8 = bmp_to_image(load_bmp("debug.bmp"))
    assert t_u8.shape == (32, 64, 3)
    gt1, gt8 = golden_fractions(t_u8, np.asarray(j_u8))
    assert gt1 <= DEFAULT_TOL[0] and gt8 <= DEFAULT_TOL[1]
    assert len(np.unique(t_u8.reshape(-1, 3), axis=0)) > 8
