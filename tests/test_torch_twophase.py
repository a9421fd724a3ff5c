"""The two-phase shadow query (K6, `ops.cuda_intersect.any_hit_two_phase`)
in its plain version on the CPU, against the JAX package's
`pallas_intersect.anyhit_two_phase` with the Pallas kernel in interpret
mode, and its place in the render.

Tolerance: none. Occlusion bits are equal, and so are the counters
[box_tests, tri_tests]: the two phases are the single-mesh any hit over
super ranges, whose counters tests/test_torch_rootfilter.py holds exactly
equal to the Pallas kernel's (f32 sums, exact below 2^24), and the
compaction between them is the same permutation. A render with
anyhit_compact_frac > 0 equals the single-pass render bit for bit:
occlusion is a union over super ranges.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rendering_tpu.ops import pallas_intersect as jpi
from rendering_tpu_torch.flagship import (
    build_tiny_scene,
    procedural_mesh,
)
from rendering_tpu_torch.ops import cuda_intersect as ci
from rendering_tpu_torch.render import pipeline as t_pipeline
from test_torch_rootfilter import EXACT, _j_build, _rays
from torch_port_util import jax_settings, jax_two_mesh_scene, port_scene


@pytest.fixture(scope="module")
def clipped():
    """A clipped mesh of 1500 triangles: 3 supers of 8 x 64."""
    js = _j_build(1)
    ts = port_scene(js)
    assert ts.meshes[0].itables.sbox.shape[0] == 3
    return js, ts


@pytest.mark.parametrize("frac,root_filter", [(0.25, True), (0.5, True),
                                               (0.5, False)])
def test_two_phase_plain_matches_pallas(clipped, frac, root_filter):
    """Occlusion and counters of plain K6 equal JAX anyhit_two_phase's,
    with the root filter on and off, at a split of 1 and of 2 supers."""
    js, ts = clipped
    ro, rd, tl = _rays(1400, seed=21)
    jtri, jbox, jtt = (np.asarray(x) for x in jpi.anyhit_two_phase(
        js.meshes[0], js.meshes[0].itables, jnp.asarray(ro), jnp.asarray(rd),
        jnp.asarray(tl), frac=frac, backface_culling=True,
        use_root_filter=root_filter, collect_stats=True, interpret=True))
    tb = ts.meshes[0].itables
    assert ci.two_phase_split(3, frac) == (1 if frac == 0.25 else 2)
    occ, box, tri = ci.any_hit_two_phase(
        tb, *(torch.from_numpy(x) for x in (ro, rd, tl)), frac=frac,
        backface_culling=True, root_filter=root_filter, collect_stats=True)
    np.testing.assert_array_equal(occ.numpy(), jtri >= 0)
    assert 50 < int(occ.sum()) < len(ro[0]) - 50
    assert 0 < int(tri) < EXACT and 0 < int(box) < EXACT
    assert (int(box), int(tri)) == (int(jbox), int(jtt))
    # The same occlusion as the single-pass query (K2).
    single = ci.any_hit(tb, *(torch.from_numpy(x) for x in (ro, rd, tl)),
                        backface_culling=True, root_filter=root_filter)
    assert torch.equal(occ, single)


def test_two_phase_one_super_is_single_pass():
    """A table of one super has no second phase (the JAX package aborts
    there, pallas_intersect.py:975): K6 answers with the single-pass
    query, counters included."""
    m = procedural_mesh(300, pos=(0, 0, -2), size=(2, 2, 2))
    tb = ci.build_intersect_tables(m.v, tri_chunk=64)
    assert tb.sbox.shape[0] == 1 and ci.two_phase_split(1, 0.5) == 1
    ro, rd, tl = (torch.from_numpy(x) for x in _rays(700, seed=22,
                                                     aims=((0, 0, -2),)))
    for frac in (0.25, 0.5, 0.9):
        got = ci.any_hit_two_phase(tb, ro, rd, tl, frac=frac,
                                   collect_stats=True)
        want = ci.any_hit(tb, ro, rd, tl, collect_stats=True)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert 0 < int(got[0].sum()) < 700


def test_two_phase_without_limit():
    """t_limit None: every ray enters with FLT_MAX, as in the single pass."""
    m = procedural_mesh(2000, pos=(0, 0, -2), size=(2, 2, 2))
    tb = ci.build_intersect_tables(m.v, tri_chunk=64)
    ro, rd, _ = (torch.from_numpy(x) for x in _rays(600, seed=23,
                                                    aims=((0, 0, -2),)))
    assert torch.equal(ci.any_hit_two_phase(tb, ro, rd, frac=0.5),
                       ci.any_hit(tb, ro, rd))


def _spy(monkeypatch):
    """Count the calls of any_hit_two_phase made by the render."""
    calls = []
    real = ci.any_hit_two_phase

    def spy(*a, **kw):
        calls.append(kw["frac"])
        return real(*a, **kw)
    monkeypatch.setattr(ci, "any_hit_two_phase", spy)
    return calls


@pytest.mark.parametrize("frac", [0.25, 0.5])
def test_render_with_two_phase_is_bit_equal(monkeypatch, frac):
    """The tiny scene with a mesh of 3 supers: its shadow rays go through
    K6 at anyhit_compact_frac > 0, and the frame and rays_casted equal
    the single-pass render's bit for bit."""
    ts = build_tiny_scene(16, 8, n_tris=1100, device="cpu")
    assert ts.meshes[0].itables.sbox.shape[0] == 3
    with torch.no_grad():
        f0, aux0 = t_pipeline.render_scene(ts)
        calls = _spy(monkeypatch)
        ts2 = build_tiny_scene(16, 8, n_tris=1100, device="cpu",
                               settings_overrides=dict(
                                   anyhit_compact_frac=frac))
        f1, aux1 = t_pipeline.render_scene(ts2)
    assert calls and set(calls) == {frac}
    assert torch.equal(f0, f1)
    assert aux0["stats"]["rays_casted"] == aux1["stats"]["rays_casted"]


def test_fused_shadow_query_stays_single_pass(monkeypatch):
    """As in the JAX package, only a single mesh's shadow query takes
    K6: a scene of two meshes keeps the fused single-pass any hit (K5)."""
    js = jax_settings(jax_two_mesh_scene(), anyhit_compact_frac=0.5)
    ts = port_scene(js)
    assert ts.static.settings.anyhit_compact_frac == 0.5
    calls = _spy(monkeypatch)
    with torch.no_grad():
        frame, _ = t_pipeline.render_scene(ts)
    assert not calls and torch.isfinite(frame).all()
