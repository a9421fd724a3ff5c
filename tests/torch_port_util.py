"""Shared helpers of the port's parity tests (tests/test_torch_*.py):
carrying a JAX scene across as numpy, the two-mesh scene of
tests/test_fused.py for both packages, the JAX tiny scene and settings
or material changes of a JAX scene, renders of both packages from the
same primary rays (and strip renders from the same strip rays), the
gradient loss weights, the golden u8 measures, and primary rays whose
values are shared while each package's gradient flows through its own
(straight_through_primary_rays)."""

from __future__ import annotations

import contextlib
import dataclasses

import jax
import numpy as np
import torch

import rendering_tpu.render.pipeline as j_pipeline
import rendering_tpu_torch.render.pipeline as t_pipeline
from rendering_tpu.render.raygen import pixel_dirs as j_pixel_dirs
from rendering_tpu.render.raygen import primary_rays as j_primary_rays
from rendering_tpu_torch.convert import scene_from_numpy

# The parity tests run in several pytest-xdist workers at once. With one
# intra-op thread per core in every worker, torch's OpenMP threads
# oversubscribe the cores and wait on each other at every eager op: six
# concurrent CPU renders of t01_simple_shapes.scene through the CLI had
# not finished after 150 s at 8 threads each on 8 cores, and took 6.4-7.4
# s at 1 thread each (1.4 s alone at 8).
torch.set_num_threads(1)


def jax_leaves(scene) -> dict:
    """A JAX scene's array leaves as numpy, keyed by dotted path."""
    flat, _ = jax.tree_util.tree_flatten_with_path(scene)
    return {jax.tree_util.keystr(p, simple=True, separator="."): np.asarray(x)
            for p, x in flat}


def jax_static(scene) -> dict:
    """A JAX scene's static as a plain dict, with each mesh's
    clipped_by_root (a static field of its MeshData) added."""
    d = dataclasses.asdict(scene.static)
    d["meshes"] = [dict(m, clipped_by_root=md.clipped_by_root)
                   for m, md in zip(d["meshes"], scene.meshes)]
    return d


def port_scene(jax_scene, device="cpu"):
    """The port's SceneData carrying the JAX scene's arrays."""
    return scene_from_numpy(jax_leaves(jax_scene), jax_static(jax_scene),
                            device=device)


def two_mesh_defs(parser, procedural_mesh, settings,
                  transparent_second=False):
    """The two-mesh scene of tests/test_fused.py (plane, phong mesh A,
    diffuse or transparent mesh B, sphere; point and distant lights) as
    either package's SceneDef, from its own parser module and
    procedural_mesh."""
    sd = parser.SceneDef(settings=settings)
    sd.lights = [
        parser.LightDef("point", color=(1, 0.9, 0.8), intensity=0.7,
                        pos=(0, 2, -1)),
        parser.LightDef("distant", color=(1, 1, 1), intensity=0.3,
                        dir=(0.2, -1, -0.4)),
    ]
    mesh_a = parser.ObjectDef(
        "mesh", pos=(-0.8, 0.0, -3.0), size=(1.4, 1.4, 1.4),
        color=(0.9, 0.5, 0.3), material="phong", ambient=0.3, diffuse=0.4,
        specular=0.3, n_specular=10.0,
    )
    mesh_a.mesh = procedural_mesh(150, pos=(-0.8, 0.0, -3.0),
                                  size=(1.4, 1.4, 1.4), seed=1)
    mesh_b = parser.ObjectDef(
        "mesh", pos=(0.9, 0.2, -3.5), size=(1.2, 1.2, 1.2),
        color=(1, 1, 1) if transparent_second else (0.3, 0.5, 0.9),
        material="transparent" if transparent_second else "diffuse",
        ior=1.4,
    )
    mesh_b.mesh = procedural_mesh(90, pos=(0.9, 0.2, -3.5),
                                  size=(1.2, 1.2, 1.2), seed=2)
    sd.objects = [
        parser.ObjectDef("plane", pos=(0, -1.5, 0), normal=(0, 1, 0),
                         color=(0.85, 0.85, 0.85)),
        mesh_a,
        mesh_b,
        parser.ObjectDef("sphere", pos=(0.1, 1.0, -4.5), radius=0.6,
                         color=(0.9, 0.3, 0.3)),
    ]
    return sd


def jax_two_mesh_scene(transparent_second=False, height=32):
    """The JAX package's two-mesh scene, its Pallas kernel in interpret
    mode, 64 pixels wide and 32 high rather than tests/test_fused.py's
    64x48: at a height that is not a power of two, XLA on the CPU
    computes the horizon row's 2 * (y + 1) / h - 1 as -1.4e-8 instead of
    0 (IEEE, and the port), so its horizon rays hit the floor plane far
    away where the port's miss it.

    At any even height one pixel row looks exactly along the plane of
    mesh A's equator ring of vertices, so its rays hit shared triangle
    edges, where the Pallas kernel (t rounded by XLA) and the port (t in
    exact f32 order) may pick either neighbour. The frame does not see
    which (smooth normals); vertex gradients do. Gradient tests therefore
    take an odd height, which has no such row."""
    from rendering_tpu.flagship import procedural_mesh
    from rendering_tpu.models import parser
    from rendering_tpu.models.scene import build_scene
    from rendering_tpu.models.settings import RenderSettings

    st = RenderSettings(
        width=64, height=height, enable_ssaa=False, enable_output=False,
        output_progress=False, background_color=(0.2, 0.2, 0.25),
        max_ray_depth=3, pallas_interpret=True,
    )
    return build_scene(two_mesh_defs(parser, procedural_mesh, st,
                                     transparent_second))


def jax_settings(js, **kw):
    """The JAX scene with its settings changed (e.g. pallas_interpret)."""
    st = js.static
    return dataclasses.replace(js, static=dataclasses.replace(
        st, settings=dataclasses.replace(st.settings, **kw)))


def jax_material(js, oi: int, mat: int):
    """The JAX scene with object oi's material set to mat (a MAT_* id),
    in its mat_type leaf and in the static copy that picks the bounce
    loop's branches."""
    mats = list(js.static.mat_types)
    mats[oi] = mat
    return dataclasses.replace(
        js, mat_type=js.mat_type.at[oi].set(mat),
        static=dataclasses.replace(js.static, mat_types=tuple(mats)))


def jax_tiny_scene(width=64, height=32, n_tris=128, **settings):
    """The JAX package's build_tiny_scene, its Pallas kernel in interpret
    mode, with any further settings."""
    from rendering_tpu.flagship import build_tiny_scene

    return jax_settings(build_tiny_scene(width, height, n_tris),
                        pallas_interpret=True, **settings)


def loss_weights(shape):
    """The weights of tests/test_fused.py's gradient loss sum(frame * w):
    w = (flat index % 7 + 1) / 7, as one f32 numpy array that both
    packages multiply by."""
    n = int(np.prod(shape))
    return ((np.arange(n) % 7 + 1) / 7.0).astype(np.float32).reshape(shape)


def assert_bounce_frames_agree(t_frame, j_frame):
    """A bouncing frame of the port (t_frame) against JAX's (3, H, W):
    atol 2e-5 on all but 0.2% of the values, and those within 1e-4.

    Why not 2e-5 everywhere: XLA on the CPU contracts multiply-adds into
    FMAs inside a jitted program (the reference builds with
    -ffp-contract=off, the port keeps every f32 operation apart, as JAX's
    op-by-op eager run does). Near a sphere's silhouette the quadratic's
    cancellation amplifies that ulp: on the tiny scene with its glass
    sphere made a mirror, the jitted first bounce's continuation
    directions differ from the port's by up to 5.0e-5, while JAX's eager
    run of the same rays equals the port's to 3e-8, and the second bounce
    from the same continuation agrees to 3e-7. A few such lanes move
    their pixel by up to 5.3e-5."""
    d = np.abs(np.asarray(t_frame) - np.asarray(j_frame))
    assert d.shape == np.shape(j_frame) and np.isfinite(d).all()
    assert (d > 2e-5).mean() <= 0.002, (d > 2e-5).sum()
    assert d.max() <= 1e-4, d.max()


def golden_fractions(a_u8, b_u8):
    """(frac of interior u8 values differing by > 1, by > 8) — the first
    two measures of tests/test_golden.py, 1-pixel border excluded."""
    d = np.abs(a_u8.astype(np.int16) - b_u8.astype(np.int16))[1:-1, 1:-1]
    return float((d > 1).mean()), float((d > 8).mean())


@contextlib.contextmanager
def shared_primary_rays(jax_scene, offset: float = 1.0):
    """Within the block, both packages' render pipelines take the same
    primary rays at `offset` (1.0 the frame's, 0.5 showAC's): the JAX
    package's, computed once outside any jit. XLA
    rounds the ray normalization differently inside and outside a jit
    (1 ulp on ~1% of the rays at 64x32), and an ulp can move a ray
    across a silhouette or a triangle edge, which changes that pixel's
    colour and which vertices its gradient reaches. Render the JAX side
    with `j_render_fresh` below, which traces anew, so no trace made
    before the block is reused."""
    ro, rd, pix = (np.array(x) for x in j_primary_rays(jax_scene,
                                                         offset=offset))
    want = offset

    def j_rays(scene, offset=1.0):
        assert offset == want
        return jax.numpy.asarray(ro), jax.numpy.asarray(rd), \
            jax.numpy.asarray(pix)

    def t_rays(scene, offset=1.0):
        assert offset == want
        return tuple(torch.from_numpy(x).to(scene.device)
                     for x in (ro, rd, pix))

    saved = j_pipeline.primary_rays, t_pipeline.primary_rays
    j_pipeline.primary_rays, t_pipeline.primary_rays = j_rays, t_rays
    try:
        yield
    finally:
        j_pipeline.primary_rays, t_pipeline.primary_rays = saved


@contextlib.contextmanager
def straight_through_primary_rays(jax_scene):
    """Within the block, both packages' render pipelines compute their own
    primary rays in their graphs and swap in the values of JAX's, computed
    once outside any jit: r + stop_gradient(r_shared - r) in JAX, r +
    (r_shared - r).detach() in the port. The frames then see the same rays
    (see shared_primary_rays for why they must), and the gradient reaches
    cam_pos and cam_rmat through each package's own ray generation, which
    shared_primary_rays' constant rays cut. The rays lie within an ulp of
    each other, so r + (r_shared - r) is r_shared exactly."""
    ro, rd, pix = (np.array(x) for x in j_primary_rays(jax_scene,
                                                         offset=1.0))
    j_real, t_real = j_pipeline.primary_rays, t_pipeline.primary_rays

    def j_rays(scene, offset=1.0):
        assert offset == 1.0
        r_o, r_d, _ = j_real(scene, offset=offset)
        sg = jax.lax.stop_gradient
        return (r_o + sg(jax.numpy.asarray(ro) - r_o),
                r_d + sg(jax.numpy.asarray(rd) - r_d),
                jax.numpy.asarray(pix))

    def t_rays(scene, offset=1.0):
        assert offset == 1.0
        r_o, r_d, _ = t_real(scene, offset=offset)
        dev = scene.device
        return (r_o + (torch.from_numpy(ro).to(dev) - r_o).detach(),
                r_d + (torch.from_numpy(rd).to(dev) - r_d).detach(),
                torch.from_numpy(pix).to(dev))

    j_pipeline.primary_rays, t_pipeline.primary_rays = j_rays, t_rays
    try:
        yield
    finally:
        j_pipeline.primary_rays, t_pipeline.primary_rays = j_real, t_real


@contextlib.contextmanager
def shared_strip_rays(jax_scene):
    """Within the block, both packages' strip renders (`_render_strip`)
    take the same primary directions: JAX's eager `pixel_dirs` of every
    pixel at the frame's offset, looked up by pixel. Inside its jitted
    strip XLA rounds the normalization an ulp apart from an eager run
    (see shared_primary_rays), which moves silhouette pixels of a
    bouncing frame. The JAX package's jitted strip functions are dropped
    before and after the block (`_make_strip_fns`' cache), so its strips
    trace anew with the shared directions."""
    st = jax_scene.static.settings
    w, h = st.width, st.height
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    table = np.array(j_pixel_dirs(jax_scene, jax.numpy.asarray(xs.ravel()),
                                  jax.numpy.asarray(ys.ravel()), 1.0, 1.0))

    def j_dirs(scene, xs, ys, ox, oy):
        assert (ox, oy) == (1.0, 1.0)
        idx = ys.astype(jax.numpy.int32) * w + xs.astype(jax.numpy.int32)
        return jax.numpy.asarray(table)[idx]

    def t_dirs(scene, xs, ys, ox, oy):
        assert (ox, oy) == (1.0, 1.0)
        idx = ys.long() * w + xs.long()
        return torch.from_numpy(table).to(xs.device)[idx]

    saved = j_pipeline.pixel_dirs, t_pipeline.pixel_dirs
    j_pipeline._make_strip_fns.cache_clear()
    j_pipeline.pixel_dirs, t_pipeline.pixel_dirs = j_dirs, t_dirs
    try:
        yield
    finally:
        j_pipeline.pixel_dirs, t_pipeline.pixel_dirs = saved
        j_pipeline._make_strip_fns.cache_clear()


def j_render_fresh(scene):
    """The JAX package's render_scene frame, traced anew on every call
    (a fresh jit of its Python function), so that it reads the primary
    rays in effect now."""
    return jax.jit(lambda s: j_pipeline.render_scene.__wrapped__(s))(scene)[0]
