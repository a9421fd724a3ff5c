"""Render pipeline — the primary pass of `rendering_tpu.render.pipeline`
for non-bouncing scenes.

Frames are channel-first f32 (3, H, W) tensors on the scene's device;
`render` returns the usual (H, W, 3) numpy array. `render_scene` is
differentiable (the train step in `diff.inverse` calls it under
autograd): it derives the gather tables from the scene's canonical
arrays first, so gradients reach vertices, normals, uvs and texels.
Parity quirk kept:
the last pixel row and column are never rendered by the reference (its
tile clamp, scene.cpp:369-372) and stay black.

Adaptive SSAA, showNormals, showAC, the strip/progress renders and the
SSAA/queue escalation come with later slices; `render_scene` raises
NotImplementedError for them instead of rendering something else.
"""

from __future__ import annotations

import dataclasses

import torch

from rendering_tpu_torch.models.scene import check_supported
from rendering_tpu_torch.render.integrator import DEFAULT_RAY_BLOCK, integrate
from rendering_tpu_torch.render.raygen import primary_rays, tile_dims


def quantize_u8(frame3):
    """(3, H, W) f32 -> (H, W, 3) u8, bit-identical to
    utils.bmp.quantize_reference (the reference writer's
    `static_cast<char>(clamp(0,1,f) * 255)`, src/util.cpp:50, as
    compiled: >= 255.0 saturates to 127, in-range truncates)."""
    product = torch.clamp(frame3, 0.0, 1.0) * 255.0
    u8 = torch.floor(product).to(torch.uint8)
    u8 = torch.where(product >= 255.0, 127, u8).to(torch.uint8)
    return u8.movedim(0, -1)


def _untile(slots3, w: int, h: int):
    """Invert the primary-ray screen-tile permutation with reshapes and
    one transpose (tile_dims guarantees exact tiling)."""
    tw, th = tile_dims(w, h)
    t = slots3.reshape(3, h // th, w // tw, th, tw)
    return t.permute(0, 1, 3, 2, 4).reshape(3, h, w)


def derive_mesh_tables(scene):
    """The scene with each mesh's gather tables derived from its
    canonical arrays (JAX `pipeline.derive_mesh_tables`): vgeoT (30, T)
    rows v | n | uv | tangent | bitangent, and the packed map table mapsT
    (7, W*H) where the maps share dims; for a fused scene also their
    concatenation fused_vgeoT (30, T_total). Built once per render, in
    the autograd graph, so gradients flow back to the arrays."""
    def tables(m, ms):
        mapsT = None
        if ms.has_packed_maps:
            n_tex = ms.pmap_wh[0] * ms.pmap_wh[1]
            z3 = torch.zeros((3, n_tex), device=m.v.device)
            mapsT = torch.cat([
                m.diffuse_map.T if ms.has_diffuse_map else z3,
                m.normal_map.T if ms.has_normal_map else z3,
                (m.specular_map.reshape(1, n_tex) if ms.has_specular_map
                 else z3[:1]),
            ], dim=0)
        vgeoT = torch.cat([
            m.v.reshape(-1, 9).T, m.n.reshape(-1, 9).T, m.uv.reshape(-1, 6).T,
            m.tangent.T, m.bitangent.T,
        ], dim=0)
        return dataclasses.replace(m, vgeoT=vgeoT, mapsT=mapsT)

    meshes = tuple(tables(m, ms)
                   for m, ms in zip(scene.meshes, scene.static.meshes))
    fused_vgeoT = None
    if scene.fused_itables is not None:
        fused_vgeoT = torch.cat([m.vgeoT for m in meshes], dim=1)
    return dataclasses.replace(scene, meshes=meshes, fused_vgeoT=fused_vgeoT)


def _primary_pass(scene, *, ray_block=DEFAULT_RAY_BLOCK):
    st = scene.static
    w, h = st.settings.width, st.settings.height
    ro, rd, _ = primary_rays(scene, offset=1.0)
    weight = torch.ones((w * h,), device=scene.device)
    # No bouncing: slots stay pixel-aligned, so radiance accumulates per
    # slot and one transpose undoes the tile order.
    slots3, stats = integrate(scene, ro, rd, weight, ray_block=ray_block)
    frame3 = _untile(slots3, w, h)
    # Dead last row/column (scene.cpp:369-372): never rendered, stays 0.
    rows = torch.arange(h, device=scene.device)[:, None] < h - 1
    cols = torch.arange(w, device=scene.device)[None, :] < w - 1
    return torch.where(rows & cols, frame3, 0.0), stats


def _check_slice(scene):
    st = scene.static
    settings = st.settings
    for flag, what, slice_ in (
        (settings.enable_ssaa, "adaptive SSAA (enable_ssaa)", "SSAA"),
        (settings.show_normals, "showNormals", "debug-pass"),
        (settings.show_ac, "showAC", "debug-pass"),
        (settings.collect_statistics,
         "collectStatistics (the kernel's test counters, K3)", "statistics"),
        (st.any_bouncing, "reflective/transparent materials", "bouncing"),
    ):
        if flag:
            raise NotImplementedError(
                f"{what} is not ported yet; it comes with the {slice_} "
                f"slice of the port")
    check_supported(st)


def render_scene(scene, ray_block: int = DEFAULT_RAY_BLOCK,
                 out_u8: bool = False):
    """Render on the scene's device: returns (frame3 (3, H, W) f32, aux
    dict with the stats counters), differentiable with respect to the
    scene's float tensors. `out_u8` quantizes the frame on the device to
    the BMP writer's u8 codes, (H, W, 3)."""
    _check_slice(scene)
    scene = derive_mesh_tables(scene)
    frame3, stats = _primary_pass(scene, ray_block=ray_block)
    aux = {"stats": stats, "ssaa_masked": 0}
    return (quantize_u8(frame3) if out_u8 else frame3), aux


def render(scene, ray_block: int = DEFAULT_RAY_BLOCK, out_u8: bool = False):
    """Host-facing render: ((H, W, 3) numpy frame, aux). With out_u8 the
    frame is the BMP writer's u8 codes, else f32 in [0, 1+]."""
    with torch.no_grad():
        frame, aux = render_scene(scene, ray_block=ray_block, out_u8=out_u8)
    if not out_u8:
        frame = frame.permute(1, 2, 0)
    return frame.cpu().numpy(), aux
