"""Render pipeline — `rendering_tpu.render.pipeline`: the primary pass
and adaptive SSAA (scene.cpp:508-593: Sobel edge mask, the masked pixels
compacted into a queue of static capacity, 4 subsample rays each, their
mean scattered back into the frame), for every material.

Frames are channel-first f32 (3, H, W) tensors on the scene's device;
`render` returns the usual (H, W, 3) numpy array. `render_scene` is
differentiable (the train step in `diff.inverse` calls it under
autograd): it derives the gather tables from the scene's canonical
arrays first, so gradients reach vertices, normals, uvs and texels. A
scene without reflective or transparent objects accumulates radiance per
queue slot and undoes the screen-tile order with one transpose; a
bouncing one scatters it into the pixel buffer through the queue's pixel
ids. Parity quirk kept: the last pixel row and column are never rendered
by the reference (its tile clamp, scene.cpp:369-372) and stay black.

`render` redoes a frame whose Sobel mask outgrew the SSAA capacity at a
raised capacity, and one whose transparent queue dropped paths at a
doubled queue headroom (`escalating_render`). showNormals, showAC and
the strip/progress renders come with later slices; `render_scene` raises
NotImplementedError for the first two instead of rendering something
else.
"""

from __future__ import annotations

import dataclasses

import torch

from rendering_tpu_torch.device import deterministic_algorithms
from rendering_tpu_torch.ops.sobel import sobel_mask
from rendering_tpu_torch.render.integrator import (
    DEFAULT_RAY_BLOCK,
    add_stats,
    integrate,
)
from rendering_tpu_torch.render.raygen import (
    primary_rays,
    ssaa_subsample_rays,
    tile_dims,
)


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


def _primary_pass(scene, *, ray_block=DEFAULT_RAY_BLOCK, queue_headroom=1):
    st = scene.static
    w, h = st.settings.width, st.settings.height
    ro, rd, pix = primary_rays(scene, offset=1.0)
    weight = torch.ones((w * h,), device=scene.device)
    if st.any_bouncing:
        accum3, stats = integrate(scene, ro, rd, pix, weight, w * h,
                                  ray_block=ray_block,
                                  queue_headroom=queue_headroom)
        frame3 = accum3.reshape(3, h, w)
    else:
        # No bouncing: slots stay pixel-aligned, so radiance accumulates
        # per slot and one transpose undoes the tile order.
        slots3, stats = integrate(scene, ro, rd, pix, weight, w * h,
                                  ray_block=ray_block, out_slots=True)
        frame3 = _untile(slots3, w, h)
    # Dead last row/column (scene.cpp:369-372): never rendered, stays 0.
    rows = torch.arange(h, device=scene.device)[:, None] < h - 1
    cols = torch.arange(w, device=scene.device)[None, :] < w - 1
    return torch.where(rows & cols, frame3, 0.0), stats


def default_ssaa_capacity(settings) -> int:
    """The SSAA queue's capacity unless a caller raises it:
    ssaa_capacity_fraction of the pixels, at least 1."""
    return max(1, int(settings.width * settings.height
                      * settings.ssaa_capacity_fraction))


def _ssaa_pass(scene, frame3, *, capacity: int, ray_block=DEFAULT_RAY_BLOCK,
               queue_headroom: int = 1):
    """Sobel-adaptive refinement (JAX `_ssaa_pass`). The first `capacity`
    masked pixels in raster order are refined; the queue keeps its static
    size, its fill lanes aiming at the clamped last pixel with weight 0,
    so the rays traced and the counters equal the JAX package's. A
    bouncing scene scatters the weighted subsamples through their pixel
    ids; another accumulates per slot and sums the four subsamples of a
    pixel before one scatter. Returns (frame3, n_masked (host int),
    stats)."""
    st = scene.static
    w, h = st.settings.width, st.settings.height
    mask = sobel_mask(frame3.detach())
    flat = mask.reshape(-1)
    # torch.nonzero syncs with the host; the overflow check reads the
    # mask size on the host anyway.
    idx = torch.nonzero(flat).reshape(-1)[:capacity].to(torch.int32)
    n_masked = int(flat.sum())
    valid = torch.arange(capacity, device=frame3.device) < idx.numel()
    idx_c = torch.nn.functional.pad(idx, (0, capacity - idx.numel()),
                                    value=w * h - 1)
    ro, rd, pix, weight = ssaa_subsample_rays(scene, idx_c, valid, w)
    if st.any_bouncing:
        accum3, stats = integrate(scene, ro, rd, pix, weight, w * h,
                                  ray_block=ray_block,
                                  queue_headroom=queue_headroom)
    else:
        slots3, stats = integrate(scene, ro, rd, pix, weight, w * h,
                                  ray_block=ray_block, out_slots=True)
        # Subsample i of masked pixel k sits at slot i*capacity + k; the
        # four sum in the JAX package's order. Fill lanes add exact zeros.
        s = slots3.reshape(3, 4, capacity)
        summed3 = ((s[:, 0] + s[:, 1]) + s[:, 2]) + s[:, 3]
        with deterministic_algorithms():
            accum3 = torch.zeros((3, w * h), device=frame3.device).index_add(
                1, idx_c.long(), summed3)
    frame3 = torch.where(mask[None], accum3.reshape(3, h, w), frame3)
    return frame3, n_masked, stats


def _check_slice(scene):
    st = scene.static
    settings = st.settings
    for flag, what, slice_ in (
        (settings.show_normals, "showNormals", "debug-pass"),
        (settings.show_ac, "showAC", "debug-pass"),
    ):
        if flag:
            raise NotImplementedError(
                f"{what} is not ported yet; it comes with the {slice_} "
                f"slice of the port")


def render_scene(scene, ray_block: int = DEFAULT_RAY_BLOCK,
                 ssaa_capacity: int | None = None, queue_headroom: int = 1,
                 out_u8: bool = False):
    """Render on the scene's device: returns (frame3 (3, H, W) f32, aux
    dict with the stats counters and the SSAA mask size "ssaa_masked"),
    differentiable with respect to the scene's float tensors.
    `ssaa_capacity` overrides the fraction-derived SSAA queue size;
    `queue_headroom` multiplies the transparent continuation queue's
    capacity. `out_u8` quantizes the frame on the device to the BMP
    writer's u8 codes, (H, W, 3)."""
    _check_slice(scene)
    settings = scene.static.settings
    scene = derive_mesh_tables(scene)
    frame3, stats = _primary_pass(scene, ray_block=ray_block,
                                  queue_headroom=queue_headroom)
    n_masked = 0
    if settings.enable_ssaa:
        frame3, n_masked, s2 = _ssaa_pass(
            scene, frame3, ray_block=ray_block,
            capacity=ssaa_capacity or default_ssaa_capacity(settings),
            queue_headroom=queue_headroom)
        add_stats(stats, s2)
    aux = {"stats": stats, "ssaa_masked": n_masked}
    return (quantize_u8(frame3) if out_u8 else frame3), aux


# Upper bound of the transparent-queue headroom escalation: headroom h
# costs h x the queue's lanes per bounce (dead lanes are culled in the
# kernel but still shade), so a frame whose transparent tree outgrows 8
# slots per pixel keeps the drop warning instead of escalating further.
MAX_QUEUE_HEADROOM = 8


def escalating_render(render_fn, st):
    """The redo policy of JAX `escalating_render`: render_fn(ssaa_cap,
    headroom) -> (frame3, aux) runs again with the SSAA capacity raised
    to the mask size (next power of two, at most the pixel count) when
    more pixels were masked than the queue held, and with the queue
    headroom doubled (up to MAX_QUEUE_HEADROOM) while the transparent
    queue drops paths, so the output does not depend on the static queue
    sizes. Prints the drop warning of the last attempt."""
    ssaa_cap = None
    headroom = 1
    while True:
        frame3, aux = render_fn(ssaa_cap, headroom)
        redo = False
        n_masked = int(aux["ssaa_masked"])
        if (st.enable_ssaa and not st.show_ac
                and n_masked > (ssaa_cap or default_ssaa_capacity(st))):
            ssaa_cap = min(st.width * st.height,
                           1 << (max(n_masked, 2) - 1).bit_length())
            redo = True
        if (float(aux["stats"].get("paths_dropped", 0)) > 0
                and headroom < MAX_QUEUE_HEADROOM):
            headroom *= 2
            redo = True
        if not redo:
            break
    warn_dropped_paths(aux["stats"])
    return frame3, aux


def warn_dropped_paths(stats) -> None:
    """Print the transparent-queue drop warning when a render's stats
    report compacted-away continuation paths (drops must stay 0 for
    parity with the reference's unbounded recursion)."""
    dropped = float(stats.get("paths_dropped", 0))
    if dropped:
        print(f"warning: {dropped:.0f} transparent continuation paths were "
              f"dropped by queue compaction; output deviates from the "
              f"reference's unbounded recursion")


def render(scene, ray_block: int = DEFAULT_RAY_BLOCK, out_u8: bool = False):
    """Host-facing render: ((H, W, 3) numpy frame, aux). With out_u8 the
    frame is the BMP writer's u8 codes, else f32 in [0, 1+]. A frame
    whose SSAA mask outgrew the queue, or whose transparent queue dropped
    paths, is rendered again with a larger queue (`escalating_render`)."""
    with torch.no_grad():
        frame, aux = escalating_render(
            lambda cap, headroom: render_scene(
                scene, ray_block=ray_block, ssaa_capacity=cap,
                queue_headroom=headroom, out_u8=out_u8),
            scene.static.settings,
        )
    if not out_u8:
        frame = frame.permute(1, 2, 0)
    return frame.cpu().numpy(), aux
