"""Render pipeline — the forward primary pass of
`rendering_tpu.render.pipeline` for non-bouncing scenes.

Frames are channel-first f32 (3, H, W) tensors on the scene's device;
`render` returns the usual (H, W, 3) numpy array. Parity quirk kept:
the last pixel row and column are never rendered by the reference (its
tile clamp, scene.cpp:369-372) and stay black.

Adaptive SSAA, showNormals, showAC, the strip/progress renders and the
SSAA/queue escalation come with later slices; `render_scene` raises
NotImplementedError for them instead of rendering something else.
"""

from __future__ import annotations

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
    """Forward render on the scene's device: returns (frame3 (3, H, W)
    f32, aux dict with the stats counters). `out_u8` quantizes the frame
    on the device to the BMP writer's u8 codes, (H, W, 3)."""
    _check_slice(scene)
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
