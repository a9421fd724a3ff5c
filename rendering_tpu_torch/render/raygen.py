"""Primary-ray generation (`Camera::getRay` + the per-pixel loops in
`renderWorker`, src/scene.cpp:16-54, 444-468), as in
`rendering_tpu.render.raygen`.

Parity quirks kept:
* The reference double-adds 0.5, so the primary sample sits at grid
  position (x+1.0, y+1.0). Callers pass the total offset.
* NDC: xPix = (2*sx/W - 1) * scale * aspect, yPix = -(2*sy/H - 1) *
  scale, aspect = W/H (scene.cpp:447-457).
* Direction = normalize((xPix, yPix, -1)) @ R: the rotation comes after
  normalization (scene.cpp:52), written as multiply-adds, not a matmul
  (a matmul may run in TF32 on the GPU).
"""

from __future__ import annotations

import numpy as np
import torch

from rendering_tpu_torch.ops.geometry import normalize


def pixel_dirs(scene, xs, ys, offset_x: float, offset_y: float):
    """xs/ys: (R,) float pixel coordinates. Returns rd (R, 3)."""
    st = scene.static.settings
    w = np.float32(st.width)
    h = np.float32(st.height)
    aspect = float(w / h)  # the f32 quotient, as the JAX package takes it
    w, h = float(w), float(h)
    x_pix = (2.0 * (xs + offset_x) / w - 1.0) * scene.scale * aspect
    y_pix = -(2.0 * (ys + offset_y) / h - 1.0) * scene.scale
    d = torch.stack([x_pix, y_pix, -torch.ones_like(x_pix)], dim=-1)
    d = normalize(d)
    r = scene.cam_rmat
    return d[:, 0:1] * r[0] + d[:, 1:2] * r[1] + d[:, 2:3] * r[2]


def tile_dims(w: int, h: int, tw: int = 32, th: int = 16):
    """Largest tile dims <= (tw, th) that divide the frame exactly, so
    the screen-tile permutation inverts with a reshape + transpose."""
    while tw > 1 and w % tw:
        tw //= 2
    while th > 1 and h % th:
        th //= 2
    return tw, th


def primary_rays(scene, offset: float = 1.0):
    """Full-frame ray grid in screen-tile order (each ray block the
    intersection kernel sees is then a compact screen rect).
    Returns (ro (R, 3), rd (R, 3), pix (R,) int32 = y*W + x)."""
    st = scene.static.settings
    w, h = st.width, st.height
    tw, th = tile_dims(w, h)
    s = torch.arange(w * h, dtype=torch.int32, device=scene.device)
    tile_id, within = s // (tw * th), s % (tw * th)
    ty, tx = within // tw, within % tw
    tiles_x = w // tw
    x = (tile_id % tiles_x) * tw + tx
    y = (tile_id // tiles_x) * th + ty
    pix = y * w + x
    rd = pixel_dirs(scene, x.to(torch.float32), y.to(torch.float32),
                    offset, offset)
    ro = scene.cam_pos.expand(rd.shape)
    return ro, rd, pix
