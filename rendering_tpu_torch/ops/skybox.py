"""Six-face skybox lookup (Scene::getSkybox, src/scene.cpp:381-442) on
rows. Same face ladder, projection and texel math as
`rendering_tpu.ops.skybox` (a byte-parity surface).

Face index (scene-file key order left,front,right,back,top,bottom):
0=left(x<0), 1=front(z<0), 2=right(x>0), 3=back(z>0), 4=top(y>0),
5=bottom(y<0). The (6, H, W, 3) array rows are in loadBMP order.
"""

from __future__ import annotations

import torch

from rendering_tpu_torch.ops.texture import _to_i32, gather_index


def _to_pixel(v, maximum: int):
    return torch.clamp_max(_to_i32((v + 1.0) / 2.0 * maximum), maximum - 1)


def _face_ij(x, y, z, h: int, w: int):
    ax, ay, az = torch.abs(x), torch.abs(y), torch.abs(z)
    m = torch.maximum(ax, torch.maximum(ay, az))
    safe = torch.where(m > 0, m, 1.0)
    # Reciprocal then multiply, exactly like `dir * (1 / -dir.z)`
    # (scene.cpp:398-439): a plain division rounds once instead of twice
    # and can land on another texel next to an integer boundary.
    recip = 1.0 / safe
    px, py, pz = x * recip, y * recip, z * recip
    # Ladder order: z first, then x, else y.
    is_z = m == az
    is_x = (~is_z) & (m == ax)
    neg = torch.where(is_z, z < 0, torch.where(is_x, x < 0, y < 0))
    face = torch.where(
        is_z,
        torch.where(neg, 1, 3),
        torch.where(is_x, torch.where(neg, 0, 2), torch.where(neg, 5, 4)),
    )
    i_val = torch.where(is_z | is_x, py, pz)
    j_val = torch.where(
        is_z,
        torch.where(neg, px, -px),
        torch.where(is_x, torch.where(neg, -pz, pz), px),
    )
    return face, _to_pixel(i_val, h), _to_pixel(j_val, w)


def sample_skybox_r(skybox, dir3, bg_color):
    """skybox (6, H, W, 3) or None; dir3 (3, R); bg_color (3,).
    Returns (3, R); the background color when there is no skybox
    (scene.cpp:383-385)."""
    if skybox is None:
        return bg_color[:, None].expand(3, dir3.shape[1])
    h = int(skybox.shape[1])
    w = int(skybox.shape[2])
    face, i, j = _face_ij(dir3[0], dir3[1], dir3[2], h, w)
    return skybox.movedim(3, 0)[:, face, gather_index(i, h),
                                gather_index(j, w)]
