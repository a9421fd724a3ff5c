"""Map sampling (Mesh::{getDiffuseColor,getSpecularValue,getSurfaceData}
map paths, src/objects.cpp:121-175) on row tensors.

Maps are flat (H*W, C) arrays in the reference's loadBMP layout
(bottom-up rows), so the index `(int)(H*ty) * W + (int)(W*tx)` with
high-side clamping only is reproduced verbatim. Out-of-range texture
coordinates follow the JAX package bit for bit: the float -> int32
convert saturates (NaN -> 0), int32 arithmetic wraps, and the gather
first adds the table length to a negative index and then clamps it into
range. A plain torch index would wrap a negative index once and fault
on any other.
"""

from __future__ import annotations

import torch

_I32_MIN = -(2**31)
_I32_MAX = 2**31 - 1


def _to_i32(x):
    """f32 -> int32 value (held in int64) with XLA's saturating convert:
    truncation toward zero, out-of-range to the int32 limits, NaN to 0."""
    big = x >= 2147483648.0
    small = x <= -2147483648.0
    safe = torch.where(big | small | torch.isnan(x), 0.0, x)
    out = safe.to(torch.int64)
    out = torch.where(big, _I32_MAX, out)
    return torch.where(small, _I32_MIN, out)


def _wrap_i32(x):
    """int64 -> the int32 value two's-complement arithmetic would give."""
    return torch.remainder(x - _I32_MIN, 2**32) + _I32_MIN


def gather_index(idx, n: int):
    """A JAX gather's view of an index into a length-n axis: negative
    indices count from the end, then everything clamps into range."""
    return torch.clamp(torch.where(idx < 0, idx + n, idx), 0, n - 1)


def _map_index(tx, ty, w: int, h: int):
    wi = torch.clamp_max(_to_i32(w * tx), w - 1)  # high side only
    hi = torch.clamp_max(_to_i32(h * ty), h - 1)  # (objects.cpp:146-148)
    return gather_index(_wrap_i32(hi * w + wi), w * h)


def sample_map_r(flat_map, wh, tex2):
    """flat_map (H*W, C) or (H*W,); wh (W, H); tex2 (2, R) -> (C, R)
    (or (1, R) for a single-channel map)."""
    w, h = int(wh[0]), int(wh[1])
    idx = _map_index(tex2[0], tex2[1], w, h)
    if flat_map.ndim == 1:
        return flat_map[idx][None]
    return flat_map.T[:, idx]


def sample_packed_r(mapsT, wh, tex2):
    """Gather every row of a packed transposed map table at once:
    mapsT (rows, H*W); tex2 (2, R) -> (rows, R)."""
    w, h = int(wh[0]), int(wh[1])
    idx = _map_index(tex2[0], tex2[1], w, h)
    return mapsT[:, idx]


def _bilinear_corners(tx, ty, w: int, h: int):
    """4 corner texel indices (4, R) and blend weights (4, R). Texel
    centers sit at (i + 0.5)/w; edges clamp."""
    fx = w * tx - 0.5
    fy = h * ty - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    ax = fx - x0
    ay = fy - y0
    x0r = _to_i32(x0)
    y0r = _to_i32(y0)
    x0i = torch.clamp(x0r, 0, w - 1)
    x1i = torch.clamp(_wrap_i32(x0r + 1), 0, w - 1)
    y0i = torch.clamp(y0r, 0, h - 1)
    y1i = torch.clamp(_wrap_i32(y0r + 1), 0, h - 1)
    idx4 = torch.stack(
        [y0i * w + x0i, y0i * w + x1i, y1i * w + x0i, y1i * w + x1i]
    )
    wts4 = torch.stack(
        [(1 - ax) * (1 - ay), ax * (1 - ay), (1 - ax) * ay, ax * ay]
    )
    return idx4, wts4


def _blend4(vals, wts4):
    """Sum of the 4 weighted corners, (C, 4, R) -> (C, R), in the order
    ((c0 + c1) + c2) + c3."""
    p = vals * wts4[None]
    return ((p[:, 0] + p[:, 1]) + p[:, 2]) + p[:, 3]


def sample_map_bilinear_r(flat_map, wh, tex2):
    """Bilinear sample_map_r: tex2 (2, R) -> (C, R) (or (1, R))."""
    w, h = int(wh[0]), int(wh[1])
    idx4, wts4 = _bilinear_corners(tex2[0], tex2[1], w, h)
    fm = flat_map[None] if flat_map.ndim == 1 else flat_map.T
    return _blend4(fm[:, idx4], wts4)


def sample_packed_bilinear_r(mapsT, wh, tex2):
    """Bilinear sample_packed_r: tex2 (2, R) -> (rows, R)."""
    w, h = int(wh[0]), int(wh[1])
    idx4, wts4 = _bilinear_corners(tex2[0], tex2[1], w, h)
    return _blend4(mapsT[:, idx4], wts4)
