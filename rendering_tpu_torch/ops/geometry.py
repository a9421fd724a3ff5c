"""Small vector helpers over (3, R) row tensors and (..., 3) tensors.

Same formulas, in the same f32 operation order, as
`rendering_tpu.ops.geometry`: left-to-right sums, no fused
multiply-add, multiply by 1/sqrt rather than divide.
"""

from __future__ import annotations

import torch

FLT_MAX = 3.4028234663852886e38  # rounds to the f32 FLT_MAX exactly


def dot_r(a, b):
    """a, b: (3, ...) -> (...,)."""
    return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2]


def cross_r(a, b):
    """a, b: (3, ...) -> (3, ...). Component order of a cross product."""
    return torch.stack(
        [
            a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0],
        ]
    )


def normalize_r(a):
    """Vec3::normalize on rows; zero vectors unchanged (geometry.h)."""
    len2 = dot_r(a, a)[None]
    pos = len2 > 0
    safe = torch.where(pos, len2, 1.0)
    return torch.where(pos, a * (1.0 / torch.sqrt(safe)), a)


def normalize(a):
    """normalize_r on (..., 3) vectors."""
    len2 = ((a[..., 0] * a[..., 0] + a[..., 1] * a[..., 1])
            + a[..., 2] * a[..., 2])[..., None]
    pos = len2 > 0
    safe = torch.where(pos, len2, 1.0)
    return torch.where(pos, a * (1.0 / torch.sqrt(safe)), a)
