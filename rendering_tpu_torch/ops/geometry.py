"""Small vector helpers over (3, R) row tensors and (..., 3) tensors,
and the Morton key that orders the bounce queue.

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


def clamp(low: float, high: float, val):
    """max(low, min(high, val)), NaN-propagating, and splitting the
    gradient at a tie as jnp.maximum/minimum do."""
    return torch.maximum(val.new_full((), low),
                         torch.minimum(val.new_full((), high), val))


MORTON_INACTIVE = 0xFFFFFFFF  # the key of a lane that sorts last


@torch.no_grad()
def morton_key_r(p3):
    """Per-point 30-bit Morton (Z-curve) key. p3: (3, N) -> (N,) int64
    holding the bits of `rendering_tpu.ops.geometry.morton_key_r`'s
    uint32 key: points quantized to a 1024^3 grid over the batch's own
    bounds, each coordinate's 10 bits spread and interleaved. The bounce
    loop sorts its continuation queue by it, so the intersection kernel's
    512-ray tiles stay spatially coherent after reflection and refraction
    scatter the rays. A discrete reordering: no gradient."""
    lo = p3.amin(dim=1, keepdim=True)
    span = p3.amax(dim=1, keepdim=True) - lo
    span = torch.where(span > 0, span, 1.0)
    q = torch.clamp((p3 - lo) / span * 1023.0, 0.0, 1023.0).to(torch.int64)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    return spread(q[0]) | (spread(q[1]) << 1) | (spread(q[2]) << 2)


def euler_matrix_j(rot_deg):
    """Differentiable twin of `models.objloader.euler_matrix` (JAX
    `ops.geometry.euler_matrix_j`): the 3x3 rotation from Euler degrees
    (3,) in the reference's row-vector convention (apply as v @ R; mz*my*mx
    composition, scene.cpp:22-49), built in the autograd graph so that a
    gradient reaches the angles (camera pose recovery). The numpy original
    stays the parity path at scene build.

    The angles scale by pi/180 in f32, as in JAX. The matrices are stacked
    from their entries (torch.tensor would cut the graph), and the two
    products are written out entry by entry as left-to-right sums plus an
    exact +0.0, as `objloader._mat3_mul` rounds them: no BLAS or TF32
    path, so the products round alike on the CPU and the card."""
    rot = torch.as_tensor(rot_deg, dtype=torch.float32)
    r = rot * torch.tensor(torch.pi / 180.0, dtype=torch.float32,
                           device=rot.device)
    c, s = torch.cos(r), torch.sin(r)
    one, zero = torch.ones_like(r[0]), torch.zeros_like(r[0])
    mx = ((one, zero, zero), (zero, c[0], -s[0]), (zero, s[0], c[0]))
    my = ((c[1], zero, s[1]), (zero, one, zero), (-s[1], zero, c[1]))
    mz = ((c[2], -s[2], zero), (s[2], c[2], zero), (zero, zero, one))

    def mul(a, b):
        return tuple(tuple(((a[i][0] * b[0][j] + a[i][1] * b[1][j])
                            + a[i][2] * b[2][j]) + 0.0 for j in range(3))
                     for i in range(3))

    m = mul(mul(mz, my), mx)
    return torch.stack([torch.stack(row) for row in m])
