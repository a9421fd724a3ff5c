"""Shading math on (3, B) rows — the reflect and specular-power parts of
`rendering_tpu.ops.shading` (refract/fresnel come with the bouncing
slice)."""

from __future__ import annotations

import torch

from rendering_tpu_torch.ops.geometry import dot_r


def reflect_r(d3, n3):
    """dir - 2*dot(dir, n)*n (scene.cpp:672-675)."""
    return d3 - 2.0 * dot_r(d3, n3)[None] * n3


def spec_pow(base, exponent):
    """pow(max(0, base), exponent) written as exp(e * log(base)) so the
    exponent's gradient is finite at base == 0; base <= 0 maps to 0
    (the reference always feeds max(0, x) with exponent > 0)."""
    pos = base > 0
    safe = torch.where(pos, base, 1.0)
    return torch.where(pos, torch.exp(exponent * torch.log(safe)), 0.0)
