"""Shading math on (3, B) rows — `rendering_tpu.ops.shading`: reflect,
refract and fresnel with the reference's float semantics
(Render::{reflect,refract,fresnel}, src/scene.cpp:672-722), and the
specular power."""

from __future__ import annotations

import torch

from rendering_tpu_torch.ops.geometry import clamp, dot_r


def reflect_r(d3, n3):
    """dir - 2*dot(dir, n)*n (scene.cpp:672-675)."""
    return d3 - 2.0 * dot_r(d3, n3)[None] * n3


def refract_r(d3, n3, ior):
    """Snell refraction on rows, total internal reflection -> the zero
    vector (scene.cpp:677-696). d3/n3: (3, B); ior: (B,). Returns (3, B).
    TIR is k < 0 (k == 0 refracts, scene.cpp:693). At the critical angle
    k == 0 the lane is live and sqrt'(0) = inf would make a NaN gradient
    through the where: sqrt reads a guarded operand there (the primal
    stays sqrt(0) = 0)."""
    cosi = clamp(-1.0, 1.0, dot_r(d3, n3))
    outside = cosi < 0
    n1 = torch.where(outside, 1.0, ior)
    n2 = torch.where(outside, ior, 1.0)
    cosi_abs = torch.abs(cosi)
    mod_normal = torch.where(outside[None], n3, -n3)
    rri = n1 / n2
    k = 1.0 - rri * rri * (1.0 - cosi_abs * cosi_abs)
    tir = k < 0
    crit = k <= 0
    sqrt_k = torch.where(crit, 0.0, torch.sqrt(torch.where(crit, 1.0, k)))
    out = rri[None] * d3 + (rri * cosi_abs - sqrt_k)[None] * mod_normal
    return torch.where(tir[None], 0.0, out)


def fresnel_r(d3, n3, ior):
    """The exact Fresnel rs/rp mean kr on rows (scene.cpp:698-722); TIR
    -> 1. d3/n3: (3, B); ior: (B,). Returns (B,). At a head-on hit
    (cosi = +-1) sin^2 is exactly 0: sqrt reads a guarded operand there,
    so the gradient stays finite."""
    cosi = clamp(-1.0, 1.0, dot_r(d3, n3))
    outside_medium = cosi > 0  # fresnel swaps n1/n2 on cosi > 0
    n1 = torch.where(outside_medium, ior, 1.0)
    n2 = torch.where(outside_medium, 1.0, ior)
    zero = cosi.new_zeros(())
    sin2 = torch.maximum(zero, 1.0 - cosi * cosi)
    head_on = sin2 <= 0.0
    sint = n1 / n2 * torch.where(
        head_on, 0.0, torch.sqrt(torch.where(head_on, 1.0, sin2)))
    tir = sint >= 1.0
    cost = torch.sqrt(torch.where(tir, 1.0,
                                  torch.maximum(zero, 1.0 - sint * sint)))
    cosi_a = torch.abs(cosi)
    rs = ((n2 * cosi_a) - (n1 * cost)) / ((n2 * cosi_a) + (n1 * cost))
    rp = ((n1 * cosi_a) - (n2 * cost)) / ((n1 * cosi_a) + (n2 * cost))
    kr = (rs * rs + rp * rp) / 2.0
    return torch.where(tir, 1.0, kr)


def spec_pow(base, exponent):
    """pow(max(0, base), exponent) written as exp(e * log(base)) so the
    exponent's gradient is finite at base == 0; base <= 0 maps to 0
    (the reference always feeds max(0, x) with exponent > 0)."""
    pos = base > 0
    safe = torch.where(pos, base, 1.0)
    return torch.where(pos, torch.exp(exponent * torch.log(safe)), 0.0)
