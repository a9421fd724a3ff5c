"""Sobel edge mask for adaptive SSAA (Scene::launchSSAA,
src/scene.cpp:547-569) — `rendering_tpu.ops.sobel` in eager PyTorch.

The reference convolves the RGB framebuffer with the 3x3 Sobel operator
in both orientations, takes val = sqrt(|gx|^2 + |gy|^2) where |.| is the
RGB vector length, and marks pixels with val > 0.5. Border pixels are
never written by the reference (its loop runs over the interior only);
they are False here, as in the JAX package.

Eager elementwise ops in the JAX package's order, on purpose: no
conv2d (cuDNN may run it in TF32) and no torch.compile (which may
contract the products into FMAs), since a pixel at the 0.5 threshold
flips on an ulp.
"""

from __future__ import annotations

import torch

_S = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))


def sobel_mask(frame3: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    """frame3: (3, H, W) -> bool (H, W); borders False."""
    h, w = frame3.shape[1:]
    if h < 3 or w < 3:
        # No interior pixels: the reference's interior-only loop does no
        # work (scene.cpp:556).
        return torch.zeros((h, w), dtype=torch.bool, device=frame3.device)
    gx = torch.zeros((3, h - 2, w - 2), dtype=frame3.dtype,
                     device=frame3.device)
    gy = torch.zeros_like(gx)
    # x += fb[i-1+a, j-1+b] * S[a][b]; y += fb[...] * S[b][a]
    # (scene.cpp:558-562), in that order.
    for a in range(3):
        for b in range(3):
            patch = frame3[:, a:h - 2 + a, b:w - 2 + b]
            gx = gx + patch * _S[a][b]
            gy = gy + patch * _S[b][a]

    # val = sqrtf(powf(x.length(), 2) + powf(y.length(), 2))
    # (scene.cpp:564): each length() a rounded sqrtf of the left-to-right
    # sum x*x + y*y + z*z (geometry.h:94-102), then squared again.
    def _len(g):
        return torch.sqrt((g[0] * g[0] + g[1] * g[1]) + g[2] * g[2])

    lx, ly = _len(gx), _len(gy)
    val = torch.sqrt(lx * lx + ly * ly)
    return torch.nn.functional.pad(val > threshold, (1, 1, 1, 1), value=False)
