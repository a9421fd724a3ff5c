"""The reference's train steps: the pixel loss mean((frame - target)^2)
of the reference renderer, its gradients, and Adam (torch.optim.Adam's
update with betas 0.9, 0.999 and eps 1e-8, written out), from the same
start as the program's steps."""

from __future__ import annotations

import torch

from .render import Scene, render

BETAS = (0.9, 0.999)
EPS = 1e-8


def replay(scene: Scene, target, start: dict, lrs: dict, steps: int) -> dict:
    """`steps` Adam steps from `start` against `target`: {"losses",
    "grad_norms" (the first step's, per leaf), "delta_norms" (the change
    after the last step, per leaf)}."""
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in start.items()}
    m = {k: torch.zeros_like(v) for k, v in leaves.items()}
    s = {k: torch.zeros_like(v) for k, v in leaves.items()}
    losses, grad_norms = [], {}
    for step in range(1, steps + 1):
        for v in leaves.values():
            v.grad = None
        _, loss = render(scene.with_params(leaves), target=target)
        losses.append(loss)
        with torch.no_grad():
            for k, p in leaves.items():
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                if step == 1:
                    grad_norms[k] = float(torch.linalg.vector_norm(g.float()))
                m[k].mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                s[k].mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                bc1 = 1 - BETAS[0] ** step
                bc2 = 1 - BETAS[1] ** step
                denom = (s[k].sqrt() / bc2 ** 0.5).add_(EPS)
                p.addcdiv_(m[k], denom, value=-lrs[k] / bc1)
    delta = {k: float(torch.linalg.vector_norm((leaves[k].detach()
                                                - start[k]).float()))
             for k in leaves}
    return {"losses": losses, "grad_norms": grad_norms, "delta_norms": delta}
