"""Inverse-rendering demo on the PyTorch port: recover perturbed scene
parameters by gradient descent on pixel MSE (the port of
examples/inverse_demo.py).

Renders a target frame from a scene file, perturbs the first light's
intensity and the objects' colours, then optimizes them back with Adam.
Runs on the CUDA device unless `--device cpu` is given.

Usage (from a directory whose input/ holds the scene's assets):
    python examples/inverse_demo_torch.py [scene.scene] [--steps 150]
    python examples/inverse_demo_torch.py [scene.scene] --camera

--camera recovers the CAMERA POSE instead: the target is rendered at the
scene file's pose, the camera is then translated and rotated away, and
gradient descent on pixel MSE, flowing through the differentiable hit
re-evaluation and ops.geometry.euler_matrix_j, brings it back.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from rendering_tpu_torch.device import resolve_device  # noqa: E402
from rendering_tpu_torch.diff.inverse import (  # noqa: E402
    apply_params,
    extract_params,
    make_train_step,
)
from rendering_tpu_torch.models.parser import parse_scene  # noqa: E402
from rendering_tpu_torch.models.scene import build_scene  # noqa: E402
from rendering_tpu_torch.models.settings import RenderSettings  # noqa: E402
from rendering_tpu_torch.ops.geometry import euler_matrix_j  # noqa: E402
from rendering_tpu_torch.render.pipeline import render_scene  # noqa: E402

# The camera demo's start: the true pose moved by these (JAX demo's).
POS_OFFSET = (0.04, -0.03, 0.05)
ANGLE_OFFSET_DEG = (1.0, -0.7, 0.5)
# Its optimizer: the clip's global norm, the cosine schedule's floor.
MAX_NORM = 1.0
ALPHA = 0.02


def set_pose(scene, params):
    """The scene seen from params {"pos": (3,), "angles_deg": (3,)}: the
    rotation rebuilt in the graph by euler_matrix_j."""
    return dataclasses.replace(scene, cam_pos=params["pos"],
                               cam_rmat=euler_matrix_j(params["angles_deg"]))


class ClippedCosineAdam(torch.optim.Adam):
    """The camera demo's optimizer: the global gradient norm clipped to
    MAX_NORM, then Adam on a cosine schedule from lr down to ALPHA x lr
    over `steps` (optax.chain(clip_by_global_norm(1.0), adam(
    cosine_decay_schedule(lr, steps, 0.02))), examples/inverse_demo.py). Large early steps cross
    the pose basin, small late ones settle the residual (a fixed lr parks
    Adam's unit-scale steps in a limit cycle around the optimum), and the
    clip keeps a step from walking the camera across a visibility
    discontinuity."""

    def __init__(self, params, lr: float, steps: int):
        super().__init__(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
        self.base_lr, self.steps = lr, steps
        self.count = 0

    @torch.no_grad()
    def step(self, closure=None):
        torch.nn.utils.clip_grad_norm_(
            [p for g in self.param_groups for p in g["params"]], MAX_NORM)
        frac = min(self.count, self.steps) / self.steps
        decay = 0.5 * (1.0 + np.cos(np.pi * frac))
        for g in self.param_groups:
            g["lr"] = self.base_lr * ((1 - ALPHA) * decay + ALPHA)
        self.count += 1
        return super().step(closure)


def start_pose(scene, true_angles) -> dict:
    """The perturbed start {"pos", "angles_deg"}: the scene's camera
    position and the true Euler angles moved by POS_OFFSET and
    ANGLE_OFFSET_DEG, leaf tensors that require grad."""
    dev = scene.device
    return {
        "pos": (scene.cam_pos.detach()
                + torch.tensor(POS_OFFSET, device=dev)).requires_grad_(True),
        "angles_deg": torch.tensor(
            np.asarray(true_angles, np.float32)
            + np.float32(ANGLE_OFFSET_DEG), device=dev).requires_grad_(True),
    }


def make_pose_step(params: dict, lr: float, steps: int):
    """(init_fn, step_fn) of `diff.inverse.make_train_step` for the pose
    in `params`: no scene path, the step renders through set_pose, which
    reads the parameter tensors that the optimizer (ClippedCosineAdam)
    steps in place."""
    return make_train_step(
        (), optimizer=lambda ps: ClippedCosineAdam(ps, lr, steps),
        render_fn=lambda s: render_scene(set_pose(s, params))[0])


def recover_camera_pose(scene, true_angles, steps: int, lr: float):
    """Camera pose recovery by gradient descent on pixel MSE, printing the
    loss and the pose errors."""
    with torch.no_grad():
        target = render_scene(scene)[0]
    true_pos = scene.cam_pos.detach().cpu().numpy()
    true_angles = np.asarray(true_angles, np.float32)
    params = start_pose(scene, true_angles)
    init_fn, step_fn = make_pose_step(params, lr, steps)
    opt_state = init_fn(params)

    def errors():
        pe = float(np.abs(params["pos"].detach().cpu().numpy()
                          - true_pos).max())
        ae = float(np.abs(params["angles_deg"].detach().cpu().numpy()
                          - true_angles).max())
        return pe, ae

    for i in range(steps):
        params, opt_state, loss = step_fn(params, opt_state, scene, target)
        if i % 20 == 0 or i == steps - 1:
            pe, ae = errors()
            print(f"step {i:4d}  loss {float(loss):.3e}  pos_err {pe:.4f}  "
                  f"angle_err {ae:.3f} deg", flush=True)
    pe, ae = errors()
    print(f"\nrecovered pose: max |pos err| {pe:.5f}, max |angle err| "
          f"{ae:.4f} deg (started at 0.05 / 1.0)")


def recover_light_and_colour(scene, steps: int, lr: float):
    """The first light's intensity and obj_color recovered with Adam at lr
    from 0.4 x true + 0.1, printing the loss and the errors."""
    paths = (("lights", 0, "intensity"), ("obj_color",))
    true_params = extract_params(scene, paths)
    with torch.no_grad():
        target = render_scene(scene)[0]
    start_scene = apply_params(
        scene, {k: v.detach() * 0.4 + 0.1 for k, v in true_params.items()},
        paths)
    init_fn, step_fn = make_train_step(
        paths, optimizer=lambda ps: torch.optim.Adam(ps, lr=lr, eps=1e-8))
    params = extract_params(start_scene, paths)
    opt_state = init_fn(params)
    for i in range(steps):
        params, opt_state, loss = step_fn(params, opt_state, start_scene,
                                          target)
        if i % 10 == 0 or i == steps - 1:
            print(f"step {i:4d}  loss {float(loss):.3e}", flush=True)
    print("\nrecovered vs true (light intensity x albedo is only "
          "identifiable as a\nproduct from a single image, and channels the "
          "camera never sees keep their init):")
    for k in params:
        err = float((params[k] - true_params[k]).detach().abs().max())
        print(f"  {k}: max abs err {err:.4f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("scene", nargs="?", default="input/simple_shapes.scene")
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--lr", type=float, default=5e-2)
    ap.add_argument("--camera", action="store_true",
                    help="recover a perturbed camera pose instead of "
                         "light/colour parameters")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ns = ap.parse_args(argv)

    device = resolve_device(ns.device)
    # SSAA off: the Sobel mask is a discrete function of the frame, so
    # keeping it out of the loop gives cleaner gradients.
    sd = parse_scene(ns.scene, RenderSettings(enable_ssaa=False))
    scene = build_scene(sd, device=device)
    if ns.camera:
        recover_camera_pose(scene, sd.cam_rot, ns.steps, ns.lr)
    else:
        recover_light_and_colour(scene, ns.steps, ns.lr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
