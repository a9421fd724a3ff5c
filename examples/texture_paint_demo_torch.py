"""Texture painting by gradient descent on the PyTorch port: the
flagship-scale inverse-rendering showcase (the port of
examples/texture_paint_demo.py).

Starting from a flat grey texture, Adam on pixel MSE against one rendered
target repaints every camera-visible texel of the flagship's diffuse map,
the gradient flowing through the differentiable hit re-evaluation and
the packed-map gather (render.pipeline.derive_mesh_tables). The scene is
the flagship with the committed maps (tests/assets/maps), SSAA off, on
real geometry where REFERENCE_DIR holds the reference assets: shotgun.obj
subdivided and displaced to --tris triangles (flagship.densify_mesh, as
the JAX demo does); elsewhere the procedural mesh of --tris triangles.
It prints which geometry it ran on. Runs on the CUDA device unless
`--device cpu` is given.

Writes to --out:
  target.bmp / start.bmp / recovered.bmp   (renders)
  map_true.bmp / map_start.bmp / map_recovered.bmp  (the texture)
  convergence.json   (per-step loss + covered-texel MAE)

Usage: python examples/texture_paint_demo_torch.py [--steps 200]
       [--width 960] [--height 540] [--tris 250000] [--out showcase]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from rendering_tpu_torch.device import resolve_device  # noqa: E402
from rendering_tpu_torch.diff.inverse import (  # noqa: E402
    apply_params,
    make_train_step,
)
from rendering_tpu_torch.flagship import (  # noqa: E402
    build_flagship_scene,
    reference_obj,
)
from rendering_tpu_torch.render.pipeline import render_scene  # noqa: E402
from rendering_tpu_torch.utils.bmp import save_bmp  # noqa: E402

PATHS = (("meshes", 0, "diffuse_map"),)
KEY = "meshes/0/diffuse_map"


def flat_grey(scene) -> dict:
    """The start: the diffuse map as flat 50% grey, a full repaint."""
    return {KEY: torch.full_like(scene.meshes[0].diffuse_map,
                                 0.5).requires_grad_(True)}


def make_paint_step(lr: float):
    """(init_fn, step_fn) of `diff.inverse.make_train_step` on the diffuse
    map with Adam at lr, the map clamped to [0, 1] in place after every
    step (textures live in [0, 1]: the decode_normal/specular contracts).
    After a step each parameter's .grad holds that step's gradient."""
    init_fn, step_fn = make_train_step(
        PATHS, optimizer=lambda ps: torch.optim.Adam(ps, lr=lr, eps=1e-8))

    def paint_step(params, opt_state, scene, target):
        params, opt_state, loss = step_fn(params, opt_state, scene, target)
        with torch.no_grad():
            for v in params.values():
                v.clamp_(0.0, 1.0)
        return params, opt_state, loss

    return init_fn, paint_step


def covered_texels(grad):
    """Texels the camera sees: those with a nonzero gradient at the
    start. The rest (back faces, unused UV area) keep their start value
    and are left out of the recovery error."""
    return (grad.abs() > 0).any(dim=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--height", type=int, default=540)
    ap.add_argument("--tris", type=int, default=250_000)
    ap.add_argument("--out", default="showcase")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ns = ap.parse_args(argv)

    device = resolve_device(ns.device)
    geometry = ("shotgun.obj densified" if reference_obj("shotgun.obj")
                else "procedural")
    scene = build_flagship_scene(ns.width, ns.height, n_tris=ns.tris,
                                 enable_ssaa=False, real_geometry=True,
                                 device=device)
    ms = scene.static.meshes[0]
    if not ms.has_diffuse_map:
        raise RuntimeError("the flagship has no diffuse map: the committed "
                           "maps under tests/assets/maps are missing")
    w_t, h_t = ms.dmap_wh
    print(f"scene: {ms.n_tris} tris ({geometry} geometry), {w_t}x{h_t} "
          f"diffuse map, {ns.width}x{ns.height} render on {device}",
          flush=True)

    true_map = scene.meshes[0].diffuse_map.detach().cpu().numpy()
    with torch.no_grad():
        target3 = render_scene(scene)[0]
        params = flat_grey(scene)
        start3 = render_scene(apply_params(scene, params, PATHS))[0]
    init_fn, paint_step = make_paint_step(ns.lr)
    opt_state = init_fn(params)

    covered = None
    curve = []
    for i in range(ns.steps):
        params, opt_state, loss = paint_step(params, opt_state, scene,
                                             target3)
        if covered is None:  # the first step's gradient is at the start
            covered = covered_texels(params[KEY].grad).cpu().numpy()
            print(f"covered texels: {covered.sum()}/{covered.size}",
                  flush=True)
        if i % 10 == 0 or i == ns.steps - 1:
            rec = params[KEY].detach().cpu().numpy()
            mae = float(np.abs(rec - true_map)[covered].mean())
            curve.append({"step": i, "loss": float(loss),
                          "covered_texel_mae": round(mae, 5)})
            print(f"step {i:4d}  loss {float(loss):.3e}  "
                  f"covered-texel MAE {mae:.4f}", flush=True)

    with torch.no_grad():
        rec3 = render_scene(apply_params(scene, params, PATHS))[0]

    def frame_img(f3):
        return f3.permute(1, 2, 0).cpu().numpy()

    def map_img(flat):
        return np.asarray(flat).reshape(h_t, w_t, 3)

    os.makedirs(ns.out, exist_ok=True)
    save_bmp(os.path.join(ns.out, "target.bmp"), frame_img(target3))
    save_bmp(os.path.join(ns.out, "start.bmp"), frame_img(start3))
    save_bmp(os.path.join(ns.out, "recovered.bmp"), frame_img(rec3))
    save_bmp(os.path.join(ns.out, "map_true.bmp"), map_img(true_map))
    save_bmp(os.path.join(ns.out, "map_start.bmp"),
             np.full((h_t, w_t, 3), 0.5, np.float32))
    save_bmp(os.path.join(ns.out, "map_recovered.bmp"),
             map_img(params[KEY].detach().cpu().numpy()))
    result = {
        "tris": int(ms.n_tris),
        "geometry": geometry,
        "render": f"{ns.width}x{ns.height}",
        "map": f"{w_t}x{h_t}",
        "covered_texels": int(covered.sum()),
        "steps": ns.steps,
        "start_covered_mae": round(float(
            np.abs(0.5 - true_map)[covered].mean()), 5),
        "final_covered_mae": curve[-1]["covered_texel_mae"],
        "curve": curve,
        "platform": str(device),
    }
    with open(os.path.join(ns.out, "convergence.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({k: v for k, v in result.items() if k != "curve"}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
