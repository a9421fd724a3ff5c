"""Turntable animation demo on the PyTorch port: orbit the camera around
a scene and write one BMP per frame (the port of
examples/turntable_demo.py). The scene's tables stay on the device for
every frame; only the camera's two tensors change
(rendering_tpu_torch/render/animation.py). Runs on the CUDA device
unless `--device cpu` is given.

Usage:
    python examples/turntable_demo_torch.py [scene.scene] [--frames N]
        [--radius R] [--center x,y,z] [--elevation DEG] [--out DIR]

Defaults orbit the reference's simple_shapes.scene.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from rendering_tpu_torch.device import resolve_device  # noqa: E402
from rendering_tpu_torch.models.scene import load_scene  # noqa: E402
from rendering_tpu_torch.render.animation import (  # noqa: E402
    orbit_cameras,
    render_frames,
)
from rendering_tpu_torch.utils.bmp import save_bmp  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("scene", nargs="?", default="input/simple_shapes.scene")
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--radius", type=float, default=5.0)
    p.add_argument("--center", default="0,0,-4")
    p.add_argument("--elevation", type=float, default=15.0)
    p.add_argument("--out", default="turntable")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device)")
    ns = p.parse_args(argv)

    scene = load_scene(ns.scene, device=resolve_device(ns.device))
    center = tuple(float(v) for v in ns.center.split(","))
    cams = orbit_cameras(center, ns.radius, ns.frames,
                         elevation_deg=ns.elevation)
    os.makedirs(ns.out, exist_ok=True)
    t0 = time.perf_counter()
    for i, (frame, _aux) in enumerate(render_frames(scene, cams)):
        path = os.path.join(ns.out, f"frame_{i:04d}.bmp")
        save_bmp(path, frame)
        dt = time.perf_counter() - t0
        t0 = time.perf_counter()
        print(f"{path}  ({dt:.3f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
