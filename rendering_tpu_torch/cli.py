"""Command-line entry — `python -m rendering_tpu_torch [scene.scene]`, the
port of `rendering_tpu.cli`.

Mirrors the reference's `main` (src/main.cpp:5-16): the default scene is
`input/simple_shapes.scene` and the output `<image_name>.bmp`, unless
`--output` names another. The phase timers carry the reference's Timer
names: Total time, Scene loading, Render scene, and OBJ loading per mesh
(models/parser.py). With collectStatistics the intersection kernels'
test counters, the BVH counts and the rays cast are printed as the
reference's stats::printStats does.

The render runs on the CUDA device; `main(argv, device="cpu")` runs the
plain PyTorch versions of the kernels on the CPU instead. With
outputProgress=1, the scene-file default, the frame renders in strips
with progress prints (`render_with_progress`), as the JAX package's
single-device path does; otherwise, and under showAC, in one pass
(`render`). showNormals and showAC render their debug images.
--trace-dir DIR captures a `torch.profiler` trace of the render phase
into DIR (`utils.profiling.trace`; read it with `op_profile`).
--geo-shard (multi-device) raises NotImplementedError: not ported yet.
--no-shard is accepted and changes nothing on one device.
"""

from __future__ import annotations

import argparse
import contextlib
import sys

from rendering_tpu_torch.device import resolve_device
from rendering_tpu_torch.models.scene import load_scene
from rendering_tpu_torch.render.pipeline import render, render_with_progress
from rendering_tpu_torch.utils.bmp import save_bmp
from rendering_tpu_torch.utils.profiling import trace
from rendering_tpu_torch.utils.stats import RenderStats
from rendering_tpu_torch.utils.timer import Timer


def main(argv=None, *, device=None) -> int:
    p = argparse.ArgumentParser(description="PyTorch + CUDA raytracer")
    p.add_argument("scene", nargs="?", default="input/simple_shapes.scene")
    p.add_argument("--output", default=None, help="override output path")
    p.add_argument("--trace-dir", default=None,
                   help="capture a profiler trace of the render phase "
                        "into DIR")
    p.add_argument("--no-shard", action="store_true",
                   help="render on one device (the only mode of the port)")
    p.add_argument("--geo-shard", type=int, default=0, metavar="G",
                   help="shard the geometry over G devices (not ported yet)")
    args = p.parse_args(argv)
    if args.geo_shard:
        raise NotImplementedError(
            "--geo-shard is not ported yet; it comes with the multi-device "
            "slice of the port")
    device = resolve_device(device)

    total = Timer("Total time", device=device)
    t_load = Timer("Scene loading", device=device)
    scene = load_scene(args.scene, device=device)
    settings = scene.static.settings
    t_load.enable_output = settings.enable_output
    total.enable_output = settings.enable_output
    t_load.stop()

    t_render = Timer("Render scene", settings.enable_output, device=device)
    with (trace(args.trace_dir, device=device) if args.trace_dir
          else contextlib.nullcontext()):
        if settings.output_progress and not settings.show_ac:
            frame, aux = render_with_progress(scene, out_u8=True)
        else:
            frame, aux = render(scene, out_u8=True)
    t_render.stop()

    if settings.collect_statistics:
        rs = RenderStats()
        rs.add_device_counts({k: int(v) for k, v in aux["stats"].items()})
        rs.mesh_count = sum(m.n_tris for m in scene.static.meshes)
        rs.tri_copies_count = sum(m.tri_copies for m in scene.static.meshes)
        rs.ac_count = sum(m.n_real_nodes for m in scene.static.meshes)
        rs.print_stats()

    if settings.image_output:
        out = args.output or (settings.image_name + ".bmp")
        save_bmp(out, frame)
        if settings.enable_output:
            print(f"Successfully wrote to output file {out}")

    total.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
