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
with progress prints (`render_with_progress`); otherwise, and under
showAC, in one pass (`render`). showNormals and showAC render their
debug images. --trace-dir DIR captures a `torch.profiler` trace of the
render phase into DIR (`utils.profiling.trace`; read it with
`op_profile`).

Several ranks, as the JAX package shards over every visible device:
under a launcher (`torchrun --nproc-per-node=N -m rendering_tpu_torch
scene.scene`: WORLD_SIZE > 1), or in a process group the caller already
joined, each rank joins the group (`parallel.multihost`) and the frame
renders with its rays sharded over the ranks (`render_sharded`, or the
sharded strips with outputProgress=1). `python -m rendering_tpu_torch`
(`entry`) started alone with more than one visible card starts one such
rank per card itself; --no-shard renders on one device instead. `main`
is always the one process it is called in. --geo-shard G shards the
geometry over G ranks too (G divides the rank count; the scene builds
with geo_shard_axis="geo"). Only rank 0 prints and writes the BMP.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import socket
import sys

import torch
import torch.distributed as dist

from rendering_tpu_torch.models.scene import load_scene
from rendering_tpu_torch.models.settings import RenderSettings
from rendering_tpu_torch.parallel import multihost
from rendering_tpu_torch.render.pipeline import render, render_with_progress
from rendering_tpu_torch.utils.bmp import save_bmp
from rendering_tpu_torch.utils.profiling import trace
from rendering_tpu_torch.utils.stats import RenderStats
from rendering_tpu_torch.utils.timer import Timer
from rendering_tpu_torch.utils.tracing import span


def _parse(argv):
    p = argparse.ArgumentParser(description="PyTorch + CUDA raytracer")
    p.add_argument("scene", nargs="?", default="input/simple_shapes.scene")
    p.add_argument("--output", default=None, help="override output path")
    p.add_argument("--trace-dir", default=None,
                   help="capture a profiler trace of the render phase "
                        "into DIR")
    p.add_argument("--no-shard", action="store_true",
                   help="render in this one process even when more than one "
                        "card is visible")
    p.add_argument("--geo-shard", type=int, default=0, metavar="G",
                   help="shard the geometry over G ranks (beyond-memory "
                        "scenes): rays shard over the remaining ranks/G; G "
                        "must divide the rank count")
    return p.parse_args(argv)


def _launched() -> bool:
    """This process is a rank of a group: joined, or under a launcher."""
    return (dist.is_initialized()
            or int(os.environ.get("WORLD_SIZE", "1")) > 1)


def _rank_main(local_rank: int, argv, port: int, n: int, device):
    """One rank of the CLI's own spawn: the launcher's environment, then
    main."""
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      WORLD_SIZE=str(n), RANK=str(local_rank),
                      LOCAL_RANK=str(local_rank), LOCAL_WORLD_SIZE=str(n))
    rc = main(argv, device=device)
    if rc:
        raise SystemExit(rc)


def _spawn_ranks(argv, n: int, device=None) -> int:
    """Run main on n ranks, one process per card, on this node."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    print(f"{n} cards visible: rendering on {n} ranks (--no-shard: one)")
    torch.multiprocessing.start_processes(
        _rank_main, args=(argv, port, n, device), nprocs=n,
        start_method="spawn")
    return 0


def entry(argv=None, *, device=None) -> int:
    """`python -m rendering_tpu_torch`: main on one rank per visible card
    when more than one is visible, the process is no rank of a group yet
    and --no-shard is not given, as the JAX package shards over every
    visible device; else main in this process."""
    argv = sys.argv[1:] if argv is None else list(argv)
    n = torch.cuda.device_count()
    if n > 1 and not _launched() and not _parse(argv).no_shard:
        return _spawn_ranks(argv, n, device)
    return main(argv, device=device)


def main(argv=None, *, device=None) -> int:
    """The CLI in this one process: a rank of the group when it is one
    (`_launched`), else the whole render on one device."""
    args = _parse(argv)
    launched = _launched()
    joined_here = launched and not dist.is_initialized()
    if launched:
        multihost.initialize_distributed(device=device)
    device = multihost.rank_device(device)
    rank = dist.get_rank() if dist.is_initialized() else 0
    try:
        # Ranks other than 0 print nothing.
        with (contextlib.redirect_stdout(io.StringIO()) if rank
              else contextlib.nullcontext()):
            with span("rt.cli.main"):
                return _run(args, device,
                            sharded=launched and not args.no_shard,
                            writer=rank == 0)
    finally:
        if joined_here:
            dist.destroy_process_group()


def _run(args, device, *, sharded: bool, writer: bool) -> int:
    if args.geo_shard:
        # Built for geometry sharding: the per-triangle tables stay in
        # host memory until each rank stages its shard.
        from rendering_tpu_torch.parallel.geoshard import make_geo_mesh

        mesh = make_geo_mesh(args.geo_shard, device=device)
        base_settings = RenderSettings(geo_shard_axis="geo")
    elif sharded:
        from rendering_tpu_torch.parallel.shard import make_ray_mesh

        mesh = make_ray_mesh(device=device)
        base_settings = None
    else:
        mesh = base_settings = None

    total = Timer("Total time", device=device)
    t_load = Timer("Scene loading", device=device)
    scene = load_scene(args.scene, base_settings, device=device)
    settings = scene.static.settings
    t_load.enable_output = settings.enable_output
    total.enable_output = settings.enable_output
    t_load.stop()

    t_render = Timer("Render scene", settings.enable_output, device=device)
    progress = settings.output_progress and not settings.show_ac
    with (trace(args.trace_dir, device=device) if args.trace_dir
          else contextlib.nullcontext()):
        if progress:
            frame, aux = render_with_progress(scene, mesh=mesh, out_u8=True)
        elif args.geo_shard:
            from rendering_tpu_torch.parallel.geoshard import (
                render_geo_sharded,
            )

            frame, aux = render_geo_sharded(scene, mesh, out_u8=True)
        elif mesh is not None:
            from rendering_tpu_torch.parallel.shard import render_sharded

            frame, aux = render_sharded(scene, mesh, out_u8=True)
        else:
            frame, aux = render(scene, out_u8=True)
    t_render.stop()

    if settings.collect_statistics:
        rs = RenderStats()
        with span("rt.sync.stats"):
            counts = {k: int(v) for k, v in aux["stats"].items()}
        rs.add_device_counts(counts)
        rs.mesh_count = sum(m.n_tris for m in scene.static.meshes)
        rs.tri_copies_count = sum(m.tri_copies for m in scene.static.meshes)
        rs.ac_count = sum(m.n_real_nodes for m in scene.static.meshes)
        rs.print_stats()

    if settings.image_output and writer:
        out = args.output or (settings.image_name + ".bmp")
        with span("rt.pipeline.pull"):
            save_bmp(out, frame)
        if settings.enable_output:
            print(f"Successfully wrote to output file {out}")

    total.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
