"""Multi-process helpers of the port's multi-device tests
(tests/test_torch_parallel.py, tests/test_torch_geoshard.py): `run_ranks`
runs a worker function of this module on W ranks of a gloo process group
on the CPU, and the workers and the scenes they render live here.

This module imports torch and the port, never JAX, so the spawned ranks
start cheaply. Each rank runs at one torch thread, joins its group
through a FileStore under the test's tmp_path (no TCP port to clash
between pytest-xdist workers) with a 60 s collective timeout, and sends
its result back pickled. `run_ranks` fails the test when a rank raises
or when the ranks have not all answered within `timeout` seconds, and
kills every child it started either way.
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
import multiprocessing
import os
import queue
import signal
import subprocess
import sys
import time
import traceback

import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T01 = os.path.join(REPO, "tests", "scenes", "t01_simple_shapes.scene")
TIMEOUT_S = 120
STRIP_TOL = dict(atol=2e-6, rtol=3e-4)  # tests/test_progress.py:43
_runs = itertools.count()


def _child(fn, rank, world, store_path, args, q):
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(store_path, world), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=60))
        q.put((rank, True, fn(rank, world, *args)))
    except BaseException:  # noqa: B036 - reported to the parent, then exit
        q.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world: int, tmp_path, *args, timeout: float = TIMEOUT_S):
    """fn(rank, world, *args) on `world` spawned ranks (fn a module-level
    function, sent by its import path); returns their results in rank
    order."""
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    store = os.path.join(str(tmp_path),
                         f"store_{fn.__name__}_{os.getpid()}_{next(_runs)}")
    procs = [ctx.Process(target=_child, args=(fn, r, world, store, args, q))
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world:
            try:
                rank, ok, out = q.get(
                    timeout=max(0.1, deadline - time.monotonic()))
            except queue.Empty:
                raise AssertionError(
                    f"{fn.__name__} on {world} ranks: no answer from ranks "
                    f"{sorted(set(range(world)) - set(results))} within "
                    f"{timeout} s") from None
            if not ok:
                raise AssertionError(f"{fn.__name__}: rank {rank} of {world} "
                                     f"raised\n{out}")
            results[rank] = out
    finally:
        for p in procs:
            p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(world)]


# ---- scenes (the parent builds the same ones for its references) ------


def shrink(scene, w, h, **kw):
    st = scene.static
    return dataclasses.replace(scene, static=dataclasses.replace(
        st, settings=st.settings.replace(width=w, height=h, **kw)))


def make_scene(name: str, **kw):
    """The tests' scenes on the CPU: "t01" (t01_simple_shapes.scene at
    96x64, SSAA with the whole frame as its capacity), "tiny" (the four
    materials, a transparent sphere, SSAA on), "multimesh" (the 16-mesh
    scene), "flag" (the flagship's mesh at 1,500 triangles without its
    maps, SSAA off). `kw` overrides settings; geo_shard_axis="geo"
    builds for geometry sharding."""
    from rendering_tpu_torch import flagship
    from rendering_tpu_torch.models.scene import load_scene
    from rendering_tpu_torch.models.settings import RenderSettings

    if name == "t01":
        w, h = kw.pop("width", 96), kw.pop("height", 64)
        geo = kw.pop("geo_shard_axis", None)
        scene = load_scene(T01, RenderSettings(geo_shard_axis=geo),
                           device="cpu")
        return shrink(scene, w, h, **{"ssaa_capacity_fraction": 1.0, **kw})
    if name == "tiny":
        return flagship.build_tiny_scene(
            kw.pop("width", 48), kw.pop("height", 32), n_tris=128,
            settings_overrides={"enable_ssaa": True, **kw}, device="cpu")
    if name == "multimesh":
        return flagship.build_multimesh_scene(
            kw.pop("width", 64), kw.pop("height", 48), n_meshes=16,
            tris_per_mesh=60, max_ray_depth=2, settings_overrides=kw,
            device="cpu")
    if name == "flag":
        return flagship.build_flagship_scene(
            kw.pop("width", 64), kw.pop("height", 48), n_tris=1500,
            with_maps=False, settings_overrides=kw, device="cpu")
    raise ValueError(name)


# The gradient cases: a scene, its settings and the parameters. The
# distant light's intensity (the point lights' falloff saturates at these
# distances), the object colours, and a visible mesh's vertices (meshes
# 0-3 of the 16-mesh scene sit below its floor) or the spheres' centres.
GRAD_CASES = {
    "multimesh": ({"width": 48, "height": 32},
                  (("lights", 1, "intensity"), ("obj_color",),
                   ("meshes", 5, "v"))),
    "t01": ({"width": 48, "height": 32, "enable_ssaa": True},
            (("lights", 1, "intensity"), ("obj_color",), ("sph_pos",))),
}


def grad_target(scene):
    """The train target: the frame at 1.3x the distant light's intensity
    and shifted colours (host numpy, (3, H, W))."""
    from rendering_tpu_torch.render.pipeline import render_scene

    l1 = dataclasses.replace(scene.lights[1],
                             intensity=scene.lights[1].intensity * 1.3)
    s = dataclasses.replace(scene, lights=scene.lights[:1] + (l1,)
                            + scene.lights[2:],
                            obj_color=scene.obj_color * 0.8 + 0.1)
    with torch.no_grad():
        return render_scene(s)[0].numpy()


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def _stats(aux):
    return {k: float(v) for k, v in aux["stats"].items()}


# ---- workers ------------------------------------------------------------


def frames_worker(rank, world, cases):
    """render_sharded (f32 twice, then u8) of each (name, settings) case
    over the world's ray mesh: [(frame, u8, stats, ssaa_masked, the
    frame again)]."""
    from rendering_tpu_torch.parallel.shard import make_ray_mesh, render_sharded

    mesh = make_ray_mesh(device="cpu")
    assert (mesh.rays.rank, mesh.rays.size) == (rank, world)
    out = []
    for name, kw in cases:
        scene = make_scene(name, **kw)
        f, aux = render_sharded(scene, mesh)
        again, _ = render_sharded(scene, mesh)
        u8, _ = render_sharded(scene, mesh, out_u8=True)
        out.append((f, u8, _stats(aux), int(aux["ssaa_masked"]), again))
    return out


def train_steps(step, init, scene, paths, target, n):
    """n steps of a train step from fresh parameters: (each step's
    gradients, each step's loss, the parameters after the last), numpy."""
    from rendering_tpu_torch.diff.inverse import extract_params

    params = extract_params(scene, paths)
    state = init(params)
    grads, losses = [], []
    for _ in range(n):
        params, state, loss = step(params, state, scene, target)
        grads.append({k: _np(p.grad).copy() for k, p in params.items()})
        losses.append(float(loss))
    return grads, losses, {k: _np(p).copy() for k, p in params.items()}


def grads_worker(rank, world, name):
    """The sharded train step and grad fn on GRAD_CASES[name]: the train
    step's (gradients, losses, parameters) over two steps and the first
    step again from a fresh state; with SSAA off, make_sharded_grad_fn's
    (loss, grads) under both schedules."""
    from rendering_tpu_torch.diff.inverse import extract_params, make_train_step
    from rendering_tpu_torch.parallel.overlap import make_sharded_grad_fn
    from rendering_tpu_torch.parallel.shard import make_ray_mesh

    kw, paths = GRAD_CASES[name]
    mesh = make_ray_mesh(device="cpu")
    scene = make_scene(name, **kw)
    target = torch.from_numpy(grad_target(scene))
    init, step = make_train_step(paths, mesh=mesh)
    out = {"train": train_steps(step, init, scene, paths, target, 2),
           "train_again": train_steps(step, init, scene, paths, target, 1)}
    if scene.static.settings.enable_ssaa:
        return out
    for overlap in (True, False):
        fn = make_sharded_grad_fn(paths, mesh, overlap=overlap)
        params = extract_params(scene, paths)
        loss, grads = fn(params, scene, target)
        out[f"grad_fn_{overlap}"] = (float(loss),
                                     {k: _np(g).copy()
                                      for k, g in grads.items()})
    return out


def strips_worker(rank, world, ck_path, mesh_kind, case):
    """The strip renders over a mesh (mesh_kind "rays", or "geo" with
    n_geo = 2): render_with_progress's frame and prints, the one-shot
    sharded frame, render_resumable's frame, then its resume after rank 0
    cleared the last strip of the checkpoint (the strips it rendered)."""
    from rendering_tpu_torch.diff.checkpoint import (
        load_checkpoint,
        load_checkpoint_meta,
        save_checkpoint,
    )
    from rendering_tpu_torch.render import pipeline

    name, kw = case
    mesh, oneshot = _mesh_and_render(mesh_kind)
    scene = make_scene(name, **kw)
    prints = []
    prog, aux = pipeline.render_with_progress(
        scene, strip_rows=16, mesh=mesh, _now=itertools.count(0, 2).__next__,
        _print=prints.append)
    one, _ = oneshot(scene, mesh)
    res1, _ = pipeline.render_resumable(scene, ck_path, strip_rows=16,
                                        mesh=mesh)
    if rank == 0:
        _s, _p, _o, frame_ck, mask = load_checkpoint(ck_path, {}, {})
        mask[-1] = False
        save_checkpoint(ck_path, 2, {}, {}, frame=frame_ck, tile_mask=mask,
                        meta=load_checkpoint_meta(ck_path))
    dist.barrier()
    strips = []
    real = pipeline._make_strip_fns

    def counting(*a, **k):
        prepare, strip_fn, ssaa_fn = real(*a, **k)

        def strip(p, *, y0, rows):
            strips.append(y0)
            return strip_fn(p, y0=y0, rows=rows)

        return prepare, strip, ssaa_fn

    pipeline._make_strip_fns = counting
    try:
        res2, _ = pipeline.render_resumable(scene, ck_path, strip_rows=16,
                                            mesh=mesh)
    finally:
        pipeline._make_strip_fns = real
    return {"progress": prog, "prints": prints, "stats": _stats(aux),
            "oneshot": one, "resumed_from_scratch": res1, "resumed": res2,
            "strips": strips}


def _mesh_and_render(mesh_kind, n_geo=2, shade_sharded=True):
    """(mesh, render fn(scene, mesh) -> (H, W, 3) frame, aux)."""
    if mesh_kind == "rays":
        from rendering_tpu_torch.parallel.shard import make_ray_mesh, render_sharded

        return make_ray_mesh(device="cpu"), render_sharded
    from rendering_tpu_torch.parallel.geoshard import (
        make_geo_mesh,
        render_geo_sharded,
    )

    def fn(scene, mesh):
        return render_geo_sharded(scene, mesh, shade_sharded=shade_sharded)

    return make_geo_mesh(n_geo, device="cpu"), fn


def animation_worker(rank, world):
    """render_frames and render_frames_pipelined (depth 2) over the ray
    mesh on the tiny scene, two cameras."""
    from rendering_tpu_torch.parallel.shard import make_ray_mesh
    from rendering_tpu_torch.render.animation import (
        orbit_cameras,
        render_frames,
        render_frames_pipelined,
    )

    mesh = make_ray_mesh(device="cpu")
    scene = make_scene("tiny")
    cams = orbit_cameras((0.3, 0.0, -3.0), 3.0, 2, elevation_deg=10.0)
    plain = [f for f, _ in render_frames(scene, cams, mesh=mesh)]
    piped = [f for f, _ in render_frames_pipelined(scene, cams, mesh=mesh,
                                                   depth=2)]
    return {"cams": cams, "frames": plain, "pipelined": piped}


def cli_worker(rank, world, ws, argv):
    """cli.main(argv, device="cpu") from the workspace `ws` on this rank
    (the process group is joined already), and what it printed."""
    import contextlib
    import io

    from rendering_tpu_torch import cli

    os.chdir(ws)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(argv), device="cpu")
    return rc, buf.getvalue()


def geo_worker(rank, world, n_geo, cases):
    """render_geo_sharded of each (name, settings, shade_sharded) case
    over the (world / n_geo, n_geo) mesh, as u8 frames with the stats,
    and each case's memory accounting and local shard shapes."""
    from rendering_tpu_torch.parallel.geoshard import (
        geo_shard_memory_accounting,
        make_geo_mesh,
        prepare_geo_scene,
        render_geo_sharded,
    )

    mesh = make_geo_mesh(n_geo, device="cpu")
    out = []
    for name, kw, shade in cases:
        scene = make_scene(name, geo_shard_axis="geo", **kw)
        u8, aux = render_geo_sharded(scene, mesh, shade_sharded=shade,
                                     out_u8=True)
        acct = (None if scene.static.settings.show_ac
                else geo_shard_memory_accounting(scene, mesh,
                                                 shade_sharded=shade))
        shapes = None
        if acct is not None:
            local = prepare_geo_scene(scene, mesh, shade).scene
            shapes = {
                "tri": tuple(local.fused_itables.geo.tri.shape),
                "idmap": tuple(local.fused_itables.idmap.shape),
                "v": [tuple(m.v.shape) for m in local.meshes],
                "vgeo": (None if local.vgeoT_sharded is None
                         else tuple(local.vgeoT_sharded.shape)),
            }
        out.append((_np(u8), _stats(aux), acct, shapes))
    return {"ranks": (mesh.rays.rank, mesh.rays.size, mesh.geo.rank,
                      mesh.geo.size), "cases": out}


GLASS_PATHS = (("lights", 0, "intensity"), ("obj_color",), ("meshes", 0, "v"))


def glass_scene(device="cpu", seed=7, width=64, height=48, n_tris=2000,
                size=3.6):
    """(SceneDef of the port, the description) of the benchmark's
    glass250k configuration cut to `width` x `height` and `n_tris`
    triangles, SSAA off, the glass mesh at `size` (3.6: its transparent
    queue overflows headroom 1 at 64x48)."""
    import copy

    bench = os.path.join(REPO, "benchmark")
    if bench not in sys.path:
        sys.path.insert(0, bench)
    from harness import registry, scenes

    cfg = copy.deepcopy(registry.config("glass250k"))
    mesh = next(o for o in cfg["objects"] if o["type"] == "mesh")
    mesh["size"] = [size] * 3
    desc = scenes.describe(cfg, seed, {"width": width, "height": height,
                                       "n_tris": n_tris,
                                       "enable_ssaa": False})
    return scenes.program_scene(desc, device), desc


def glass_target(scene):
    """The glass cases' target: the frame inside a growing queue, x 0.8
    + 0.05 (every rank computes the same)."""
    from rendering_tpu_torch.render.integrator import (
        QueueGrowth,
        growing_queue,
    )
    from rendering_tpu_torch.render.pipeline import render_scene

    with torch.no_grad(), growing_queue(QueueGrowth()):
        return render_scene(scene)[0] * 0.8 + 0.05


def glass_worker(rank, world):
    """On the glass-heavy scene: the sharded train step's first step
    (loss, gradients) and make_sharded_grad_fn's (loss, gradients)."""
    from rendering_tpu_torch.diff.inverse import extract_params, make_train_step
    from rendering_tpu_torch.parallel.overlap import make_sharded_grad_fn
    from rendering_tpu_torch.parallel.shard import make_ray_mesh

    mesh = make_ray_mesh(device="cpu")
    scene, _ = glass_scene()
    target = glass_target(scene)
    init, step = make_train_step(GLASS_PATHS, mesh=mesh)
    grads, losses, _ = train_steps(step, init, scene, GLASS_PATHS, target, 1)
    fn = make_sharded_grad_fn(GLASS_PATHS, mesh)
    loss, g = fn(extract_params(scene, GLASS_PATHS), scene, target)
    return {"train": (losses[0], grads[0]),
            "grad_fn": (float(loss), {k: _np(v).copy() for k, v in g.items()})}


def collectives_worker(rank, world):
    """The collectives on the world's axis and on a subgroup of ranks 1..
    (`parallel.collectives`), and the backward of the two that carry a
    gradient: [all_reduce sum/min/max, all_gather, gather_slots' and
    sum_replicated's input gradients, the subgroup's all_reduce and
    all_gather]."""
    from rendering_tpu_torch.parallel import collectives
    from rendering_tpu_torch.parallel.shard import comm_for

    comm = comm_for(None)
    x = torch.arange(4, dtype=torch.float32) + 10 * rank
    out = [collectives.all_reduce(comm, x, op) for op in ("sum", "min", "max")]
    out += [collectives.all_gather(comm, x)]
    xg = x.clone().requires_grad_(True)
    w = torch.arange(4 * world, dtype=torch.float32)
    (collectives.gather_slots(comm, xg) * w).sum().backward()
    xs = x.clone().requires_grad_(True)
    (collectives.sum_replicated(comm, xs) * w[:4]).sum().backward()
    out += [xg.grad, xs.grad]
    sub = dist.new_group(list(range(1, world)))
    if rank >= 1:
        c = comm_for(sub)
        out += [collectives.all_reduce(c, x), collectives.all_gather(c, x)]
    return [t.numpy() for t in out]


def diverge_worker(rank, world):
    """Rank 0 waits in an all-reduce that rank 1 never joins."""
    if rank == 0:
        dist.all_reduce(torch.ones(4))
    return rank


MESH_SCENE = """[options]
width=48
height=32
background_color=0.52,0.8,0.92
enableOutput=0
outputProgress=1
image_name=mesh

[light]
type=point
position=0,2,-1
color=1,1,1
intensity=0.6

[light]
type=distant
direction=0.3,-1,-0.4
color=1,1,1
intensity=0.3

[object]
type=plane
pos=0,-1.2,0
normal=0,1,0
color=0.9,0.9,0.9

[object]
type=mesh
pos=0,0,-3
size=2,2,2
color=1,1,1
rot=0,160,0
material=phong,0.4,0.3,0.5,10.0
name=mesh.obj

[end]
"""


def write_mesh_scene(ws) -> str:
    """A scene file over a procedural OBJ (outputProgress=1, SSAA on: the
    scene-file defaults) in the directory ws."""
    from rendering_tpu_torch.flagship import procedural_mesh
    from rendering_tpu_torch.models.objloader import write_obj

    m = procedural_mesh(600, pos=(0, 0, 0), size=(2, 2, 2), seed=0)
    write_obj(os.path.join(ws, "mesh.obj"), m.v, m.uv, m.n)
    with open(os.path.join(ws, "mesh.scene"), "w") as fh:
        fh.write(MESH_SCENE)
    return "mesh.scene"


def run_cli_both(ws, scene_name, extra=()):
    """(BMP bytes of cli.main in this process, of cli.main on two ranks
    with `extra` arguments, the ranks' (rc, prints)), run from ws (the
    cwd); the one-process BMP is ws/one.bmp, the ranks' ws/two.bmp."""
    from rendering_tpu_torch import cli

    assert cli.main([scene_name, "--output", "one.bmp"], device="cpu") == 0
    res = run_ranks(cli_worker, 2, ws, str(ws),
                    [scene_name, "--output", "two.bmp", *extra])
    return ((ws / "one.bmp").read_bytes(), (ws / "two.bmp").read_bytes(),
            res)


_ENTRY = """
import sys
sys.path.insert(0, {repo!r})
import torch
torch.cuda.device_count = lambda: {cards}
from rendering_tpu_torch import cli
raise SystemExit(cli.entry({argv!r}, device="cpu"))
"""


def run_cli_entry(ws, argv, cards: int, timeout: float = TIMEOUT_S):
    """`cli.entry(argv, device="cpu")` in a fresh process run from ws,
    with `cards` cards visible to it (torch.cuda.device_count patched:
    the spawned ranks render on the CPU). Returns (rc, stdout); kills
    the process and every rank it started when `timeout` passes."""
    code = _ENTRY.format(repo=REPO, cards=cards, argv=list(argv))
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    p = subprocess.Popen([sys.executable, "-c", code], cwd=ws, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, start_new_session=True)
    try:
        out, _ = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        raise AssertionError(f"cli.entry {argv}: no end within {timeout} s")
    finally:
        try:
            os.killpg(p.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    return p.returncode, out
