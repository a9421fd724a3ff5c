#!/usr/bin/env python3
"""Where the time of the PyTorch + CUDA port goes, on one NVIDIA GPU.

    python3 tools/profile_torch_port.py            # one forward frame
    python3 tools/profile_torch_port.py --fwd-bwd  # one train step

Both modes run at chip_smoke.py's shapes. The forward mode renders the
flagship scene (250k triangles at 3840x1080) once to warm up, then:

1. phase breakdown: the frame again with a synchronize around each call
   of the pre-pass (`prepare`), each kernel launch, and the
   closest-hit / occlusion / shading stages of the integrator, summed
   per phase (host clock; the synchronizes serialize the frame, so the
   sum is an upper bound of the unsynchronized frame);
2. device profile: torch.profiler over one unsynchronized frame; the
   device time summed by kernel name (top 25), the total device time and
   the device's idle share of the frame's wall time.

The --fwd-bwd mode takes chip_smoke.py's train step on the flagship
(bench.py's three parameters) and on the 16-mesh scene at 1920x1080, and
for each:

1. splits `make_train_step`'s step into forward (apply_params, render),
   backward (loss, backward) and optimizer, through the step's own
   hooks: a render_fn and an optimizer that synchronize and note the
   time as they finish (host clock, mean of 3 steps after a warm-up);
2. times whole unsynchronized steps (mean of 3) with deterministic
   algorithms (as the step runs) and without them (the step's
   `deterministic_algorithms` swapped for a null context), and says
   whether two steps without them from the same state are bit-equal;
3. torch.profiler over one unsynchronized step, as in the forward mode.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import functools
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (  # noqa: E402
    BENCH_PATHS,
    HEIGHT,
    MM_HEIGHT,
    MM_MESHES,
    MM_PATHS,
    MM_TRIS_PER_MESH,
    MM_WIDTH,
    N_TRIS,
    WIDTH,
)
from rendering_tpu_torch.diff import inverse  # noqa: E402
from rendering_tpu_torch.flagship import (  # noqa: E402
    build_flagship_scene,
    build_multimesh_scene,
)
from rendering_tpu_torch.ops import cuda_intersect as ci  # noqa: E402
from rendering_tpu_torch.render import integrator as it  # noqa: E402
from rendering_tpu_torch.render.pipeline import render_scene  # noqa: E402


def timed(table, name, fn):
    """fn wrapped to add its synchronized host time to table[name]."""
    @functools.wraps(fn)
    def wrapper(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        table[name] += time.perf_counter() - t0
        return out
    return wrapper


def dev_us(event) -> float:
    """Self device time of a profiler row, in microseconds."""
    return float(getattr(event, "self_device_time_total",
                         getattr(event, "self_cuda_time_total", 0.0)))


def device_profile(fn, what: str) -> None:
    """torch.profiler over one unsynchronized call of fn: device busy
    time, idle share of the wall time, and the top 25 device rows."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # Device-side rows only (kernels and copies), not the host ops that
    # launched them, so no time is counted twice.
    events = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA")]
    dev_total = sum(dev_us(e) for e in events) / 1e3  # ms
    print(f"profiled {what} wall {wall * 1e3:.3f} ms; device busy "
          f"{dev_total:.3f} ms; idle share {1 - dev_total / (wall * 1e3):.4f}")
    for e in sorted(events, key=lambda e: -dev_us(e))[:25]:
        print(f"  {dev_us(e) / 1e3:10.3f} ms  {e.count:6d}x  "
              f"{e.key[:90]}")


def forward_frame() -> None:
    scene = build_flagship_scene(WIDTH, HEIGHT, n_tris=N_TRIS)
    with torch.no_grad():
        render_scene(scene)
    torch.cuda.synchronize()

    # 1. phase breakdown (synchronized)
    phases = collections.defaultdict(float)
    patches = [
        (ci, "prepare", "pre-pass (prepare)"),
        (it, "trace_closest", "trace_closest (incl. its pre-pass + kernel)"),
        (it, "trace_occlusion", "trace_occlusion (incl. its pre-pass + kernel)"),
        (it, "surface_data", "surface_data"),
        (it, "point_shadow_batch", "shadow-ray build"),
    ]
    # The kernels, looked up by variant name at every query.
    kernels = [("closest_hit", "closest-hit kernel"),
               ("any_hit", "any-hit kernel")]
    saved = [(m, n, getattr(m, n)) for m, n, _ in patches]
    saved_k = {n: ci.KERNELS[n] for n, _ in kernels}
    for m, n, label in patches:
        setattr(m, n, timed(phases, label, getattr(m, n)))
    for n, label in kernels:
        ci.KERNELS[n] = timed(phases, label, ci.KERNELS[n])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        render_scene(scene)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    for m, n, fn in saved:
        setattr(m, n, fn)
    ci.KERNELS.update(saved_k)
    print(f"synchronized frame {WIDTH}x{HEIGHT}, {N_TRIS} "
          f"triangles: {total * 1e3:.3f} ms")
    for label, s in sorted(phases.items(), key=lambda kv: -kv[1]):
        print(f"  {label:48s} {s * 1e3:10.3f} ms  {100 * s / total:5.1f}%")

    # 2. device profile (unsynchronized frame)
    def frame():
        with torch.no_grad():
            render_scene(scene)
    device_profile(frame, "frame")


@contextlib.contextmanager
def without_determinism():
    """Run the train step without deterministic algorithms: the step
    looks `deterministic_algorithms` up in its module at every call."""
    saved = inverse.deterministic_algorithms
    inverse.deterministic_algorithms = contextlib.nullcontext
    try:
        yield
    finally:
        inverse.deterministic_algorithms = saved


def train_step(what: str, scene, paths) -> None:
    st = scene.static.settings
    gen = torch.Generator(device=scene.device).manual_seed(0)
    target = torch.rand((3, st.height, st.width), generator=gen,
                        device=scene.device)
    reps = 3

    # 1. forward / backward / optimizer split of make_train_step's own
    # step, through its hooks: a render_fn and an optimizer that each
    # synchronize and note the time when they finish.
    marks: dict = {}

    def render_fn(s):
        frame = render_scene(s)[0]
        torch.cuda.synchronize()
        marks["forward"] = time.perf_counter()
        return frame

    def optimizer(params):
        opt = inverse.adam(params)
        adam_step = opt.step

        def step(*a, **kw):
            torch.cuda.synchronize()
            marks["backward"] = time.perf_counter()
            out = adam_step(*a, **kw)
            torch.cuda.synchronize()
            marks["optimizer"] = time.perf_counter()
            return out
        opt.step = step
        return opt

    init, step_fn = inverse.make_train_step(paths, optimizer,
                                            render_fn=render_fn)
    params = inverse.extract_params(scene, paths)
    state = init(params)
    step_fn(params, state, scene, target)  # warm-up
    phases = collections.defaultdict(float)
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_fn(params, state, scene, target)
        phases["forward (apply_params, render)"] += marks["forward"] - t0
        phases["backward (loss, backward)"] += (marks["backward"]
                                                - marks["forward"])
        phases["optimizer (Adam)"] += marks["optimizer"] - marks["backward"]
    total = sum(phases.values())
    print(f"{what}: synchronized step {total / reps * 1e3:.3f} ms "
          f"(mean of {reps})")
    for label, s in phases.items():
        print(f"  {label:40s} {s / reps * 1e3:10.3f} ms  "
              f"{100 * s / total:5.1f}%")

    # 2. the cost of deterministic algorithms, on the unhooked step
    init, step_fn = inverse.make_train_step(paths)

    def mean_step_ms() -> float:
        p = inverse.extract_params(scene, paths)
        s = init(p)
        p, s, _ = step_fn(p, s, scene, target)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            p, s, _ = step_fn(p, s, scene, target)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    for det, label in ((True, "deterministic"), (False, "not deterministic"),
                       (False, "not deterministic (again)"),
                       (True, "deterministic (again)")):
        with contextlib.nullcontext() if det else without_determinism():
            print(f"{what}: step {mean_step_ms():.3f} ms, {label}")
    outs = []
    with without_determinism():
        for _ in range(2):
            p = inverse.extract_params(scene, paths)
            p, _, loss = step_fn(p, init(p), scene, target)
            outs.append([loss] + [v.grad for v in p.values()])
    equal = all(torch.equal(a, b) for a, b in zip(*outs))
    print(f"{what}: two steps without deterministic algorithms bit-equal: "
          f"{equal}")

    # 3. device profile (unsynchronized step)
    p = inverse.extract_params(scene, paths)
    s = init(p)
    device_profile(lambda: step_fn(p, s, scene, target), f"{what} step")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--fwd-bwd", action="store_true",
                        help="profile the train step instead of a frame")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_port: no CUDA device is available",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    if not args.fwd_bwd:
        forward_frame()
        return 0
    train_step(f"flagship {WIDTH}x{HEIGHT}",
               build_flagship_scene(WIDTH, HEIGHT, n_tris=N_TRIS), BENCH_PATHS)
    train_step(f"multimesh {MM_WIDTH}x{MM_HEIGHT}",
               build_multimesh_scene(MM_WIDTH, MM_HEIGHT, n_meshes=MM_MESHES,
                                     tris_per_mesh=MM_TRIS_PER_MESH), MM_PATHS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
