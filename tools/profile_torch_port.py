#!/usr/bin/env python3
"""Where the time of one forward frame of the PyTorch + CUDA port goes,
on one NVIDIA GPU.

    python3 tools/profile_torch_port.py

Renders the flagship scene at chip_smoke.py's shape (250k triangles at
3840x1080) once to warm up, then:

1. phase breakdown: the frame again with a synchronize around each call
   of the pre-pass (`prepare`), each kernel launch, and the
   closest-hit / occlusion / shading stages of the integrator, summed
   per phase (host clock; the synchronizes serialize the frame, so the
   sum is an upper bound of the unsynchronized frame);
2. device profile: torch.profiler over one unsynchronized frame; the
   device time summed by kernel name (top 25), the total device time and
   the device's idle share of the frame's wall time.
"""

from __future__ import annotations

import collections
import functools
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import HEIGHT, N_TRIS, WIDTH  # noqa: E402
from rendering_tpu_torch.flagship import build_flagship_scene  # noqa: E402
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


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_port: no CUDA device is available",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)
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
    patches += [(ci, "closest_hit_kernel", "closest-hit kernel"),
                (ci, "any_hit_kernel", "any-hit kernel")]
    saved = [(m, n, getattr(m, n)) for m, n, _ in patches]
    for m, n, label in patches:
        setattr(m, n, timed(phases, label, getattr(m, n)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        render_scene(scene)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    for m, n, fn in saved:
        setattr(m, n, fn)
    print(f"synchronized frame {WIDTH}x{HEIGHT}, {N_TRIS} "
          f"triangles: {total * 1e3:.3f} ms")
    for label, s in sorted(phases.items(), key=lambda kv: -kv[1]):
        print(f"  {label:48s} {s * 1e3:10.3f} ms  {100 * s / total:5.1f}%")

    # 2. device profile (unsynchronized frame)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with torch.no_grad():
            render_scene(scene)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # Device-side rows only (kernels and copies), not the host ops that
    # launched them, so no time is counted twice.
    events = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA")]
    dev_total = sum(dev_us(e) for e in events) / 1e3  # ms
    print(f"profiled frame wall {wall * 1e3:.3f} ms; device busy "
          f"{dev_total:.3f} ms; idle share {1 - dev_total / (wall * 1e3):.4f}")
    for e in sorted(events, key=lambda e: -dev_us(e))[:25]:
        print(f"  {dev_us(e) / 1e3:10.3f} ms  {e.count:6d}x  "
              f"{e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
