#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from rendering_tpu_torch/csrc with nvcc,
then drives the port's two paths through the entry points a user calls.

The 250k-triangle flagship scene at 3840x1080 (kernels K1 closest hit
and K2 any hit):

1. renders the full frame through `render_scene`, checks that both
   kernels were launched once per ray block, that the frame is finite and
   the mesh is hit, and times the forward pass (1 warm-up, 3 reps); the
   render keeps the two queries (primary rays, batched shadow rays) that
   its middle ray block hands to the kernels;
2. holds each kernel against its plain PyTorch version on 64 sampled
   512-ray tiles of those queries: ids equal, t bit-equal;
3. times each kernel, its plain version and its pre-pass on the whole
   queries, checks the two agree there too, and computes each kernel's
   bound;
4. renders at 384x216 with the kernels and with the plain versions on
   the card and requires equal u8 frames;
5. trains: `diff.inverse.make_train_step` with bench.py's three
   parameters (point light intensity, obj_color, vertices) against a
   seeded target. Counts launches per step, checks the gradients (finite;
   the vertices' nonzero; the other two exactly 0, as jax.grad's are on
   this scene, tests/test_torch_grad.py), requires two steps from the
   same state to be bit-equal, and reports the step time, rays/s
   (W * H / step time, bench.py's key) and the peak device memory.

The 16-mesh scene at 1920x1080 (kernel K5, fused closest hit and fused
any hit over all meshes):

6. renders it through `render_scene`: each K5 entry launched once per
   ray block and no K1/K2 launch; keeps the middle block's queries;
7. holds each K5 entry against its plain version on 64 sampled tiles
   and at the whole query, times both and computes the bound;
8. whole-render u8 parity, kernels vs plain versions, at 384x216;
9. trains the point light's intensity, obj_color and the vertices of
   meshes 4 and 5: launches per step, finite nonzero gradients, two
   steps from the same state bit-equal, step time and peak memory.

Prints the card, a JSON line of per-kernel numbers, a JSON line of the
path numbers, and as its last line {"ok": true, "device": {...}}. Any
failed check raises, so the script exits non-zero; without a CUDA device
it exits 1 and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

import torch

N_TRIS = 250_000
WIDTH, HEIGHT = 3840, 1080
MM_WIDTH, MM_HEIGHT = 1920, 1080
MM_MESHES, MM_TRIS_PER_MESH = 16, 5000
PARITY_WH = (384, 216)
SAMPLED_TILES = 64
RAY_BLOCK = 1 << 17     # integrator.DEFAULT_RAY_BLOCK
BENCH_PATHS = (("lights", 0, "intensity"), ("obj_color",), ("meshes", 0, "v"))
# Meshes 0-3, the grid's bottom row, sit below the floor plane (centres
# at y = -1.95, the plane at y = -1.2) and get no gradient; 4 and 5 are
# the first two visible ones.
MM_PATHS = (("lights", 0, "intensity"), ("obj_color",), ("meshes", 4, "v"),
            ("meshes", 5, "v"))
HBM_RATE = 3.35e12      # H100 SXM bytes/s
# The kernels are built with -fmad=false, so every f32 multiply, add and
# compare issues on its own: one per lane per clock, 132 SMs x 128 lanes
# x 1.98 GHz = 33.5e12/s, half the data sheet's 67 TFLOP/s (which counts
# an FMA as two operations).
F32_OPS_RATE = 67e12 / 2
# f32 instructions per ray-triangle pair in the kernels' inner loop
# (csrc/mesh_intersect.cu): cross products p and q, 2 x (6 mul + 3 sub);
# det, 3 mul + 2 add; tv, 3 sub; u, v and t, 3 x (4 mul + 2 add); u + v,
# 1 add; 7 compares (det, u >= 0, u <= 1, v >= 0, u + v <= 1, t >= 0,
# t < t_best); 1 select (ok ? det : 1); and the IEEE reciprocal 1/det,
# MUFU.RCP plus 3 refinement instructions. Shared-memory loads, branches
# and predicate logic are left out, so the bound stays a lower bound.
OPS_PER_PAIR = 18 + 5 + 3 + 18 + 1 + 7 + 1 + 4
SOURCE = "rendering_tpu_torch/csrc/mesh_intersect.cu"
TPU_KERNEL = "rendering_tpu/ops/pallas_intersect.py:135"
TPU_FUSED = "rendering_tpu/ops/pallas_intersect.py:1154"


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the card, by CUDA events, after one
    warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# Each kernel's name in the report, the launcher in ops/cuda_intersect.py
# that counts its launches, and whether it answers any-hit queries.
KERNELS = {
    "closest_hit": ("closest_hit_kernel", False),
    "any_hit": ("any_hit_kernel", True),
    "fused_closest_hit": ("fused_closest_hit_kernel", False),
    "fused_any_hit": ("fused_any_hit_kernel", True),
}


def launch(ci, tables, prep, anyhit, bfc):
    """The port's query on card tensors, which launches its kernel:
    `run_fused_query` for fused tables, else `run_query`."""
    run = (ci.run_fused_query if isinstance(tables, ci.FusedTables)
           else ci.run_query)
    return run(tables, prep, anyhit=anyhit, backface_culling=bfc)


def plain(ci, tables, prep, anyhit, bfc, stats=None):
    """The same query through the kernel's plain PyTorch version."""
    fn = (ci.intersect_fused_plain if isinstance(tables, ci.FusedTables)
          else ci.intersect_plain)
    return fn(tables, prep, anyhit=anyhit, backface_culling=bfc, stats=stats)


@contextlib.contextmanager
def counted(ci, out: dict):
    """Set every kernel's launch count to 0, run the block, and store the
    counts just after it (synchronized) in `out`."""
    launchers = {name: getattr(ci, attr)
                 for name, (attr, _) in KERNELS.items()}
    for k in launchers.values():
        k.launches = 0
    yield
    torch.cuda.synchronize()
    out.update({name: k.launches for name, k in launchers.items()})


def same(a, b) -> bool:
    """Bit equality of two output tuples (floats compared as bits)."""
    def bits(x):
        return x.view(torch.int32) if x.dtype == torch.float32 else x
    return all(torch.equal(bits(x), bits(y)) for x, y in zip(a, b))


def sample_tiles(ci, prep, n_tiles: int):
    """The n_tiles evenly spaced 512-ray tiles of a prepared query, with
    their own rows of the visit tables."""
    pick = torch.linspace(0, prep.n_tiles - 1, n_tiles).round().long()
    lanes = (pick[:, None] * ci.RAY_TILE
             + torch.arange(ci.RAY_TILE)[None, :]).reshape(-1)
    pick, lanes = pick.to(prep.aux.device), lanes.to(prep.aux.device)
    return ci.Prepared(prep.aux[:, lanes].contiguous(),
                       prep.torder[pick].contiguous(),
                       prep.counts[pick].contiguous(), lanes.numel())


def check_parity(ci, name, tables, prep, bfc) -> float:
    """Kernel vs plain version on 64 sampled tiles of a prepared query:
    every integer output equal, t bit-equal. Returns the max |t|
    difference (0 when bit-equal); raises on any mismatch."""
    anyhit = KERNELS[name][1]
    prep = sample_tiles(ci, prep, SAMPLED_TILES)
    out_k = launch(ci, tables, prep, anyhit, bfc)
    out_p = plain(ci, tables, prep, anyhit, bfc)
    torch.cuda.synchronize()
    ids_mis = sum(int((a != b).sum()) for a, b in zip(out_k[1:], out_p[1:]))
    bits_mis = int((out_k[0].view(torch.int32)
                    != out_p[0].view(torch.int32)).sum())
    hit = out_k[1] >= 0
    print(f"parity {name}: {prep.n_rays} rays in {SAMPLED_TILES} "
          f"tiles, {int(hit.sum())} hit/occluded; mismatches: ids "
          f"{ids_mis}, t bits {bits_mis}")
    if ids_mis or bits_mis or not bool(hit.any()):
        raise AssertionError(f"{name} kernel disagrees with its plain "
                             f"version (or found nothing)")
    return float((out_k[0] - out_p[0]).abs().max())


def kernel_numbers(ci, name, tables, prep, bfc) -> dict:
    """Times of the kernel, its plain version and the pre-pass on a
    prepared query of the main path, and the kernel's bound from this
    query's work. Also checks the kernel against its plain version on the
    whole query."""
    anyhit = KERNELS[name][1]
    ms = cuda_ms(lambda: launch(ci, tables, prep, anyhit, bfc), reps=20)
    plain_ms = cuda_ms(lambda: plain(ci, tables, prep, anyhit, bfc), reps=1)
    stats: dict = {}
    out_p = plain(ci, tables, prep, anyhit, bfc, stats)
    out_k = launch(ci, tables, prep, anyhit, bfc)
    if not same(out_k, out_p):
        raise AssertionError(f"{name} disagrees with its plain "
                             f"version at the main path's shape")
    n, aux = prep.n_rays, prep.aux
    fused = isinstance(tables, ci.FusedTables)
    geo = tables.geo if fused else tables
    prepass_ms = cuda_ms(
        lambda: ci.prepare(geo, aux[0:3, :n], aux[3:6, :n], aux[9, :n]),
        reps=5)
    table_tensors = [geo.tri, geo.cbox] + ([tables.idmap] if fused else [])
    n_in = sum(x.numel() * x.element_size()
               for x in (*table_tensors, prep.aux, prep.torder,
                         prep.counts))
    n_out = sum(x.numel() * x.element_size() for x in out_k)
    bytes_ms = (n_in + n_out) / HBM_RATE * 1e3
    ops_ms = stats["pairs"] * OPS_PER_PAIR / F32_OPS_RATE * 1e3
    return {
        "rays": prep.n_rays, "pairs": stats["pairs"], "ms": ms,
        "plain_ms": plain_ms, "prepass_ms": prepass_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
    }


@contextlib.contextmanager
def routed_queries(ci, route):
    """Send the port's intersection queries (single-mesh and fused)
    through route(real, tables, prep, anyhit, backface_culling) instead
    of `ci.run_query` / `ci.run_fused_query`."""
    saved = ci.run_query, ci.run_fused_query

    def wrap(real):
        def query(tables, prep, *, anyhit, backface_culling):
            return route(real, tables, prep, anyhit, backface_culling)
        return query

    ci.run_query, ci.run_fused_query = map(wrap, saved)
    try:
        yield
    finally:
        ci.run_query, ci.run_fused_query = saved


def keep_block(ci, block: int, kept: dict):
    """A route that keeps the (tables, prepared query) of ray block
    `block` under kept[anyhit] and runs the real query."""
    seen = {False: 0, True: 0}

    def route(real, tables, prep, anyhit, backface_culling):
        if seen[anyhit] == block:
            kept[anyhit] = (tables, prep)
        seen[anyhit] += 1
        return real(tables, prep, anyhit=anyhit,
                    backface_culling=backface_culling)
    return routed_queries(ci, route)


def plain_queries(ci):
    """Every query through its plain PyTorch version, on the card."""
    def route(real, tables, prep, anyhit, backface_culling):
        return plain(ci, tables, prep, anyhit, backface_culling)
    return routed_queries(ci, route)


def check_frame(scene, frame3, w, h, what):
    if tuple(frame3.shape) != (3, h, w):
        raise AssertionError(f"{what}: frame shape {tuple(frame3.shape)}")
    if not bool(torch.isfinite(frame3).all()):
        raise AssertionError(f"{what}: frame is not finite")
    bg = scene.bg_color[:, None, None]
    interior = frame3[:, :-1, :-1]
    obj_px = int((interior != bg).any(dim=0).sum())
    print(f"{what}: frame finite; {obj_px} of {interior[0].numel()} pixels "
          f"differ from the background; mean {float(frame3.mean()):.6f}")
    if obj_px < 0.05 * interior[0].numel():
        raise AssertionError(f"{what}: the geometry is not hit")


def check_launches(counts, expect: dict, what):
    """counts of the path's run: each kernel in `expect` launched that
    many times (> 0), every other kernel not at all."""
    print(f"{what} launches: {counts}")
    for name, n in counts.items():
        want = expect.get(name, 0)
        if n != want:
            raise AssertionError(f"{what}: {name} launched {n} times, "
                                 f"expected {want}")
    if min(expect.values()) <= 0:
        raise AssertionError(f"{what}: a kernel of the path never launched")


def whole_render_parity(ci, build, what):
    from rendering_tpu_torch.render.pipeline import render_scene

    small = build(*PARITY_WH)
    with torch.no_grad():
        u8_k, _ = render_scene(small, out_u8=True)
        with plain_queries(ci):
            u8_p, _ = render_scene(small, out_u8=True)
    n_diff = int((u8_k != u8_p).sum())
    print(f"whole-render parity {what} {PARITY_WH[0]}x{PARITY_WH[1]}: "
          f"{n_diff} differing u8 values")
    if n_diff:
        raise AssertionError(f"{what}: kernel and plain renders disagree")


def train(ci, scene, paths, *, reps: int, zero_ok=()):
    """make_train_step on `scene`: one counted step from fresh parameters
    (launches, peak memory, gradients), a second step from the same state
    that must be bit-equal, then `reps` timed steps (host clock,
    synchronized). Gradients must be finite, and nonzero except for the
    keys in `zero_ok`, which must be exactly 0."""
    from rendering_tpu_torch.diff.inverse import (
        extract_params,
        make_train_step,
    )

    st = scene.static.settings
    gen = torch.Generator(device=scene.device).manual_seed(0)
    target = torch.rand((3, st.height, st.width), generator=gen,
                        device=scene.device)

    def one_step(step):
        init, step_fn = step
        params = extract_params(scene, paths)
        params, _, loss = step_fn(params, init(params), scene, target)
        torch.cuda.synchronize()
        return loss, {k: (v.detach().clone(), v.grad.clone())
                      for k, v in params.items()}

    step = make_train_step(paths)
    counts: dict = {}
    torch.cuda.reset_peak_memory_stats()
    with counted(ci, counts):
        loss, out = one_step(step)
    peak = torch.cuda.max_memory_allocated()
    grads = {}
    for k, (_, g) in out.items():
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"gradient of {k} is not finite")
        grads[k] = float(g.abs().sum())
        if (k in zero_ok) != (grads[k] == 0.0):
            raise AssertionError(f"gradient of {k}: sum |g| = {grads[k]}")
    print(f"step loss {float(loss):.8f}; sum |grad| {grads}; peak "
          f"{peak / 2**30:.3f} GiB")
    result = {"launches": counts, "loss": float(loss), "grad_abs_sum": grads,
              "peak_bytes": peak}
    loss2, out2 = one_step(step)
    equal = torch.equal(loss, loss2) and all(
        torch.equal(out[k][0], out2[k][0])
        and torch.equal(out[k][1], out2[k][1]) for k in out)
    print(f"two steps from the same state bit-equal: {equal}")
    if not equal:
        raise AssertionError("repeat train steps differ")
    result["repeat_bit_equal"] = equal

    init, step_fn = step
    params = extract_params(scene, paths)
    state = init(params)
    params, state, _ = step_fn(params, state, scene, target)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        params, state, _ = step_fn(params, state, scene, target)
    torch.cuda.synchronize()
    result["step_ms"] = (time.perf_counter() - t0) / reps * 1e3
    result["rays_per_s"] = st.width * st.height / result["step_ms"] * 1e3
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from rendering_tpu_torch.flagship import (
        build_flagship_scene,
        build_multimesh_scene,
    )
    from rendering_tpu_torch.ops import cuda_intersect as ci
    from rendering_tpu_torch.render.pipeline import render_scene

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card_line = card()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(card_line)

    # ---- build -----------------------------------------------------------
    t0 = time.perf_counter()
    path, log = ci.build_library()
    print(f"built {path} in {time.perf_counter() - t0:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print("  ptxas:", line.strip())

    t0 = time.perf_counter()
    scene = build_flagship_scene(WIDTH, HEIGHT, n_tris=N_TRIS)
    torch.cuda.synchronize()
    tb = scene.meshes[0].itables
    print(f"flagship scene {N_TRIS} triangles at {WIDTH}x{HEIGHT} built in "
          f"{time.perf_counter() - t0:.1f} s; tables tc={tb.tri_chunk} "
          f"n_sub={tb.n_sub} Cs={tb.sbox.shape[0]}")
    bfc = scene.static.settings.use_backface_culling
    n_blocks = -(-WIDTH * HEIGHT // RAY_BLOCK)

    # ---- 1. flagship forward render through render_scene -------------------
    kept: dict = {}
    fwd_counts: dict = {}
    with torch.no_grad(), keep_block(ci, n_blocks // 2, kept), \
            counted(ci, fwd_counts):
        frame3, _ = render_scene(scene)
    check_launches(fwd_counts, {"closest_hit": n_blocks, "any_hit": n_blocks},
                   f"flagship render_scene ({n_blocks} ray blocks)")
    check_frame(scene, frame3, WIDTH, HEIGHT, "flagship")

    def forward():
        with torch.no_grad():
            render_scene(scene)

    frame_ms = cuda_ms(forward, reps=3)
    rays = WIDTH * HEIGHT
    print(f"forward frame {WIDTH}x{HEIGHT}, {N_TRIS} triangles: "
          f"{frame_ms:.3f} ms, {rays / frame_ms * 1e3:.4e} rays/s "
          f"(CUDA events, mean of 3 after 1 warm-up) on {card_line}")

    # ---- 2-3. K1, K2 vs plain, and their numbers, on the kept queries ------
    err, nums = {}, {}
    for name in ("closest_hit", "any_hit"):
        err[name] = check_parity(ci, name, *kept[KERNELS[name][1]], bfc)
    for name in ("closest_hit", "any_hit"):
        nums[name] = kernel_numbers(ci, name, *kept[KERNELS[name][1]], bfc)
        print(f"{name}: {json.dumps(nums[name])}")
    kept.clear()

    # ---- 4. flagship whole-render parity ------------------------------------
    whole_render_parity(
        ci, lambda w, h: build_flagship_scene(w, h, n_tris=N_TRIS), "flagship")

    # ---- 5. flagship fwd+bwd train step --------------------------------------
    flag = train(ci, scene, BENCH_PATHS, reps=3,
                 zero_ok=("lights/0/intensity", "obj_color"))
    check_launches(flag["launches"],
                   {"closest_hit": n_blocks, "any_hit": n_blocks},
                   "flagship train step")
    print(f"flagship fwd+bwd step {WIDTH}x{HEIGHT}: {flag['step_ms']:.3f} ms, "
          f"{flag['rays_per_s']:.4e} rays/s; peak "
          f"{flag['peak_bytes'] / 2**30:.3f} GiB on {card_line}")
    del scene, frame3
    torch.cuda.empty_cache()

    # ---- 6. 16-mesh forward render (K5) --------------------------------------
    t0 = time.perf_counter()
    mm = build_multimesh_scene(MM_WIDTH, MM_HEIGHT, n_meshes=MM_MESHES,
                               tris_per_mesh=MM_TRIS_PER_MESH)
    torch.cuda.synchronize()
    ft = mm.fused_itables
    print(f"multimesh scene {MM_MESHES} x {MM_TRIS_PER_MESH} triangles at "
          f"{MM_WIDTH}x{MM_HEIGHT} built in {time.perf_counter() - t0:.1f} s; "
          f"fused tables tc={ft.geo.tri_chunk} Cs={ft.geo.sbox.shape[0]}")
    mm_blocks = -(-MM_WIDTH * MM_HEIGHT // RAY_BLOCK)
    bfc = mm.static.settings.use_backface_culling
    mm_counts: dict = {}
    with torch.no_grad(), keep_block(ci, mm_blocks // 2, kept), \
            counted(ci, mm_counts):
        mm_frame, _ = render_scene(mm)
    check_launches(mm_counts, {"fused_closest_hit": mm_blocks,
                               "fused_any_hit": mm_blocks},
                   f"multimesh render_scene ({mm_blocks} ray blocks)")
    check_frame(mm, mm_frame, MM_WIDTH, MM_HEIGHT, "multimesh")

    def mm_forward():
        with torch.no_grad():
            render_scene(mm)

    mm_frame_ms = cuda_ms(mm_forward, reps=3)
    print(f"multimesh forward frame: {mm_frame_ms:.3f} ms on {card_line}")

    # ---- 7. K5 vs plain, and its numbers, on the kept queries -----------------
    for name in ("fused_closest_hit", "fused_any_hit"):
        err[name] = check_parity(ci, name, *kept[KERNELS[name][1]], bfc)
    for name in ("fused_closest_hit", "fused_any_hit"):
        nums[name] = kernel_numbers(ci, name, *kept[KERNELS[name][1]], bfc)
        print(f"{name}: {json.dumps(nums[name])}")
    kept.clear()

    # ---- 8. multimesh whole-render parity ------------------------------------
    whole_render_parity(
        ci, lambda w, h: build_multimesh_scene(
            w, h, n_meshes=MM_MESHES, tris_per_mesh=MM_TRIS_PER_MESH),
        "multimesh")

    # ---- 9. multimesh fwd+bwd train step ------------------------------------
    mmt = train(ci, mm, MM_PATHS, reps=3)
    check_launches(mmt["launches"], {"fused_closest_hit": mm_blocks,
                                     "fused_any_hit": mm_blocks},
                   "multimesh train step")
    print(f"multimesh fwd+bwd step {MM_WIDTH}x{MM_HEIGHT}: "
          f"{mmt['step_ms']:.3f} ms, {mmt['rays_per_s']:.4e} rays/s; peak "
          f"{mmt['peak_bytes'] / 2**30:.3f} GiB on {card_line}")

    # ---- report ----------------------------------------------------------------
    step_launches = {**flag["launches"], **{
        k: mmt["launches"][k] for k in ("fused_closest_hit", "fused_any_hit")}}
    rows = []
    for name in KERNELS:
        n = nums[name]
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": TPU_FUSED if name.startswith("fused") else TPU_KERNEL,
            "launches": step_launches[name], "max_abs_err": err[name],
            "ms": n["ms"], "plain_ms": n["plain_ms"],
            "bound_ms": n["bound_ms"], "bound_by": n["bound_by"],
            "library_ms": None,
        })
    print(json.dumps({
        "card": card_line,
        "flagship": {"frame_ms": frame_ms,
                     "rays_per_s": rays / frame_ms * 1e3,
                     "fwd_bwd": flag},
        "multimesh": {"frame_ms": mm_frame_ms, "fwd_bwd": mmt},
    }))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
